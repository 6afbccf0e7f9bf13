"""The dataclass field marker that the copied modules declare per-member
tables with; on one process it is a plain field."""

from __future__ import annotations

import dataclasses


def per_member(axis: int, **kw):
    return dataclasses.field(metadata={"ens_axis": axis}, **kw)
