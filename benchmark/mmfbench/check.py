"""The comparison that decides ``correct``: steps that the timed path took
are taken again by the plain reference (``mmfref``, a frozen plain-PyTorch
copy of the MMF step's mathematics, in float64, every loop on the host,
no kernel of the program) and the two compared field by field.

Three samples, drawn from the run's seed, out of the steps the window
took (the loop goes on past the window's end until it has taken them):

- ``start``: step 0 from the reference's own start, which it builds from
  the seed as the program's set-up does (the supercell column, the
  members' perturbations, the driver of the first chunk): the set-up and
  the first GCM boundary;
- ``boundary``: a later GCM boundary (the forcing computed from the
  program's state and applied, then the CRM step) from the program's
  state before it;
- ``interior``: a CRM step inside a GCM step from the program's state.

Each compares one chunk of the program, drawn from the seed, which the
reference steps whole: Kessler's rain sub-cycles follow the minimum over
a chunk, so the reference steps the program's chunks.

For each field that the reference's step changes, the gap is the norm of
the program's field less the reference's, over the norm of the
reference's change or, where that is less, ``MOVES`` of the field's own
norm (below it float32's rounding of the field is as large as the
change): a step that leaves a field as it was reads 1 in it, or its
change's share of MOVES. Two numbers a sample: ``gap.<kind>``, the widest
gap trimmed of the configuration's ``trim`` share of the chunk's points
where the two differ most (threshold processes, such as condensation,
cloud fraction and freezing, flip single points between float32 and
float64), and ``gap_all.<kind>``, the widest gap over every point, which
bounds the trimmed points. A value of the program's that is not finite
makes both read inf. A field that the reference leaves as it is must
come out bit for bit as it went in."""

from __future__ import annotations

import contextlib
import dataclasses
import math
import random

import numpy as np
import torch

from mmfref.driver import config as ref_config
from mmfref.driver import mmf as ref_mmf

# the least change a gap is measured against, as a share of the field's
# norm
MOVES = 1e-3
KINDS = ("start", "boundary", "interior")


@dataclasses.dataclass(frozen=True)
class Plan:
    """Which steps and which chunk a run compares."""
    samples: dict          # kind -> step index (from t=0)
    chunk_index: int


def plan(seed: int, traffic: dict, ncrm: int, nchunks: int) -> Plan:
    """The steps and the chunk compared, drawn from the seed: the GCM
    boundary among the GCM steps ``traffic["check"]["boundaries"]`` (first
    and last, counted from 0), the interior step among the CRM steps
    ``traffic["check"]["interior"]`` that no GCM boundary starts."""
    rng = random.Random(int(seed))
    c = traffic["check"]
    interior = [i for i in range(c["interior"][0], c["interior"][1] + 1)
                if i % ncrm]
    return Plan(samples={
        "start": 0,
        "boundary": ncrm * rng.randint(*c["boundaries"]),
        "interior": rng.choice(interior)},
        chunk_index=rng.randrange(nchunks))


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """float32 products in TF32 or in full float32 inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


class Reference:
    """The plain reference for chunk ``chunk_index`` of a run: its own
    driver and start, built from the configuration and the members'
    seeds as the program's set-up builds them, in ``dtype`` (products in
    TF32 where ``tf32``: the control)."""

    def __init__(self, run: dict, seeds: np.ndarray, chunk: int,
                 chunk_index: int, device, dtype=torch.float64,
                 tf32: bool = False, state_dtype=None):
        self.dtype, self.tf32 = dtype, tf32
        self.device = torch.device(device)
        # the state rounded to ``state_dtype`` as each step takes and
        # gives it (the control in bfloat16)
        self.state_dtype = state_dtype
        kw = ref_config.setup_kwargs(run, chunk, dtype, device)
        # the perturbation's draw in the configuration's precision: its
        # bits depend on it
        kw["noise_dtype"] = ref_config.dtype(run)
        with matmul_precision(tf32):
            self.drv, _ = ref_mmf.setup_supercell_mmf(
                **kw, perturb_seeds=seeds[:chunk])
            _, self.start = ref_mmf.setup_supercell_mmf(
                **kw, state_only=True,
                perturb_seeds=seeds[chunk_index * chunk:
                                    (chunk_index + 1) * chunk])

    def step(self, before: dict, boundary: bool) -> dict:
        """One CRM step from ``before`` (cast to the reference's dtype),
        its GCM forcing first at a boundary."""
        s = {k: self._round(v.to(self.device)).to(self.dtype)
             for k, v in before.items()}
        with matmul_precision(self.tf32):
            if boundary:
                s = self.drv.forcing(s)
            s = self.drv.crm_phys_step(s)
        return {k: self._round(v) for k, v in s.items()}

    def _round(self, v: torch.Tensor) -> torch.Tensor:
        if self.state_dtype is None or not v.is_floating_point():
            return v
        return v.to(self.state_dtype).to(v.dtype)


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.to(torch.float64)))


def gaps(before: dict, got: dict, want: dict, trim: float) -> dict:
    """Per field of ``want`` that ``before`` holds: ("moved", gap,
    trimmed gap) with gap = |got - want| over the larger of |want -
    before| and MOVES |want| (norms over the chunk), the trimmed gap the
    same without the ``trim`` share of the points where the two differ
    most; or ("kept", the elements of ``got`` that differ from ``want``,
    None) for a field that the reference's step leaves as it was. Where
    ``got`` holds a value that is not finite both gaps read inf."""
    out = {}
    for k, w in want.items():
        if k not in before:
            # made by the start's forcing: tendencies towards the GCM
            # column that the state starts as, rounding on both sides
            continue
        if k not in got:
            out[k] = ("moved", float("inf"), float("inf"))
            continue
        w = w.to(torch.float64)
        g = got[k].to(w.device, torch.float64)
        change = _norm(w - before[k].to(w.device, torch.float64))
        if change == 0.0:
            out[k] = ("kept", int(torch.count_nonzero(g != w)), None)
            continue
        if not bool(torch.isfinite(g).all()):
            out[k] = ("moved", float("inf"), float("inf"))
            continue
        floor = max(change, MOVES * _norm(w))
        d = (g - w).abs().flatten()
        gap = _norm(d) / floor
        keep = d.numel() - math.ceil(trim * d.numel())
        trimmed = _norm(torch.sort(d).values[:keep]) / floor
        out[k] = ("moved", gap if np.isfinite(gap) else float("inf"),
                  trimmed if np.isfinite(trimmed) else float("inf"))
    return out


def numbers(found: dict) -> dict:
    """The numbers compared, from the gaps of each sample kind:
    ``gap.<kind>``, the widest trimmed gap of a moved field,
    ``gap_all.<kind>``, the widest untrimmed one, and ``kept_changed``,
    the elements of the fields the reference keeps that the program
    changed, over the samples that start from the program's
    state."""
    out = {}
    for kind in KINDS:
        if kind in found:
            moved = [(g, tg) for t, g, tg in found[kind].values()
                     if t == "moved"]
            out[f"gap.{kind}"] = (max(tg for _, tg in moved) if moved
                                  else float("inf"))
            out[f"gap_all.{kind}"] = (max(g for g, _ in moved) if moved
                                      else float("inf"))
    out["kept_changed"] = sum(
        g for kind in ("boundary", "interior") if kind in found
        for t, g, _ in found[kind].values() if t == "kept")
    return out


def widest(found: dict) -> dict:
    """kind -> (field, gap, field, trimmed gap) of the widest gap and the
    widest trimmed gap, for the log."""
    out = {}
    for kind, per in found.items():
        moved = [(k, g, tg) for k, (t, g, tg) in per.items() if t == "moved"]
        if moved:
            a = max(moved, key=lambda m: m[1])
            b = max(moved, key=lambda m: m[2])
            out[kind] = (a[0], a[1], b[0], b[2])
    return out


def compare(ref: Reference, snaps: dict, plan_: Plan, trim: float) -> dict:
    """kind -> gaps of the program's step ``snaps[step]`` = (before,
    after) against the reference's, the ``start`` sample from the
    reference's own start."""
    found = {}
    for kind, i in plan_.samples.items():
        before, after = snaps[i]
        start = ref.start if kind == "start" else before
        want = ref.step(start, boundary=kind != "interior")
        found[kind] = gaps(start, after, want, trim)
        del want
    return found


def verdict(values: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every number at or under its
    limit, ``kept_changed`` exactly 0."""
    rows = [(name, values.get(name, float("inf")), limits[name])
            for name in sorted(limits)]
    ok = all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
