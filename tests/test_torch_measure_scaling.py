"""The port's scaling tool (python -m pam_tpu_torch.measure_scaling) on
the CPU over gloo, and the payload bytes that parallel/comm.py counts in
Mesh.bytes.

The tool runs here as a user runs it, in a subprocess where importing
JAX or pam_tpu fails: the slab configuration (SPAM+SI Kessler) cut to
16x1x12, nens 8, one timed step, on the meshes of at most 2 ranks:
(ens 1, x 1), (ens 2, x 1) and (ens 1, x 2). Its collectives a step are
pinned exactly: on 2 x shards 86 point-to-point messages and 23
all_reduces, as on 2 to 8 x shards at 64x1x50 (chip_smoke.py phase 17c;
the counts do not depend on the grid): 12 halos of B1's WENO stencils
and 74 single-column shifts; 6 psum-DFT reductions of the SI solves, 3
horizontal means of the forcing and 7 of the sponge, 6 sums of
fill_holes and the rainsplit's minimum. The ensemble-only mesh and the
single rank make none.
"""

import json
import os
import subprocess
import sys

import pytest

from pam_tpu_torch.parallel import mesh as tmesh

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_sharding_case as case  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NONE = {"p2p": 0, "all_reduce": 0, "all_gather": 0, "all_to_all": 0}
SLAB_X2 = {"p2p": 86, "all_reduce": 23, "all_gather": 0, "all_to_all": 0}
RUN = r"""
import sys, runpy
sys.modules["jax"] = None
sys.modules["pam_tpu"] = None
sys.argv = ["measure_scaling"] + sys.argv[1:]
runpy.run_module("pam_tpu_torch.measure_scaling", run_name="__main__")
"""


def _snapshot():
    """The repository's top-level JSON files, with the contents of its
    SCALING*.json."""
    top = sorted(f for f in os.listdir(ROOT) if f.endswith(".json"))
    scaling = {f: open(os.path.join(ROOT, f), "rb").read() for f in top
               if f.startswith("SCALING")}
    return top, scaling


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("scaling")
    work, out = tmp / "cwd", tmp / "report" / "scaling.json"
    work.mkdir()
    out.parent.mkdir()
    before = _snapshot()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               PYTHONDONTWRITEBYTECODE="1")
    proc = subprocess.run(
        [sys.executable, "-c", RUN, "--device", "cpu", "--configs", "slab",
         "--nx", "16", "--nz", "12", "--steps", "1", "--max-ranks", "2",
         "--out", str(out)],
        cwd=work, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return dict(stdout=proc.stdout, out=out, work=work, before=before,
                after=_snapshot())


def test_prints_and_writes_only_out(report):
    """The JSON goes to stdout and to --out; nothing else is written: not
    in the working directory, not in the repository (no
    SCALING_measured.json, which the JAX tool writes)."""
    printed = json.loads(report["stdout"])
    assert json.loads(report["out"].read_text()) == printed
    assert os.listdir(report["work"]) == []
    assert report["after"] == report["before"]
    assert printed["device"] == "cpu" and printed["chip"] == "cpu"
    assert "GSPMD" in printed["modes"]


def test_meshes_and_times(report):
    r = json.loads(report["stdout"])
    cfg = r["configs"]["slab"]
    assert (cfg["grid"], cfg["nens"], cfg["micro"]) == ("16x1x12", 8,
                                                         "kessler")
    rows = cfg["meshes"]
    assert [(m["ens_shards"], m["x_shards"]) for m in rows] == \
        [(1, 1), (2, 1), (1, 2)]
    for m in rows:
        assert len(m["ms_per_step_rank"]) == m["ranks"] == \
            m["ens_shards"] * m["x_shards"]
        assert all(t > 0 for t in m["ms_per_step_rank"])
        assert m["ms_per_step_all"] > 0 and m["strong_eff"] > 0
        # ranks on the CPU over gloo say that they share its cores
        if m["ranks"] > 1:
            assert m["backend"] == "gloo" and "not scaling" in m["caveat"]
        else:
            assert m["backend"] == "none" and "caveat" not in m


def test_collectives_per_step_are_pinned(report):
    rows = json.loads(report["stdout"])["configs"]["slab"]["meshes"]
    got = {(m["ens_shards"], m["x_shards"]): m["collectives_per_step"]
           for m in rows}
    assert got == {(1, 1): NONE, (2, 1): NONE, (1, 2): SLAB_X2}


def test_bytes_per_step_follow_the_counts(report):
    """Bytes for every kind that is counted, and none for the rest."""
    for m in json.loads(report["stdout"])["configs"]["slab"]["meshes"]:
        for kind, n in m["collectives_per_step"].items():
            assert (m["bytes_per_step"][kind] > 0) == (n > 0), (m, kind)


def test_mesh_bytes_of_known_payloads(tmp_path):
    """Mesh.bytes against counts worked out by hand, on 4 ranks along x,
    each holding a (2, 3, 1, 4) block: a halo of 3 is one message each
    way of (2, 3, 1, 3) = 18 values, 144 bytes in float64 and 72 in
    float32; a halo of 6 takes the whole neighbour blocks (24 values)
    and 2 columns (12 values) from the next ones, each way; the mean over
    (y, x) reduces (2, 3) = 6 values. reset_counts zeroes both."""
    res = tmesh.spawn_ranks(case.payload_bytes, 4, timeout=120,
                            rendezvous_dir=str(tmp_path))
    want = [({"p2p": 2}, {"p2p": 2 * 18 * 8}),
            ({"p2p": 2}, {"p2p": 2 * 18 * 4}),
            ({"p2p": 4}, {"p2p": (2 * 24 + 2 * 12) * 8}),
            ({"all_reduce": 1}, {"all_reduce": 6 * 8}),
            ({}, {})]
    for per_rank in res:
        assert per_rank == [(dict(NONE, **c), dict(NONE, **b))
                            for c, b in want]
