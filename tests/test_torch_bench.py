"""The port's benchmark route (python -m pam_tpu_torch.bench) on the CPU.

It runs as a user runs it, in a subprocess where importing JAX or
pam_tpu fails, with PAM_BENCH_DEVICE=cpu, and is held to bench.py's
contract (tests/test_bench_smoke.py): one parseable JSON line per config
on stdout, the last the line of record (Kessler on SPAM+SI), with unit,
value > 0, ms_per_step > 0 and reps; plus the port's own keys
(first_step_s, peak_mib, chip, capture_s: the compiled step's capture,
of which a CPU run makes none) and no baseline ratio (the baseline is
a TPU figure). Once through the single-config route, once through the
default rows at full width (65x1x50) with tiny ensembles and one step
of each kind, and once through a row run in chunks (bench.py's rows 2-4
run so, each chunk stepped alone). The Kessler row's start state is
pam_tpu's, within float32 rounding.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pam_tpu_torch import bench

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = r"""
import sys, runpy
sys.modules["jax"] = None
sys.modules["pam_tpu"] = None
sys.argv = ["bench"] + sys.argv[1:]
runpy.run_module("pam_tpu_torch.bench", run_name="__main__")
"""
KEYS = {"metric", "value", "unit", "config", "ms_per_step",
        "ms_per_step_median", "reps", "device_ms_per_step", "first_step_s",
        "peak_mib", "chip", "capture_s"}
RECORD = "micro=kessler,sgs=none,dycore=spam"


def run_bench(env_extra, args=()):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PAM_BENCH_")}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1", PAM_BENCH_DEVICE="cpu",
               PAM_BENCH_STEPS="1", PAM_BENCH_REPS="1",
               PAM_BENCH_TRACE_STEPS="1")
    env.update(env_extra)
    proc = subprocess.run([sys.executable, "-c", RUN, *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    recs = [json.loads(ln) for ln in lines]
    for rec in recs:
        assert set(rec) == KEYS, rec
        assert rec["unit"] == "gridpoint-steps/s"
        assert rec["value"] > 0 and rec["ms_per_step"] > 0
        assert rec["ms_per_step_median"] >= rec["ms_per_step"]
        assert rec["reps"] == int(env["PAM_BENCH_REPS"])
        assert rec["first_step_s"] > 0
        # a CPU run states no device time or memory, and says where it ran
        assert rec["chip"] == "cpu"
        assert rec["device_ms_per_step"] is None and rec["peak_mib"] is None
        assert rec["capture_s"] is None
    return recs, proc.stderr


def test_single_config_route():
    recs, err = run_bench({"PAM_BENCH_MICRO": "kessler",
                           "PAM_BENCH_NENS": "2", "PAM_BENCH_REPS": "2"})
    assert [r["config"] for r in recs] == [RECORD]
    r = recs[0]
    # value is gridpoints / best ms
    assert r["value"] == pytest.approx(65 * 50 * 2 / r["ms_per_step"] * 1e3)
    assert "spread" in err     # the reps' spread goes to stderr


def test_default_rows_at_full_width():
    """bench.py's rows in its order, the nens 1024 row skipped
    (PAM_BENCH_NENS_BIG2=0), each line printed, the line of record last;
    the big rows name their ensemble and pick_ens_chunk's chunk, as
    bench.py prints them (4 of 4 here, so they run in one program)."""
    recs, _ = run_bench({"PAM_BENCH_NENS": "2", "PAM_BENCH_NENS_BIG": "4",
                         "PAM_BENCH_NENS_BIG2": "0",
                         "PAM_BENCH_AWFL_STEPS": "1"})
    assert [r["config"] for r in recs] == [
        "micro=p3,sgs=shoc,dycore=spam",
        "micro=p3,sgs=shoc,dycore=spam,nens=4,ens_chunk=4",
        "micro=kessler,sgs=none,dycore=spam,nens=4,ens_chunk=4",
        "micro=kessler,sgs=none,dycore=awfl",
        RECORD]
    for r, nens in zip(recs, (2, 4, 4, 2, 2)):
        assert r["value"] == pytest.approx(65 * 50 * nens /
                                           r["ms_per_step"] * 1e3)


def test_rows_with_the_nens_1024_row():
    """PAM_BENCH_NENS_BIG2 adds its row after the nens 512 one."""
    s = bench.Settings()
    assert [(r.micro, r.nens, r.dycore, r.steps) for r in bench.rows(s)] == [
        ("p3", 128, "spam", 60), ("p3", 512, "spam", 60),
        ("p3", 1024, "spam", 60), ("kessler", 512, "spam", 60),
        ("kessler", 128, "awfl", 10), ("kessler", 128, "spam", 60)]
    one = bench.Settings.from_env({"PAM_BENCH_DYCORE": "awfl",
                                   "PAM_BENCH_STEPS": "7"})
    assert [(r.micro, r.sgs, r.dycore, r.steps) for r in bench.rows(one)] == \
        [("kessler", "none", "awfl", 7)]
    assert one.device == "cuda"


def test_big_rows_carry_bench_py_chunks():
    """Rows 2-4 are bench.py's (bench.py:282-308): the driver at
    pick_ens_chunk(65, 1, 50, f32, nens), 128 members, and the config
    strings end in ,nens=<n>,ens_chunk=128; the other rows run their
    ensemble in one program."""
    rows = bench.rows(bench.Settings())
    assert [(r.config, r.nens, r.chunk) for r in rows] == [
        ("micro=p3,sgs=shoc,dycore=spam", 128, None),
        ("micro=p3,sgs=shoc,dycore=spam,nens=512,ens_chunk=128", 512, 128),
        ("micro=p3,sgs=shoc,dycore=spam,nens=1024,ens_chunk=128", 1024,
         128),
        ("micro=kessler,sgs=none,dycore=spam,nens=512,ens_chunk=128", 512,
         128),
        ("micro=kessler,sgs=none,dycore=awfl", 128, None),
        (RECORD, 128, None)]
    # the unchunked 512 stays reachable as a single config
    one = bench.Settings.from_env({"PAM_BENCH_MICRO": "p3",
                                   "PAM_BENCH_SGS": "shoc",
                                   "PAM_BENCH_NENS": "512"})
    assert [(r.config, r.nens, r.chunk) for r in bench.rows(one)] == [
        ("micro=p3,sgs=shoc,dycore=spam", 512, None)]


def test_chunk_knobs_keep_bench_py_meanings():
    """PAM_BENCH_ENS_MICROBATCH sizes the driver of a row that picks no
    chunk (bench.py:128-141), PAM_BENCH_KESSLER_CHUNK is Kessler's
    ens_chunk (bench.py:124-127); unset, neither applies."""
    s = bench.Settings.from_env({"PAM_BENCH_ENS_MICROBATCH": "64",
                                 "PAM_BENCH_KESSLER_CHUNK": "8"})
    assert (s.ens_microbatch, s.kessler_chunk) == (64, 8)
    s = bench.Settings.from_env({"PAM_BENCH_ENS_MICROBATCH": "",
                                 "PAM_BENCH_KESSLER_CHUNK": ""})
    assert (s.ens_microbatch, s.kessler_chunk) == (None, None)
    drv, state = bench.setup_config("kessler", "none", 4, device="cpu",
                                    drv_nens=2,
                                    micro_kwargs={"ens_chunk": 1})
    assert drv.coupler.nens == 2 and drv.micro.ens_chunk == 1
    assert state["temp"].shape[0] == 4
    p3, _ = bench.setup_config("p3", "shoc", 2, device="cpu",
                               micro_kwargs={"ens_chunk": 1})
    assert p3.coupler.nens == 2


def test_chunked_row_runs():
    """A row run in chunks at full width: the Kessler line of record at
    nens 4 with the driver at 2 (PAM_BENCH_ENS_MICROBATCH), Kessler's own
    chunk at 1; one line, the ensemble's gridpoints over the best ms."""
    recs, err = run_bench({"PAM_BENCH_MICRO": "kessler",
                           "PAM_BENCH_NENS": "4",
                           "PAM_BENCH_ENS_MICROBATCH": "2",
                           "PAM_BENCH_KESSLER_CHUNK": "1"})
    assert [r["config"] for r in recs] == [RECORD]
    assert recs[0]["value"] == pytest.approx(65 * 50 * 4 /
                                             recs[0]["ms_per_step"] * 1e3)
    assert "nens 4 driver 2]" in err


def test_chunked_route_steps_each_chunk_alone(monkeypatch):
    """run_row's chunked step is the chunk driver's step of each chunk in
    turn: after the route's steps the chunks equal the chunk driver's
    steps of the split state, bit for bit (float32, 16x1x12 to keep it
    small)."""
    monkeypatch.setattr(bench, "GRID", dict(bench.GRID, nx=16, nz=12,
                                            xlen=32000.0))
    steps = []
    real = bench.timed_steps

    def timed(step, state, n, cuda=True):
        out = real(step, state, n, cuda)
        steps.append((n, out[0]))
        return out
    monkeypatch.setattr(bench, "timed_steps", timed)
    s = bench.Settings(steps=1, reps=1, trace_steps=0, device="cpu")
    row = bench.Row("kessler", "none", 4, "spam", 1, chunk=2)
    bench.run_row(s, row, "cpu")
    n_run = sum(n for n, _ in steps)
    drv, state = bench.setup_config("kessler", "none", 4, device="cpu",
                                    drv_nens=2)
    from pam_tpu_torch.driver.mmf import _split_ens
    chunks = _split_ens(state, 2)
    for _ in range(n_run):
        chunks = [drv.crm_phys_step(c) for c in chunks]
    got = steps[-1][1]
    assert len(got) == 2
    for c, ref in zip(got, chunks):
        for k, v in ref.items():
            assert torch.equal(c[k], v), k


def test_no_card_and_no_cpu_request_raises(monkeypatch):
    """Without a card and without PAM_BENCH_DEVICE=cpu the route raises
    before it measures anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="PAM_BENCH_DEVICE=cpu"):
        bench.run(bench.Settings(single=("kessler", "none"), nens=2))


# the CRM field whose horizontal mean each forcing tendency relaxes
# toward the GCM's: (gcm - mean) / dt_gcm, so it carries the rounding of
# that mean, a few float32 ulps of the field's scale over dt_gcm
TEND_SOURCE = {"temp": "temp", "uvel": "uvel", "vvel": "vvel",
               "rho_d": "density_dry", "rho_v": "water_vapor",
               "qv": "water_vapor", "qtot": "water_vapor"}
ULPS = 8


def test_kessler_start_state_matches_pam_tpu():
    """The Kessler row at nens 2 after the GCM forcing: every field equals
    pam_tpu's setup_supercell_mmf with bench.py's arguments
    (bench.py:142-148) and its forcing, the fields bit for bit, the
    forcing tendencies within ULPS float32 ulps of their field's scale
    over dt_gcm, the temperature within ULPS ulps of its scale (the same
    draw; the perturbation's conserving rescale divides horizontal means
    that may sum in another order)."""
    from pam_tpu.driver.mmf import setup_supercell_mmf as jax_setup
    from pam_tpu.modules import gcm_forcing as jax_forcing
    jdrv, js = jax_setup(**bench.GRID, nens=2, micro="kessler", sgs="none",
                         dycore="spam", dtype=jnp.float32,
                         dycore_kwargs={"linear_system": "velocity",
                                        "si_two_point": False})
    js = jax_forcing.compute_gcm_forcing_tendencies(jdrv.coupler, js,
                                                    jdrv.dt_gcm)
    _, ts = bench.setup_config("kessler", "none", 2, device="cpu")
    assert sorted(js) == sorted(ts)
    eps = float(np.finfo(np.float32).eps)
    for k in js:
        a, b = np.asarray(js[k], np.float64), ts[k].double().numpy()
        assert a.shape == b.shape and ts[k].dtype == torch.float32, k
        tol = ULPS * eps * float(np.abs(a).max()) if k == "temp" else 0.0
        if k.startswith("gcm_forcing_tend_"):
            src = TEND_SOURCE.get(k[len("gcm_forcing_tend_"):])
            if src is not None:
                tol = (ULPS * eps * float(np.abs(np.asarray(js[src])).max())
                       / jdrv.dt_gcm)
        assert float(np.abs(a - b).max()) <= tol, k


def test_two_point_option_matches_pam_tpu():
    """PAM_BENCH_TWOPOINT=1 (bench.py:118-120) reaches the port's coupled
    build as si_two_point, and one CRM step of SPAM+SI Kessler with the
    two-point discrete gradient, from pam_tpu's start state, equals
    pam_tpu's jitted step at 1e-10 of each field's scale (f64, 16x1x12,
    nens 2)."""
    import jax
    from pam_tpu.driver.mmf import setup_supercell_mmf as jax_setup
    from pam_tpu.modules import gcm_forcing as jax_forcing
    from pam_tpu_torch.convert import state_from_numpy, state_to_numpy
    from pam_tpu_torch.driver.mmf import setup_supercell_mmf
    s = bench.Settings.from_env({"PAM_BENCH_TWOPOINT": "1"})
    assert s.two_point and not bench.Settings.from_env({}).two_point
    drv, _ = bench.setup_config("kessler", "none", 1, "spam", s.linsys,
                                s.two_point, device="cpu")
    assert drv.dycore.si_two_point
    kw = dict(nx=16, ny=1, nz=12, nens=2, xlen=32000.0, ylen=64000.0,
              zlen=20000.0, micro="kessler", sgs="none", dt_gcm=200.0,
              dt_crm_phys=20.0, dycore="spam",
              dycore_kwargs={"linear_system": "velocity",
                             "si_two_point": True})
    jd, js = jax_setup(**kw, dtype=jnp.float64)
    js = jax_forcing.compute_gcm_forcing_tendencies(jd.coupler, js,
                                                    jd.dt_gcm)
    td, _ = setup_supercell_mmf(**kw, dtype=torch.float64, device="cpu")
    assert td.dycore.si_two_point and jd.dycore.si_two_point
    ts = state_from_numpy({k: np.asarray(v) for k, v in js.items()}, "cpu",
                          torch.float64)
    ref = jax.jit(jd.crm_phys_step)(js)
    got = state_to_numpy(td.crm_phys_step(ts))
    assert sorted(ref) == sorted(got)
    for k in ref:
        a = np.asarray(ref[k])
        err = float(np.abs(a - got[k]).max())
        assert err < 1e-10 * max(float(np.abs(a).max()), 1e-9), k
