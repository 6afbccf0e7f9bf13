"""The frozen work of B1 and B4 equals the port's today, at the calls the
port's step makes at the configurations' shapes."""

import pytest
import torch

from mmfbench import kernels, spec
from pam_tpu_torch.ops import p3_part2, weno, weno_x

CONFIGS = ("mmf_production", "mmf_pamc_kessler")


def _config(name):
    return spec.load_json(spec.HERE / "configs" / f"{name}.json")


@pytest.mark.parametrize("name", CONFIGS)
def test_b1_work_equals_the_ports(name):
    tables = weno.weno_tables(5, torch.float64)
    for call in _config(name)["kernel_calls"]["b1"]:
        for chunk in (1, 128):
            assert kernels.weno_x_work(call["rows"] * chunk, call["nx"], 4) \
                == weno_x.weno_x_work(call["rows"] * chunk, call["nx"], 4,
                                      tables)


def test_b4_arrays_equal_the_ports():
    assert (kernels.B4_ARRAYS_IN, kernels.B4_ARRAYS_OUT) == \
        (p3_part2.N_IN, p3_part2.N_OUT)


def test_b4_operations_equal_the_plain_versions_count():
    """chip_smoke.py::plain_ops over the plain P3 part 2 (the table stage
    by gathers, then the core) at half the species present: one
    operation per element each elementwise PyTorch operation writes."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    from pam_tpu_torch.physics.p3 import main as p3main

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            held = {a.untyped_storage().data_ptr()
                    for a in tree_leaves((args, kwargs))
                    if isinstance(a, torch.Tensor)}
            self.ops += sum(o.numel() for o in tree_leaves(out)
                            if isinstance(o, torch.Tensor)
                            and o.untyped_storage().data_ptr() not in held)
            return out

    shape = (50, 65, 128)        # the count chip_smoke.py made, B4's call
    args = p3_part2.cast_inputs(p3_part2.sample_inputs(
        shape, torch.float64, "cpu", seed=11, present=0.5), torch.float32)
    with Count() as mode:
        p3main._part2_core(*args, p3main._part2_tables(args[-1], gather=True))
    assert round(mode.ops / (50 * 65 * 128)) == kernels.B4_OPS


@pytest.mark.parametrize("name", CONFIGS)
def test_kernel_calls_are_the_ports_step(name):
    """Every B1 and B4 call of one CRM step of the port at the
    configuration's grid, two members."""
    from pam_tpu_torch.driver import mmf
    from pam_tpu_torch.physics.p3 import main as p3main
    from pam_tpu_torch.spam import tendencies

    from mmfbench import program
    cfg = _config(name)
    system = program.build(cfg, {"nens": 2}, seed=5, device="cpu")
    calls = {"b1": [], "b4": []}
    b1, b4 = tendencies.weno_x.weno_edges_x, p3_part2.p3_part2

    def rec1(field, tables, kind="x"):
        calls["b1"].append({"rows": field.numel() // field.shape[-1] // 2,
                            "nx": field.shape[-1]})
        return b1(field, tables, kind)

    def rec4(*a, **k):
        calls["b4"].append({"points": a[1].numel() // 2})
        return b4(*a, **k)

    state = system.drv._forcing(system.chunks[0])
    tendencies.weno_x.weno_edges_x, p3_part2.p3_part2 = rec1, rec4
    try:
        system.drv._crm_phys_step_single(state)
    finally:
        tendencies.weno_x.weno_edges_x, p3_part2.p3_part2 = b1, b4
    assert calls["b1"] == cfg["kernel_calls"]["b1"]
    assert calls["b4"] == cfg["kernel_calls"].get("b4", [])
    assert isinstance(system.drv, mmf.MmfDriver) and p3main
