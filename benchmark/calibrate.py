"""The readings that the limits of ``correct`` are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 ... \
        [--control-seeds 1 2 3] [--out readings.json]

For each seed, in one process: the program built and warmed up as a run
builds it, its GCM loop driven from t=0 up to the steps that the seed's
run compares, and the numbers of ``mmfbench/check.py`` read for

- ``program``: the program's steps against the float64 reference (the
  lower readings);
- ``float32``: the reference in float32 put in the program's place (the
  control of a float64 configuration);
- with ``--control-seeds``, for a float32 configuration, the lower
  precisions in the program's place: ``tf32`` (float32 products in TF32:
  the configurations' float32 runs with TF32 off), ``bf16_state`` (the
  state rounded to bfloat16 as each step takes and gives it, float32
  between) and ``bf16`` (the reference wholly in bfloat16, which does not
  run: its error is recorded);
- the faults a run can have, planted in the program's steps: a step that
  returns its state unchanged, half of the chunk's members left as they
  were, one member's temperature changed by 0.01 K in one cell.

A configuration's ``control`` names the reading that is its control.

One JSON line a seed on stdout; with ``--out`` all of them in one file.
The benchmark's runs do not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


def faults(snaps: dict) -> dict:
    """name -> snaps with the program's step broken."""
    import torch
    out = {"unchanged": {}, "half_members": {}, "one_cell": {}}
    for i, (before, after) in snaps.items():
        out["unchanged"][i] = (before, dict(before))
        half = {}
        for k, v in after.items():
            n = v.shape[0] // 2 if v.dim() else 0
            half[k] = (v if k not in before or n == 0 else
                       torch.cat([v[:n], before[k][n:]]))
        out["half_members"][i] = (before, half)
        bent = dict(after)
        t = after["temp"].clone()
        t.view(-1)[t.numel() // 2] += 0.01
        bent["temp"] = t
        out["one_cell"][i] = (before, bent)
    return out


def readings(cell, seed: int, control: bool, device: str = "cuda") -> dict:
    import torch
    from mmfbench import check, program, spec

    t0 = time.perf_counter()
    system = program.build(cell.config, cell.traffic, seed, device)
    plan = check.plan(seed, cell.traffic, system.ncrm, len(system.chunks))
    program.warm_up(system, 2 * len(plan.samples))
    loop = program.gcm_loop(system, 0.0, samples=plan.samples.values(),
                            chunk_index=plan.chunk_index)
    run = program.run_settings(cell.config, cell.traffic)
    seeds = program.member_seeds(seed, system.nens, system.chunk)
    chunk = system.chunk
    del system
    torch.cuda.empty_cache()
    ref = check.Reference(run, seeds, chunk, plan.chunk_index, device)
    want = {kind: ref.step(ref.start if kind == "start"
                           else loop.snaps[i][0], boundary=kind != "interior")
            for kind, i in plan.samples.items()}
    starts = {kind: ref.start if kind == "start" else loop.snaps[i][0]
              for kind, i in plan.samples.items()}
    del ref

    def read(snaps):
        found = {kind: check.gaps(starts[kind], snaps[i][1], want[kind],
                                  cell.config["trim"])
                 for kind, i in plan.samples.items()}
        return {"numbers": check.numbers(found),
                "fields": {kind: {k: [g, tg] for k, (t, g, tg) in per.items()
                                  if t == "moved"}
                           for kind, per in found.items()}}

    out = {"seed": seed, "chunk_index": plan.chunk_index,
           "samples": plan.samples, "steps_taken": loop.steps_done,
           "program": read(loop.snaps)}
    for name, snaps in faults(loop.snaps).items():
        out["fault." + name] = read(snaps)
    variants = [("float32", dict(dtype=torch.float32))]
    if control and spec.dtype_name(cell.config) == "float32":
        variants += [("tf32", dict(dtype=torch.float32, tf32=True)),
                     ("bf16_state", dict(dtype=torch.float32,
                                         state_dtype=torch.bfloat16)),
                     ("bf16", dict(dtype=torch.bfloat16))]
    for name, kw in variants:
        try:
            other = check.Reference(run, seeds, chunk, plan.chunk_index,
                                    device, **kw)
            snaps = {i: (None, other.step(other.start if kind == "start"
                                          else loop.snaps[i][0],
                                          boundary=kind != "interior"))
                     for kind, i in plan.samples.items()}
            out[name] = read(snaps)
            del other, snaps
        except Exception as e:      # a control that fails gives no number
            out[name] = {"error": f"{type(e).__name__}: {e}"[:500]}
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=())
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    from mmfbench import spec
    if not torch.cuda.is_available():
        print("calibrate.py: no card", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    rows = []
    for seed in args.seeds:
        r = readings(cell, seed, seed in args.control_seeds)
        rows.append(r)
        print(json.dumps(r), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
