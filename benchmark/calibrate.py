"""The readings that the limits of `correct` are set from, for one cell, in
one process:

  * sound runs: the program's numbers on each of `--seeds` seeds (set-up,
    the entry's first steps or a short window, then the check);
  * the control on the first `--control` seeds: the plain reference in the
    program's place, its products one precision below the configuration's
    (reference/plain/precision.py; an evaluation's decode reading the head's
    outputs rounded to bfloat16), judged as the program is;
  * for a train cell, on the first `--faults` seeds, the faults planted
    in the program: "half of the batch left out, the mean taken over the rest"
    (half_batch) and the adversary's Adam chain advancing its moments but
    leaving its parameters where they were (adversary_frozen);
  * with --float32-witness instead, the program run in float32 (compute
    dtype float32, the adversary's MLP in float32): a second witness of
    how far the train step's gaps come from anything but rounding.

    python3 benchmark/calibrate.py --workload NAME --seeds 12 --control 3 \
        [--faults 3] [--seconds S] [--first-seed N] [--float32-witness] [--out FILE]

Prints one JSON line per reading and appends them to --out."""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def halve(b):
    """The batch with its second half of frames left out."""
    if isinstance(b, tuple) and not hasattr(b, "_fields"):
        return tuple(halve(x) for x in b)
    if hasattr(b, "_fields"):
        return type(b)(*(x[: x.shape[0] // 2] for x in b))
    return b[: b.shape[0] // 2]


def _namespace(program):
    return types.SimpleNamespace(**{k: getattr(program, k) for k in dir(program)
                                    if not k.startswith("__")})


def with_half_batch(program):
    """The family's program module with its timed train step fed half the batch."""
    ns = _namespace(program)
    ns.train_step = lambda t, b, e: program.train_step(t, halve(b), e)
    return ns


def freeze_chain(chain) -> None:
    """The optimizer chain's moments advance as before; its updates are nought."""
    update = chain.update
    chain.update = lambda *a: [u.mul_(0.0) for u in update(*a)]


def with_frozen_adversary(program):
    """The family's program module whose trainer leaves the adversary's
    parameters where they were."""
    ns = _namespace(program)

    def trainer(cfg, device):
        t = program.trainer(cfg, device)
        freeze_chain(t.adv_tx)
        return t
    ns.trainer = trainer
    return ns


FAULTS = {"half_batch": with_half_batch, "adversary_frozen": with_frozen_adversary}


def control_numbers(ctx, kind: str, epoch: float = 0.0):
    """The control's numbers: the reference at control precision in the
    program's place, judged against the float32 reference (an evaluation
    on `sampled_batches` batches of the pool)."""
    import torch

    from benchmark import check, harness
    from benchmark.reference import train

    ref = ctx.reference.Reference(ctx.cfg, ctx.device)
    try:
        if kind == "train":
            batches = ctx.pool[:3]
            with harness.reference_precision("control"):
                low = train.three_steps(ref, ctx.weights, batches, epoch, ctx.cfg["optim"])
            timings = []
            with harness.reference_precision():
                full = train.three_steps(ref, ctx.weights, batches, epoch, ctx.cfg["optim"],
                                         timings)
            return check.train_gaps(low, full), dict(diagnostics(low, full),
                                                     reference_timings=timings)
        ref.model.load_state_dict(ctx.weights)
        ref.model.eval()
        hg = dg = 0.0
        for batch in ctx.pool[:int(ctx.traffic["sampled_batches"])]:
            with harness.reference_precision("control"):
                heads = ref.eval_heads(batch)
            with harness.reference_precision():
                dets = ref.decode({k: v.to(torch.bfloat16).float() for k, v in heads.items()})
                hg = max(hg, check.head_gap(heads, ref.eval_heads(batch)))
                dg = max(dg, check.decode_gap(dets, ref.decode(heads)))
        return {"head_gap": hg, "decode_gap": dg}, {}
    finally:
        del ref
        harness.free(ctx.device)


def diagnostics(prog, ref, top: int = 5):
    """The look behind a train cell's numbers: each step's loss on both
    sides, and the leaves with the widest gaps as (name, gap, program's
    norm, reference's norm)."""
    from benchmark import check

    grad, change = check.train_leaf_gaps(prog, ref)

    def worst(gaps, key):
        return [(k, gaps[k], prog[key][k], ref[key][k])
                for k in sorted(gaps, key=gaps.get, reverse=True)[:top]]
    return {"loss": [prog["loss"], ref["loss"]], "grad_worst": worst(grad, "grad"),
            "change_worst": worst(change, "change"),
            "adversary": [prog["adversary"], ref["adversary"]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="readings for the limits of `correct`")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "calibrate.jsonl"))
    ap.add_argument("--float32-witness", action="store_true",
                    help="run the program in float32 instead (a witness, not a sound run)")
    args = ap.parse_args(argv)
    sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != HERE]

    from benchmark import harness, run as bench_run

    bench = harness.spec()
    wl = harness.workload(args.workload, bench)
    cfg, traffic, _ = harness.cell_parts(wl, bench)
    if args.float32_witness:
        cfg["env"] = dict(cfg.get("env", {}), RPC_PERT_BF16="0")
        cfg["model"]["compute_dtype"] = "float32"
    bench_run.set_environment(cfg.get("env", {}))
    import torch

    device = torch.device("cuda", 0)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)

    def emit(rec):
        rec.update(workload=args.workload, device=torch.cuda.get_device_name(device))
        line = json.dumps(rec)
        print(line, flush=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")

    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        for what in (("float32",) if args.float32_witness else
                     ("program", "control") + tuple(FAULTS)):
            if what == "control" and i >= args.control or what in FAULTS and i >= args.faults:
                continue
            if what in FAULTS and traffic["entry"] != "train_inline":
                continue
            t0 = time.perf_counter()
            ctx = harness.make_context(cfg, traffic, seed, device)
            if what == "control":
                kind = "train" if traffic["entry"] == "train_inline" else "eval"
                numbers, diag = control_numbers(ctx, kind, float(traffic.get("epoch", 0)))
            else:
                if what in FAULTS:
                    ctx.program = FAULTS[what](ctx.program)
                entry = harness.entry_class(traffic)(ctx)
                if entry.kind == "eval":
                    entry.window(args.seconds, ctx.sync)
                entry.release()
                harness.free(device)
                numbers = harness.reference_check(entry, ctx)
                got = getattr(entry, "reference_readings", None)
                diag = diagnostics(entry.readings, got) if got else {}
                del entry
            emit({"what": what, "seed": seed, "numbers": numbers, "look": diag,
                  "seconds": time.perf_counter() - t0})
            del ctx
            harness.free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
