"""The readings a cell's correctness limit is set from, on the chip:

    python -m qoebench.readings --workload <cell> --seeds a,b,... \
        --control-seeds a,b,c --seconds 15

For each seed, one lead-in and window at the cell's own load in one
process (weights redrawn per seed), the cell's sample of served requests,
and the widest logit gap of the served tokens under the float32
reference (the lower reading comes from these). On the control seeds the
same prompts and tokens are also read by the fp8 control: the widest gap
of the tokens it puts first (the upper reading).

``--witness`` also reads, for the same prompts and served tokens, the
first choices of the port's own batch-1 path (``Model.prefill`` over the
prompt, then one ``decode_step`` per served token, the cache's length
left where the model keeps it) against the reference: a second witness
where the engine's tokens and the reference part. ``--traffic`` and
``--sample`` run another mix than the cell's, with another sample size
(the served-token readings of a mix that is not a cell).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from qoebench import harness


def batch1_choices(model, params, cfgd: dict, prompt, served) -> list:
    """The port's first choice at each served position, one request at a
    time, as a plain language model reads it: the prompt prefilled at its
    own length, then each served token decoded at the next position."""
    import torch
    dev = model.device
    dtype = getattr(torch, cfgd["dtype"])
    toks = torch.as_tensor(np.asarray(prompt, np.int32))[None].to(dev)
    cache = model.init_cache(1, cfgd["serving"]["max_seq"], dtype=dtype)
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": toks}, cache)
        out = [int(logits[0].argmax())]
        for tok in served[:-1]:
            logits, cache = model.decode_step(
                params, torch.tensor([int(tok)], dtype=torch.int32,
                                     device=dev), cache)
            out.append(int(logits[0].argmax()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--witness", action="store_true")
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--traffic", default=None)
    ap.add_argument("--sample", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from qoebench.reference.model import served_gaps
    from qoebench.session import Session
    seeds = [int(x) for x in args.seeds.split(",")]
    ctl = {int(x) for x in args.control_seeds.split(",") if x}
    s = Session(args.workload, seeds[0], traffic=args.traffic)
    if args.sample:
        s.check = dict(s.check, sample=args.sample)
    rows = []
    for seed in seeds:
        rec = s.window(seed, args.seconds)
        sample = harness.sample_served(rec, s.check, seed)
        res = harness.check_served(s.cfgd, s.params, sample, "cuda",
                                   quant="fp8" if seed in ctl else None)
        res.update(seed=seed, preemptions=rec["preemptions"],
                   peak_kv=rec["peak_kv_util"])
        if args.witness:
            judged = [dict(x, judge=batch1_choices(
                s.model, s.params, s.cfgd, x["prompt"], x["served"]))
                for x in sample]
            out = served_gaps(s.cfgd["model"], s.params, judged,
                              device="cuda")
            res["batch1_widest_gap"] = float(max(np.max(o["served"])
                                                 for o in out))
            res["batch1_per_request"] = [
                [float(o["served"].max()), int(o["served"].argmax()),
                 int(np.sum(np.asarray(j["judge"]) != np.asarray(j["served"])))]
                for j, o in zip(judged, out)]
            res["batch1_differs"] = int(sum(
                int(np.sum(np.asarray(j["judge"]) != np.asarray(j["served"])))
                for j in judged))
        rows.append(res)
        print(json.dumps(res), flush=True)
        s.torch.cuda.empty_cache()
    low = max(r["widest_gap"] for r in rows)
    cw = [r["control_widest_gap"] for r in rows if "control_widest_gap" in r]
    harness.log(f"lower reading {low!r} over {len(rows)} seeds; upper "
                f"reading {min(cw) if cw else None!r} over {len(cw)} seeds")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
