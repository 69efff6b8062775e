"""ANF per-variable -> per-system gap analysis and CDCL-assisted completion.

    python -m diffusionsat_torch.anf_error_structure \
        --ckpt pretrained/anf_sat_sha1_r17_130k.npz --test_rounds 64 \
        [--input_anchor] [--skip_frac_ladder] [--device cpu] \
        [--out ANF_ERROR_STRUCTURE.json]

Counterpart of the TPU package's root `anf_error_structure.py`, with its
flags, per-system records and summary. For every test system of the SHA-1
ANF split it measures how the wrong variables sit: their count, the
equations left unsatisfied, and the confidence cover (sorting variables by
|logit|, the share of least-confident variables that must be released so
that every wrong one is). Then, on the host, the CDCL completion ladders:
fix the top-confidence (1 - f) share of the variables to the model's bits,
encode the residual system to CNF and solve it with the native CDCL
(`--release_fracs`), and with `--input_anchor` fix only the predicted
free-input bits, releasing the least-confident ones on a ladder
(`--anchor_release`). The model runs flat with each batch's kernel plans,
its rounds replayed as one CUDA graph on the card, so its membership sums
and AND scatter run on the segsum kernel. It runs on the card unless
`--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from diffusionsat_torch.anf_eval import add_data_args, build_anf_dataset
from diffusionsat_torch.device import resolve_device
from diffusionsat_torch.models.anf_sat import (
    ANFSATConfig,
    anf_sat_apply,
    anf_sat_init,
)
from diffusionsat_torch.sat.anf_completion import (
    encode_residual_cnf,
    eval_equations,
    extract_graph_equations,
    free_inputs_of,
)
from diffusionsat_torch.sat.solvers import solve
from diffusionsat_torch.train.checkpoint import restore_model_params
from diffusionsat_torch.train.loop import plan_batches


def _completes(eqs, vids, fixed: dict, released: list, budget: int) -> bool:
    """Whether CDCL (within `budget` conflicts) extends the `fixed` bits over
    the `released` vars to an assignment satisfying every equation."""
    enc = encode_residual_cnf(eqs, fixed, released)
    if enc is None:
        return False
    clauses, ncnf, var2cnf = enc
    try:
        sat, model = solve(clauses, ncnf, conflict_budget=budget)
    except TimeoutError:
        return False
    if not sat:
        return False
    bits = dict(fixed)
    for v, c in var2cnf.items():
        bits[v] = 1 if model[c - 1] > 0 else 0
    fb = np.zeros(int(np.max(vids)) + 1, dtype=np.int8)
    for v, b in bits.items():
        fb[v] = b
    return bool((eval_equations(eqs, fb) == 1).all())


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", required=True)
    add_data_args(p, train_size=8000, test_size=256)
    p.add_argument("--test_rounds", type=int, default=64)
    p.add_argument("--feature_maps", type=int, default=128)
    p.add_argument("--max_batches", type=int, default=0)
    p.add_argument("--release_fracs", default="0.05,0.1,0.2,0.35,0.5")
    p.add_argument("--conflict_budget", type=int, default=500_000)
    p.add_argument("--skip_frac_ladder", action="store_true",
                   help="skip the confidence-fraction CDCL ladder (phase 2)")
    p.add_argument("--input_anchor", action="store_true",
                   help="phase 3: fix ONLY the model's predicted free-input "
                        "bits (the circuit's true degrees of freedom, "
                        "<=20 per system), release every derived var, and "
                        "CDCL-propagate; ladder by releasing the "
                        "least-confident inputs")
    p.add_argument("--anchor_release", default="0,2,4,8,all",
                   help="ladder of how many least-confident inputs to "
                        "release in the input-anchor phase")
    p.add_argument("--anchor_budget", type=int, default=100_000,
                   help="CDCL conflict budget per input-anchor attempt "
                        "(the 'all' rung is a solve-from-scratch; keep "
                        "bounded)")
    p.add_argument("--deadline_s", type=float, default=0,
                   help="stop taking new batches after this many seconds "
                        "(partial summary still written)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    dev = resolve_device(args.device)

    test_batches = build_anf_dataset(args).test_data()
    if args.max_batches:
        test_batches = test_batches[:args.max_batches]
    print(f"{len(test_batches)} test batches", flush=True)

    cfg = ANFSATConfig(feature_maps=args.feature_maps,
                       query_maps=args.feature_maps,
                       test_rounds=args.test_rounds)
    params = restore_model_params(args.ckpt, anf_sat_init, cfg, dev)
    # one-time device placement, each batch with its kernel plans
    planned = plan_batches(test_batches, dev)

    @torch.no_grad()
    def predict(batch, plans, generator):
        logits = anf_sat_apply(params, cfg, batch, generator, training=False,
                               plans=plans, device=dev)[0]
        return logits.cpu().numpy()                        # [V, H]

    fracs = [float(x) for x in args.release_fracs.split(",")]
    generator = torch.Generator(device=dev)
    generator.manual_seed(9)

    systems = []        # per-system records
    solved_at: dict[float, int] = {f: 0 for f in fracs}
    n_sys = 0
    t_start = time.time()
    for bi, (batch, (dbatch, plans)) in enumerate(zip(test_batches,
                                                      planned)):
        logits = predict(dbatch, plans, generator)
        head = logits[:, 0]
        pred = (head > 0).astype(np.int8)   # sigmoid>0.5 <=> logit>0
        conf = np.abs(head)
        sols = batch.solutions.numpy()
        var_graph = batch.var_graph.numpy()
        graph_mask = batch.graph_mask.numpy() > 0
        geqs = extract_graph_equations(batch)

        for g in np.where(graph_mask)[0]:
            g = int(g)
            vids = np.where(var_graph == g)[0]
            if len(vids) == 0 or g not in geqs:
                continue
            n_sys += 1
            bits_pred = {int(v): int(pred[v]) for v in vids}
            wrong = vids[pred[vids] != sols[vids]]
            eqs = geqs[g]
            full_bits = np.zeros(int(np.max(vids)) + 1, dtype=np.int8)
            full_bits[vids] = pred[vids]
            eq_ok = eval_equations(eqs, full_bits)
            # confidence cover: ascending-confidence rank of the worst
            # -ranked wrong var, as a fraction of the system's vars
            order = vids[np.argsort(conf[vids])]
            rank_of = {int(v): i for i, v in enumerate(order)}
            cover = (max(rank_of[int(w)] for w in wrong) + 1
                     ) / len(vids) if len(wrong) else 0.0

            rec = {
                "n_vars": int(len(vids)),
                "n_eqs": int(len(eqs)),
                "n_wrong": int(len(wrong)),
                "n_unsat_eqs": int((eq_ok == 0).sum()),
                "confidence_cover_frac": round(float(cover), 4),
                "already_solved": bool((eq_ok == 1).all()),
            }
            # CDCL completion ladder
            # the free message-bit inputs: no equation's max var
            free_inputs = free_inputs_of(eqs, vids)
            rec["n_free_inputs"] = len(free_inputs)
            rec["wrong_free_inputs"] = int(
                sum(1 for v in free_inputs if pred[v] != sols[v]))

            if args.input_anchor and not bool((eq_ok == 1).all()):
                rec["anchor_solved_at"] = None
                anchor_order = sorted(free_inputs, key=lambda v: conf[v])
                for spec in args.anchor_release.split(","):
                    k_rel = len(free_inputs) if spec == "all" else \
                        min(int(spec), len(free_inputs))
                    fixed = {v: int(pred[v]) for v in anchor_order[k_rel:]}
                    released = [v for v in vids if v not in fixed]
                    if _completes(eqs, vids, fixed, released,
                                  args.anchor_budget):
                        rec["anchor_solved_at"] = spec
                        break
            elif args.input_anchor:
                rec["anchor_solved_at"] = "0"

            rec["solved_at_frac"] = None
            if rec["already_solved"]:
                rec["solved_at_frac"] = 0.0
                for f in fracs:
                    solved_at[f] += 1
            elif not args.skip_frac_ladder:
                for f in fracs:
                    k = max(1, int(round(f * len(vids))))
                    released = [int(v) for v in order[:k]]
                    fixed = {v: b for v, b in bits_pred.items()
                             if v not in set(released)}
                    if _completes(eqs, vids, fixed, released,
                                  args.conflict_budget):
                        rec["solved_at_frac"] = f
                        for f2 in fracs:
                            if f2 >= f:
                                solved_at[f2] += 1
                        break
            systems.append(rec)
        print(f"[batch {bi}] systems so far {n_sys}, "
              f"solved@max_frac {solved_at[fracs[-1]]} "
              f"({time.time() - t_start:.0f}s)", flush=True)
        if args.out:  # incremental partial write: a timeout loses nothing
            with open(args.out, "w") as f:
                json.dump({"summary": _summarize(args, systems, solved_at,
                                                 fracs, n_sys, t_start,
                                                 partial=True),
                           "systems": systems}, f)
        if args.deadline_s and time.time() - t_start > args.deadline_s:
            print(f"deadline_s reached after batch {bi}; stopping",
                  flush=True)
            break

    summary = _summarize(args, systems, solved_at, fracs, n_sys, t_start)
    print(json.dumps(summary, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "systems": systems}, f)
    return summary


def _summarize(args, systems, solved_at, fracs, n_sys, t_start,
               partial=False):
    if not systems:
        return {"ckpt": args.ckpt, "n_systems": 0, "partial": partial}
    n = max(n_sys, 1)
    wrongs = np.array([r["n_wrong"] for r in systems])
    covers = np.array([r["confidence_cover_frac"] for r in systems])
    unsat = np.array([r["n_unsat_eqs"] for r in systems])
    summary = {
        "ckpt": args.ckpt,
        "test_rounds": args.test_rounds,
        "n_systems": n_sys,
        "raw_solved": round(float(np.mean([r["already_solved"]
                                           for r in systems])), 4),
        "per_var_accuracy": round(1.0 - float(
            wrongs.sum()) / max(sum(r["n_vars"] for r in systems), 1), 4),
        "wrong_vars_per_system": {
            "mean": round(float(wrongs.mean()), 2),
            "median": float(np.median(wrongs)),
            "p90": float(np.percentile(wrongs, 90)),
        },
        "unsat_eqs_per_system": {
            "mean": round(float(unsat.mean()), 2),
            "median": float(np.median(unsat)),
        },
        "confidence_cover_frac": {
            "mean": round(float(covers.mean()), 4),
            "median": round(float(np.median(covers)), 4),
            "p90": round(float(np.percentile(covers, 90)), 4),
        },
        "cdcl_solved_at_frac": {str(f): round(solved_at[f] / n, 4)
                                for f in fracs},
        "conflict_budget": args.conflict_budget,
        "elapsed_s": round(time.time() - t_start, 1),
    }
    if args.input_anchor:
        ladder = args.anchor_release.split(",")
        anchor = {}
        # cumulative solve rate at each ladder point (a system solved at
        # an earlier spec counts at every later one)
        solved_specs = [r.get("anchor_solved_at") for r in systems]
        for i, spec in enumerate(ladder):
            ok = sum(1 for s in solved_specs
                     if s is not None and s in ladder[:i + 1])
            anchor[spec] = round(ok / n, 4)
        summary["input_anchor_solved_at"] = anchor
        wf = np.array([r["wrong_free_inputs"] for r in systems])
        nf = np.array([max(r["n_free_inputs"], 1) for r in systems])
        summary["free_input_accuracy"] = round(
            1.0 - float(wf.sum()) / float(nf.sum()), 4)
        summary["systems_with_all_inputs_right"] = round(
            float((wf == 0).mean()), 4)
    if partial:
        summary["partial"] = True
    return summary


if __name__ == "__main__":
    main()
