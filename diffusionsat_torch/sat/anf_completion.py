"""ANF -> CNF residual encoding and input-anchored CDCL completion.

A copy of the TPU package's `sat/anf_completion.py` (host code), on the
port's `sat/solvers.solve` (the same native CDCL source).

The production inference path for ANF systems (reference
model/anf_sat.py:230-279 reports raw rounded-prediction solving only):
the round-4 error-structure study (ANF_ERROR_STRUCTURE.json,
ANF_ANCHOR_CPU_SUBSET.json) showed that when the model fails it is
wrong diffusely and confidently (median 113 wrong vars), so
"fix high-confidence vars anywhere" completion is dead — but the
circuit's true degrees of freedom are its <=20 free message-bit inputs,
the model's confidence DOES rank input errors usefully, and fixing only
the predicted inputs + releasing the k least-confident ones before
CDCL-propagating lifts systems-solved from 34% to ~59% at k=8
(vs 100% for unconstrained CDCL: the neural value on this task is the
input prior, not the propagation).

Equation convention (graph/anf_batch.py, losses/anf.py:140-156): each
equation is (parity_const, [term...]) with term ('v', var) linear or
('a', o1, o2) an AND; XOR of terms plus parity_const must equal 0.
"""

from __future__ import annotations

import numpy as np

from diffusionsat_torch.sat.solvers import solve


def extract_graph_equations(batch):
    """Host-side equation lists per graph from an ANFBatch.

    Returns {g: [(parity_const, [term, ...]), ...]} (0-based global var
    indices)."""
    a = lambda t: t.detach().cpu().numpy()  # noqa: E731
    edge_node = a(batch.edge_node_c)
    edge_clause = a(batch.edge_clause_c)
    edge_mask = a(batch.edge_mask_c) > 0
    and1 = a(batch.and1)
    and2 = a(batch.and2)
    clause_graph = a(batch.clause_graph)
    graph_mask = a(batch.graph_mask) > 0
    V = int(batch.var_mask.shape[0])

    eqs_per_clause: dict[int, tuple[int, list]] = {}
    order = np.argsort(edge_clause[edge_mask], kind="stable")
    nodes = edge_node[edge_mask][order]
    clauses = edge_clause[edge_mask][order]
    uniq, starts = np.unique(clauses, return_index=True)
    for i, c in enumerate(uniq):
        lo = starts[i]
        hi = starts[i + 1] if i + 1 < len(uniq) else len(clauses)
        parity = 0
        terms = []
        for nid in nodes[lo:hi]:
            nid = int(nid)
            if nid == 0:                      # const-one node: bit 1
                parity ^= 1
            elif nid <= V:                    # variable node
                terms.append(("v", nid - 1))
            else:                             # AND node
                a = int(and1[nid - 1 - V])
                b = int(and2[nid - 1 - V])
                # operand 0 = const one (bit 1): AND(1, x) = x
                if a == 0 and b == 0:
                    parity ^= 1
                elif a == 0:
                    terms.append(("v", b - 1))
                elif b == 0:
                    terms.append(("v", a - 1))
                else:
                    terms.append(("a", a - 1, b - 1))
        eqs_per_clause[int(c)] = (parity, terms)

    out: dict[int, list] = {}
    for g in np.where(graph_mask)[0]:
        cs = np.where(clause_graph == g)[0]
        out[int(g)] = [eqs_per_clause[int(c)] for c in cs
                       if int(c) in eqs_per_clause]
    return out


def eval_equations(eqs, bits):
    """Vector of 0/1 satisfaction per equation under a full assignment."""
    ok = []
    for parity, terms in eqs:
        v = parity
        for t in terms:
            if t[0] == "v":
                v ^= int(bits[t[1]])
            else:
                v ^= int(bits[t[1]]) & int(bits[t[2]])
        ok.append(1 - v)
    return np.array(ok, dtype=np.int8)


def encode_residual_cnf(eqs, fixed_bits: dict[int, int],
                        released: list[int]):
    """CNF of the system with `fixed_bits` substituted; released vars map
    to CNF ids 1..len(released). AND terms -> Tseitin aux, XOR chains ->
    4 clauses per 3-ary gate; duplicate literals cancel mod 2. Returns
    (clauses, n_cnf_vars, var2cnf) or None if a fully-substituted
    equation is already violated."""
    var2cnf = {v: i + 1 for i, v in enumerate(released)}
    n = len(released)
    clauses: list[list[int]] = []
    and_cache: dict[tuple[int, int], int] = {}

    def and_aux(x: int, y: int) -> int:
        nonlocal n
        key = (min(x, y), max(x, y))
        if key in and_cache:
            return and_cache[key]
        n += 1
        t = n
        clauses.append([-t, x])
        clauses.append([-t, y])
        clauses.append([t, -x, -y])
        and_cache[key] = t
        return t

    def xor_gate(x: int, y: int) -> int:
        nonlocal n
        n += 1
        z = n
        clauses.append([-z, x, y])
        clauses.append([-z, -x, -y])
        clauses.append([z, x, -y])
        clauses.append([z, -x, y])
        return z

    for parity, terms in eqs:
        p = parity
        lit_count: dict[int, int] = {}
        for t in terms:
            if t[0] == "v":
                v = t[1]
                if v in fixed_bits:
                    p ^= fixed_bits[v]
                else:
                    c = var2cnf[v]
                    lit_count[c] = lit_count.get(c, 0) + 1
            else:
                a, b = t[1], t[2]
                fa, fb = fixed_bits.get(a), fixed_bits.get(b)
                if fa is not None and fb is not None:
                    p ^= fa & fb
                elif fa is not None:
                    if fa == 1:
                        c = var2cnf[b]
                        lit_count[c] = lit_count.get(c, 0) + 1
                elif fb is not None:
                    if fb == 1:
                        c = var2cnf[a]
                        lit_count[c] = lit_count.get(c, 0) + 1
                else:
                    c = and_aux(var2cnf[a], var2cnf[b])
                    lit_count[c] = lit_count.get(c, 0) + 1
        lits = [c for c, k in lit_count.items() if k % 2]
        if not lits:
            if p == 1:
                return None
            continue
        if len(lits) == 1:
            clauses.append([lits[0] if p else -lits[0]])
            continue
        z = lits[0]
        for li in lits[1:]:
            z = xor_gate(z, li)
        clauses.append([z] if p else [-z])
    return clauses, n, var2cnf


def free_inputs_of(eqs, vids):
    """Free message-bit inputs of a feed-forward ANF circuit: the SHA
    circuit only references earlier vars, so every equation's max var id
    is the gate output it defines (output-fix equations constrain gate
    outputs too); free inputs are the vars that are no equation's max."""
    defined = set()
    for parity, terms in eqs:
        vs = [t[1] for t in terms if t[0] == "v"] + \
             [x for t in terms if t[0] == "a" for x in (t[1], t[2])]
        if vs:
            defined.add(max(vs))
    return [int(v) for v in vids if int(v) not in defined]


def input_anchored_complete(eqs, vids, pred_bits, conf,
                            ladder=(0, 2, 4, 8),
                            conflict_budget: int = 100_000):
    """Fix the predicted free-input bits, release everything else, and
    CDCL-propagate; ladder over releasing the least-confident inputs.

    pred_bits/conf: arrays indexed by global var id. Returns
    (solved: bool, spec: int | None, bits: dict | None)."""
    free = free_inputs_of(eqs, vids)
    anchor_order = sorted(free, key=lambda v: conf[v])
    for k_rel in ladder:
        k = min(int(k_rel), len(free))
        fixed = {v: int(pred_bits[v]) for v in anchor_order[k:]}
        released = [int(v) for v in vids if int(v) not in fixed]
        enc = encode_residual_cnf(eqs, fixed, released)
        if enc is None:
            continue
        clauses, ncnf, var2cnf = enc
        try:
            sat, model = solve(clauses, ncnf,
                               conflict_budget=conflict_budget)
        except TimeoutError:
            continue
        if not sat:
            continue
        bits = dict(fixed)
        for v, c in var2cnf.items():
            bits[v] = 1 if model[c - 1] > 0 else 0
        fb = np.zeros(int(np.max(vids)) + 1, dtype=np.int8)
        for v, b in bits.items():
            fb[v] = b
        if (eval_equations(eqs, fb) == 1).all():
            return True, int(k), bits
    return False, None, None
