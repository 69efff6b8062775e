"""SHA-1 preimage problems as ANF (XOR of AND-pairs) equation systems.

Copied from `diffusionsat_torch/data/sha_anf.py` (commit ca3446b), itself
a copy of the TPU package's generator: pure Python on `random.Random`.
Each gate output of an r-round SHA-1 with `free_bits` unknown message bits
becomes a fresh variable with a degree-<=2 defining equation over GF(2);
every equation XORs to 0 and the generating message is the witness, so
each system is satisfiable. A Bit is (var, flip): the GF(2) value
var + flip, with var=None for constants.
"""

from __future__ import annotations

import random

Term = tuple
Bit = tuple  # (var: int | None, flip: int)

CONST0: Bit = (None, 0)
CONST1: Bit = (None, 1)


class AnfCircuit:
    def __init__(self):
        self.n_vars = 0
        self.equations: list[list[Term]] = []
        self.values: dict[int, int] = {}

    def fresh(self, value: int) -> int:
        self.n_vars += 1
        self.values[self.n_vars] = int(value)
        return self.n_vars

    def bit_value(self, b: Bit) -> int:
        var, flip = b
        if var is None:
            return flip
        return self.values[var] ^ flip

    # -- equation assembly ------------------------------------------------
    def _emit(self, out_var: int, lin: dict[int, int], quad: dict[tuple, int],
              const: int) -> None:
        """Add equation out ^ (lin + quad + const) = 0."""
        terms: list[Term] = [(out_var,)]
        for v, cnt in lin.items():
            if cnt % 2:
                terms.append((v,))
        for (a, b), cnt in quad.items():
            if cnt % 2:
                terms.append((a, b))
        if const % 2:
            terms.append(())
        self.equations.append(terms)

    @staticmethod
    def _add_lin(lin: dict, v: int, times: int = 1):
        lin[v] = lin.get(v, 0) + times

    @staticmethod
    def _add_quad(quad: dict, a: int, b: int, times: int = 1):
        key = (min(a, b), max(a, b))
        quad[key] = quad.get(key, 0) + times

    def _product_terms(self, a: Bit, b: Bit, lin: dict, quad: dict
                       ) -> int:
        """Accumulate (va+fa)(vb+fb) into lin/quad; returns constant part."""
        va, fa = a
        vb, fb = b
        if va is None and vb is None:
            return fa & fb
        if va is None:
            if fa:
                self._add_lin(lin, vb)
                return fb
            return 0
        if vb is None:
            if fb:
                self._add_lin(lin, va)
                return fa
            return 0
        if va == vb:
            # (x+fa)(x+fb) = x^2 + (fa+fb)x + fafb = (1+fa+fb)x + fafb
            self._add_lin(lin, va, 1 + fa + fb)
            return fa & fb
        self._add_quad(quad, va, vb)
        if fb:
            self._add_lin(lin, va)
        if fa:
            self._add_lin(lin, vb)
        return fa & fb

    # -- gates ------------------------------------------------------------
    def NOT(self, a: Bit) -> Bit:
        return (a[0], a[1] ^ 1)

    def XOR(self, *bits: Bit) -> Bit:
        """Linear: no new variable needed unless requested; fold into a
        fresh var with a linear equation (keeps downstream gates simple)."""
        lin: dict[int, int] = {}
        const = 0
        for var, flip in bits:
            const ^= flip
            if var is not None:
                self._add_lin(lin, var)
        live = [v for v, c in lin.items() if c % 2]
        if not live:
            return (None, const)
        if len(live) == 1 and const == 0:
            return (live[0], 0)
        if len(live) == 1:
            return (live[0], const)
        value = const
        for v in live:
            value ^= self.values[v]
        z = self.fresh(value)
        self._emit(z, {v: 1 for v in live}, {}, const)
        return (z, 0)

    def AND(self, a: Bit, b: Bit) -> Bit:
        if a[0] is None:
            return b if a[1] else CONST0
        if b[0] is None:
            return a if b[1] else CONST0
        lin: dict[int, int] = {}
        quad: dict[tuple, int] = {}
        const = self._product_terms(a, b, lin, quad)
        value = self.bit_value(a) & self.bit_value(b)
        z = self.fresh(value)
        self._emit(z, lin, quad, const)
        return (z, 0)

    def MAJ(self, a: Bit, b: Bit, c: Bit) -> Bit:
        consts = [x for x in (a, b, c) if x[0] is None]
        if consts:
            # reduce with one constant: maj(1,b,c)=OR(b,c), maj(0,b,c)=AND
            const = consts[0]
            rest = [x for x in (a, b, c) if x is not const]
            if const[1]:
                return self.OR(rest[0], rest[1])
            return self.AND(rest[0], rest[1])
        lin: dict[int, int] = {}
        quad: dict[tuple, int] = {}
        const_acc = 0
        const_acc ^= self._product_terms(a, b, lin, quad)
        const_acc ^= self._product_terms(a, c, lin, quad)
        const_acc ^= self._product_terms(b, c, lin, quad)
        va, vb, vc = self.bit_value(a), self.bit_value(b), self.bit_value(c)
        z = self.fresh(int(va + vb + vc >= 2))
        self._emit(z, lin, quad, const_acc)
        return (z, 0)

    def OR(self, a: Bit, b: Bit) -> Bit:
        # a or b = a ^ b ^ ab
        if a[0] is None:
            return CONST1 if a[1] else b
        if b[0] is None:
            return CONST1 if b[1] else a
        lin: dict[int, int] = {}
        quad: dict[tuple, int] = {}
        const = self._product_terms(a, b, lin, quad)
        self._add_lin(lin, a[0])
        self._add_lin(lin, b[0])
        const ^= a[1] ^ b[1]
        value = self.bit_value(a) | self.bit_value(b)
        z = self.fresh(value)
        self._emit(z, lin, quad, const)
        return (z, 0)

    def CH(self, a: Bit, b: Bit, c: Bit) -> Bit:
        # ch = ab ^ c ^ ac
        if a[0] is None:
            return b if a[1] else c
        lin: dict[int, int] = {}
        quad: dict[tuple, int] = {}
        const = self._product_terms(a, b, lin, quad)
        const ^= self._product_terms(a, c, lin, quad)
        vc, fc = c
        if vc is not None:
            self._add_lin(lin, vc)
        const ^= fc
        va_, vb_, vc_ = (self.bit_value(a), self.bit_value(b),
                         self.bit_value(c))
        z = self.fresh(vb_ if va_ else vc_)
        self._emit(z, lin, quad, const)
        return (z, 0)

    def fix(self, b: Bit, value: int) -> None:
        """Assert bit == constant: equation b ^ value ^ ... = 0."""
        var, flip = b
        want = value ^ flip
        if var is None:
            if flip != value:
                raise ValueError("constant contradiction")
            return
        terms: list[Term] = [(var,)]
        if want:
            terms.append(())
        self.equations.append(terms)

    def add32(self, a: list[Bit], b: list[Bit]) -> list[Bit]:
        out = []
        carry: Bit = CONST0
        for i in range(32):
            out.append(self.XOR(a[i], b[i], carry))
            carry = self.MAJ(a[i], b[i], carry)
        return out

    @staticmethod
    def rotl(w: list[Bit], n: int) -> list[Bit]:
        return [w[(i - n) % 32] for i in range(32)]


def _const_word(value: int) -> list[Bit]:
    return [(None, (value >> i) & 1) for i in range(32)]


def sha1_anf(rounds: int = 6, free_bits: int = 8, seed: int = 0
             ) -> tuple[int, list[list[Term]], list[int]]:
    """r-round SHA-1 preimage as a degree-2 ANF system with witness."""
    rng = random.Random(seed)
    c = AnfCircuit()

    message = [rng.randint(0, 1) for _ in range(512)]
    free_idx = set(rng.sample(range(512), min(free_bits, 512)))
    msg: list[Bit] = []
    for i in range(512):
        if i in free_idx:
            msg.append((c.fresh(message[i]), 0))
        else:
            msg.append((None, message[i]))

    W = [msg[t * 32:(t + 1) * 32] for t in range(16)]
    for t in range(16, min(80, rounds)):
        x = [c.XOR(W[t - 3][i], W[t - 8][i], W[t - 14][i], W[t - 16][i])
             for i in range(32)]
        W.append(AnfCircuit.rotl(x, 1))

    h = [0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0]
    a, b, bb, d, e = (_const_word(h[0]), _const_word(h[1]),
                      _const_word(h[2]), _const_word(h[3]),
                      _const_word(h[4]))
    K = [0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xCA62C1D6]
    for t in range(rounds):
        if t < 20:
            f = [c.CH(b[i], bb[i], d[i]) for i in range(32)]
        elif t < 40 or t >= 60:
            f = [c.XOR(b[i], bb[i], d[i]) for i in range(32)]
        else:
            f = [c.MAJ(b[i], bb[i], d[i]) for i in range(32)]
        tmp = c.add32(AnfCircuit.rotl(a, 5), f)
        tmp = c.add32(tmp, e)
        tmp = c.add32(tmp, _const_word(K[t // 20]))
        tmp = c.add32(tmp, W[t] if t < len(W) else _const_word(0))
        e, d, bb, b, a = d, bb, AnfCircuit.rotl(b, 30), a, tmp

    for bit in a + b + bb + d + e:
        c.fix(bit, c.bit_value(bit))

    witness = [c.values[v] for v in range(1, c.n_vars + 1)]
    return c.n_vars, c.equations, witness
