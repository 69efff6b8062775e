"""SHA-1 preimage problems as CNF, self-contained.

A copy of the TPU package's `data/sha.py` (pure Python on `random.Random`,
so both packages generate the same formulas and witnesses from the same
seeds). It replaces the reference's cgen binary pipeline with a Tseitin
circuit encoder for r rounds of the SHA-1 compression function with n free
message bits. Fixed message bits are constant-folded (like cgen's
assignments), so small-n instances stay compact. Every instance carries
its witness (the generating message's full variable assignment), so these
are guaranteed SAT and directly usable as supervised/diffusion training
data.

Bit representation (CNF): Python bool = constant; signed int = literal.
"""

from __future__ import annotations

import random
from typing import Iterator

from diffusionsat_torch.data.generators import SatInstances

Bit = object  # bool | int literal


class CnfCircuit:
    """Clause builder with constant folding and witness tracking."""

    def __init__(self):
        self.n_vars = 0
        self.clauses: list[list[int]] = []
        self.values: dict[int, int] = {}  # var -> 0/1 under the witness

    def fresh(self, value: int) -> int:
        self.n_vars += 1
        self.values[self.n_vars] = int(value)
        return self.n_vars

    def lit_value(self, b: Bit) -> int:
        if isinstance(b, bool):
            return int(b)
        v = self.values[abs(b)]
        return v if b > 0 else 1 - v

    def const_or_lit(self, b: Bit):
        return b

    # -- gates ------------------------------------------------------------
    def NOT(self, a: Bit) -> Bit:
        if isinstance(a, bool):
            return not a
        return -a

    def XOR(self, a: Bit, b: Bit) -> Bit:
        if isinstance(a, bool):
            return self.NOT(b) if a else b
        if isinstance(b, bool):
            return self.NOT(a) if b else a
        z = self.fresh(self.lit_value(a) ^ self.lit_value(b))
        self.clauses += [[-a, -b, -z], [a, b, -z], [a, -b, z], [-a, b, z]]
        return z

    def XOR3(self, a: Bit, b: Bit, c: Bit) -> Bit:
        return self.XOR(self.XOR(a, b), c)

    def AND(self, a: Bit, b: Bit) -> Bit:
        if isinstance(a, bool):
            return b if a else False
        if isinstance(b, bool):
            return a if b else False
        z = self.fresh(self.lit_value(a) & self.lit_value(b))
        self.clauses += [[-z, a], [-z, b], [z, -a, -b]]
        return z

    def OR(self, a: Bit, b: Bit) -> Bit:
        return self.NOT(self.AND(self.NOT(a), self.NOT(b)))

    def MAJ(self, a: Bit, b: Bit, c: Bit) -> Bit:
        if isinstance(a, bool):
            return self.OR(b, c) if a else self.AND(b, c)
        if isinstance(b, bool):
            return self.OR(a, c) if b else self.AND(a, c)
        if isinstance(c, bool):
            return self.OR(a, b) if c else self.AND(a, b)
        val = (self.lit_value(a) + self.lit_value(b) + self.lit_value(c)) >= 2
        z = self.fresh(int(val))
        self.clauses += [[-z, a, b], [-z, a, c], [-z, b, c],
                         [z, -a, -b], [z, -a, -c], [z, -b, -c]]
        return z

    def CH(self, a: Bit, b: Bit, c: Bit) -> Bit:
        """a ? b : c."""
        if isinstance(a, bool):
            return b if a else c
        if isinstance(b, bool) and isinstance(c, bool):
            if b == c:
                return b
            return a if b else self.NOT(a)
        if b is c:
            return b
        val = self.lit_value(b) if self.lit_value(a) else self.lit_value(c)
        z = self.fresh(int(val))
        bb = [b] if not isinstance(b, bool) else []
        cc = [c] if not isinstance(c, bool) else []
        # z <-> (a -> b) & (~a -> c)
        if isinstance(b, bool):
            if b:
                self.clauses += [[-a, z]]
            else:
                self.clauses += [[-a, -z]]
        else:
            self.clauses += [[-a, -b, z], [-a, b, -z]]
        if isinstance(c, bool):
            if c:
                self.clauses += [[a, z]]
            else:
                self.clauses += [[a, -z]]
        else:
            self.clauses += [[a, -c, z], [a, c, -z]]
        return z

    def fix(self, b: Bit, value: int) -> None:
        """Assert a bit equals a constant (unit clause)."""
        if isinstance(b, bool):
            if int(b) != value:
                raise ValueError("constant contradiction")
            return
        self.clauses.append([b if value else -b])

    # -- 32-bit words -----------------------------------------------------
    def add32(self, a: list[Bit], b: list[Bit]) -> list[Bit]:
        """Ripple-carry adder, LSB-first word bit lists."""
        out = []
        carry: Bit = False
        for i in range(32):
            s = self.XOR3(a[i], b[i], carry)
            carry = self.MAJ(a[i], b[i], carry)
            out.append(s)
        return out

    @staticmethod
    def rotl(w: list[Bit], n: int) -> list[Bit]:
        """Rotate left on LSB-first lists: bit i of result = bit (i-n) mod 32."""
        return [w[(i - n) % 32] for i in range(32)]


def _const_word(c: CnfCircuit, value: int) -> list[Bit]:
    return [bool((value >> i) & 1) for i in range(32)]


def sha1_cnf(rounds: int = 8, free_bits: int = 8, seed: int = 0,
             hash_bits_fixed: int | None = None
             ) -> tuple[int, list[list[int]], list[int]]:
    """Encode an r-round SHA-1 preimage problem.

    A random 512-bit message is drawn; `free_bits` of its bits become CNF
    variables, the rest are folded constants. The compression function runs
    `rounds` rounds; `hash_bits_fixed` output bits (default: all 160) are
    pinned to the true hash of the message — so the instance is SAT with
    the original message as witness. Returns (n_vars, clauses, witness
    bits for all variables).
    """
    rng = random.Random(seed)
    c = CnfCircuit()

    message = [rng.randint(0, 1) for _ in range(512)]
    free_idx = set(rng.sample(range(512), min(free_bits, 512)))
    msg_bits: list[Bit] = []
    for i in range(512):
        if i in free_idx:
            msg_bits.append(c.fresh(message[i]))
        else:
            msg_bits.append(bool(message[i]))

    # message schedule (LSB-first words)
    W = [msg_bits[t * 32:(t + 1) * 32] for t in range(16)]
    for t in range(16, min(80, rounds)):
        x = [c.XOR(c.XOR(W[t - 3][i], W[t - 8][i]),
                   c.XOR(W[t - 14][i], W[t - 16][i])) for i in range(32)]
        W.append(CnfCircuit.rotl(x, 1))

    h = [0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0]
    a, b, bb, d, e = (_const_word(c, h[0]), _const_word(c, h[1]),
                      _const_word(c, h[2]), _const_word(c, h[3]),
                      _const_word(c, h[4]))
    K = [0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xCA62C1D6]

    for t in range(rounds):
        if t < 20:
            f = [c.CH(b[i], bb[i], d[i]) for i in range(32)]
        elif t < 40 or t >= 60:
            f = [c.XOR3(b[i], bb[i], d[i]) for i in range(32)]
        else:
            f = [c.MAJ(b[i], bb[i], d[i]) for i in range(32)]
        tmp = c.add32(CnfCircuit.rotl(a, 5), f)
        tmp = c.add32(tmp, e)
        tmp = c.add32(tmp, _const_word(c, K[t // 20]))
        tmp = c.add32(tmp, W[t] if t < len(W) else _const_word(c, 0))
        e = d
        d = bb
        bb = CnfCircuit.rotl(b, 30)
        b = a
        a = tmp

    out_bits = a + b + bb + d + e
    n_fix = len(out_bits) if hash_bits_fixed is None else hash_bits_fixed
    for bit in out_bits[:n_fix]:
        c.fix(bit, c.lit_value(bit))

    witness = [c.values[v] for v in range(1, c.n_vars + 1)]
    return c.n_vars, c.clauses, witness


class Sha1Instances(SatInstances):
    """SAT-instance stream of r-round SHA-1 preimages
    (reference `data/SHAGen2019.py:21-186` semantics: n free message bits,
    r rounds, guaranteed-SAT, witness attached)."""

    def __init__(self, rounds: int = 8, min_free_bits: int = 4,
                 max_free_bits: int = 12, train_size: int = 10_000,
                 test_size: int = 1_000, seed: int = 0):
        self.rounds = rounds
        self.min_free_bits = min_free_bits
        self.max_free_bits = max_free_bits
        self.train_size = train_size
        self.test_size = test_size
        self.seed = seed

    # `split` is the base class's None: one stream. (The TPU package's
    # class has no `split` at all, so a dataset of it that would generate
    # in several processes fails there.)

    def train_generator(self):
        return self._generator(self.train_size, self.seed)

    def test_generator(self):
        return self._generator(self.test_size, self.seed + 1_000_003)

    def _generator(self, size: int, seed: int) -> Iterator:
        rng = random.Random(seed)
        for i in range(size):
            n_free = rng.randint(self.min_free_bits, self.max_free_bits)
            n_vars, clauses, witness = sha1_cnf(
                rounds=self.rounds, free_bits=n_free, seed=seed + i)
            yield n_vars, clauses, witness
