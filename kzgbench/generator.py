"""The one traffic generator: it reads a mix's parameters
(``traffic/<mix>.json``) and a configuration, and makes every call of a
run from ``--seed`` before the window opens.

Mixes name an ``api``:

* ``verify_blob_kzg_proof_batch``: calls of ``blobs_per_call`` lanes, each
  lane a (blob, commitment, proof) triple of the pool (:mod:`.pool`),
  drawn with the lane order from the seed.  One call in ``fault_every``
  (the seed sets the phase) carries one fault in one lane, the kinds of
  ``fault_kinds`` in turn.
* ``blob_tx``: transactions of ``blobs_per_call`` blobs, each blob
  committed (``blob_to_kzg_commitment``) and then proved
  (``compute_blob_kzg_proof``); blobs are random canonical field elements
  with the top byte zeroed.

Every call's lanes are bytes objects of their own, in a ring of distinct
calls whose bytes total ``ring_llc_multiple`` times the host's last-level
cache and at least ``ring_min_bytes``, so that a window reads its inputs
from DRAM as a node reading distinct blobs does; the window cycles the
ring.

What a call is expected to give by construction (``Call.expect``): True
for a valid verification, False for a wrong proof or a changed blob, and
the error kind for an input the specs refuse.  The reference
(:mod:`.reference.kzg`) recomputes a sample of calls besides.
"""

from __future__ import annotations

import glob
import math
import re
from dataclasses import dataclass, field

import numpy as np

from .reference import curve
from .reference.field import P, R, fp_sqrt

VERIFY_APIS = ("verify_blob_kzg_proof_batch",)
FAULT_KINDS = ("wrong_proof", "blob_byte", "non_canonical", "bad_encoding", "off_subgroup")
EXPECT = {
    None: True,
    "wrong_proof": False,
    "blob_byte": False,
    "non_canonical": "non_canonical",
    "bad_encoding": "invalid_g1",
    "off_subgroup": "not_in_subgroup",
}
# Streams of the seed, one a use, so that a change to one leaves the others.
_LANES, _BLOBS, _FAULTS, _PHASE, _SAMPLE, _VERIFY = 1, 2, 3, 4, 5, 6


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([seed & (2**64 - 1), *stream])


def random_blob(gen: np.random.Generator, fe: int) -> bytes:
    """fe random field elements, 32 big-endian bytes each, the top byte
    zero (below 2^248 < r)."""
    a = np.frombuffer(gen.bytes(32 * fe), dtype=np.uint8).reshape(fe, 32).copy()
    a[:, 0] = 0
    return a.tobytes()


def own(b: bytes) -> bytes:
    """A new bytes object with b's content (``bytes(b)`` would return b)."""
    return bytes(memoryview(b))


def last_level_cache_bytes() -> int:
    """The host's largest CPU cache: the largest of sysfs's cache sizes and
    /proc/cpuinfo's "cache size" (a VM may give only one of them), or an
    assumed 128 MiB where neither is read."""
    sizes = []
    for path in glob.glob("/sys/devices/system/cpu/cpu0/cache/index*/size"):
        try:
            with open(path) as fh:
                sizes.append(fh.read().strip())
        except OSError:
            continue
    try:
        with open("/proc/cpuinfo") as fh:
            sizes += [line.split(":", 1)[1].strip() for line in fh if line.startswith("cache size")][:1]
    except OSError:
        pass
    best = 0
    for text in sizes:
        m = re.fullmatch(r"(\d+)\s*([KMG]?)B?", text, re.IGNORECASE)
        if m:
            best = max(best, int(m[1]) << {"": 0, "K": 10, "M": 20, "G": 30}[m[2].upper()])
    return best or 128 << 20


def ring_bytes(mix: dict, llc_bytes: int) -> int:
    """The ring's least size: ``ring_llc_multiple`` times the cache read,
    and at least ``ring_min_bytes`` (a host may report a cache smaller
    than it has, and one size on every host keeps the work the same)."""
    return max(int(mix.get("ring_min_bytes", 0)), int(float(mix["ring_llc_multiple"]) * llc_bytes))


@dataclass
class Call:
    """One call of the window: ``args`` for the API (blob, commitment and
    proof lists; or the transaction's blobs), the blobs it carries, what it
    must give by construction (None where only the reference knows), and
    for a verification the pool index of each lane and its fault."""

    args: tuple
    blobs: int
    expect: object = None
    lanes: list = field(default_factory=list)
    fault: dict | None = None


class VerifyTraffic:
    def __init__(self, mix: dict, config: dict, seed: int, pool: list, llc_bytes: int):
        self.n = int(mix["blobs_per_call"])
        self.fe = int(config["FIELD_ELEMENTS_PER_BLOB"])
        self.pool = pool
        self.seed = seed
        self.every = int(mix["fault_every"])
        self.kinds = tuple(mix["fault_kinds"])
        for kind in self.kinds:
            if kind not in FAULT_KINDS:
                raise ValueError(f"fault kind {kind!r}: expected one of {FAULT_KINDS}")
        phase = rng(seed, _PHASE)
        self.phase = int(phase.integers(self.every))
        self.kind_phase = int(phase.integers(len(self.kinds)))
        call_bytes = self.n * (32 * self.fe + 96)
        self.ring_len = max(2, math.ceil(ring_bytes(mix, llc_bytes) / call_bytes))
        self.ring_bytes = self.ring_len * call_bytes
        self.ring = []
        for i in range(self.ring_len):
            idx = [int(x) for x in rng(seed, _LANES, i).integers(len(pool), size=self.n)]
            lanes = [tuple(own(b) for b in pool[j]) for j in idx]
            self.ring.append((idx, [t[0] for t in lanes], [t[1] for t in lanes], [t[2] for t in lanes]))
        self._faults: dict[int, dict] = {}
        for j in range(math.ceil(int(mix.get("prebuilt_calls", 0)) / self.every)):
            self.fault(j)

    def is_faulty(self, k: int) -> bool:
        return bool(self.kinds) and k % self.every == self.phase

    def fault(self, j: int) -> dict:
        """The j-th faulty call's fault: its kind, lane, the field replaced
        and the bytes put there."""
        got = self._faults.get(j)
        if got is None:
            got = self._faults[j] = make_fault(self, j)
        return got

    def call(self, k: int) -> Call:
        idx, blobs, comms, proofs = self.ring[k % self.ring_len]
        if not self.is_faulty(k):
            return Call((blobs, comms, proofs), self.n, True, idx)
        f = self.fault(k // self.every)
        blobs, comms, proofs = list(blobs), list(comms), list(proofs)
        {"blob": blobs, "commitment": comms, "proof": proofs}[f["field"]][f["lane"]] = f["bytes"]
        return Call((blobs, comms, proofs), self.n, EXPECT[f["kind"]], idx, f)

    def warmup(self, count: int) -> list[Call]:
        """Valid calls of the ring's shapes (a faulty call runs the same
        kernels, and is refused after them)."""
        return [Call(tuple(self.ring[i % self.ring_len][1:]), self.n, True) for i in range(count)]

    def sample(self, calls: list, count: int) -> list[int]:
        """The calls the reference checks: every faulty call of the window
        and ``count`` valid ones drawn from the seed (``"all"``: every one)."""
        faulty = [k for k, c in enumerate(calls) if c.fault is not None]
        valid = [k for k, c in enumerate(calls) if c.fault is None]
        if count == "all":
            return sorted(faulty + valid)
        pick = rng(self.seed, _SAMPLE).permutation(len(valid))[:count]
        return sorted(faulty + [valid[i] for i in pick])


def _off_curve_x(gen: np.random.Generator) -> int:
    while True:
        x = int.from_bytes(gen.bytes(48), "big") % P
        if fp_sqrt((x * x * x + 4) % P) is None:
            return x


def _off_subgroup_point(gen: np.random.Generator) -> bytes:
    while True:
        x = int.from_bytes(gen.bytes(48), "big") % P
        y = fp_sqrt((x * x * x + 4) % P)
        if y is not None and not curve.g1_in_subgroup((x, y)):
            return curve.g1_compress((x, y))


def make_fault(t: VerifyTraffic, j: int) -> dict:
    kind = t.kinds[(j + t.kind_phase) % len(t.kinds)]
    gen = rng(t.seed, _FAULTS, j)
    k = j * t.every + t.phase
    idx = t.ring[k % t.ring_len][0]
    lane = int(gen.integers(t.n))
    own_blob, own_comm, own_proof = t.pool[idx[lane]]
    point_field = "commitment" if gen.integers(2) == 0 else "proof"
    if kind == "wrong_proof":
        other = (idx[lane] + 1 + int(gen.integers(len(t.pool) - 1))) % len(t.pool)
        new, fld = own(t.pool[other][2]), "proof"
        if new == own_proof:
            raise ValueError("the pool holds one proof twice")
    elif kind in ("blob_byte", "non_canonical"):
        a = bytearray(own_blob)
        e = int(gen.integers(t.fe))
        if kind == "blob_byte":
            # any byte but the element's top one, which stays zero: the
            # element stays below r
            a[32 * e + 1 + int(gen.integers(31))] ^= 1 + int(gen.integers(255))
        else:
            a[32 * e : 32 * e + 32] = (R + int(gen.integers(1 << 32))).to_bytes(32, "big")
        new, fld = bytes(a), "blob"
    elif kind == "bad_encoding":
        src = own_comm if point_field == "commitment" else own_proof
        if gen.integers(2) == 0:  # the compression flag cleared
            new = bytes([src[0] & 0x7F]) + src[1:]
        else:  # an x with no point on the curve
            enc = bytearray(_off_curve_x(gen).to_bytes(48, "big"))
            enc[0] |= 0x80
            new = bytes(enc)
        fld = point_field
    else:  # off_subgroup
        new, fld = _off_subgroup_point(gen), point_field
    return {"kind": kind, "lane": lane, "field": fld, "bytes": new}


class TxTraffic:
    def __init__(self, mix: dict, config: dict, seed: int, llc_bytes: int):
        self.n = int(mix["blobs_per_call"])
        self.fe = int(config["FIELD_ELEMENTS_PER_BLOB"])
        self.seed = seed
        bpb = 32 * self.fe
        self.ring_len = max(2 * self.n, math.ceil(ring_bytes(mix, llc_bytes) / bpb))
        self.ring_bytes = self.ring_len * bpb
        self.ring = [self.blob(i) for i in range(self.ring_len)]

    def blob(self, i: int) -> bytes:
        return random_blob(rng(self.seed, _BLOBS, i), self.fe)

    def call(self, k: int) -> Call:
        blobs = [self.ring[(k * self.n + j) % self.ring_len] for j in range(self.n)]
        return Call((blobs,), self.n)

    def warmup(self, count: int) -> list[Call]:
        return [self.call(k) for k in range(count)]

    def sample(self, calls: list, count: int, stream: int = _SAMPLE) -> list[tuple[int, int]]:
        """(call, blob) pairs the reference proves again, drawn from the seed."""
        pairs = [(k, j) for k, c in enumerate(calls) for j in range(c.blobs)]
        pick = rng(self.seed, stream).permutation(len(pairs))[:count]
        return sorted(pairs[i] for i in pick)

    def verify_sample(self, calls: list, count: int) -> list[tuple[int, int]]:
        """(call, blob) pairs whose outputs the reference verifies, drawn
        from the seed apart from :meth:`sample`."""
        return self.sample(calls, count, _VERIFY)


def traffic(mix: dict, config: dict, seed: int, pool, llc_bytes: int):
    if mix["api"] in VERIFY_APIS:
        return VerifyTraffic(mix, config, seed, pool, llc_bytes)
    if mix["api"] == "blob_tx":
        return TxTraffic(mix, config, seed, llc_bytes)
    raise ValueError(f"traffic api {mix['api']!r}: expected one of {VERIFY_APIS + ('blob_tx',)}")
