"""ctypes loader and Python wrappers for the native C++ host engine.

The engine, ``native/kzg_native.cpp`` at the root of the repository (shared
with the JAX package), is the host-side counterpart of blst (reference: the
C+asm blst crate behind every ``unsafe`` block in src/utils.rs): point
(de)serialization, subgroup checks, single scalar multiplications, the
pairing check, batched barycentric evaluation, and the fused contexts that
run a whole batch verification or prover call in one GIL-free native call.
Everything here returns the same bits as the pure-Python golden model,
which stays the oracle and the fallback (``available()`` is False when no
engine loads).

The source is compiled with ``g++ -O3 -march=native`` at the first use in a
process into the port's build directory (``kzg_rust_tpu_torch/build/``, or
``KZG_TORCH_BUILD_DIR``), as ``libkzg_native-<hash>.so``, the hash taken
over the source, the compiler flags and this CPU's feature flags: a library
built for one CPU is never loaded on another.  ``KZG_TORCH_NATIVE=0``
forces the golden model.  :func:`require` builds and loads the engine or
raises with the reason; ``TorchBackend`` calls it on a CUDA device, so a
card run never falls back to the golden model unasked.

Point convention matches the golden model: affine int tuples, ``None`` for
infinity; G2 coordinates are Fp2 pairs.  The boundary serializes to
canonical big-endian bytes (48 B/Fp, 32 B/Fr).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time

from ..errors import BadArgs
from ..messages import (
    G2_UNCOMPRESS_RC_ERRORS,
    MSG_EXPECT_48,
    MSG_G2_EXPECT_96,
    MSG_INVALID_BYTES32,
    PROVER_RC_ERRORS,
    VERIFY_RC_ERRORS,
)
from ..ops._build import build_dir

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO_ROOT, "native", "kzg_native.cpp")
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-pthread", "-shared"]
_ABI_VERSION = 6

R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

_P = ctypes.c_void_p  # output buffers, context handles
_B = ctypes.c_char_p  # input bytes
_I = ctypes.c_int
_U32 = ctypes.c_uint32
_PI = ctypes.POINTER(ctypes.c_int)

# entry point -> (argtypes, restype)
ENTRY_POINTS = {
    "kzg_native_abi_version": ([], _I),
    "kzg_g1_uncompress": ([_B, _P, _PI], _I),
    "kzg_g1_uncompress_batch": ([_B, _I, _P, _P, _P], _I),
    "kzg_g1_compress": ([_B, _I, _P], _I),
    "kzg_g1_in_subgroup": ([_B, _I], _I),
    "kzg_g1_subgroup_batch": ([_B, _B, _I], _I),
    "kzg_g1_mul": ([_B, _I, _B, _P, _PI], _I),
    "kzg_g1_add": ([_B, _I, _B, _I, _I, _P, _PI], _I),
    "kzg_g2_uncompress": ([_B, _P, _PI], _I),
    "kzg_g2_mul": ([_B, _I, _B, _P, _PI], _I),
    "kzg_g2_add": ([_B, _I, _B, _I, _I, _P, _PI], _I),
    "kzg_g1_lincomb": ([_B, _B, _B, _I, _P, _PI], _I),
    "kzg_pairings_verify": ([_B, _I, _B, _I, _B, _I, _B, _I], _I),
    "kzg_sha256": ([_B, ctypes.c_uint64, _P], _I),
    "kzg_bary_ctx_new": ([_U32, _B], _P),
    "kzg_bary_ctx_free": ([_P], None),
    "kzg_bary_eval_batch": ([_P, _B, _U32, _B, _P], _I),
    "kzg_verify_ctx_new": ([_U32, _B, _B, _I, _B, _I, _B, _B], _P),
    "kzg_verify_ctx_free": ([_P], None),
    "kzg_verify_blob_batch": ([_P, _B, _U32, _B, _B, _PI], _I),
    "kzg_verify_blob_batch_ptrs": ([_P, _P, _U32, _B, _B, _PI], _I),
    "kzg_verify_single": ([_P, _B, _B, _B, _B, _PI], _I),
    "kzg_verify_blob_single": ([_P, _B, _B, _B, _PI], _I),
    "kzg_prover_ctx_new": ([_U32, _B, _B, _B, _B], _P),
    "kzg_prover_ctx_free": ([_P], None),
    "kzg_prover_commit": ([_P, _B, _P, _PI], _I),
    "kzg_prover_prove": ([_P, _B, _B, _P, _PI, _P], _I),
    "kzg_prover_blob_proof": ([_P, _B, _B, _P, _PI], _I),
}

# What the last load found: the library's path, the seconds its build took
# (0 when it was already built), and the error when it did not load.
BUILD_INFO: dict = {}

_lib = None
_lib_lock = threading.Lock()
_load_failed = False


def _cpu_flags() -> bytes:
    """What ``-march=native`` resolves to on this machine: the feature flags
    of its first CPU (empty where /proc/cpuinfo is not there)."""
    try:
        with open("/proc/cpuinfo", "rb") as fh:
            for line in fh:
                if line.startswith((b"flags", b"Features")):
                    return line
    except OSError:
        pass
    return b""


def library_path() -> str:
    """Where this machine's build of the engine goes."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + _cpu_flags())
    with open(SOURCE, "rb") as fh:
        h.update(fh.read())
    return os.path.join(build_dir(), f"libkzg_native-{h.hexdigest()[:16]}.so")


def _build() -> str:
    """Compile the engine into the build directory unless it is there;
    returns the library's path, raises with the compiler's output."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(build_dir(), exist_ok=True)
    tmp = out + f".tmp{os.getpid()}"
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp, SOURCE]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    return out


def _open(path: str):
    lib = ctypes.CDLL(path)
    for name, (argtypes, restype) in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    abi = lib.kzg_native_abi_version()
    if abi != _ABI_VERSION:
        raise RuntimeError(f"{path}: ABI version {abi}, expected {_ABI_VERSION}")
    return lib


def wanted() -> bool:
    """False where ``KZG_TORCH_NATIVE=0`` asks for the golden model."""
    return os.environ.get("KZG_TORCH_NATIVE", "1") != "0"


def _load():
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lib_lock:
        if _lib is not None or _load_failed:
            return _lib
        if not wanted():
            BUILD_INFO["error"] = "KZG_TORCH_NATIVE=0"
            _load_failed = True
            return None
        BUILD_INFO["seconds"] = 0.0
        try:
            BUILD_INFO["path"] = _build()
            _lib = _open(BUILD_INFO["path"])
        except Exception as e:  # no source or compiler, a failed build or probe
            BUILD_INFO["error"] = f"{type(e).__name__}: {e}"
            _load_failed = True
        return _lib


def available() -> bool:
    return _load() is not None


def require():
    """The loaded engine; raises RuntimeError with the compiler's or the
    loader's error where it does not load."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native host engine not available: {BUILD_INFO.get('error')}")
    return lib


# ---------------------------------------------------------------------------
# Byte codecs (golden int tuples <-> boundary bytes)
# ---------------------------------------------------------------------------


def _g1_to_bytes(p):
    if p is None:
        return b"\x00" * 96, 1
    return p[0].to_bytes(48, "big") + p[1].to_bytes(48, "big"), 0


def _g1_from_bytes(buf, inf: int):
    if inf:
        return None
    b = bytes(buf)
    return (int.from_bytes(b[:48], "big"), int.from_bytes(b[48:], "big"))


def _g2_to_bytes(p):
    if p is None:
        return b"\x00" * 192, 1
    (x0, x1), (y0, y1) = p
    return (
        x0.to_bytes(48, "big") + x1.to_bytes(48, "big") + y0.to_bytes(48, "big") + y1.to_bytes(48, "big")
    ), 0


def _g2_from_bytes(buf, inf: int):
    if inf:
        return None
    b = bytes(buf)
    return (
        (int.from_bytes(b[:48], "big"), int.from_bytes(b[48:96], "big")),
        (int.from_bytes(b[96:144], "big"), int.from_bytes(b[144:], "big")),
    )


# ---------------------------------------------------------------------------
# Wrappers (signatures mirror golden/curve.py + golden/pairing.py)
# ---------------------------------------------------------------------------


def g1_uncompress(data: bytes):
    """48-byte ZCash-format decode (reference: blst_p1_uncompress at
    utils.rs:291); raises BadArgs like golden.curve.g1_uncompress."""
    lib = _load()
    if len(data) != 48:
        raise BadArgs(MSG_EXPECT_48)
    out = (ctypes.c_uint8 * 96)()
    inf = ctypes.c_int()
    if lib.kzg_g1_uncompress(bytes(data), out, ctypes.byref(inf)):
        raise BadArgs("g1_uncompress: malformed point encoding")
    return _g1_from_bytes(out, inf.value)


def g1_uncompress_batch(datas):
    """Decode many 48-byte points on the engine's threads; raises BadArgs
    on the first malformed one."""
    lib = _load()
    n = len(datas)
    if n == 0:
        return []
    joined = b"".join(bytes(d) for d in datas)
    if len(joined) != 48 * n:
        raise BadArgs(MSG_EXPECT_48)
    out = (ctypes.c_uint8 * (96 * n))()
    infs = (ctypes.c_uint8 * n)()
    errs = (ctypes.c_uint8 * n)()
    if lib.kzg_g1_uncompress_batch(joined, n, out, infs, errs):
        raise BadArgs("g1_uncompress: malformed point encoding")
    return [_g1_from_bytes(out[96 * i : 96 * (i + 1)], infs[i]) for i in range(n)]


def g2_uncompress(data: bytes):
    """96-byte ZCash-format G2 decode (reference: blst_p2_uncompress at
    kzg.rs:876): an Fp2 square root (eprint 2012/685 alg 9) in place of the
    golden Tonelli-Shanks, with the same points and error strings."""
    lib = _load()
    if len(data) != 96:
        raise BadArgs(MSG_G2_EXPECT_96)
    out = (ctypes.c_uint8 * 192)()
    inf = ctypes.c_int()
    rc = lib.kzg_g2_uncompress(bytes(data), out, ctypes.byref(inf))
    if rc:
        raise BadArgs(G2_UNCOMPRESS_RC_ERRORS.get(rc, f"g2_uncompress failed ({rc})"))
    return _g2_from_bytes(out, inf.value)


def g1_compress(p) -> bytes:
    lib = _load()
    xy, inf = _g1_to_bytes(p)
    out = (ctypes.c_uint8 * 48)()
    if lib.kzg_g1_compress(xy, inf, out):
        raise ValueError("g1_compress: coordinates out of range")
    return bytes(out)


def g1_in_subgroup(p) -> bool:
    lib = _load()
    xy, inf = _g1_to_bytes(p)
    return lib.kzg_g1_in_subgroup(xy, inf) == 1


def g1_subgroup_batch(points) -> bool:
    """True iff every point is in G1 (infinity passes)."""
    lib = _load()
    n = len(points)
    if n == 0:
        return True
    bufs, infs = [], []
    for p in points:
        xy, inf = _g1_to_bytes(p)
        bufs.append(xy)
        infs.append(inf)
    return lib.kzg_g1_subgroup_batch(b"".join(bufs), bytes(infs), n) == 1


def g1_mul(p, k: int):
    lib = _load()
    k %= R
    if p is None or k == 0:
        return None
    xy, inf = _g1_to_bytes(p)
    out = (ctypes.c_uint8 * 96)()
    oinf = ctypes.c_int()
    lib.kzg_g1_mul(xy, inf, k.to_bytes(32, "big"), out, ctypes.byref(oinf))
    return _g1_from_bytes(out, oinf.value)


def _g1_addsub(p, q, negate: int):
    lib = _load()
    pxy, pinf = _g1_to_bytes(p)
    qxy, qinf = _g1_to_bytes(q)
    out = (ctypes.c_uint8 * 96)()
    oinf = ctypes.c_int()
    lib.kzg_g1_add(pxy, pinf, qxy, qinf, negate, out, ctypes.byref(oinf))
    return _g1_from_bytes(out, oinf.value)


def g1_add(p, q):
    return _g1_addsub(p, q, 0)


def g1_sub(p, q):
    return _g1_addsub(p, q, 1)


def g2_mul(p, k: int):
    lib = _load()
    k %= R
    if p is None or k == 0:
        return None
    b, inf = _g2_to_bytes(p)
    out = (ctypes.c_uint8 * 192)()
    oinf = ctypes.c_int()
    lib.kzg_g2_mul(b, inf, k.to_bytes(32, "big"), out, ctypes.byref(oinf))
    return _g2_from_bytes(out, oinf.value)


def _g2_addsub(p, q, negate: int):
    lib = _load()
    pb, pinf = _g2_to_bytes(p)
    qb, qinf = _g2_to_bytes(q)
    out = (ctypes.c_uint8 * 192)()
    oinf = ctypes.c_int()
    lib.kzg_g2_add(pb, pinf, qb, qinf, negate, out, ctypes.byref(oinf))
    return _g2_from_bytes(out, oinf.value)


def g2_add(p, q):
    return _g2_addsub(p, q, 0)


def g2_sub(p, q):
    return _g2_addsub(p, q, 1)


def g1_lincomb_naive(points, scalars):
    """Runtime-base lincomb, reference semantics (utils.rs:329-342)."""
    lib = _load()
    n = len(points)
    if n != len(scalars):
        raise ValueError("g1_lincomb: points/scalars length mismatch")
    if n == 0:
        return None
    bufs, infs, sb = [], [], []
    for p, s in zip(points, scalars):
        xy, inf = _g1_to_bytes(p)
        bufs.append(xy)
        infs.append(inf)
        sb.append((s % R).to_bytes(32, "big"))
    out = (ctypes.c_uint8 * 96)()
    oinf = ctypes.c_int()
    if lib.kzg_g1_lincomb(b"".join(bufs), bytes(infs), b"".join(sb), n, out, ctypes.byref(oinf)):
        raise ValueError("g1_lincomb: bad point bytes")
    return _g1_from_bytes(out, oinf.value)


def pairings_verify(a1, a2, b1, b2) -> bool:
    """e(a1, a2) == e(b1, b2) (reference: pairings_verify, utils.rs:189-214)."""
    lib = _load()
    a1b, a1i = _g1_to_bytes(a1)
    b1b, b1i = _g1_to_bytes(b1)
    a2b, a2i = _g2_to_bytes(a2)
    b2b, b2i = _g2_to_bytes(b2)
    rc = lib.kzg_pairings_verify(a1b, a1i, a2b, a2i, b1b, b1i, b2b, b2i)
    if rc < 0:
        raise ValueError("pairings_verify: bad point bytes")
    return rc == 1


def sha256(data: bytes) -> bytes:
    """SHA-256 in the engine (the same digest as hashlib)."""
    lib = _load()
    out = (ctypes.c_uint8 * 32)()
    lib.kzg_sha256(bytes(data), len(data), out)
    return bytes(out)


def _roots_bytes(roots_of_unity) -> bytes:
    return b"".join(w.to_bytes(32, "big") for w in roots_of_unity)


class _Ctx:
    """A native context over a domain of ``n`` roots: its handle, and the
    entry point that frees it."""

    _free = ""

    def __init__(self, lib, handle, n: int, what: str):
        if not handle:
            raise ValueError(f"{what}: bad inputs")
        self._lib, self._handle, self._n = lib, handle, n

    def _check(self, name: str, got: int, want: int) -> None:
        if got != want:
            raise ValueError(f"{type(self).__name__}: {name} is {got} bytes, expected {want}")

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            getattr(self._lib, self._free)(handle)


# ---------------------------------------------------------------------------
# Barycentric evaluation context
# ---------------------------------------------------------------------------


class BaryCtx(_Ctx):
    """Holds the converted roots-of-unity table for repeated evaluations.

    Mirrors evaluate_polynomial_in_evaluation_form (reference:
    kzg.rs:346-389) minus the in-domain short-circuit, which the caller
    handles (kzg.rs:360-362).
    """

    _free = "kzg_bary_ctx_free"

    def __init__(self, roots_of_unity: list[int]):
        lib = require()
        n = len(roots_of_unity)
        super().__init__(lib, lib.kzg_bary_ctx_new(n, _roots_bytes(roots_of_unity)), n, "bary_ctx")

    def eval_batch(self, blobs_bytes: bytes, nb: int, xs: list[int]) -> list[int]:
        """blobs_bytes: nb*n*32 raw field-element bytes; xs: canonical ints.
        Returns ys; raises BadArgs on non-canonical blob elements."""
        self._check("blobs", len(blobs_bytes), nb * self._n * 32)
        self._check("xs", 32 * len(xs), 32 * nb)
        xs_b = b"".join(x.to_bytes(32, "big") for x in xs)
        ys = (ctypes.c_uint8 * (32 * nb))()
        rc = self._lib.kzg_bary_eval_batch(self._handle, bytes(blobs_bytes), nb, xs_b, ys)
        if rc == 2:
            raise BadArgs(MSG_INVALID_BYTES32)
        if rc:
            raise BadArgs(f"barycentric evaluation failed (code {rc})")
        out = bytes(ys)
        return [int.from_bytes(out[32 * i : 32 * (i + 1)], "big") for i in range(nb)]


# ---------------------------------------------------------------------------
# Fused verification context
# ---------------------------------------------------------------------------


class VerifyCtx(_Ctx):
    """One-call verify_blob_kzg_proof_batch hot section (reference:
    kzg.rs:637-693 + :579-627): point validation, Fiat-Shamir challenges,
    barycentric evaluations, RLC combination and the single pairing check,
    all inside one GIL-free native region; and the single-proof calls."""

    _free = "kzg_verify_ctx_free"

    def __init__(self, roots_of_unity, g2_s, g2_gen, fs_domain: bytes, rc_domain: bytes):
        lib = require()
        g2s_b, g2s_inf = _g2_to_bytes(g2_s)
        g2g_b, g2g_inf = _g2_to_bytes(g2_gen)
        handle = lib.kzg_verify_ctx_new(
            len(roots_of_unity), _roots_bytes(roots_of_unity), g2s_b, g2s_inf, g2g_b, g2g_inf,
            bytes(fs_domain), bytes(rc_domain),
        )
        super().__init__(lib, handle, len(roots_of_unity), "verify_ctx")

    def _result(self, rc: int, ok, what: str) -> bool:
        if rc:
            raise BadArgs(VERIFY_RC_ERRORS.get(rc, f"{what} failed ({rc})"))
        return ok.value == 1

    def _check_points(self, nb: int, comms: bytes, proofs: bytes) -> None:
        self._check("commitments", len(comms), 48 * nb)
        self._check("proofs", len(proofs), 48 * nb)

    def verify(self, blobs_bytes: bytes, nb: int, comms: bytes, proofs: bytes) -> bool:
        """blobs_bytes: nb*n*32; comms/proofs: nb*48 compressed points.
        Raises BadArgs on invalid inputs (same cases as the piecewise path)."""
        self._check("blobs", len(blobs_bytes), nb * self._n * 32)
        self._check_points(nb, comms, proofs)
        ok = ctypes.c_int()
        rc = self._lib.kzg_verify_blob_batch(self._handle, bytes(blobs_bytes), nb, comms, proofs, ctypes.byref(ok))
        return self._result(rc, ok, "verify_blob_batch")

    def verify_scatter(self, blobs, nb: int, comms: bytes, proofs: bytes) -> bool:
        """Zero-copy variant: ``blobs`` is a sequence of nb ``bytes`` objects
        (each n*32); only their pointers cross the boundary."""
        self._check("blob count", len(blobs), nb)
        for b in blobs:
            self._check("a blob", len(b), self._n * 32)
        self._check_points(nb, comms, proofs)
        ptrs = (ctypes.c_char_p * nb)(*blobs)
        ok = ctypes.c_int()
        rc = self._lib.kzg_verify_blob_batch_ptrs(self._handle, ptrs, nb, comms, proofs, ctypes.byref(ok))
        return self._result(rc, ok, "verify_blob_batch")

    def verify_single(self, comm48: bytes, z32: bytes, y32: bytes, proof48: bytes) -> bool:
        """Fused verify_kzg_proof (reference: kzg.rs:429-443): decode +
        validation + the pairing equation in one native call."""
        for name, b, size in (("commitment", comm48, 48), ("z", z32, 32), ("y", y32, 32), ("proof", proof48, 48)):
            self._check(name, len(b), size)
        ok = ctypes.c_int()
        rc = self._lib.kzg_verify_single(self._handle, comm48, z32, y32, proof48, ctypes.byref(ok))
        return self._result(rc, ok, "verify_single")

    def verify_blob_single(self, blob_bytes: bytes, comm48: bytes, proof48: bytes) -> bool:
        """Fused verify_blob_kzg_proof (reference: kzg.rs:547-569):
        challenge + barycentric + pairing in one native call."""
        self._check("blob", len(blob_bytes), self._n * 32)
        self._check_points(1, comm48, proof48)
        ok = ctypes.c_int()
        rc = self._lib.kzg_verify_blob_single(self._handle, blob_bytes, comm48, proof48, ctypes.byref(ok))
        return self._result(rc, ok, "verify_blob_single")


# ---------------------------------------------------------------------------
# Fused prover context
# ---------------------------------------------------------------------------


class ProverCtx(_Ctx):
    """One-call prover ops over a persistent Lagrange-setup context:
    blob_to_kzg_commitment, compute_kzg_proof, compute_blob_kzg_proof
    (reference: kzg.rs:396-406, :446-544), with the engine's Pippenger MSM;
    the same bits as the golden model."""

    _free = "kzg_prover_ctx_free"

    def __init__(self, roots_of_unity, g1_lagrange, fs_domain: bytes):
        lib = require()
        n = len(roots_of_unity)
        if len(g1_lagrange) != n:
            raise ValueError("prover_ctx: |g1_lagrange| != |roots|")
        pts = bytearray(96 * n)
        infs = bytearray(n)
        for i, p in enumerate(g1_lagrange):
            pts[96 * i : 96 * (i + 1)], infs[i] = _g1_to_bytes(p)
        handle = lib.kzg_prover_ctx_new(n, _roots_bytes(roots_of_unity), bytes(pts), bytes(infs), bytes(fs_domain))
        super().__init__(lib, handle, n, "prover_ctx")

    def _point(self, rc: int, out, inf, what: str):
        if rc:
            raise BadArgs(PROVER_RC_ERRORS.get(rc, f"{what} failed ({rc})"))
        return _g1_from_bytes(out, inf.value)

    def commit(self, blob_bytes: bytes):
        """blob -> commitment point (reference: kzg.rs:396-406)."""
        self._check("blob", len(blob_bytes), self._n * 32)
        out, inf = (ctypes.c_uint8 * 96)(), ctypes.c_int()
        rc = self._lib.kzg_prover_commit(self._handle, blob_bytes, out, ctypes.byref(inf))
        return self._point(rc, out, inf, "prover_commit")

    def prove(self, blob_bytes: bytes, z32: bytes):
        """compute_kzg_proof -> (proof point, y int)
        (reference: kzg.rs:446-457)."""
        self._check("blob", len(blob_bytes), self._n * 32)
        self._check("z", len(z32), 32)
        out, inf, y = (ctypes.c_uint8 * 96)(), ctypes.c_int(), (ctypes.c_uint8 * 32)()
        rc = self._lib.kzg_prover_prove(self._handle, blob_bytes, z32, out, ctypes.byref(inf), y)
        return self._point(rc, out, inf, "prover_prove"), int.from_bytes(bytes(y), "big")

    def blob_proof(self, blob_bytes: bytes, comm48: bytes):
        """compute_blob_kzg_proof -> proof point
        (reference: kzg.rs:533-544)."""
        self._check("blob", len(blob_bytes), self._n * 32)
        self._check("commitment", len(comm48), 48)
        out, inf = (ctypes.c_uint8 * 96)(), ctypes.c_int()
        rc = self._lib.kzg_prover_blob_proof(self._handle, blob_bytes, comm48, out, ctypes.byref(inf))
        return self._point(rc, out, inf, "prover_blob_proof")
