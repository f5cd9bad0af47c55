"""The pool of valid (blob, commitment, proof) triples that verification
traffic draws its lanes from.

The reference prover makes it from the mix's ``pool_seed`` (random blobs,
then their commitments and proofs), once a checkout: it is cached under
``.cache/pool/`` beside this file, named by the configuration, the seed,
the size and the setup file's digest, written whole or not at all.
"""

from __future__ import annotations

import hashlib
import os


def path_for(cache_dir: str, config: dict, setup_path: str, pool_seed: int, size: int) -> str:
    with open(setup_path, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    return os.path.join(cache_dir, f"pool-{config['name']}-{pool_seed}-{size}-{digest}.bin")


def read(path: str, fe: int) -> list[tuple[bytes, bytes, bytes]]:
    bpb = 32 * fe
    with open(path, "rb") as fh:
        data = fh.read()
    step = bpb + 96
    if len(data) % step:
        raise ValueError(f"{path}: {len(data)} bytes, not a whole number of triples")
    return [(data[o : o + bpb], data[o + bpb : o + bpb + 48], data[o + bpb + 48 : o + step]) for o in range(0, len(data), step)]


def cached(path: str, fe: int, size: int) -> bool:
    return os.path.exists(path) and os.path.getsize(path) == size * (32 * fe + 96)


def load_or_make(path: str, fe: int, pool_seed: int, size: int, make_executor) -> list[tuple[bytes, bytes, bytes]]:
    """The cached pool at ``path``, or a new one made in the reference's
    workers (``make_executor()``) and cached there."""
    if cached(path, fe, size):
        return read(path, fe)
    from . import workers

    with make_executor() as ex:
        triples = list(ex.map(workers.make_triple, [pool_seed] * size, range(size)))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as fh:
        for t in triples:
            fh.write(b"".join(t))
    os.replace(tmp, path)
    return read(path, fe)
