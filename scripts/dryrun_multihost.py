"""Multi-host (DCN) dryrun: 2 JAX processes, one global mesh, sharded corpus.

SURVEY §5 promises the distributed story in two halves: inside a host the
corpus is sharded over the mesh and the top-k merge rides the device
interconnect; ACROSS hosts the same collectives ride the network via
`jax.distributed`. The 8-device `dryrun_multichip` proves the first half in
one process; this script proves the code survives a PROCESS BOUNDARY — the
thing a multi-host deployment adds:

  - `jax.distributed.initialize` (coordinator + N workers)
  - a global mesh whose "data" axis spans both processes
  - `shard_corpus`/`sharded_cosine_topk` (parallel/sharded_topk.py) running
    unchanged, with the candidate all-gather crossing the process boundary
  - retrieval-index parity with the single-process numpy oracle

Run: python scripts/dryrun_multihost.py          (parent; spawns 2 workers)
     exit 0 + "MULTIHOST PASS" on parity across both processes.

On CPU the cross-process collectives run over gRPC where a GPU cluster
would use the network; device count per process is forced to 4 (8 global).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_PROC = 2
LOCAL_DEV = 4
N_DOCS, DIM, B, K = 1000, 64, 8, 5


def child(pid: int, coord: str) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_force_host_platform_device_count={LOCAL_DEV}")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=coord,
                               num_processes=N_PROC, process_id=pid)
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from rag_serving_system.parallel.sharded_topk import (
        shard_corpus, sharded_cosine_topk)

    assert len(jax.devices()) == N_PROC * LOCAL_DEV, jax.devices()
    assert len(jax.local_devices()) == LOCAL_DEV

    # the "data" axis spans the process (DCN) boundary: devices 0-3 live in
    # process 0, devices 4-7 in process 1
    mesh = Mesh(np.array(jax.devices()).reshape(N_PROC * 2, LOCAL_DEV // 2),
                ("data", "model"))

    rng = np.random.default_rng(42)  # same data in both processes
    corpus = rng.standard_normal((N_DOCS, DIM)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=-1, keepdims=True)
    queries = rng.standard_normal((B, DIM)).astype(np.float32)

    with mesh:
        c_sharded = shard_corpus(jnp.asarray(corpus), mesh)
        # the corpus array is now a GLOBAL array: each process holds only its
        # addressable shards; the all-gather of per-shard candidates crosses
        # the process boundary
        scores, idx = sharded_cosine_topk(
            c_sharded, jnp.asarray(queries), K, mesh,
            valid_n=N_DOCS)

    # replicated output: every process can read it whole
    from jax.experimental import multihost_utils

    # the jit output is a global array; materialize it whole in every process
    idx = np.asarray(multihost_utils.process_allgather(idx, tiled=True))

    # single-process oracle
    qn = queries / np.linalg.norm(queries, axis=-1, keepdims=True)
    sims = qn @ corpus.T
    want = np.argsort(-sims, axis=1, kind="stable")[:, :K]
    assert np.array_equal(idx, want), (pid, idx[:2], want[:2])
    print(f"[child {pid}] parity ok over {N_PROC}-process mesh "
          f"{dict(mesh.shape)}", flush=True)
    jax.distributed.shutdown()


def main() -> None:
    if "--child" in sys.argv:
        i = sys.argv.index("--child")
        child(int(sys.argv[i + 1]), sys.argv[sys.argv.index("--coord") + 1])
        return
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__),
         "--child", str(pid), "--coord", coord],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(N_PROC)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    ok = all(p.returncode == 0 for p in procs)
    for pid, out in enumerate(outs):
        tail = "\n".join(out.strip().splitlines()[-6:])
        print(f"--- child {pid} (rc={procs[pid].returncode}) ---\n{tail}")
    print("MULTIHOST PASS" if ok else "MULTIHOST FAIL")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
