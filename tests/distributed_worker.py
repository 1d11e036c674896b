"""Worker for the 2-process `jax.distributed` integration test.

Launched (twice) by tests/test_distributed.py::test_two_process_cpu_cluster
— NOT collected by pytest. Exercises the multi-process branches of
parallel/distributed.py (initialize with an explicit coordinator,
is_primary on both ranks, a real cross-process barrier) plus one tiny
train iteration over the GLOBAL 4-device mesh: the gradient pmean becomes
a genuine cross-process collective and every process writes its shards
of a multi-process checkpoint (SURVEY.md §4 "Distributed without a cluster";
BASELINE.json:10 is the real-hardware version of this layout).
"""

import json
import os
import sys
import time

proc_id = int(sys.argv[1])
nproc = int(sys.argv[2])
port = sys.argv[3]
workdir = sys.argv[4]

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

# force the CPU backend before any backend init, whatever the environment
# selects: both workers must stay off any accelerator
jax.config.update("jax_platforms", "cpu")

from alphafive_tpu.parallel import distributed  # noqa: E402

distributed.initialize(f"localhost:{port}", nproc, proc_id)
assert jax.process_count() == nproc, jax.process_count()
assert len(jax.devices()) == 2 * nproc  # global devices
assert len(jax.local_devices()) == 2
assert distributed.is_primary() == (proc_id == 0)
assert distributed.scale_for_processes(8) == 8 // nproc

# --- barrier actually synchronizes: rank 1 arrives ~2s late, so rank 0's
# wait at the barrier must reflect that delay (a no-op barrier returns
# instantly and fails the assert)
t0 = time.time()
if proc_id == 1:
    time.sleep(2.0)
distributed.barrier("test-sync")
barrier_wait = time.time() - t0
assert barrier_wait > 1.5, barrier_wait

# --- one tiny train iteration over the global mesh: loop.py picks
# n = len(jax.devices()) for multi-process runs, shards the 4 envs 1/device,
# pmeans grads across processes, and checkpoints through the multi-process
# path (train/checkpoint.py); only the primary writes metrics.jsonl
from alphafive_tpu.config import get_preset  # noqa: E402
from alphafive_tpu.train.loop import train  # noqa: E402
from alphafive_tpu import parallel  # noqa: E402

cfg = get_preset("tiny_test")

# Align the collective EXECUTION across processes: gloo's context
# handshake has a fixed ~30s window, and on a loaded single-core machine
# one process's XLA compile can lag past it. Pre-compile the iteration
# into a per-process persistent cache (compile only — no collective
# runs), barrier, then train(): its own jit instance hits the cache and
# both processes reach the pmean within milliseconds.
jax.config.update("jax_compilation_cache_dir",
                  os.path.join(workdir, f"xla_cache_{proc_id}"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
_mesh = parallel.make_mesh(len(jax.devices()))
_carry = parallel.init_carry(cfg, jax.random.key(0), _mesh)
parallel.make_train_iteration(cfg, _mesh).lower(
    _carry, jax.random.key(1)).compile()
del _carry
distributed.barrier("precompiled")

carry, _ = train(cfg, workdir=workdir, total_iters=1)

# --- params must be bit-identical across processes after the pmean'd
# update (the cross-process psum working is exactly this invariant)
from jax.experimental import multihost_utils  # noqa: E402

digest = np.asarray(
    [float(jax.device_get(jax.numpy.sum(jax.numpy.abs(leaf))))
     for leaf in jax.tree.leaves(carry.train_state.params)], np.float64)
gathered = np.asarray(multihost_utils.process_allgather(digest))
assert gathered.shape[0] == nproc
assert np.array_equal(gathered[0], gathered[proc_id]), gathered

distributed.barrier("done")
print(json.dumps({"proc": proc_id, "ok": True,
                  "barrier_wait": round(barrier_wait, 2),
                  "digest0": float(digest[0])}))
