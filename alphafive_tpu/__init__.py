"""alphafive_tpu — an accelerator-native AlphaZero-Gomoku framework.

A from-scratch JAX/XLA re-design of the capability surface of the
reference repo ``GuoYi0/alphaFive`` (an AlphaZero Gomoku system: board engine,
MCTS, replay buffer, residual policy-value net, self-play→train→evaluate
pipeline — see SURVEY.md §1–§3).  Nothing here is a port: the reference is
recursive per-game Python + TF sessions; this framework runs thousands of
environments in lockstep on-device, with an array-based batched MCTS, a
plain-JAX policy-value network, an on-device replay ring, and a single SPMD
actor-learner program sharded over a ``jax.sharding.Mesh``.

Provenance note: ``/root/reference`` contained 0 files when this framework was
designed and built (SURVEY.md §0), so docstrings cite SURVEY.md / BASELINE.json
sections instead of reference ``file:line``.
"""

__version__ = "0.1.0"

import os as _os

# Persistent XLA compilation cache: the 400-sim search program takes minutes
# to compile; caching it makes reruns (bench, CLI, resume) start in seconds.
# JAX_COMPILATION_CACHE_DIR, when set, is read by JAX itself and wins;
# otherwise the cache lives at a fixed path inside the checkout (the path is
# part of the cache key, so it must not move between runs).
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")

import jax as _jax  # noqa: E402

if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
