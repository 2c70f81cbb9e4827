"""siga: a string-graph genome assembler on JAX/XLA with a C++ native runtime."""
import os

import jax

# Persistent XLA compilation cache: every pipeline stage is a fresh `siga`
# process, which would otherwise recompile each kernel.  JAX reads
# JAX_COMPILATION_CACHE_DIR itself; without it the cache sits at a fixed path
# inside the checkout, so every process of every run finds the same entries.
CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")

if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)

__version__ = "0.1.0"
