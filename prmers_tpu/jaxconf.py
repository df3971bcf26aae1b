"""Central JAX configuration for prmers_tpu.

Import this module before any jax.numpy use inside the package. The Goldilocks
field lives in u64, so x64 mode is mandatory.

Compiled programs persist across processes: in JAX_COMPILATION_CACHE_DIR
when it is set (JAX reads that variable itself), otherwise in
<checkout>/.jax_cache.
"""

import os

import jax

jax.config.update("jax_enable_x64", True)

if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), ".jax_cache"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
