"""Opt-in runtime sanitizers (``sanitizers.py``, mirror of
``megatron_llm_tpu/analysis/sanitizers.py``): the recompilation guard,
the lock-order checker and the block-pool ledger sanitizer.  The JAX
package's static pass (``core``, ``rules``) lints that package's own
idioms and has no counterpart here."""
