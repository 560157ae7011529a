"""PyTorch/CUDA port of ``megatron_llm_tpu`` for NVIDIA Hopper (H100).

The JAX package stays beside this one as the reference every slice is
tested against; this package imports ``torch`` and never ``jax`` or
anything of ``megatron_llm_tpu``.  The module layout and names mirror the
JAX package's so each counterpart is easy to find.

Two paths are ported.  Serving: ``generation.server.MegatronServer`` →
``serving.engine.ServingEngine`` → ``models.model`` →
``models.transformer`` → ``ops`` → the hand-written kernels in
``kernels/``.  Training on one device: ``finetune`` →
``training.driver.pretrain`` → ``training.step`` → the same model, its
backward through autograd, ``parallel.cross_entropy``,
``resilience.anomaly`` and ``training.optimizer``.  KV-cached generation
(``generation.generate_tokens``, ``score_tokens``, ``beam_search``,
``generation.speculative``) runs the same model one request at a time,
behind the server's beam, score and prompt-lookup routes.  Serving also runs
quantized: an int8 KV cache (``ops.kv_quant``) and int8 / int4 weight
policies (``ops.quant``).  The kernels: flash-attention forward and
backward (dQ; dK/dV) and the decode-attention family (dense, int8, paged,
paged int8) in CUDA C++ under ``csrc/``, RMSNorm and LayerNorm forward and
backward in Triton.  Entry points
run on ``cuda`` unless the caller passes a CPU device; on CPU tensors
every kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.2.0"
