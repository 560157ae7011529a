"""Hand-written Hopper kernels, each beside its plain PyTorch version.

- ``flash_attention.py``: flash-attention forward (``csrc/flash_attention.cu``)
  and backward, dQ and dK/dV (``csrc/flash_attention_bwd.cu``).
- ``flash_decode.py``: single-token decode attention over a dense cache, an
  int8 cache, and both read from the paged pool through block tables
  (``csrc/flash_decode.cu``).
- ``rmsnorm.py``: RMSNorm and LayerNorm, forward and dx (Triton,
  ``rmsnorm_triton.py``).
- ``decode_step.py``: the whole decoder stack for one new token per row in
  one cooperative launch, over a dense cache, the paged pool, and a
  speculative verify window, linear or a tree (``csrc/decode_step.cu``).
- ``build.py``: ``nvcc`` into ``build/kernels/`` and ``ctypes`` loading.

Each wrapper counts its launches in a ``launches`` attribute; the fused
decode step's wrappers count their launches with a LoRA arena apart, in
``<wrapper>.lora.launches``, and their launches of the TMA weight-stream
body (bf16) in ``<wrapper>.tma_launches`` and
``<wrapper>.lora.tma_launches``; the flash-attention forward, dQ and dK/dV
wrappers their launches of the tensor-core body (bf16 / fp16 inputs) in
``<wrapper>.mma_launches``; the decode-attention wrappers (K8-K11) their
launches of the split cache walk in ``<wrapper>.split_launches``.  Each
body count follows the C launcher's own report of the body it ran.
"""


class _AttrCounter:
    """One integer attribute of a wrapper, read and reset as ``launches``
    like the other counters."""

    def __init__(self, fn, attr: str):
        self._fn, self._attr = fn, attr

    @property
    def launches(self) -> int:
        return getattr(self._fn, self._attr)

    @launches.setter
    def launches(self, n: int) -> None:
        setattr(self._fn, self._attr, n)


def launch_counters() -> dict:
    """``{kernel name: counter}`` of every kernel wrapper's launch counter
    (read and reset through ``counter.launches``): the wrappers
    themselves, ``<name>_lora`` for the fused decode step's launches with a
    LoRA arena, ``<name>_tma`` and ``<name>_lora_tma`` for its launches of
    the TMA body, ``<name>_mma`` for the flash-attention forward's,
    dQ's and dK/dV's launches of their tensor-core bodies, and
    ``<name>_split`` for K8-K11's launches of the split cache walk."""
    from .decode_step import (
        fused_decode_step,
        fused_decode_step_paged,
        fused_decode_verify_paged,
        fused_decode_verify_tree_paged,
    )
    from .flash_attention import (
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_fwd,
    )
    from .flash_decode import (
        flash_decode,
        flash_decode_int8,
        flash_decode_paged,
        flash_decode_paged_int8,
    )
    from .rmsnorm import (
        layernorm_bwd,
        layernorm_fwd,
        rmsnorm_bwd,
        rmsnorm_fwd,
    )

    return {"flash_attention_fwd": flash_attention_fwd,
            "flash_attention_fwd_mma": _AttrCounter(flash_attention_fwd,
                                                    "mma_launches"),
            "flash_attention_bwd_dq": flash_attention_bwd_dq,
            "flash_attention_bwd_dq_mma": _AttrCounter(
                flash_attention_bwd_dq, "mma_launches"),
            "flash_attention_bwd_dkv": flash_attention_bwd_dkv,
            "flash_attention_bwd_dkv_mma": _AttrCounter(
                flash_attention_bwd_dkv, "mma_launches"),
            "flash_decode": flash_decode,
            "flash_decode_int8": flash_decode_int8,
            "flash_decode_paged": flash_decode_paged,
            "flash_decode_paged_int8": flash_decode_paged_int8,
            "rmsnorm_fwd": rmsnorm_fwd,
            "rmsnorm_bwd": rmsnorm_bwd,
            "layernorm_fwd": layernorm_fwd,
            "layernorm_bwd": layernorm_bwd,
            "fused_decode_step": fused_decode_step,
            "fused_decode_step_paged": fused_decode_step_paged,
            "fused_decode_verify_paged": fused_decode_verify_paged,
            "fused_decode_verify_tree_paged":
                fused_decode_verify_tree_paged,
            "fused_decode_step_lora": fused_decode_step.lora,
            "fused_decode_step_paged_lora": fused_decode_step_paged.lora,
            "fused_decode_verify_paged_lora": fused_decode_verify_paged.lora,
            "fused_decode_verify_tree_paged_lora":
                fused_decode_verify_tree_paged.lora,
            **{f"{fn.__name__}{sfx}_tma": _AttrCounter(c, "tma_launches")
               for fn in (fused_decode_step, fused_decode_step_paged,
                          fused_decode_verify_paged,
                          fused_decode_verify_tree_paged)
               for sfx, c in (("", fn), ("_lora", fn.lora))},
            **{f"{fn.__name__}_split": _AttrCounter(fn, "split_launches")
               for fn in (flash_decode, flash_decode_int8,
                          flash_decode_paged, flash_decode_paged_int8)}}
