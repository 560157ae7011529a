from . import activations, attention, kv_quant, norms, rope  # noqa: F401
