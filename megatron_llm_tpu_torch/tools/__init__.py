"""Command-line tools (mirror of ``megatron_llm_tpu/tools``)."""
