from . import families, model, transformer  # noqa: F401
