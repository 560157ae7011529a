from . import model, transformer  # noqa: F401
