"""REST front-end over the serving engine (standard generation)."""

from .server import GenerationService, MegatronServer  # noqa: F401
