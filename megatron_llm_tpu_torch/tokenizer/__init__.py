from .tokenizer import NullTokenizer, Tokenizer  # noqa: F401
