from .tokenizer import (  # noqa: F401
    GPT2BPENativeTokenizer,
    HFTokenizer,
    NullTokenizer,
    SentencePieceTokenizer,
    Tokenizer,
    WordPieceNativeTokenizer,
    build_tokenizer,
)
