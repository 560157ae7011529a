"""The port's tokenizers against the JAX package's, on the CPU.

The vocabulary files are the JAX tests' own (``tests/data/
test_native_tokenizers.py`` builds them), so both packages read the same
files.  Ids, splits and texts must be equal: no tolerance.

The port's GPT-2 pretokenizer is a scanner over ``unicodedata`` classes
(no ``regex`` module); it is held to JAX's ``regex`` pattern on the JAX
tests' samples and on ``hypothesis`` strings drawn over the letter,
number, mark, space and punctuation categories.
"""

import importlib.util
import subprocess
import sys
import types
from pathlib import Path

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from megatron_llm_tpu.tokenizer import bpe as jbpe
from megatron_llm_tpu.tokenizer import tokenizer as jtok
from megatron_llm_tpu_torch.tokenizer import bpe as tbpe
from megatron_llm_tpu_torch.tokenizer import native_bpe as tnative
from megatron_llm_tpu_torch.tokenizer import tokenizer as ttok

ROOT = Path(__file__).resolve().parents[1]


def _jax_tokenizer_tests():
    spec = importlib.util.spec_from_file_location(
        "jax_native_tokenizer_tests",
        ROOT / "tests" / "data" / "test_native_tokenizers.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JT = _jax_tokenizer_tests()
SAMPLES = JT.SAMPLES + [
    "  two  spaces\n\n\nthree newlines\t\ttabs ",
    "I'm you'll we'd THEY'RE 'quoted' '' ''s",
    " nbsp em　ideographic\x1cfs\x85nel",
    "٣٤٥ ⅷ 𝟙 ¼ x²",
    "é ñ äb",
]
WORDS = ["hello", "world", "the", "don't", "123", "²", "½", "é", "中",
         ",", ".", "!", "  ", " ", "\n", "\t", "--", "'s", "'ll"]


@pytest.fixture(scope="module")
def gpt2_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("gpt2")
    vf, mf = JT._make_gpt2_files(d)
    return d, vf, mf


# ---------------------------------------------------------------------------
# The GPT-2 pretokenizer without ``regex``
# ---------------------------------------------------------------------------


def test_gpt2_split_matches_regex_on_samples():
    for s in SAMPLES + ["", " ", "a", "'", "''s", " 's", "\n", "x "]:
        assert tbpe.gpt2_split(s) == jbpe._GPT2_SPLIT.findall(s), repr(s)


_CHARS = st.one_of(
    st.characters(categories=("L", "N", "M", "Zs", "Zl", "Zp", "P")),
    st.sampled_from(list("'stdremvl \n\t\r\x0b\x0c\x1c\x85\xa0")))


@settings(max_examples=400, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.text(_CHARS, max_size=40))
def test_gpt2_split_matches_regex_on_hypothesis_strings(text):
    assert tbpe.gpt2_split(text) == jbpe._GPT2_SPLIT.findall(text)


def test_port_tokenizer_imports_no_regex(gpt2_files):
    """With ``regex`` unimportable the port still splits and encodes."""
    d, _, _ = gpt2_files
    code = (
        "import sys\n"
        "sys.modules['regex'] = None\n"
        "from megatron_llm_tpu_torch.tokenizer.tokenizer import "
        "build_tokenizer\n"
        f"tok = build_tokenizer('gpt2-bpe', {str(d)!r})\n"
        "ids = tok.tokenize('hello world x² 5½')\n"
        "assert tok.detokenize(ids) == 'hello world x² 5½'\n"
        "assert 'regex' not in [m for m in sys.modules if sys.modules[m]]\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
    assert "regex" not in Path(tbpe.__file__).read_text().replace(
        "``regex``", "").replace("regex module", "")


# ---------------------------------------------------------------------------
# GPT-2 BPE ids
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("native", [True, False])
def test_gpt2_bpe_ids_match_jax(gpt2_files, native):
    _, vf, mf = gpt2_files
    ours = tbpe.GPT2BPETokenizer(vf, mf, use_native=native)
    ref = jbpe.GPT2BPETokenizer(vf, mf)
    assert (ours._native is not None) == native
    assert ours.vocab_size == ref.vocab_size
    import random

    rng = random.Random(7)
    texts = SAMPLES + ["".join(rng.choice(WORDS)
                               for _ in range(rng.randrange(0, 14)))
                       for _ in range(200)]
    for s in texts:
        got = ours.encode(s)
        assert got == ref.encode(s), repr(s)
        assert ours.decode(got) == ref.decode(got) == s


@settings(max_examples=200, deadline=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.function_scoped_fixture])
@given(st.text(_CHARS, max_size=30))
def test_gpt2_bpe_ids_match_jax_on_hypothesis_strings(gpt2_files, text):
    _, vf, mf = gpt2_files
    ours = _cached(vf, mf)
    assert ours.encode(text) == _cached(vf, mf, jax=True).encode(text)


_TOKS: dict = {}


def _cached(vf, mf, jax=False):
    key = (vf, mf, jax)
    if key not in _TOKS:
        _TOKS[key] = (jbpe if jax else tbpe).GPT2BPETokenizer(vf, mf)
    return _TOKS[key]


def test_native_merge_loop_equals_python_loop(gpt2_files):
    """The C++ merge loop against the Python loop, pretoken by pretoken
    (cold caches, every pretoken of the samples)."""
    _, vf, mf = gpt2_files
    py = tbpe.GPT2BPETokenizer(vf, mf, use_native=False)
    engine = tnative.NativeBPE(py.encoder, py.bpe_ranks)
    pretokens = sorted({"".join(py.byte_encoder[b] for b in t.encode())
                        for s in SAMPLES for t in tbpe.gpt2_split(s)})
    flat, offs = engine.encode_pretokens(pretokens)
    for i, t in enumerate(pretokens):
        assert flat[offs[i]:offs[i + 1]] == [py.encoder[p]
                                             for p in py._bpe(t)], t


def test_gpt2_native_build_tokenizer_matches_jax(gpt2_files):
    d, vf, mf = gpt2_files
    for path in (str(d), f"{vf},{mf}"):
        ours = ttok.build_tokenizer("gpt2-bpe", path)
        ref = jtok.build_tokenizer("gpt2-bpe", path)
        assert ours.eod == ref.eod == ours.vocab_size - 1
        assert ours.pad == ref.pad and ours.bos == ref.bos is None
        assert ours.tokenize(SAMPLES[2]) == ref.tokenize(SAMPLES[2])


# ---------------------------------------------------------------------------
# WordPiece
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lower", [True, False])
def test_wordpiece_ids_match_jax(tmp_path, lower):
    vf = JT._make_bert_vocab(tmp_path)
    ours = tbpe.WordPieceTokenizer(vf, lower_case=lower)
    ref = jbpe.WordPieceTokenizer(vf, lower_case=lower)
    import random

    rng = random.Random(99)
    pieces = ["the", "quick", "Fox", "jumps", "unbelievable", "café",
              "12345", "[MASK]", "zzz", ",", "!", "?", " ", "\t", "\n",
              "'", "over-the", "dog.", "中文", "​", "x²"]
    texts = JT.BERT_SAMPLES + [" ".join(rng.choice(pieces)
                                        for _ in range(rng.randrange(0, 10)))
                               for _ in range(200)]
    for s in texts:
        got = ours.encode(s)
        assert got == ref.encode(s), repr(s)
        assert ours.decode(got) == ref.decode(got)


def test_wordpiece_build_tokenizer_matches_jax(tmp_path):
    vf = JT._make_bert_vocab(tmp_path)
    for kind in ("bert-wordpiece", "wordpiece", "bertwordpiecelowercase",
                 "bertwordpiececase"):
        ours, ref = (ttok.build_tokenizer(kind, vf),
                     jtok.build_tokenizer(kind, vf))
        assert type(ours).__name__ == type(ref).__name__
        assert (ours.cls, ours.sep, ours.mask, ours.pad, ours.eod) == \
            (ref.cls, ref.sep, ref.mask, ref.pad, ref.eod)
        s = "The quick brown Fox jumps!"
        assert ours.tokenize(s) == ref.tokenize(s)
        assert ours.detokenize(ours.tokenize(s)) == \
            ref.detokenize(ref.tokenize(s))


# ---------------------------------------------------------------------------
# HF, SentencePiece and the dispatch
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hf_dir(gpt2_files):
    transformers = pytest.importorskip("transformers")
    d, vf, mf = gpt2_files
    out = d / "hf"
    t = transformers.GPT2TokenizerFast(vocab_file=vf, merges_file=mf)
    t.save_pretrained(str(out))
    return str(out)


@pytest.mark.parametrize("kind", ["hf", "huggingface", "falcon"])
def test_hf_tokenizer_matches_transformers_and_jax(hf_dir, kind):
    import transformers

    hf = transformers.AutoTokenizer.from_pretrained(hf_dir)
    ours = ttok.build_tokenizer(kind, hf_dir, ["<|im_start|>"])
    ref = jtok.build_tokenizer(kind, hf_dir, ["<|im_start|>"])
    assert ours.vocab_size == ref.vocab_size == len(hf) + 1
    for s in SAMPLES + ["<|im_start|>hello world"]:
        got = ours.tokenize(s)
        assert got == ref.tokenize(s)
        if "<|im_start|>" not in s:
            assert got == hf.encode(s, add_special_tokens=False)
        assert ours.detokenize(got) == ref.detokenize(got)
    assert (ours.eod, ours.pad, ours.bos) == (ref.eod, ref.pad, ref.bos)


def test_missing_packages_raise_import_error_naming_them(monkeypatch,
                                                         tmp_path):
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="'transformers'"):
        ttok.HFTokenizer("anything")
    monkeypatch.setitem(sys.modules, "sentencepiece", None)
    with pytest.raises(ImportError, match="'sentencepiece'"):
        ttok.SentencePieceTokenizer(str(tmp_path / "tokenizer.model"))


class _CharPiece:
    """A stand-in ``sentencepiece`` processor (one id per character of a
    fixed alphabet), so the two packages' SentencePiece wrappers can be
    compared where the package itself is not installed."""

    ALPHABET = "<>?abcdefghijklmnopqrstuvwxyz |_"

    def __init__(self, model_file=None):
        self.model_file = model_file

    def vocab_size(self):
        return len(self.ALPHABET)

    def encode(self, text):
        return [self.ALPHABET.index(c) if c in self.ALPHABET else 2
                for c in text]

    def decode(self, ids):
        return "".join(self.ALPHABET[i] for i in ids)

    def eos_id(self):
        return 1

    def bos_id(self):
        return 0


def test_sentencepiece_wrapper_matches_jax_on_a_stand_in(monkeypatch):
    """Extra ids (longest first), ``base_vocab_size``, eod / bos and the
    split around special tokens, through both wrappers over the same
    stand-in processor."""
    fake = types.ModuleType("sentencepiece")
    fake.SentencePieceProcessor = _CharPiece
    monkeypatch.setitem(sys.modules, "sentencepiece", fake)
    extra = ["<|im_start|>", "<|im_start|>x", "<|im_end|>"]
    for kind in ("sentencepiece", "sentencepiecetokenizer", "llama"):
        ours = ttok.build_tokenizer(kind, "m.model", extra)
        ref = jtok.build_tokenizer(kind, "m.model", extra)
        assert ours.base_vocab_size == ref.base_vocab_size == 32
        assert ours.vocab_size == ref.vocab_size == 35
        assert (ours.eod, ours.bos) == (ref.eod, ref.bos) == (1, 0)
        for s in ["<|im_start|>xhello<|im_end|> world", "plain text",
                  "<|im_end|><|im_start|>", ""]:
            got = ours.tokenize(s)
            assert got == ref.tokenize(s)
            assert ours.detokenize(got) == ref.detokenize(got)


def test_sentencepiece_model_file():
    """A real ``.model`` file needs the ``sentencepiece`` package (or
    ``transformers`` with it for the slow-to-fast conversion); neither the
    package nor a model file is installed here."""
    pytest.importorskip("sentencepiece")
    pytest.skip("no SentencePiece model file in the repository (ROADMAP "
                "Queue 1 item 12)")


def test_build_tokenizer_dispatch_matches_jax():
    for kind in ("null", "nulltokenizer", "NULL"):
        ours = ttok.build_tokenizer(kind, vocab_size=77)
        ref = jtok.build_tokenizer(kind, vocab_size=77)
        assert type(ours).__name__ == type(ref).__name__ == "NullTokenizer"
        assert ours.tokenize("1 2 300") == ref.tokenize("1 2 300")
        assert ours.eod == ref.eod == 76
    for bad in ("bogus", "gpt3"):
        with pytest.raises(ValueError, match="unknown tokenizer"):
            ttok.build_tokenizer(bad)
        with pytest.raises(ValueError, match="unknown tokenizer"):
            jtok.build_tokenizer(bad)
