"""Token-exact parity of the JAX tokenizer vs the reference CLIP tokenizer.

The reference implementation (open_clip tokenizer) is loaded from
/root/reference at test time purely as an oracle; ftfy is stubbed out (identity)
since the corpus here is clean ASCII where ftfy is a no-op.
"""

import sys
import types

import numpy as np
import pytest

from clip_embeds.text.tokenizer import BPETokenizer, get_tokenizer

CORPUS = [
    "a photo of a cat",
    "A photo of a dog on the left of a table.",
    "an armchair to the right of a mug",
    "The quick brown fox jumps over 12 lazy dogs!!!",
    "it's a photo; isn't it?",
    "a photo of " + "very " * 100 + "long caption",
    "hello   world\twith\nweird   whitespace",
    "Ünïcodé çhāracters résumé naïve",
    "数字 and 中文 mixed with english",
    "emoji 🙂 test 🚀🚀",
    "",
    "punctuation-only !!! ??? ...",
    "a photo of a person under the bed",
    "An apple behind the laptop",
]


@pytest.fixture(scope="module")
def reference_tokenizer():
    import importlib.util

    if "ftfy" not in sys.modules:
        import importlib.machinery
        stub = types.ModuleType("ftfy")
        stub.fix_text = lambda t: t
        stub.__spec__ = importlib.machinery.ModuleSpec("ftfy", None)
        sys.modules["ftfy"] = stub
    path = "/root/reference/open_clip/src/open_clip/tokenizer.py"
    spec = importlib.util.spec_from_file_location("_ref_tokenizer", path)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    except Exception as exc:  # pragma: no cover
        pytest.skip(f"reference tokenizer unavailable: {exc}")
    return mod.SimpleTokenizer()


def test_vocab_layout():
    tok = get_tokenizer()
    assert tok.vocab_size == 49408
    assert tok.sot_token_id == 49406
    assert tok.eot_token_id == 49407


def test_encode_decode_roundtrip():
    tok = get_tokenizer()
    ids = tok.encode("a photo of a cat")
    assert tok.decode(ids).strip() == "a photo of a cat"


def test_parity_ids(reference_tokenizer):
    tok = get_tokenizer()
    for text in CORPUS:
        ours = tok.encode(text)
        theirs = reference_tokenizer.encode(text)
        assert ours == theirs, f"mismatch for {text!r}: {ours} vs {theirs}"


def test_parity_batched(reference_tokenizer):
    tok = get_tokenizer()
    ours = tok(CORPUS)
    theirs = reference_tokenizer(CORPUS).numpy().astype(np.int32)
    assert ours.shape == (len(CORPUS), 77)
    np.testing.assert_array_equal(ours, theirs)


def test_truncation_preserves_eot():
    tok = get_tokenizer()
    out = tok(["word " * 500])
    assert out.shape == (1, 77)
    assert out[0, -1] == tok.eot_token_id
    assert out[0, 0] == tok.sot_token_id


def test_custom_context_length():
    tok = BPETokenizer(context_length=32)
    out = tok(["a photo of a cat"])
    assert out.shape == (1, 32)


# -- cleaning / wrappers / reduction masks ------------------------------------


def test_canonicalize_matches_reference():
    import importlib.machinery
    import sys
    import types

    # stub ftfy like the reference import path expects
    if "ftfy" not in sys.modules:
        stub = types.ModuleType("ftfy")
        stub.fix_text = lambda t: t
        stub.__spec__ = importlib.machinery.ModuleSpec("ftfy", None)
        sys.modules["ftfy"] = stub
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "ref_tok", "/root/reference/open_clip/src/open_clip/tokenizer.py"
    )
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)

    from clip_embeds.text.tokenizer import canonicalize_text, get_clean_fn

    cases = [
        "Hello_World! It's  GREAT.",
        "a{b}c {kept} d", "under_score and CAPS...", "  spaces\teverywhere ",
    ]
    for c in cases:
        assert canonicalize_text(c) == ref.canonicalize_text(c)
    assert canonicalize_text(
        "a {} b {} c!", keep_punctuation_exact_string="{}"
    ) == ref.canonicalize_text("a {} b {} c!", keep_punctuation_exact_string="{}")
    for kind in ("canonicalize", "lower", "whitespace"):
        mine, theirs = get_clean_fn(kind), ref.get_clean_fn(kind)
        for c in cases:
            assert mine(c) == theirs(c)


def test_hf_tokenizer_wrapper(tmp_path):
    from transformers import BertTokenizer

    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "hello", "world", "a", "b"]
    (tmp_path / "vocab.txt").write_text("\n".join(vocab))
    BertTokenizer(str(tmp_path / "vocab.txt")).save_pretrained(str(tmp_path))

    from clip_embeds.text.tokenizer import HFTokenizer

    tok = HFTokenizer(str(tmp_path), context_length=8)
    ids = tok(["Hello  WORLD", "a b"])
    assert ids.shape == (2, 8) and ids.dtype == np.int32
    # bert lowercases; wrapper collapsed the double space first
    assert list(ids[0][:4]) == [2, 4, 5, 3]  # [CLS] hello world [SEP]

    tok2 = HFTokenizer(str(tmp_path), context_length=8, strip_sep_token=True)
    ids2 = tok2("hello world")
    assert 3 not in ids2  # sep stripped


def test_reduction_mask_tokenizers():
    from clip_embeds.text.tokenizer import (
        BPETokenizer,
        get_reduction_mask_fn,
        simple_mask_tokenize,
    )

    tok = BPETokenizer(context_length=10)
    long_text = " ".join(["token"] * 40)
    rng = np.random.default_rng(0)
    out = get_reduction_mask_fn("random")(
        [long_text, "short"], tok, context_length=10, rng=rng
    )
    assert out.shape == (2, 10)
    assert out[0, 0] == tok.sot_token_id and tok.eot_token_id in out[0]
    # short text unharmed: decode row 1 contents
    assert out[1, 0] == tok.sot_token_id

    out2 = simple_mask_tokenize(
        [long_text], tok, context_length=10, rng=np.random.default_rng(1)
    )
    assert out2.shape == (1, 10)
    assert (out2[0] != 0).sum() == 10  # full block kept

    shuf = get_reduction_mask_fn("shuffle")(
        [long_text], tok, context_length=10, rng=np.random.default_rng(2)
    )
    assert shuf.shape == (1, 10)


def test_siglip_tokenizer_missing_file():
    import pytest as _pytest

    from clip_embeds.text.tokenizer import SigLipTokenizer

    with _pytest.raises(FileNotFoundError, match="c4-en"):
        SigLipTokenizer("c4-en")


def _tiny_spm_pieces():
    """A tiny unigram vocab in sentencepiece id order (specials first)."""
    from clip_embeds.text.unigram import CONTROL, NORMAL, UNKNOWN

    words = ["the", "cat", "sat", "on", "mat", "a", "dog", "ran", "to",
             "hat", "rat", "t", "h", "e", "c", "a", "o", "n", "m", "s",
             "d", "g", "r", "▁", "▁the", "▁cat", "▁a",
             "▁s", "at", "he", "ca"]
    pieces = [("<pad>", 0.0, CONTROL), ("</s>", 0.0, CONTROL),
              ("<unk>", 0.0, UNKNOWN)]
    import numpy as np

    r = np.random.default_rng(0)
    for w in words:
        pieces.append((w, float(-r.uniform(1.0, 8.0)), NORMAL))
    return pieces


def test_spm_model_proto_roundtrip(tmp_path):
    from clip_embeds.text.unigram import (
        UnigramTokenizer,
        parse_model_proto,
        write_model_proto,
    )

    pieces = _tiny_spm_pieces()
    blob = write_model_proto(pieces)
    parsed = parse_model_proto(blob)
    assert [(p, t) for p, _, t in parsed] == [(p, t) for p, _, t in pieces]
    np.testing.assert_allclose(           # scores ride a float32 proto field
        [s for _, s, _ in parsed], [s for _, s, _ in pieces], rtol=1e-6
    )

    path = tmp_path / "tiny.model"
    path.write_bytes(blob)
    tok = UnigramTokenizer.from_model_file(str(path))
    assert tok.unk_id == 2 and tok.eos_id == 1 and tok.pad_id == 0
    assert tok.tokenize("the cat")[0].startswith("▁")


def test_spm_unigram_matches_hf_tokenizers_engine():
    """Viterbi parity vs the HF `tokenizers` Rust Unigram model — the exact
    engine behind T5TokenizerFast (reference SigLipTokenizer backend)."""
    tokenizers = pytest.importorskip("tokenizers")
    from tokenizers import Tokenizer, models, normalizers, pre_tokenizers

    from clip_embeds.text.unigram import UNKNOWN, UnigramTokenizer

    pieces = _tiny_spm_pieces()
    ours = UnigramTokenizer(pieces)

    oracle = Tokenizer(models.Unigram(
        [(p, s) for p, s, _ in pieces],
        unk_id=next(i for i, (_, _, t) in enumerate(pieces) if t == UNKNOWN),
        byte_fallback=False,
    ))
    oracle.normalizer = normalizers.NFKC()
    oracle.pre_tokenizer = pre_tokenizers.Metaspace()

    texts = [
        "the cat sat on a mat",
        "a dog ran to the hat",
        "that rat sat",
        "cats eat hats",          # needs single-char fallbacks
        "the",
        "attach据",                # unknown char -> unk id
    ]
    for text in texts:
        got = ours.encode(text)
        expected = oracle.encode(text).ids
        assert got == expected, (text, got, expected,
                                 [pieces[i][0] for i in got],
                                 [pieces[i][0] for i in expected])
    # whitespace collapse is ours to do (the oracle's Precompiled charsmap
    # equivalent): extra spaces change nothing
    assert ours.encode("  the   cat ") == ours.encode("the cat")


def test_siglip_tokenizer_end_to_end(tmp_path):
    from clip_embeds.text.tokenizer import SigLipTokenizer
    from clip_embeds.text.unigram import write_model_proto

    path = tmp_path / "c4-en-tiny.model"
    path.write_bytes(write_model_proto(_tiny_spm_pieces()))
    tok = SigLipTokenizer(str(path), context_length=16)

    out = tok(["The cat sat!", "a dog"])
    assert out.shape == (2, 16) and out.dtype.name == "int32"
    # eos terminates each row, pad id 1 (T5 vocab) fills the rest
    for row in out:
        nz = [i for i, v in enumerate(row) if v == 1]
        assert nz, row  # contains eos/pad id
    # canonicalize_text strips punctuation: "The cat sat!" == "The cat sat"
    same = tok(["The cat sat"])
    assert (out[0] == same[0]).all()

    # truncation leaves room for </s>
    long = tok(["the cat " * 50])
    assert long.shape == (1, 16) and long[0, -1] == 1


def test_syntax_mask_tokenize_matches_reference_algorithm():
    """syntax_mask_tokenize vs an inline oracle of the reference algorithm
    (tokenizer.py:330-389) with an injected deterministic tagger."""
    import numpy as np

    from clip_embeds.text.tokenizer import (
        BPETokenizer,
        get_reduction_mask_fn,
        syntax_mask_tokenize,
    )

    tok = BPETokenizer(context_length=12)
    TAGS = {"red": "JJ", "cat": "NN", "sat": "VBD", "mat": "NN",
            "quickly": "RB", "big": "JJ", "dog": "NN", "ran": "VBD",
            "tree": "NN", "river": "NN", "bank": "NN", "old": "JJ"}

    def tagger(tokens):
        return [(t, TAGS.get(t, "XX")) for t in tokens]

    text = ("the red cat sat quickly on the big mat while the dog ran "
            "around the old tree near a river bank today")

    got = syntax_mask_tokenize([text], tok, pos_tag_fn=tagger)

    # inline oracle (reference semantics): order buckets, stable argsort,
    # keep first ctx-2, restore order, re-tokenize
    words = text.split()
    order = []
    for w, tag in tagger(words):
        if tag.startswith("NN"):
            order.append(1)
        elif tag.startswith("JJ"):
            order.append(2)
        elif tag.startswith("VB"):
            order.append(3)
        else:
            order.append(4)
    ids = sorted(np.argsort(np.asarray(order), kind="stable")[:10].tolist())
    expected_text = " ".join(words[j] for j in ids)
    toks = [tok.sot_token_id] + tok.encode(expected_text) + [tok.eot_token_id]
    if len(toks) > 12:
        toks = toks[:12]
        toks[-1] = tok.eot_token_id
    expected = np.zeros((1, 12), np.int32)
    expected[0, : len(toks)] = toks
    np.testing.assert_array_equal(got, expected)

    # high-priority words survive: cat/mat/dog (nouns) must be in the kept set
    kept = [words[j] for j in ids]
    assert {"cat", "mat", "dog"} <= set(kept)
    assert "quickly" not in kept  # adverb drops first

    # dispatch + offline fallback tagger path
    fn = get_reduction_mask_fn("syntax")
    out = fn([text], tok)
    assert out.shape == (1, 12) and out[0, 0] == tok.sot_token_id
    assert (out == tok.eot_token_id).any()


# -- stdlib pre-tokenizer vs the reference's `regex` pattern ----------------

_SPECIALS = ["<start_of_text>", "<end_of_text>"]
_REGEX_PATTERN = (
    r"""'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""")


@pytest.fixture(scope="module")
def regex_words():
    regex = pytest.importorskip("regex")
    pat = regex.compile("|".join(_SPECIALS) + "|" + _REGEX_PATTERN,
                        regex.IGNORECASE)
    return pat.findall


SCANNER_CORPUS = CORPUS + [
    "<start_of_text>A Photo<END_OF_TEXT> <start_of_textx",
    "it'S they'LL we'VE i'M he'D don'T you'RE 'ſ 'Ss",
    "Kelvin İstanbul ſs ͅxͅ",
    "sep\x1crow\x1dgroup\x1eunit\x1fend  nbsp em　ideo",
    "x² ½ Ⅻ ⅻ ① ٣ ๓ 𝟙 3.14 1,000",
    "!'s ''s '''t a'b' --'ll",
]


@pytest.mark.parametrize("text", SCANNER_CORPUS)
def test_split_words_matches_regex_on_corpus(text, regex_words):
    from clip_embeds.text.tokenizer import split_words

    assert split_words(text, _SPECIALS) == regex_words(text)


def test_split_words_matches_regex_property(regex_words):
    """Any text over the characters this interpreter's Unicode database
    assigns (the `regex` module may carry a newer one)."""
    from hypothesis import given, settings, strategies as st

    from clip_embeds.text.tokenizer import split_words

    chars = st.characters(exclude_categories=("Cs", "Cn"))
    pieces = st.one_of(
        st.text(chars, max_size=8),
        st.sampled_from(_SPECIALS + ["'s", "'T", "'ll", "'Re", " ", "\t",
                                     "ſ", "K", "İ", "ͅ"]))

    @settings(max_examples=400, deadline=None, derandomize=True)
    @given(st.lists(pieces, max_size=12))
    def check(parts):
        text = "".join(parts)
        assert split_words(text, _SPECIALS) == regex_words(text)

    check()


def test_non_ascii_special_tokens_rejected():
    with pytest.raises(ValueError, match="ASCII"):
        BPETokenizer(additional_special_tokens=["<bild>", "<図>"])
