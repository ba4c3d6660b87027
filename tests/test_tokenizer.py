"""Tokenizer wrapper tests (hermetic byte fallback always available)."""

import numpy as np

from teal_jax.utils.tokenizer import ByteTokenizer, get_tokenizer


def test_byte_tokenizer_roundtrip():
    t = ByteTokenizer()
    s = "Hello, GPU! éè"
    ids = t.encode(s)
    assert t.decode(ids) == s
    assert t.encode(s, bos=True)[0] == t.bos_id()
    assert t.vocab_size() == 258


def test_get_tokenizer_fallback(tmp_path):
    t = get_tokenizer(None)
    assert isinstance(t, ByteTokenizer)
    t = get_tokenizer(str(tmp_path))  # empty dir -> fallback
    assert isinstance(t, ByteTokenizer)


def test_byte_tokenizer_decode_skips_specials():
    t = ByteTokenizer()
    ids = t.encode("hi", bos=True) + [t.eos_id()]
    assert t.decode(ids) == "hi"
