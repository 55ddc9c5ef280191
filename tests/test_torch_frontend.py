"""The port's frontend (text normalisation, pinyin, the native speech
library's binding, TTS, English and Mandarin alignment, concatenative TTS,
dictionary building) against the JAX package's originals on the same seeded
inputs. Every comparison is exact: both sides run the same host arithmetic
(numpy, scipy, the same native code).

The JAX side's native binding is pointed at the port's library (built by
``g++`` from the same ``native/align`` sources into ``build/torch_native``
under a lock), so no test here builds the JAX package's ``native/build``."""

import numpy as np
import pytest
import torch

from text2video_tpu_torch.config import PACKAGED_DATA_DIR

torch.set_num_threads(1)

SR = 16000
EN_TEXT = "She had your dark suit"
ZH_TEXT = "今天天气很好"


@pytest.fixture
def jnative(monkeypatch):
    """The JAX package's ``frontend.native`` loading the port's library."""
    from text2video_tpu.frontend import native as jn

    from text2video_tpu_torch.frontend import native as tn

    path = tn.ensure_built()
    monkeypatch.setattr(jn, "ensure_built", lambda: path)
    monkeypatch.setattr(jn, "_lib", None)
    return jn


def _english_aligners(jnative):
    """(port, JAX) EnglishAligner on the packaged fadg0 model, empty dict."""
    from text2video_tpu.frontend import align_english as jae

    from text2video_tpu_torch.frontend import align_english as tae
    from text2video_tpu_torch.frontend import native as tn

    model = str(PACKAGED_DATA_DIR / "english_fadg0.am")
    return (tae.EnglishAligner(tn.AcousticModel.load(model),
                               tae.PronouncingDict({})),
            jae.EnglishAligner(jnative.AcousticModel.load(model),
                               jae.PronouncingDict({})))


def _mandarin_aligners(jnative):
    from text2video_tpu.frontend import align_mandarin as jam

    from text2video_tpu_torch.frontend import align_mandarin as tam

    model = str(PACKAGED_DATA_DIR / "mandarin_henan.am")
    return tam.MandarinAligner.load(model), jam.MandarinAligner.load(model)


@pytest.mark.parametrize("text", [
    "She had your dark suit in greasy wash water all year.",
    "Call 911, then 42 more!",
    "In 1999 it cost $3,500.75 (roughly).",
    "  spaced   out  -- words; here?",
    "12345678901234567890123 digits",
    "你好，世界！今天是2024年。",
    "“引号”与《书名》——破折号…",
    "mixed 中文 and English 7",
    "",
    "0",
])
def test_textnorm_matches_jax(text):
    from text2video_tpu.frontend import textnorm as jt

    from text2video_tpu_torch.frontend import textnorm as tt

    for strip_spaces in (True, False):
        assert tt.derive_file_name(text, strip_spaces) == \
            jt.derive_file_name(text, strip_spaces)
        assert tt.strip_punct(text, strip_spaces, ascii_too=True) == \
            jt.strip_punct(text, strip_spaces, ascii_too=True)
    assert tt.spell_numbers(text) == jt.spell_numbers(text)
    assert tt.clean_transcript_words(text) == jt.clean_transcript_words(text)


@pytest.mark.parametrize("text", [
    "今天天气很好", "我们一起去公园散步吧", "长大了地上得到", "ABC 2024年〇"])
def test_pinyin_and_walk_stream_match_jax(text):
    from text2video_tpu.frontend import align_mandarin as jam
    from text2video_tpu.frontend import pinyin as jp

    from text2video_tpu_torch.frontend import align_mandarin as tam
    from text2video_tpu_torch.frontend import pinyin as tp

    assert tp.to_pinyin(text) == jp.to_pinyin(text)
    assert tam.expand_walk_stream(text) == jam.expand_walk_stream(text)
    for syl in tp.to_pinyin(text):
        assert tam.pinyin_to_phones(syl) == jam.pinyin_to_phones(syl)


def test_wav_io_and_resample_match_jax(tmp_path):
    from text2video_tpu.frontend import audio as ja

    from text2video_tpu_torch.frontend import audio as ta

    wave = (0.3 * np.sin(np.arange(22050) / 9.0)
            + 0.05 * np.random.RandomState(0).randn(22050)).astype(np.float32)
    ta.save_wav(str(tmp_path / "a.wav"), wave, 22050)
    ja.save_wav(str(tmp_path / "b.wav"), wave, 22050)
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()
    s, sr = ta.load_wav(str(tmp_path / "a.wav"))
    rs, rsr = ja.load_wav(str(tmp_path / "a.wav"))
    assert sr == rsr and np.array_equal(s, rs)
    np.testing.assert_array_equal(
        ta.load_wav_for_alignment(str(tmp_path / "a.wav")),
        ja.load_wav_for_alignment(str(tmp_path / "a.wav")))


def test_native_features_g2p_and_variants_match_jax(jnative):
    from text2video_tpu_torch.frontend import native as tn

    wave = (0.2 * np.sin(np.arange(8000) / 5.0)
            + 0.02 * np.random.RandomState(1).randn(8000)).astype(np.float32)
    for kind in (tn.FEAT_MFCC, tn.FEAT_PLP):
        f = tn.extract_features(wave, SR, kind)
        ref = jnative.extract_features(wave, SR, kind)
        assert f.dtype == ref.dtype == np.float32 and f.shape == ref.shape
        np.testing.assert_array_equal(f, ref)
    for word in ("greasy", "suit", "xylophone", "Qatar", "a"):
        assert tn.g2p(word) == jnative.g2p(word)

    tal, jal = _english_aligners(jnative)
    from text2video_tpu_torch.frontend.tts import FormantTTS

    samples = FormantTTS().synthesize(EN_TEXT, SR)
    segments, _, _ = tal._segments(["she", "had", "your"])
    ref_segments, _, _ = jal._segments(["she", "had", "your"])
    assert segments == ref_segments
    feats = tn.extract_features(samples, SR, tal.model.feat_kind)
    recs, ll = tn.align_variants(tal.model, feats, segments)
    ref_recs, ref_ll = jnative.align_variants(jal.model, feats, segments)
    assert recs == ref_recs and ll == ref_ll
    states = tn.align_frame_states(tal.model, feats, segments)
    for a, b in zip(states, jnative.align_frame_states(jal.model, feats,
                                                        segments)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("text", [EN_TEXT, ZH_TEXT])
def test_formant_tts_matches_jax(jnative, text):
    from text2video_tpu.frontend.tts import FormantTTS as JaxTTS

    from text2video_tpu_torch.frontend.tts import FormantTTS

    out = FormantTTS().synthesize(text, SR)
    ref = JaxTTS().synthesize(text, SR)
    assert out.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(out, ref)


def test_english_aligner_matches_jax(jnative):
    from text2video_tpu_torch.frontend.tts import FormantTTS

    tal, jal = _english_aligners(jnative)
    samples = FormantTTS().synthesize(EN_TEXT, SR)
    out, ref = tal.align(samples, EN_TEXT), jal.align(samples, EN_TEXT)
    assert out.phones.entries == ref.phones.entries
    assert [(w.start, w.end, w.word) for w in out.words] == \
        [(w.start, w.end, w.word) for w in ref.words]
    assert out.phone_times == ref.phone_times
    assert tal.align_states(samples, EN_TEXT).entries == \
        jal.align_states(samples, EN_TEXT).entries


@pytest.mark.parametrize("backend", ["aligner", "energy"])
def test_timestamp_chinese_matches_jax(jnative, backend):
    from text2video_tpu.frontend import timestamp_zh as jzh

    from text2video_tpu_torch.frontend import timestamp_zh as tzh
    from text2video_tpu_torch.frontend.tts import FormantTTS

    samples = FormantTTS().synthesize(ZH_TEXT, SR)
    if backend == "aligner":
        tm, jm = _mandarin_aligners(jnative)
        out = tzh.timestamp_chinese(ZH_TEXT, samples, SR, aligner=tm)
        ref = jzh.timestamp_chinese(ZH_TEXT, samples, SR, aligner=jm)
    else:
        out = tzh.timestamp_chinese(ZH_TEXT, samples, SR,
                                    asr=tzh.EnergySegmenter(n_words=6))
        ref = jzh.timestamp_chinese(ZH_TEXT, samples, SR,
                                    asr=jzh.EnergySegmenter(n_words=6))
        assert tzh.timestamp_chinese(ZH_TEXT, samples, SR).entries == \
            jzh.timestamp_chinese(ZH_TEXT, samples, SR).entries
    assert len(out) == 6 and out.entries == ref.entries


@pytest.mark.parametrize("mode", ["en", "zh"])
def test_concat_tts_matches_jax(jnative, mode):
    from text2video_tpu.frontend.tts_concat import ConcatTTS as JaxConcat

    from text2video_tpu_torch.frontend.tts import FormantTTS
    from text2video_tpu_torch.frontend.tts_concat import ConcatTTS

    if mode == "en":
        texts = ("Do they make it", "She had your dark suit")
        tal, jal = _english_aligners(jnative)
        utts = [(FormantTTS().synthesize(t, SR), t) for t in texts]
        out = ConcatTTS.build_english(utts, tal)
        ref = JaxConcat.build_english(utts, jal)
        say = "Make your dark suit"
    else:
        texts = ("今天天气很好", "我们一起去")
        tm, jm = _mandarin_aligners(jnative)
        utts = [(FormantTTS().synthesize(t, SR), t) for t in texts]
        out = ConcatTTS.build_mandarin(utts, tm)
        ref = JaxConcat.build_mandarin(utts, jm)
        say = "我们今天去公园"
    assert out.coverage() == ref.coverage() and out.target_rms == ref.target_rms
    np.testing.assert_array_equal(out.synthesize(say, SR),
                                  ref.synthesize(say, SR))


def test_dictionaries_build_like_jax(jnative, tmp_path):
    from text2video_tpu import dictbuild as jd
    from text2video_tpu.frontend.timestamps import Timestamps as JaxTs

    from text2video_tpu_torch import dictbuild as td
    from text2video_tpu_torch.frontend.timestamps import Timestamps
    from text2video_tpu_torch.frontend.tts import FormantTTS

    tal, jal = _english_aligners(jnative)
    clips = [(f"sa{i}", FormantTTS().synthesize(t, SR), t)
             for i, t in enumerate(("Do they make it", EN_TEXT))]
    inst = td.collect_instances(clips, tal)
    ref_inst = jd.collect_instances(clips, jal)
    assert [vars(i) for i in inst] == [vars(i) for i in ref_inst]
    entries = td.build_phoneme_dict(inst, max_frame={"sa0": 30})
    assert entries == jd.build_phoneme_dict(ref_inst, max_frame={"sa0": 30})
    td.write_phoneme_dict(entries, str(tmp_path / "a.txt"))
    jd.write_phoneme_dict(entries, str(tmp_path / "b.txt"))
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()

    pairs = ((3, "ni"), (9, "hao"), (15, "ni"), (40, "shi"), (52, "jie"))
    pin = td.build_pinyin_dict(Timestamps(entries=pairs), max_frame=45)
    assert pin == jd.build_pinyin_dict(JaxTs(entries=pairs), max_frame=45)
    assert td.prompt_coverage(["ni", "ma", "shi"], pin) == \
        jd.prompt_coverage(["ni", "ma", "shi"], pin)


def test_native_build_is_cached_and_locked(tmp_path, monkeypatch):
    """A second ensure_built reuses the library; a build into a new
    directory takes the lock, publishes the library by rename and leaves no
    temporary file; a failed build raises with the compiler's message."""
    from text2video_tpu_torch.frontend import native as tn

    path = tn.ensure_built()
    assert tn.ensure_built() == path
    monkeypatch.setattr(tn, "BUILD_ROOT", tmp_path / "root")
    fresh = tn.ensure_built()
    assert fresh != path and fresh.startswith(str(tmp_path))
    files = sorted(p.name for p in (tmp_path / "root").rglob("*") if p.is_file())
    assert files == ["build.lock", "build.log", tn.LIB_NAME]
    monkeypatch.setattr(tn, "CXX_FLAGS", tn.CXX_FLAGS + ("-DT2V_NO_SUCH",
                                                         "-fno-such-flag"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tn.ensure_built()
