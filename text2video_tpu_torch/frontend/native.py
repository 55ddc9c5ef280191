"""ctypes bindings for the native alignment toolchain (libt2v_align.so;
counterpart of ``text2video_tpu/frontend/native.py``).

The native library replaces the reference's C toolchain roles — HTK HCopy
(feature extraction), HTK HVite (Viterbi forced alignment), and
english2phoneme (G2P) — with a C++ implementation in ``native/align/``.

``ensure_built`` compiles it on first use with ``g++`` directly (the flags
of ``native/CMakeLists.txt``; no cmake or ninja), into
``build/torch_native/<hash of sources and flags>/`` at the root of the
checkout, through ``buildcache.build_library`` (a lock, so concurrent test
workers build once; an atomic rename; a failed build raises with the
compiler's output and nothing falls back).
"""

from __future__ import annotations

import ctypes
import shutil
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from text2video_tpu_torch.buildcache import build_library

_REPO_ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE_DIR = _REPO_ROOT / "native" / "align"
SOURCES = ("feats.cc", "hmm.cc", "g2p.cc", "capi.cc")
BUILD_ROOT = _REPO_ROOT / "build" / "torch_native"
LIB_NAME = "libt2v_align.so"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")

_lib: Optional[ctypes.CDLL] = None


def ensure_built() -> str:
    """Path of ``libt2v_align.so``, compiled from ``native/align`` unless
    this exact build (sources, headers and flags) exists."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: building {LIB_NAME} needs it")
    lib, _ = build_library(
        BUILD_ROOT, LIB_NAME, list(SOURCE_DIR.glob("*.[ch]*")), CXX_FLAGS,
        lambda out: [cxx, *CXX_FLAGS, "-o", str(out),
                     *(str(SOURCE_DIR / s) for s in SOURCES)],
    )
    return str(lib)


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(ensure_built())
        lib.t2v_extract_features.restype = ctypes.c_int
        lib.t2v_extract_features.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.t2v_model_load.restype = ctypes.c_void_p
        lib.t2v_model_load.argtypes = [ctypes.c_char_p]
        lib.t2v_model_create.restype = ctypes.c_void_p
        lib.t2v_model_create.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.t2v_model_feat_kind.restype = ctypes.c_int
        lib.t2v_model_feat_kind.argtypes = [ctypes.c_void_p]
        lib.t2v_model_save.restype = ctypes.c_int
        lib.t2v_model_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.t2v_model_free.argtypes = [ctypes.c_void_p]
        lib.t2v_model_dim.restype = ctypes.c_int
        lib.t2v_model_dim.argtypes = [ctypes.c_void_p]
        lib.t2v_model_num_phones.restype = ctypes.c_int
        lib.t2v_model_num_phones.argtypes = [ctypes.c_void_p]
        lib.t2v_model_phone_name.restype = ctypes.c_char_p
        lib.t2v_model_phone_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.t2v_model_phone_id.restype = ctypes.c_int
        lib.t2v_model_phone_id.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.t2v_align.restype = ctypes.c_int
        lib.t2v_align.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.t2v_align_variants.restype = ctypes.c_int
        lib.t2v_align_variants.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.t2v_align_frame_states.restype = ctypes.c_int
        lib.t2v_align_frame_states.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.t2v_trainer_create.restype = ctypes.c_void_p
        lib.t2v_trainer_create.argtypes = [ctypes.c_void_p]
        lib.t2v_trainer_free.argtypes = [ctypes.c_void_p]
        lib.t2v_trainer_accumulate_global.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.t2v_trainer_finalize_flat_start.argtypes = [ctypes.c_void_p]
        lib.t2v_trainer_accumulate.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.t2v_trainer_update.argtypes = [ctypes.c_void_p]
        lib.t2v_trainer_mixup.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.t2v_g2p.restype = ctypes.c_void_p  # manual decode + free
        lib.t2v_g2p.argtypes = [ctypes.c_char_p]
        lib.t2v_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def _as_float_ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


FEAT_MFCC = 0
FEAT_PLP = 1  # the reference aligner's TARGETKIND (PLP_0_D_A_Z)


def extract_features(
    samples: np.ndarray, sample_rate: int, kind: int = FEAT_MFCC
) -> np.ndarray:
    """Mono float PCM in [-1,1] -> [T, 39] MFCC/PLP_0_D_A_Z features."""
    lib = get_lib()
    samples = np.ascontiguousarray(samples, dtype=np.float32)
    out = ctypes.POINTER(ctypes.c_float)()
    t = ctypes.c_int()
    d = ctypes.c_int()
    rc = lib.t2v_extract_features(
        _as_float_ptr(samples),
        samples.size,
        sample_rate,
        kind,
        ctypes.byref(out),
        ctypes.byref(t),
        ctypes.byref(d),
    )
    if rc != 0:
        raise RuntimeError(f"feature extraction failed: rc={rc}")
    if t.value == 0:
        return np.zeros((0, d.value), np.float32)
    feats = np.ctypeslib.as_array(out, shape=(t.value, d.value)).copy()
    lib.t2v_free(out)
    return feats


def g2p(word: str) -> List[str]:
    """Out-of-dictionary grapheme-to-phoneme (ARPABET, no stress)."""
    lib = get_lib()
    ptr = lib.t2v_g2p(word.encode())
    s = ctypes.cast(ptr, ctypes.c_char_p).value.decode()
    lib.t2v_free(ptr)
    return s.split() if s else []


class AcousticModel:
    """Handle to a native GMM-HMM monophone model set."""

    def __init__(self, handle):
        if not handle:
            raise RuntimeError("null model handle")
        self._h = handle
        lib = get_lib()
        self.dim = lib.t2v_model_dim(self._h)
        self.feat_kind = lib.t2v_model_feat_kind(self._h)
        n = lib.t2v_model_num_phones(self._h)
        self.phones = [
            lib.t2v_model_phone_name(self._h, i).decode() for i in range(n)
        ]
        self._ids = {p: i for i, p in enumerate(self.phones)}

    @classmethod
    def load(cls, path: str) -> "AcousticModel":
        h = get_lib().t2v_model_load(path.encode())
        if not h:
            raise FileNotFoundError(f"cannot load acoustic model: {path}")
        return cls(h)

    @classmethod
    def create(
        cls,
        phones: Sequence[str],
        dim: int = 39,
        states_per_phone: int = 3,
        feat_kind: int = FEAT_MFCC,
    ) -> "AcousticModel":
        names = "\n".join(phones).encode()
        return cls(
            get_lib().t2v_model_create(
                names, dim, states_per_phone, feat_kind
            )
        )

    def save(self, path: str) -> None:
        rc = get_lib().t2v_model_save(self._h, path.encode())
        if rc != 0:
            raise RuntimeError(f"cannot save model to {path}")

    def phone_id(self, name: str) -> int:
        return self._ids.get(name, -1)

    def __del__(self):
        try:
            get_lib().t2v_model_free(self._h)
        except Exception:
            pass

    def align(
        self,
        feats: np.ndarray,
        phone_ids: Sequence[int],
        skippable: Sequence[bool],
    ) -> Tuple[np.ndarray, np.ndarray, float]:
        """Viterbi-align feats [T,D] against the phone sequence.

        Returns (starts, ends, loglik); frames, end-exclusive; -1 for
        skipped phones.
        """
        lib = get_lib()
        feats = np.ascontiguousarray(feats, dtype=np.float32)
        n = len(phone_ids)
        ids = np.asarray(phone_ids, np.int32)
        skip = np.asarray(skippable, np.uint8)
        starts = np.zeros(n, np.int32)
        ends = np.zeros(n, np.int32)
        ll = ctypes.c_double()
        rc = lib.t2v_align(
            self._h,
            _as_float_ptr(feats),
            feats.shape[0],
            feats.shape[1],
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            skip.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            n,
            starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            ends.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            ctypes.byref(ll),
        )
        if rc != 0:
            raise RuntimeError(f"alignment failed: rc={rc}")
        return starts, ends, ll.value


def _int_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def align_variants(
    model: "AcousticModel",
    feats: np.ndarray,
    segments: Sequence[Tuple[List[List[int]], bool]],
):
    """Pronunciation-variant forced alignment.

    segments: list of (variants, skippable) where variants is a list of
    phone-id lists (parallel lattice paths; the best-scoring one wins,
    like HVite with dictionary alternatives).

    Returns (records, loglik) where each record is
    (segment_idx, variant_idx, phone_pos, phone_id, start_frame, end_frame).
    """
    lib = get_lib()
    feats = np.ascontiguousarray(feats, dtype=np.float32)
    seg_nv = np.asarray([len(v) for v, _ in segments], np.int32)
    seg_skip = np.asarray([1 if s else 0 for _, s in segments], np.uint8)
    var_lens = np.asarray(
        [len(ids) for v, _ in segments for ids in v], np.int32
    )
    flat_ids = np.asarray(
        [pid for v, _ in segments for ids in v for pid in ids], np.int32
    )
    cap = int(var_lens.sum()) + 8
    outs = [np.zeros(cap, np.int32) for _ in range(6)]
    n_out = ctypes.c_int()
    ll = ctypes.c_double()
    rc = lib.t2v_align_variants(
        model._h,
        _as_float_ptr(feats),
        feats.shape[0],
        feats.shape[1],
        len(segments),
        _int_ptr(seg_nv),
        seg_skip.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        _int_ptr(var_lens),
        _int_ptr(flat_ids),
        cap,
        *[_int_ptr(o) for o in outs],
        ctypes.byref(n_out),
        ctypes.byref(ll),
    )
    if rc != 0:
        raise RuntimeError(f"variant alignment failed: rc={rc}")
    n = n_out.value
    records = [
        tuple(int(outs[f][k]) for f in range(6)) for k in range(n)
    ]
    return records, ll.value


def align_frame_states(
    model: "AcousticModel",
    feats: np.ndarray,
    segments: Sequence[Tuple[List[List[int]], bool]],
):
    """Per-frame best-path positions: arrays (phone_id, state, segment,
    phone_pos) each of length T."""
    lib = get_lib()
    feats = np.ascontiguousarray(feats, dtype=np.float32)
    t = feats.shape[0]
    seg_nv = np.asarray([len(v) for v, _ in segments], np.int32)
    seg_skip = np.asarray([1 if s else 0 for _, s in segments], np.uint8)
    var_lens = np.asarray(
        [len(ids) for v, _ in segments for ids in v], np.int32
    )
    flat_ids = np.asarray(
        [pid for v, _ in segments for ids in v for pid in ids], np.int32
    )
    outs = [np.zeros(t, np.int32) for _ in range(4)]
    ll = ctypes.c_double()
    rc = lib.t2v_align_frame_states(
        model._h,
        _as_float_ptr(feats),
        t,
        feats.shape[1],
        len(segments),
        _int_ptr(seg_nv),
        seg_skip.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        _int_ptr(var_lens),
        _int_ptr(flat_ids),
        *[_int_ptr(o) for o in outs],
        ctypes.byref(ll),
    )
    if rc != 0:
        raise RuntimeError(f"frame-state alignment failed: rc={rc}")
    return tuple(outs)


class Trainer:
    """Flat-start Viterbi training driver for :class:`AcousticModel`."""

    def __init__(self, model: AcousticModel):
        self.model = model
        self._h = get_lib().t2v_trainer_create(model._h)

    def __del__(self):
        try:
            get_lib().t2v_trainer_free(self._h)
        except Exception:
            pass

    def accumulate_global(self, feats: np.ndarray) -> None:
        feats = np.ascontiguousarray(feats, dtype=np.float32)
        get_lib().t2v_trainer_accumulate_global(
            self._h, _as_float_ptr(feats), feats.shape[0], feats.shape[1]
        )

    def finalize_flat_start(self) -> None:
        get_lib().t2v_trainer_finalize_flat_start(self._h)

    def accumulate(
        self,
        feats: np.ndarray,
        phone_ids: Sequence[int],
        skippable: Sequence[bool],
        uniform: bool,
    ) -> None:
        feats = np.ascontiguousarray(feats, dtype=np.float32)
        ids = np.asarray(phone_ids, np.int32)
        skip = np.asarray(skippable, np.uint8)
        get_lib().t2v_trainer_accumulate(
            self._h,
            _as_float_ptr(feats),
            feats.shape[0],
            feats.shape[1],
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            skip.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            len(phone_ids),
            1 if uniform else 0,
        )

    def update(self) -> None:
        get_lib().t2v_trainer_update(self._h)

    def mixup(self, target_mixes: int) -> None:
        get_lib().t2v_trainer_mixup(self._h, target_mixes)
