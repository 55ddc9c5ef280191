"""Pose-synthesis stage: timestamps -> per-frame keypoint tracks (+ JSONs;
counterpart of ``text2video_tpu/pose_stage.py``).

Both branches plan on the host with ``plan_pose_track``. ``device=False``
runs the bit-exact float64 host blend and smoother; ``device=True`` runs the
fused gather + blend + smoothing op (kernel B2 on a card) on the stage's
torch device. With a mesh, the bit-exact smoother runs with the time axis
sharded over the mesh's "data" axis and replicated over its "model" axis
(``smooth_recursive_sharded``), as the JAX package's mesh path does.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional

import numpy as np

from text2video_tpu_torch import device as devices
from text2video_tpu_torch.config import PersonProfile
from text2video_tpu_torch.frontend.timestamps import Timestamps
from text2video_tpu_torch.io.dicts import KeypointTable, PoseDictionary
from text2video_tpu_torch.io.openpose import (
    dumps_keypoint_json,
    raw_with_tracks,
)
from text2video_tpu_torch.ops.fused_pose import synthesize_and_smooth
from text2video_tpu_torch.ops.interp import (
    PosePlan,
    plan_pose_track,
    synthesize_host,
)
from text2video_tpu_torch.ops.smooth import (
    smooth_host,
    smooth_recursive_sharded,
)


@dataclasses.dataclass
class PoseResult:
    """Per-frame tracks of one utterance: interpolated face/pose [T, 210] /
    [T, 75], the smoothed + mouth-re-pinned pair, and the gather plan."""

    face: np.ndarray
    pose: np.ndarray
    face_smooth: np.ndarray
    pose_smooth: np.ndarray
    plan: PosePlan

    @property
    def num_frames(self) -> int:
        return self.face.shape[0]


class PoseStage:
    def __init__(
        self,
        profile: PersonProfile,
        pdict: Optional[PoseDictionary] = None,
        table: Optional[KeypointTable] = None,
        device=None,
    ):
        """``device``: where the fused op runs, the card unless the caller
        names another."""
        self.profile = profile
        self.pdict = pdict or PoseDictionary.load(
            profile.dict_path, profile.keypoint_layout)
        self.table = table or KeypointTable.load_dir(
            profile.keypoints_dir, profile.keypoint_layout)
        self.device = devices.resolve(device)

    def run(self, ts: Timestamps, device: bool = True,
            mesh=None) -> PoseResult:
        """device=True: float32 fused op on ``self.device``; device=False:
        the bit-exact float64 host path. The unsmoothed tracks always come
        from the exact host blend.

        ``mesh`` (``parallel.make_mesh``; every rank calls with the same
        timestamps): the utterance's time axis, padded to a multiple of the
        "data" axis (replicated over "model"), is smoothed by
        ``smooth_recursive_sharded``, whatever ``device`` says, as the JAX
        package's mesh path does: the smoothed tracks are byte-equal to the
        host path's on every rank."""
        plan = plan_pose_track(ts, self.pdict, self.table, self.profile)
        face, pose = synthesize_host(plan, self.table)
        if mesh is not None:
            t = face.shape[0]
            pad = ((0, -t % mesh.n_data), (0, 0))
            face_s, pose_s = smooth_recursive_sharded(
                np.pad(face, pad), np.pad(pose, pad), mesh,
                self.profile.smooth_width, t_valid=t)
            face_s, pose_s = face_s[:t], pose_s[:t]
        elif device:
            face_s, pose_s = synthesize_and_smooth(
                plan, self.table, self.profile.smooth_width, self.device)
            face_s = face_s.cpu().numpy().astype(np.float64)
            pose_s = pose_s.cpu().numpy().astype(np.float64)
        else:
            face_s, pose_s = smooth_host(face, pose, self.profile.smooth_width)
        return PoseResult(face=face, pose=pose, face_smooth=face_s,
                          pose_smooth=pose_s, plan=plan)

    # ---- JSON emission (parity with the reference's per-frame files) ----

    def emit_pose_raws(self, result: PoseResult) -> List[Dict[str, Any]]:
        """Interpolation-stage JSON dicts, frame by frame. Verbatim frames
        re-emit their carrier unchanged (ints stay ints); blended frames
        carry blended face/pose in the carrier's deep copy."""
        out = []
        plan = result.plan
        for t in range(result.num_frames):
            carrier = self.table.raws[int(plan.carrier[t])]
            if plan.verbatim[t]:
                out.append(carrier)
            else:
                out.append(raw_with_tracks(
                    carrier, face=result.face[t], pose=result.pose[t]))
        return out

    def emit_smooth_raws(self, result: PoseResult) -> List[Dict[str, Any]]:
        """Smoothing-stage JSON dicts. The carrier is the interp-stage frame
        JSON; tracks are written as single-element nested lists, matching the
        reference's (1,N)-ndarray ``.tolist()`` output
        (...VidTIMIT_smooth.py:257-258)."""
        return [
            raw_with_tracks(interp_raw, face=result.face_smooth[t],
                            pose=result.pose_smooth[t], nested=True)
            for t, interp_raw in enumerate(self.emit_pose_raws(result))
        ]

    def write_jsons(self, result: PoseResult, pose_dir: str,
                    smooth_dir: Optional[str] = None) -> None:
        os.makedirs(pose_dir, exist_ok=True)
        for t, raw in enumerate(self.emit_pose_raws(result)):
            with open(os.path.join(pose_dir, "%05d.json" % t), "w") as f:
                f.write(dumps_keypoint_json(raw))
        if smooth_dir is not None:
            os.makedirs(smooth_dir, exist_ok=True)
            for t, raw in enumerate(self.emit_smooth_raws(result)):
                with open(os.path.join(smooth_dir, "smooth_%05d.json" % t),
                          "w") as f:
                    f.write(dumps_keypoint_json(raw))
