"""Fused pose synthesis (plain version) and the port's PoseStage on the
golden-derived table, dictionary and timestamps."""

import numpy as np
import pytest
import torch

from text2video_tpu.ops.interp import plan_pose_track, synthesize_host
from text2video_tpu.ops.smooth import smooth_host
from text2video_tpu_torch.golden import golden_pose_inputs
from text2video_tpu_torch.ops import fused_pose as tfp
from text2video_tpu_torch.pose_stage import PoseStage

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def inputs():
    profile, pdict, table, ts = golden_pose_inputs(n_frames=200, seed=3)
    return profile, pdict, table, ts, plan_pose_track(ts, pdict, table, profile)


def test_golden_inputs_plan_the_requested_length(inputs):
    profile, pdict, table, ts, plan = inputs
    assert len(table) == 87 and plan.num_frames == 200
    assert set(s for _, s in ts) <= set(pdict.entries)
    assert (~plan.verbatim).any()  # some frames are blends


def test_synthesize_and_smooth_matches_host(inputs):
    profile, _, table, _, plan = inputs
    ref_f, ref_p = smooth_host(*synthesize_host(plan, table),
                               profile.smooth_width)
    before = tfp.launches
    face, pose = tfp.synthesize_and_smooth(plan, table, profile.smooth_width,
                                           device="cpu")
    assert tfp.launches == before  # CPU tensors take the plain version
    assert face.shape == (200, 210) and pose.shape == (200, 75)
    np.testing.assert_allclose(face.numpy(), ref_f, atol=2e-3, rtol=0)
    np.testing.assert_allclose(pose.numpy(), ref_p, atol=2e-3, rtol=0)


def test_synthesize_and_smooth_matches_jax_pallas(inputs):
    from text2video_tpu.io.dicts import KeypointTable as JaxTable
    from text2video_tpu.ops.fused_pose import synthesize_and_smooth_pallas

    profile, _, table, _, plan = inputs
    jtable = JaxTable(table.face, table.pose, table.hands, table.has_hands,
                      table.raws, table._index)
    ref_f, ref_p = synthesize_and_smooth_pallas(plan, jtable,
                                                profile.smooth_width)
    face, pose = tfp.synthesize_and_smooth(plan, table, profile.smooth_width,
                                           device="cpu")
    # Coordinates reach ~500 px, where one f32 ulp is 3e-5, and the two
    # sides round differently (XLA fuses the blend and the window sum into
    # FMAs): 1e-5 plus 1e-6 of the value, i.e. a few ulps.
    np.testing.assert_allclose(face.numpy(), ref_f, atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(pose.numpy(), ref_p, atol=1e-5, rtol=1e-6)


def test_synthesize_and_smooth_rejects_bad_rows(inputs):
    profile, _, table, _, plan = inputs
    bad = type(plan)(i1=plan.i1.copy(), i2=plan.i2, w2=plan.w2,
                     carrier=plan.carrier, verbatim=plan.verbatim)
    bad.i1[3] = len(table)
    with pytest.raises(IndexError):
        tfp.synthesize_and_smooth(bad, table, profile.smooth_width,
                                  device="cpu")


@pytest.mark.parametrize("device", [False, True])
def test_pose_stage_run(inputs, device):
    profile, pdict, table, ts, plan = inputs
    stage = PoseStage(profile, pdict, table, device="cpu")
    res = stage.run(ts, device=device)
    face, pose = synthesize_host(plan, table)
    ref_f, ref_p = smooth_host(face, pose, profile.smooth_width)
    np.testing.assert_array_equal(res.face, face)
    np.testing.assert_array_equal(res.pose, pose)
    assert res.face_smooth.dtype == np.float64 and res.num_frames == 200
    atol = 2e-3 if device else 0.0
    np.testing.assert_allclose(res.face_smooth, ref_f, atol=atol, rtol=0)
    np.testing.assert_allclose(res.pose_smooth, ref_p, atol=atol, rtol=0)
