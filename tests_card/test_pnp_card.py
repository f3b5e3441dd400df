"""The PnP init's counter on the card: ``pnp_pose_init`` synchronizes as
often with its counter (``models/pnp.py PNP``) recording as with the
counter's stores dropped, and the counter holds Python ints (the host
values the solve reads anyway), so counting adds no synchronization.
Marked ``card``: it skips without a CUDA card.

    python -m pytest tests_card -m card -q
"""

import pytest
import torch


class _Dropped(dict):
    """A counter that keeps nothing it is given."""

    def __setitem__(self, key, value):
        pass


@pytest.mark.card
def test_pnp_counter_adds_no_sync(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    from freesurgs_tpu_torch.data.synthetic import make_nonrigid_scene
    from freesurgs_tpu_torch.models import pnp
    from freesurgs_tpu_torch.models import pose as posemod
    from freesurgs_tpu_torch.ops import raster_cuda as rc
    from freesurgs_tpu_torch.utils.profiling import count_syncs
    rc.build_kernels()
    sc, _ = make_nonrigid_scene(num_frames=3, n_gaussians=3000,
                                height=256, width=320, seed=4,
                                scale_range=(0.01, 0.03), patch_amp=0.08,
                                spec_speed=0.08, device="cuda")
    poses = posemod.PoseTable(quats=sc.gt_quats.clone(),
                              trans=sc.gt_trans.clone())

    def call():
        return posemod.pnp_pose_init(poses, 2, sc.flows_fw[1], sc.depths[1],
                                     poses.w2c(1), sc.cam, seed=9)

    # the first call under the sync debug mode counts a one-time sync of
    # its own (one more than every later call, on the card's machine)
    count_syncs(call)
    pnp.reset_pnp()
    counting = count_syncs(call)
    assert pnp.PNP["calls"] == 1 and pnp.PNP["fallbacks"] == 0
    assert pnp.PNP["hypotheses"] == 100 and pnp.PNP["matches"] == 4000
    assert 6 <= pnp.PNP["inliers"] <= 4000
    assert all(type(v) is int for v in pnp.PNP.values())
    dropped = _Dropped(pnp.PNP)
    monkeypatch.setattr(pnp, "PNP", dropped)
    monkeypatch.setattr(posemod, "PNP", dropped)
    assert count_syncs(call) == counting
