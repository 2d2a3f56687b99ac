#!/usr/bin/env python
"""Decompose the metric-estimator drift on one frame: tracking vs fitting.

The constant-high distortion drift (SUITE_RESULTS.json: 3 configs >4%) is
estimator-side (tests/fixtures/metric_frame_diff_*: our tracker on the
GOLDEN output differs from the reference tracker on the same frames), and
the reference is bit-deterministic across seeds
(tests/fixtures/reference_seed_variance.json), so the residual is a real
algorithmic difference.  This script isolates WHERE for a single frame
pair (unstabilized frame F, golden cropped frame F) by crossing the two
trackers with the two homography fits:

  dist[cv2 track][cv2 fit]    <- the reference's number for this frame
  dist[cv2 track][our fit]    <- fit difference on identical matches
  dist[our track][cv2 fit]    <- tracking difference under cv2's fit
  dist[our track][our fit]    <- our number for this frame

cv2 branch mirrors /root/reference/meshflowstabilizer.py:455-629 exactly
(per-subframe FAST -> calcOpticalFlowPyrLK -> RANSAC outlier mask ->
global cv2.findHomography least-squares).

Usage: python scripts/diag_metric_decomp.py [clip] [variant] [frame] [seed]
       (defaults: video-10 constant-high 131 0)
"""

import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import cv2
import numpy as np

import meshflow  # noqa: F401  (precision config)
import jax
import jax.numpy as jnp

from meshflow.config import MeshFlowConfig


def decode_frame(path, index):
    cap = cv2.VideoCapture(path)
    cap.set(cv2.CAP_PROP_POS_FRAMES, index)
    ok, frame = cap.read()
    cap.release()
    assert ok, (path, index)
    return frame


def eig_ratio(h):
    a = np.array(h, np.float64).copy()
    a[2] = [0, 0, 1]
    mags = np.sort(np.abs(np.linalg.eigvals(a)))
    return float(mags[-2] / mags[-1])


def cv2_tracker(early_frame, late_frame, config, stages=None):
    """The reference's _get_matched_features_and_homography, verbatim
    semantics (meshflowstabilizer.py:455-629).  `stages`, if a dict, gets
    per-subframe (detected, tracked, inliers) counts and the full
    per-stage point sets for overlap analysis."""
    detector = cv2.FastFeatureDetector_create()
    fh, fw = early_frame.shape[:2]
    sw = math.ceil(fw / config.mesh_outlier_subframe_col_count)
    sh = math.ceil(fh / config.mesh_outlier_subframe_row_count)
    earlies, lates = [], []
    for sx in range(0, fw, sw):
        for sy in range(0, fh, sh):
            esub = early_frame[sy : sy + sh, sx : sx + sw]
            lsub = late_frame[sy : sy + sh, sx : sx + sw]
            kps = detector.detect(esub)
            counts = [len(kps), 0, 0]
            tr_e, tr_l = np.zeros((0, 2)), np.zeros((0, 2))
            if len(kps) >= config.homography_min_number_corresponding_features:
                e = np.float32(cv2.KeyPoint_convert(kps)[:, np.newaxis, :])
                l, st, _ = cv2.calcOpticalFlowPyrLK(esub, lsub, e, None)
                m = st.flatten().astype(bool)
                e, l = e[m], l[m]
                counts[1] = len(e)
                tr_e = e.reshape(-1, 2) + np.float32([sx, sy])
                tr_l = l.reshape(-1, 2) + np.float32([sx, sy])
                if len(e) >= config.homography_min_number_corresponding_features:
                    _, inl = cv2.findHomography(e, l, method=cv2.RANSAC)
                    m = inl.flatten().astype(bool)
                    counts[2] = int(m.sum())
                    earlies.append(e[m] + np.float32([sx, sy]))
                    lates.append(l[m] + np.float32([sx, sy]))
            if stages is not None:
                stages.setdefault("counts", []).append(counts)
                stages.setdefault("tracked_early", []).append(tr_e)
                stages.setdefault("tracked_late", []).append(tr_l)
    early = np.concatenate(earlies).reshape(-1, 2)
    late = np.concatenate(lates).reshape(-1, 2)
    return early, late


def our_tracker(early_frame, late_frame, config, seed, stages=None):
    """Our metric-path matching (XLA tracker on CPU): prepare_frames
    keypoints -> tile-pyramid LK -> per-subframe RANSAC -> MatchResult."""
    from meshflow.motion.features import match_pair, track_pair
    from meshflow.motion.pipeline import (
        packed_tile_pyramids,
        prepare_frames,
        unpack_level,
    )

    fh, fw = early_frame.shape[:2]
    frames = jnp.asarray(np.stack([early_frame, late_frame]))
    kps, _ = prepare_frames(frames, config)
    max_level = config.lk_max_level(fh, fw)
    packed_un = packed_tile_pyramids(frames[:1], config, max_level)
    packed_cr = packed_tile_pyramids(frames[1:], config, max_level)
    kps0 = jax.tree.map(lambda a: a[0], kps)
    un_lv = tuple(unpack_level(pk, 0) for pk in packed_un)
    cr_lv = tuple(unpack_level(pk, 0) for pk in packed_cr)
    match = match_pair(
        kps0, un_lv, cr_lv, jax.random.PRNGKey(seed), config, fh, fw
    )
    if stages is not None:
        late_pos, tracked = track_pair(
            kps0, un_lv, cr_lv, config, fh, fw
        )
        valid = np.asarray(kps0.valid)
        trk = np.asarray(tracked) & valid
        inl2 = np.asarray(match.inlier).reshape(valid.shape)
        for s in range(valid.shape[0]):
            stages.setdefault("counts", []).append(
                [int(valid[s].sum()), int(trk[s].sum()), int(inl2[s].sum())]
            )
            stages.setdefault("tracked_early", []).append(
                np.asarray(kps0.positions)[s][trk[s]]
            )
            stages.setdefault("tracked_late", []).append(
                np.asarray(late_pos)[s][trk[s]]
            )
    inl = np.asarray(match.inlier)
    return (
        np.asarray(match.early)[inl],
        np.asarray(match.late)[inl],
        np.asarray(match.homography),
    )


def our_fit(early, late):
    from meshflow.kernels.homography import estimate_homography

    w = jnp.ones((early.shape[0],), jnp.float32)
    h = estimate_homography(jnp.asarray(early), jnp.asarray(late), w)
    return np.asarray(h)


def main():
    clip = sys.argv[1] if len(sys.argv) > 1 else "video-10"
    variant = sys.argv[2] if len(sys.argv) > 2 else "constant-high"
    frame = int(sys.argv[3]) if len(sys.argv) > 3 else 131
    seed = int(sys.argv[4]) if len(sys.argv) > 4 else 0
    config = MeshFlowConfig()

    unstab = decode_frame(
        f"/root/reference/videos/{clip}/{clip}.m4v", frame
    )
    golden = decode_frame(
        f"/root/reference/videos/{clip}/stabilized-method-{variant}.m4v", frame
    )

    cstages, ostages = {}, {}
    ce, cl = cv2_tracker(unstab, golden, config, stages=cstages)
    oe, ol, oh = our_tracker(unstab, golden, config, seed, stages=ostages)

    h_cc, _ = cv2.findHomography(ce, cl)  # method=0: LS + LM refine
    h_co = our_fit(ce, cl)
    h_oc, _ = cv2.findHomography(oe, ol)
    h_oo = oh

    print(f"{clip}/{variant} frame {frame}: "
          f"cv2 matches={len(ce)}  ours matches={len(oe)}")
    print(f"  dist[cv2 track][cv2 fit] = {eig_ratio(h_cc):.5f}   (reference)")
    print(f"  dist[cv2 track][our fit] = {eig_ratio(h_co):.5f}")
    print(f"  dist[our track][cv2 fit] = {eig_ratio(h_oc):.5f}")
    print(f"  dist[our track][our fit] = {eig_ratio(h_oo):.5f}   (ours)")
    print(f"  cropping 1/(h00*h11): cv2/cv2 {1/(h_cc[0,0]*h_cc[1,1]):.5f}  "
          f"ours/ours {1/(h_oo[0,0]*h_oo[1,1]):.5f}")

    # Per-stage funnel: detected -> LK-tracked -> RANSAC inliers, per
    # subframe, for both trackers, plus tracked-set overlap.  The two
    # trackers visit subframes in different orders (cv2 column-major per
    # the reference loop; ours row-major), so compare sorted totals.
    cc = np.array(cstages["counts"])
    oc = np.array(ostages["counts"])
    print(f"  stage totals  (detected, tracked, inliers):")
    print(f"    cv2  {cc.sum(axis=0).tolist()}   ours {oc.sum(axis=0).tolist()}")

    # Tracked-point overlap: how many of cv2's tracked early points does
    # our tracker also track (within 0.5 px), and how do the flow vectors
    # compare on the common set?
    ce_all = np.concatenate(cstages["tracked_early"]).reshape(-1, 2)
    cl_all = np.concatenate(cstages["tracked_late"]).reshape(-1, 2)
    oe_all = np.concatenate(ostages["tracked_early"]).reshape(-1, 2)
    ol_all = np.concatenate(ostages["tracked_late"]).reshape(-1, 2)
    if len(ce_all) and len(oe_all):
        d2 = ((ce_all[:, None, :] - oe_all[None, :, :]) ** 2).sum(-1)
        j = d2.argmin(1)
        common = d2[np.arange(len(ce_all)), j] < 0.25
        flow_c = cl_all - ce_all
        flow_o = ol_all[j] - oe_all[j]
        dflow = np.linalg.norm(flow_c - flow_o, axis=1)[common]
        print(f"  tracked overlap: {int(common.sum())}/{len(ce_all)} of cv2's "
              f"tracked points also tracked by ours (ours tracks {len(oe_all)})")
        if common.any():
            print(f"  flow agreement on common set: median {np.median(dflow):.3f} px, "
                  f"p90 {np.percentile(dflow, 90):.3f} px, max {dflow.max():.3f} px")


if __name__ == "__main__":
    main()
