#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (imcui_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which passes or ends the run with a non-zero exit:
  0. the card's name and power limit, the versions, the kernels' build;
  1. every CUDA kernel at the shapes the three paths below give it, held
     against its plain PyTorch version, timed beside it, beside a PyTorch
     library call of the same function where one exists (for attention,
     SDPA on a 4-D view on the fused backend that takes it), and beside the
     least time the card could take (its bound); the SASS of K5's float32
     kernels must hold cp.async copies, and that of K14, K5's bf16 kernels,
     K1 and the stem wgmma and TMA loads (cuobjdump); K1's, K2's and the
     stem's queued times, launch plans, registers and spills are logged;
     K2 is held to exact equality on uniform and tie-heavy heatmaps at
     each of its shapes, its bound beside its operations count;
  2. serving: TurboMatcher(device="cuda") at the flagship configuration
     answers concurrent requests (synthetic textured images and their
     warps under known homographies); the kernels' launch counters must
     have advanced as the path runs them, and the verified matches must
     agree with the planted homographies;
  3. timing of match_step at bench.py's operating point: pairs/s, the
     per-stage split, and a short profiler window (device time by kernel,
     device idle share);
  4. the general matching path: ImageMatchingAPI(device="cuda") with the
     registry's superpoint_inloc + superpoint-lightglue (adaptive depth)
     at 4096 keypoints answers requests on 1600x1200 planted pairs, one
     more at 1024 keypoints and one through each route of SuperPoint's
     stem; the same gate, the launch counters of all six kernels, the
     per-stage times, the device's idle share and the host cost of the
     adaptive loop; then one request at nms_radius 2, outside K2's gate,
     which must pass the gate and launch no K2;
  5. the dense path at full width: ImageMatchingAPI(device="cuda") with the
     registry's roma (DINOv2 ViT-L/14 at 560x560, GP, anchor decoder, five
     conv refiners) in float32 and in bfloat16, on seeded random weights
     (the trained checkpoints are not in the repository, so the planted-
     homography gate is not applied here): finite outputs of the expected
     shape, 48 launches of the q-tiled attention kernel per bf16 request
     and 48 of the fused one per f32 request, the GP posterior of an
     identical pair, the card against the CPU on a cut DINOv2 and one
     refiner scale, bf16 against f32, per-stage times and the idle share;
  6. the stage-tail probes (imcui_tpu_torch.tools.tail_probes, the port of
     the JAX package's tools/ scripts of kernels K8-K13) at the scripts'
     full shapes through the tap-sum kernel, bf16 and int8: its SASS must
     hold wgmma and TMA loads and stores (cuobjdump); every probe held
     against its plain version, timed beside its bound and one cuBLAS call
     of the same function; the log names the kernel's first design's time
     (a constant from commit 35980e0, kept out of the kernels line);
  7. the LoFTR dense path: ImageMatchingAPI(device="cuda") with the
     registry's loftr (640x480 forced, 2000 match slots, threshold 0.2) on
     the tree trained in the repository, which the offline route must find,
     in bf16 and f32 on planted 1600x1200 pairs: the planted-homography
     gate on every pair, the card against the port's CPU run (IoU of the
     valid coarse pairs), ms per request, per-stage CUDA-event times and
     the idle share; then one request of each LoFTR-family matcher
     (eloftr, se2loftr, xoftr, aspanformer, topicfm, matchformer, the
     four LoMa confs, jamma, rdd_dense), of the sparse rdd(sparse) and of
     RoMa's fpn-corr backbone at their registry confs on seeded random
     weights, each held to finite outputs and to its CPU run. This path
     launches none of the hand-written kernels;
  8. the user surfaces: the HTTP server (api/server.py) on the packaged
     api.yaml (bf16 SuperPoint at 1024 keypoints, mutual nearest neighbour,
     RANSAC) on a free port of 127.0.0.1 answers planted 1600x1200 pairs
     that the client (api/client.py) sends as PNG files: GET / and
     /version, the 404, the gate on every pair, K1 and K2 launched on every
     request, the time at the client and inside the server (PNG decode,
     ImageMatchingAPI, JSON encode), the sizes, device busy and idle share,
     the multipart route against the JSON route, the card against the CPU
     service, a JPEG body at the service's own conf (its answer equal to
     that of the PNG of PIL's decode of it), /v1/extract and the 500
     envelope, a truncated JPEG among its bodies (500 naming JPEG); then the CLI in subprocesses from the repository
     root: --version, match with the default superpoint+lightglue (PNG
     files) and with superpoint+mnn (JPEG files; the printed line and the
     pickle's keys), and serve on a free port until it answers a match
     request, each timed from process start;
  9. pose and evaluation: the planted relative-pose chain (fundamental
     RANSAC, essential, cheirality) on 3 synthetic scenes and PnP on a
     planted scene; `eval pose` on the flagship (superpoint+lightglue,
     subpixel) in a subprocess over synthetic-pose pairs of textured
     photos, held to the JAX tests' AUC@20 and median bars; the same pairs
     in this process as the main path (its kernels against their plain
     versions on its arguments, launch counts, seconds per pair, device
     busy and idle share), against the port's CPU run (raw-match IoU) and
     through loftr; evaluate_warp on the trained flagship;
 10. the sparse zoo: ImageMatchingAPI(device="cuda") at the API's
     defaults on one planted 1600x1200 pair each, seeded random trees but
     for SuperPoint's: the packaged app.yaml's superglue,
     superpoint+adalam, disk, alike, aliked+lightglue, xfeat(sparse),
     xfeat(dense), dedode and rord, the root config/app.yaml's
     xfeat+lightglue, superpoint+sphereglue, d2net, sfd2+imp and sfd2+mnn,
     and the registry's disk + sgmnet (ALIKED and the standalone
     xfeat+lightglue serve 4096 slots, so LightGlue's self-attention takes
     K5): finite outputs, every kernel launch of a request held against
     its plain version on the request's tensors (the stem kernel, K1 and
     K2 for the SuperPoint entries, K5 and K4 for the LightGlue entries),
     the counts of three timed requests (a kernel launched and not held
     fails; K5 and K4 once each per LightGlue layer run), ms per request,
     device busy and idle share, the ATen operations of a request and
     their float32 bound, the card against the port's CPU run (keypoints,
     descriptors, raw matches with the random learned matchers at
     threshold 1e-6, the graph matchers also on the card's inputs,
     SuperGlue's log assignment; DeDoDe at resize_max 320, D2-Net, RoRD,
     DISK, ALIKE, ALIKED and DISK + SGMNet at 640 on both devices), and
     superpoint+adalam's planted-pair gate on three pairs beside the JAX
     package's CPU numbers;
 11. SIFT's stages on the card against the port's CPU run;
 12. the rest of the zoo: REKD (the registry's rekd with mutual nearest
     neighbour) and the root config/app.yaml's raco+lightglue through
     phase 10's loop (K3 and K4 held and counted, keypoints equal to the
     CPU's); DUSt3R and MASt3R at the registry's conf and full ViT-L
     width, in float32 (no kernel) and in bfloat16 with vit.ATTN_IMPL =
     "fused" (every block through K14, 96 launches a request, each held
     against its plain version), ms per request, device busy and idle
     share, the card against the CPU at resize_max 224; DKM at the
     registry's conf and at coarse_res (544, 704), timed, the card against
     the CPU on the warp and certainty;
 13. the line matchers, LISRD and the wrappers on RoMa: the packaged
     gluestick (bf16 SuperPoint, LSD restated in ops/lsd.py, mutual NN and
     the line vote) and lisrd, the root config/app.yaml's
     LISRD+SuperPoint, LISRD+ALIKED, LISRD+SIFT, dad(RoMa) and RoMaV2, and
     the registry's sold2, each on a planted 1600x1200 pair: every stem,
     K1 and K2 launch (and DaD's 96 K3 launches a request) held against
     its plain version and counted, ms per request, device busy and idle
     share, the card against the port's CPU run on the served request
     (LSD's segments equal, lines as sets, keypoints, raw matches; the
     float32 warps of DaD's RoMa and of RoMaV2 cell by cell); then LSD's
     stages on a 1024x768 view, card against CPU, each stage's device and
     wall time, and gluestick's planted gate on three pairs beside the JAX
     package's CPU numbers (inliers, median transfer error, the share of
     matched lines within N_LINE_PX of their match's line);
 14. the root config/app.yaml's last matchers and the global
     descriptors: omniglue (bf16 SuperPoint, a float32 ViT, the DINO-biased
     attention), mickey, and the disabled cotr and Example, by their conf,
     each on a planted 1600x1200 pair through phase 13's loop (OmniGlue's
     stem, K1 and K2 launches held against their plain versions and
     counted, ms per request, device busy and idle share), against the
     port's CPU run (raw matches, OmniGlue's keypoints, MicKey's pose,
     COTR's decoder passes); then the registry's seven retrieval confs
     (netvlad, openibl, cosplace, eigenplaces, dir, fire, fire_local)
     through extract() at resize_max 1024, each timed and held to its CPU
     run (cosine and max abs error; FIRe-local's features as a set);
 15. the batch pipelines through the port's own HDF5 files
     (utils/h5lite.py) on six 1024x768 PNG views of three planted pairs
     in a temporary directory: extract_features.main (superpoint_aachen),
     pairs_from_exhaustive, match_features.main (superpoint-lightglue),
     extract_features.main (netvlad) and pairs_from_retrieval, and
     match_dense.main (loftr) over the planted pairs. Every launch of the
     run (the stem, K1, K2, K3 or K5, K4) held against its plain version
     and counted; each file against the same models in memory on the
     card, the planted gate on the sparse and the dense match files, the
     retrieval pairs against the CPU's top-k; a second, timed run (ms per
     image and per pair, device busy and idle share); scipy's version;
 16. SfM and localisation on those files, served through SfmEngine:
     six 1600x1200 PNG views of one textured image under planted
     homographies at the engine's defaults (bf16 SuperPoint at 4096
     keypoints, mutual NN, the device RANSAC at 1024 hypotheses and 4 px),
     the stem, K1 and K2 launched once a view and every launch held
     against its plain version, the database against the engine's files,
     the planted gate on every pair's verified matches; the retrieval
     branch (netvlad) against the CPU's pairs; reconstruction.main and
     triangulation.main on a planted non-planar scene, the card's
     verified sets against the CPU's and the planted; localize_sfm.main
     and localize_inloc's PnP against the CPU and the planted pose; a
     second run timed stage by stage (ms per image, pair and query,
     device busy and idle share);
 17. JPEG on the card, read by the port's decoder (utils/jpeg.py and the
     host library csrc/host/jpeg_decode.cpp, built with c++ on first use):
     PIL's q95 files of a colour 1600x1200 textured view (4:2:0, 4:4:4,
     progressive, EXIF orientation 6) equal PIL's decode bit for bit
     (read_image after ImageOps.exif_transpose, the HTTP route without
     it; gray the Y plane of PIL's draft("YCbCr")); the median of 5
     decodes of the 4:2:0 file by the port and by PIL on the host, the
     port at most 4x PIL's; SfmEngine.call (extract_features.main,
     match_features.main, reconstruction up to verification) on six JPEG
     views of phase 16's planted scene, the stem, K1 and K2 launched once
     a view and every launch held against its plain version, its
     keypoints and matches equal to the same run's on PNG copies of PIL's
     gray decode, the planted gate; phase 8's JPEG checks reported;
 18. the serving precisions: W8A8 (precision "int8") through
     ImageMatchingAPI(device="cuda") for the registry's duster, mast3r and
     roma at full width, roma also and dkm at int8_conv_min_ch 256 (DKM
     has no linear), on a planted 1600x1200 pair: the W8A8 linear and
     convolution kernels (csrc/w8a8.cu) launched as often as the
     quantised tree implies and each launch equal to its plain version
     bit for bit (and the K14 launches of the ViT blocks held), ms a
     request and device busy beside the same entry in bf16 in turns, the
     int8 maps against the bf16 maps, the card against the CPU on a copy
     of the card's tree; then LightGlue in bf16 at the flagship (4 planted
     pairs, 1024 keypoints, 9 layers, the trained tree): K3 and K4
     launched in bf16 9 times each, every launch held against its plain
     version, the planted gate on the bf16 and the float32 matches, their
     IoU and both times; last the new kernels' times (the W8A8 linear and
     convolution, K3 and K4 in bf16) beside their plain versions, library
     calls and bounds.
Near the end it prints one JSON line {"timing": ...}, one {"kernels":
[...]} and the card's name and power limit; the last line is {"ok": true,
"device": {...}}. Without a CUDA device, or without the rest of the
repository beside it, the script fails before printing any result.
"""

import contextlib
import json
import os
import platform
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# Published dense peaks (NVIDIA data sheets): bf16 tensor-core FLOP/s,
# float32 non-tensor FLOP/s, int8 tensor-core OP/s (half of each sheet's
# figure with sparsity), HBM bytes/s.
PEAKS = {
    "sxm": {"bf16": 989e12, "fp32": 67e12, "int8": 1979e12, "bw": 3.35e12},
    "pcie": {"bf16": 756e12, "fp32": 51e12, "int8": 1513e12, "bw": 2.0e12},
    "nvl": {"bf16": 835e12, "fp32": 60e12, "int8": 1671e12, "bw": 3.9e12},
}

# Serving configuration (the flagship) and bench.py's operating point.
CANVAS, MAX_KPTS, N_LAYERS, BATCH, HYPOTHESES = 1024, 1024, 9, 4, 512
HEADS = 4
# Gate on the planted homographies, per request: set from the JAX
# package's result on such a pair on the CPU (PERF.md, "serving gate").
GATE_MEDIAN_PX = 2.0
GATE_MIN_INLIERS = 50
# Original sizes of the requests: none a multiple of 8, so the area
# resize runs; the first is larger than the canvas.
REQUEST_SIZES = [(1203, 901), (1003, 757), (997, 1013), (851, 643)]
N_REQUESTS, N_THREADS = 8, 4
# The general path (phase 4): the registry's localisation operating point.
G_FEATURE, G_MATCHER, G_KPTS = "superpoint_inloc", "superpoint-lightglue", 4096
G_SIZES = [(1600, 1200), (1600, 1200), (1923, 1443)]   # the last is resized
G_CANVAS = (1280, 2048)      # (H, W) bucket of a 1600x1200 image
G_MIN_KEYPOINTS = 1024       # each view must hold more than the turbo path's
# The trained detector's serving threshold (TurboMatcher's): the synthetic
# images then hold 1600 to 3300 keypoints in the 4096 slots, about half as
# many under the API's default of 0.015.
G_DETECT_THRESHOLD = 0.0005
# The dense path (phase 5): the registry's roma entry at its published
# widths; requests of these original sizes (its preprocessing forces
# 320 x 240, the model resizes to 560 x 560).
D_MATCHER = "roma"
D_SIZES = [(640, 480), (1203, 901), (800, 600)]
D_TOKENS, D_HEADS, D_BLOCKS = 1601, 16, 24    # ViT-L/14 at 560 x 560
D_GP_BOUND = 0.15            # identical pair: max |posterior - target|
# Card against CPU, float32, relative to the largest value (measured 2e-6
# to 4e-6: sums in another order on another device), and bf16 against f32
# on the card (random weights turn a rounding difference into another
# anchor for single cells, so the bound is on the median and loose:
# measured 0.16).
D_CPU_TOL = 5e-5
D_BF16_MEDIAN_WARP = 0.25
# The stage-tail probes (phase 6): inputs from this seed.
P_SEED = 0
# The LoFTR dense path (phase 7): the registry's loftr entry (640 x 480
# forced, 2000 slots, threshold 0.2) on the tree trained in the repository,
# in bf16 (its default) and f32, on planted pairs of this size (the general
# path's gate: GATE_MIN_INLIERS, GATE_MEDIAN_PX).
L_MATCHER = "loftr"
L_SIZE = (1600, 1200)
L_SEEDS = (700, 701, 702)
L_TRAINED = os.path.join("weights", "loftr_selftrained.npz")
SP_TRAINED = os.path.join("weights", "superpoint_adapted.npz")
LG_TRAINED = os.path.join("weights", "lightglue_selftrained.npz")
# Card against the port's CPU run on one pair: the IoU of the sets of valid
# coarse (idx0, idx1) pairs must reach this (measured on an H100: f32 1.0,
# bf16 0.991 and 0.993, where cuDNN and oneDNN round the bf16 trunk in
# other places).
L_COARSE_IOU = {"fp32": 0.99, "bf16": 0.97}
# The LoFTR family at its registry confs on seeded random weights, one
# request each; card against CPU on that request's inputs: at least
# L_FAMILY_NEAR of the coarse tokens within L_FAMILY_TOL of the largest (an
# aspanformer flow that rounds to another cell moves a span), and, at a
# threshold that keeps matches on the random tree at 640 x 480
# (aspanformer's and topicfm's keep one mutual pair at any threshold), the
# IoU of the valid image-0 points (the same within L_FAMILY_PX) at least
# L_FAMILY_IOU and the median |image-1 point difference| over the common
# ones at most L_FAMILY_PX.
L_FAMILY = {"eloftr": 1e-3, "se2loftr": 1e-3, "xoftr": 0.3,
            "aspanformer": 0.2, "topicfm": 0.2, "matchformer": 1e-6,
            "loma-b": 1e-4, "loma-l": 1e-4, "loma-g": 1e-4, "loma-r": 1e-4,
            "jamma": 1e-6, "rdd_dense": 1e-7}
# ... and the sparse rdd(sparse) zoo entry (the rdd extractor on a seeded
# random tree with mutual NN): the card against the CPU on view 0's
# extraction, the IoU of the valid keypoints (the same within L_FAMILY_PX)
# at least L_RDD_IOU and their descriptors within L_RDD_DESC (set from an
# H100 reading of IoU 0.9942 and descriptors within 5.07e-7: a bf16
# descriptor head would err by ~1e-4).
L_RDD_IOU = 0.98
L_RDD_DESC = 1e-5
L_FAMILY_TOL = 1e-4
L_FAMILY_NEAR = 0.99
L_FAMILY_IOU = 0.9
L_FAMILY_PX = 0.01
# ... and RoMa's fpn-corr backbone at the registry's roma entry: card
# against CPU on the warp, in normalised units, and the certainty.
L_FPN_TOL = 1e-3
# The user surfaces (phase 8): the HTTP server on the packaged api.yaml
# (bf16 SuperPoint, 1024 keypoints at resize_max 1024, mutual NN) answers
# planted pairs of this size sent as PNG files by the client (the general
# path's gate: GATE_MIN_INLIERS, GATE_MEDIAN_PX); card against the port's
# CPU service on the first pair: the IoU of the raw match sets (a match
# common where both points lie within S_TOL_PX) must reach S_IOU (bf16
# SuperPoint rounds in other places on the two devices).
S_SEEDS = (100, 101, 102)
S_SIZE = (1600, 1200)
S_IOU, S_TOL_PX = 0.9, 0.5
S_EXTRACT_KPTS = (256, 512)
# The kernels of the served request: bf16 SuperPoint's stage 1 (the stem
# kernel), stage 2 (K1) and its NMS (K2), once per view.
SERVED_KERNELS = ("stem_tail", "stage_tail", "nms_cellmax")
# Pose and evaluation (phase 9). (a) The planted chain of
# tests/test_pose_eval.py:29-56 (3 scenes at 640 x 480, 0.75 px, 2048
# hypotheses) must close to under E_CHAIN_DEG; PnP on test_ops_pnp.py's
# scene must recover R within E_PNP_DEG and t within E_PNP_T. (b, c) A
# corpus of E_CORPUS textured photos at 480 x 640, E_POSES pose draws each
# (eval/synthpose, seed 0), through `eval pose` (the flagship,
# superpoint+lightglue with subpixel peaks) and through evaluate_matcher
# on loftr, RANSAC at 1.5 px: each held to tests/test_pose_eval.py's bars
# (AUC@20 >= 0.5 and median error <= 10 degrees). The JAX package on the
# CPU clears them on these pairs: E_JAX_CPU (tests/jax_eval_reference.py;
# 12 pairs), reported beside.
E_CHAIN_DEG = 1.5
E_PNP_DEG, E_PNP_T = 2.0, 0.2
E_CORPUS = (900, 901, 902, 903)
E_POSES = 3
E_SIZE = (480, 640)
E_RANSAC_PX = 1.5
E_AUC20_MIN, E_MEDIAN_MAX = 0.5, 10.0
E_JAX_CPU = {
    "superpoint+lightglue": {"auc@5": 0.6123, "auc@10": 0.7478,
                             "auc@20": 0.8322, "median_err_deg": 1.1337,
                             "mean_matches": 182.42},
    "loftr": {"auc@5": 0.4908, "auc@10": 0.5831, "auc@20": 0.6715,
              "median_err_deg": 2.0162, "mean_matches": 1559.42}}
# (d) evaluate_warp on one textured 480 x 640 photo (this seed), the 5
# default warps, the trained flagship as tests/test_accuracy_warp.py
# builds it: the JAX package on the CPU (tests/jax_eval_reference.py)
# gives median recall 1.0, 109 matches and a corner error of 0.822 px;
# the gate is recall >= 0.95, matches >= 82 (three quarters) and corner
# error <= 1.64 px (twice).
E_WARP_SEED = 950
E_WARP_GATE = {"median_recall": 0.95, "median_matches": 82,
               "median_h_corner_err": 1.64}
# (e) The card against the port's CPU run on the first E_CPU_PAIRS pairs:
# the IoU of the raw match sets before RANSAC, as phase 8 (S_IOU at
# S_TOL_PX; the two devices' generators draw different RANSAC streams, so
# the per-pair errors are not compared).
E_CPU_PAIRS = 2
# The kernels of the flagship's eval pair: bf16 SuperPoint's stem kernel,
# K1 and K2 (nms_radius 3) once per view, and LightGlue's self-attention
# (K3: 1024 keypoints, under the 2048 of the blockwise route) and
# cross-attention (K4) in each layer it runs.
EVAL_KERNELS = SERVED_KERNELS + ("fused_attention", "bidirectional_attention")
# The head of the sparse zoo (phase 10): the packaged app.yaml's entries
# of this slice, each built from the zoo and served at the API's defaults
# (1024 keypoints at 0.015, which ALIKED does not read: it serves 4096 at
# 0.2, so LightGlue's self-attention takes K5) on planted pairs of Z_SIZE,
# on seeded random trees but for SuperPoint's.
# Then the sparse zoo on parts already ported: the packaged xfeat(dense),
# dedode and rord, the root config/app.yaml's xfeat+lightglue (standalone:
# XFeat keeps its 4096 slots, so LightGlue's self-attention takes K5),
# superpoint+sphereglue (bf16 superpoint_max: the stem kernel, K1 and K2),
# d2net, sfd2+imp and sfd2+mnn, and the registry's disk + sgmnet, all on
# seeded random trees but for SuperPoint's.
# Then SIFT and DoG without OpenCV (ops/sift.py on the card): the packaged
# sift+NN, sift+lightglue (SIFT's 1024 keypoints under the 2048 of the
# blockwise route, so LightGlue's self-attention takes K3) and
# dog-hardnet+NN, the root sosnet, sift+sphereglue and sift+sgmnet; and
# the other extractors: the root r2d2, darkfeat, lanet, liftfeat(sparse)
# and ripe(+mnn), each with mutual nearest neighbour. The root sift,
# sift+lightglue and hardnet run models timed here already.
Z_ENTRIES = ("superglue", "superpoint+adalam", "disk", "alike",
             "aliked+lightglue", "xfeat(sparse)", "xfeat(dense)", "dedode",
             "rord", "xfeat+lightglue", "superpoint+sphereglue", "d2net",
             "sfd2+imp", "sfd2+mnn", "disk+sgmnet", "sift+NN",
             "sift+lightglue", "dog-hardnet+NN", "sosnet", "sift+sphereglue",
             "sift+sgmnet", "r2d2", "darkfeat", "lanet", "liftfeat(sparse)",
             "ripe(+mnn)")
# where an entry's conf comes from: the packaged zoo
# (imcui_tpu_torch/config/app.yaml) unless named here; "registry" joins
# the feature and matcher names of the key with parse_match_config
Z_SOURCE = {"xfeat+lightglue": "root", "superpoint+sphereglue": "root",
            "d2net": "root", "sfd2+imp": "root", "sfd2+mnn": "root",
            "disk+sgmnet": "registry", "sosnet": "root",
            "sift+sphereglue": "root", "sift+sgmnet": "root", "r2d2": "root",
            "darkfeat": "root", "lanet": "root", "liftfeat(sparse)": "root",
            "ripe(+mnn)": "root"}
# The entries whose keypoints SIFT's detector finds (ops/sift.py).
Z_SIFT = ("sift+NN", "sift+lightglue", "dog-hardnet+NN", "sosnet",
          "sift+sphereglue", "sift+sgmnet")
# Extractor conf overrides: R2D2's seed-0 tree clears neither 0.7
# threshold anywhere (0 keypoints on a planted pair), so it is served at
# thresholds of 1e-6, where its NMS and ranking still run.
Z_FEATURE_CONF = {"r2d2": {"reliability_threshold": 1e-6,
                           "repetability_threshold": 1e-6}}
# The kernels each entry must launch on every request.
Z_EXPECTED = {"superglue": SERVED_KERNELS,
              "superpoint+adalam": SERVED_KERNELS,
              "superpoint+sphereglue": SERVED_KERNELS,
              "aliked+lightglue": ("flash_attention",
                                   "bidirectional_attention"),
              "xfeat+lightglue": ("flash_attention",
                                  "bidirectional_attention"),
              "sift+lightglue": ("fused_attention",
                                 "bidirectional_attention")}
# The entries whose learned matcher decodes few or no matches at its
# threshold on a random tree: their card-against-CPU check runs the matcher
# at Z_LOW_THRESHOLD on both devices, where every mutual arg-max counts.
Z_LOW = ("dedode", "xfeat+lightglue", "superpoint+sphereglue", "sfd2+imp",
         "disk+sgmnet", "sift+lightglue", "sift+sphereglue", "sift+sgmnet")
Z_LOW_THRESHOLD = 1e-6
# The graph matchers are also held on the same inputs, the card's
# features fed to both devices' matcher at Z_LOW_THRESHOLD: the share of
# view-0 slots whose match agrees, against the f32 raw-match bound.
# Behind bf16 SuperPoint the pair's raw matches are not gated: the two
# devices' features differ in ~3 % of keypoints (the bf16 bound's IoU),
# and SphereGlue's kNN graph and Chebyshev filter carry each difference
# to the neighbours of that keypoint (raw-match IoU 0.85 at 1e-6 on pair
# 100 on an NVIDIA H100 80GB HBM3), so that check would hold the
# extractor's rounding, which the keypoint and descriptor bounds hold.
Z_SAME_INPUTS = ("superpoint+sphereglue", "sfd2+imp", "disk+sgmnet",
                 "sift+sphereglue", "sift+sgmnet")
Z_PAIR_UNGATED = ("superpoint+sphereglue",)
# The card-against-CPU check of these entries runs at this resize_max on
# both devices (their timed requests run at full size): at the full 1280 x
# 2048 canvas DeDoDe's CPU run would cost ~72 TFLOP, and D2-Net's (RoRD's)
# and DISK's CPU runs take 26-35 s an entry on an 8-core host; SIFT's CPU
# run over the doubled 1280 x 2048 canvas takes tens of seconds a view,
# and DarkFeat's, LANet's, LiftFeat's and RIPE's 10-20 s an entry; DISK's,
# ALIKE's and ALIKED's 6-15 s (at 640 the whole script stays under ~1000
# s; it read 990 s on an H100 host whose turbo phase ran 20 % slow).
# (R2D2 resizes every image to 640 x 480 itself.)
Z_CPU_RESIZE = {"dedode": 320, "d2net": 640, "rord": 640,
                "disk+sgmnet": 640, **dict.fromkeys(Z_SIFT, 640),
                **dict.fromkeys(("darkfeat", "lanet", "liftfeat(sparse)",
                                 "ripe(+mnn)", "disk", "alike",
                                 "aliked+lightglue"), 640)}
Z_SEEDS = (100, 101, 102)
Z_SIZE = (1600, 1200)
# superpoint+adalam runs on the trained SuperPoint and must pass the gate
# (GATE_MIN_INLIERS at GATE_MEDIAN_PX) on every pair of Z_SEEDS; the JAX
# package on the CPU (tests/jax_adalam_reference.py) on the same pairs:
Z_JAX_CPU = {100: {"inliers": 546, "median_px": 1.4351},
             101: {"inliers": 557, "median_px": 1.4293},
             102: {"inliers": 697, "median_px": 1.33}}
# Card against the port's CPU run of the same entry on pair 0 (the same
# tree, image and, for the matcher, the card's features): the IoU of the
# valid keypoints (within Z_KPT_PX) and of the raw matches (S_TOL_PX), the
# largest descriptor difference at common keypoints, SuperGlue's log
# assignment (entries of valid slots and dustbins, relative to the
# largest). bf16 SuperPoint rounds in other places on the two devices
# (phase 8's S_IOU); the float32 extractors and matchers run strict f32.
Z_KPT_PX = 0.01
# SIFT's descriptors are integers before RootSIFT: a histogram sum that
# rounds apart on the two devices (the card adds its votes in another
# order) can move one entry by one step, which moves a RootSIFT entry by
# up to sqrt(1 / L1) ~ 0.02 (L1 ~ 2500-4000), hence 3e-2; the keypoint
# sets may differ where an angle crosses a histogram bin's edge. DoG's
# HardNet and SOSNet read the same keypoints.
Z_BOUNDS = {"bf16": {"kpt_iou": 0.9, "desc": 2e-2, "match_iou": S_IOU},
            "f32": {"kpt_iou": 0.98, "desc": 1e-4, "match_iou": 0.95},
            "sift": {"kpt_iou": 0.95, "desc": 3e-2, "match_iou": 0.9},
            "log_assignment": 1e-4}
# REKD and RaCo (phase 12), through phase 10's loop: the registry's rekd
# extractor with mutual nearest neighbour, and the root config/app.yaml's
# raco+lightglue (RaCo's 1024 slots, which it reads from its own
# max_num_keypoints, under the 2048 of the blockwise route: LightGlue's
# self-attention takes K3). Float32 extractors: the card holds the CPU's
# keypoints exactly (Z_BOUNDS["exact"]).
R_ENTRIES = ("rekd+NN-mutual", "raco+lightglue")
Z_SOURCE.update({"rekd+NN-mutual": "registry", "raco+lightglue": "root"})
Z_EXPECTED["raco+lightglue"] = ("fused_attention", "bidirectional_attention")
Z_LOW += ("raco+lightglue",)
Z_CPU_RESIZE.update(dict.fromkeys(R_ENTRIES, 640))
Z_BOUNDS["exact"] = {"kpt_iou": 1.0, "desc": 1e-4, "match_iou": 0.95}
# The pointmap matchers (phase 12) at the registry's conf (resize_max 512,
# dfactor 16: a 1600 x 1200 pair becomes 512 x 384, its own canvas, 32 x
# 24 = 768 tokens a view) and full ViT-L width (encoder 1024 wide,
# 24 blocks, 16 heads; decoders 768 wide, 12 blocks, 12 heads; head dim
# 64), in float32 at the default route (no kernel: RoPE's float32 q and k
# take the plain attention) and in bfloat16 with vit.ATTN_IMPL = "fused":
# every block through mha_auto to K14, V_K14 launches a request (2 x 24
# encoder, 2 x 12 self and 2 x 12 cross), each held against its plain
# version at phase 1's bf16 tolerance. The card against the CPU at
# V_CPU_RESIZE on both devices on the card's tree: view 1's pointmap and
# confidence (MASt3R: descriptors and their confidence) within V_CPU_TOL
# of the largest (float32) or with a median within V_CPU_BF16 (bfloat16,
# which the two devices round in other places).
# phase 13: the line matchers, LISRD and the wrappers on RoMa, each entry
# through phase 10's serving loop on a planted Z_SIZE pair
N_ENTRIES = ("gluestick", "lisrd", "LISRD+SuperPoint", "LISRD+ALIKED",
             "LISRD+SIFT", "dad(RoMa)", "RoMaV2", "sold2")
N_SOURCE = {"gluestick": "packaged", "lisrd": "packaged",
            "LISRD+SuperPoint": "root", "LISRD+ALIKED": "root",
            "LISRD+SIFT": "root", "dad(RoMa)": "root", "RoMaV2": "root",
            "sold2": "registry"}
# the kernels each entry's request must launch: the bf16 SuperPoint's stem
# kernel, K1 and K2; DaD's float32 RoMa, K3 in its DINOv2 blocks
N_EXPECTED = {"gluestick": SERVED_KERNELS, "lisrd": SERVED_KERNELS,
              "LISRD+SuperPoint": SERVED_KERNELS,
              "dad(RoMa)": ("fused_attention",)}
N_K3 = 96  # DaD: two RoMa matches a pair, four DINOv2 encodes of 24 blocks
N_SEEDS = (100, 101, 102)
N_LINE_PX = 3.0
# the JAX package's gluestick on the CPU on the same pairs
# (tests/jax_gluestick_reference.py)
N_JAX_CPU = {100: {"inliers": 665, "median_px": 1.4615, "line_matches": 199,
                   "line_share": 1.0},
             101: {"inliers": 657, "median_px": 1.4293, "line_matches": 185,
                   "line_share": 0.973},
             102: {"inliers": 737, "median_px": 1.3261, "line_matches": 200,
                   "line_share": 0.99}}
# card against CPU: keypoint IoU of a bf16 SuperPoint (ROADMAP "bf16
# SuperPoint"), of the float32 detectors, raw-match IoU, GlueStick's
# matched line pairs as sets, DaD's wrapper on the same warps, and the
# float32 warps of DaD's RoMa and of RoMaV2 cell by cell: the share of
# cells whose warp and certainty lie within L_FPN_TOL, the median and the
# largest warp error (normalised units), set from H100 readings (RoMaV2:
# every cell, median 1.0e-7, largest 9.2e-6 and 9.8e-6; DaD: every cell,
# median 2.4e-6, largest 1.5e-5, certainty 3.4e-4)
N_BOUNDS = {"kpt_iou_bf16": 0.9, "kpt_iou": 0.99, "match_iou_bf16": 0.8,
            "match_iou": 0.95, "line_iou": 0.9, "dad_iou": 0.99,
            "warp_cells": 0.999, "warp_median": 1e-5, "warp_max": 1e-4}
N_LSD_SIZE = (1024, 768)
V_ENTRIES = ("duster", "mast3r")
V_K14 = 2 * 24 + 2 * 2 * 12
V_CPU_RESIZE = 224
V_CPU_TOL = 1e-3
V_CPU_BF16 = 2e-2
# DKM (phase 12): the registry's dkm (80 x 60 forced, on a 256 x 256
# canvas, which coarse_res None keeps), then at its published operating
# point coarse_res (544, 704); the card against the CPU on the registry's
# request: the warp (normalised units) and the certainty of the prepared
# pair within K_CPU_TOL of the largest. No kernel lies on DKM's path.
K_COARSE = (544, 704)
K_CPU_TOL = 1e-3
# SIFT's stages (phase 11): one textured T_SIZE image at the zoo's
# contrast threshold, whose pyramid holds an odd-sized octave (15 x 20),
# on the card against the port's CPU run of the same stages. The card and
# the CPU do the same IEEE operations but for torch's cos, sin, exp and
# pow and the order in which the histograms add their votes, so the
# pyramids, the candidates and the refined samples are expected equal;
# bounds: the pyramids within T_PYRAMID (grey levels), the candidate
# counts equal, the refined keypoints' IoU within Z_KPT_PX at least
# T_KPT_IOU, the common keypoints' angles within T_ANGLE_DEG and at least
# T_DESC_SAME of their integer descriptors equal, none off by more than
# T_DESC_STEP. The stage times are taken on the card at T_FULL, the canvas
# of a Z_SIZE image.
T_SIZE = (640, 480)
T_SEED = 960
T_CONTRAST = 0.0066667
T_PYRAMID = 1e-4
T_KPT_IOU = 0.99
T_ANGLE_DEG = 0.01
T_DESC_SAME = 0.99
T_DESC_STEP = 1
T_FULL = (2048, 1280)
# phase 14: the root config/app.yaml's last matchers, each through phase
# 13's serving loop on a planted Z_SIZE pair at the entry's conf (the
# disabled Example and cotr by their conf). OmniGlue and MicKey run random
# learned heads, which keep matches only at Z_LOW_THRESHOLD, the API's
# match_threshold for them; COTR's random confidence head is gated at 0
# (the JAX package's rule) and keeps no match unless its decoder predicts
# the right half. OmniGlue's bf16 SuperPoint launches the stem kernel, K1
# and K2 on each view. The card against the port's CPU run on the same
# trees: the raw matches at S_IOU (S_TOL_PX), OmniGlue's keypoints at
# Z_BOUNDS["bf16"]["kpt_iou"] within Z_KPT_PX, MicKey's float64 pose (R
# and t) within O_POSE_TOL, COTR's two decoder passes (canvas-normalised
# units) within O_COTR_TOL.
O_ENTRIES = ("omniglue", "mickey", "cotr", "Example")
O_THRESHOLD = {"omniglue": 1e-6, "mickey": 1e-6}
O_EXPECTED = {"omniglue": SERVED_KERNELS}
O_POSE_TOL = 1e-4
O_COTR_TOL = 1e-3
# phase 14: the registry's seven retrieval confs through extract() at
# resize_max 1024 (a Z_SIZE image becomes a 1024 x 768 grey canvas) on
# seeded random trees, timed, and each against the port's CPU run on the
# card's tree: the unit global descriptors at cosine >= RET_COS and max
# abs error <= RET_ABS; FIRe-local's super-features as a set of rows
# within RET_ABS at IoU >= RET_SET_IOU. No kernel lies on these paths.
RET_ENTRIES = ("netvlad", "openibl", "cosplace", "eigenplaces", "dir",
               "fire", "fire_local")
RET_COS = 1 - 1e-5
RET_ABS = 1e-4
RET_SET_IOU = 0.99
# Every wrapper of a hand-written kernel, for the count of launches that
# phase 10 holds to what it checked.
# phase 15: the batch pipelines on six 1024x768 PNG views (the planted
# pairs of B_SEEDS): extraction with the registry's superpoint_aachen, the
# exhaustive pairs, superpoint-lightglue over them, netvlad and the
# retrieval pairs, then the registry's dense loftr over the planted pairs.
# Each file is held against the same models in memory: extraction and
# sparse matches exactly (float16 where the file is float16); the dense
# matches within B_DENSE_PX of an in-memory correspondence (cells of 1 px,
# rounded) with their score within B_DENSE_SCORE, on at least
# B_DENSE_SHARE of them. Both match files pass the planted gate after the
# API's RANSAC (GATE_MIN_INLIERS at GATE_MEDIAN_PX).
B_SEEDS = (100, 101, 102)
B_SIZE = (1024, 768)
B_RETRIEVAL_K = 2
B_KERNELS = ("stem_tail", "stage_tail", "nms_cellmax", "fused_attention",
             "flash_attention", "bidirectional_attention")
B_DENSE_PX = 1.0
B_DENSE_SCORE = 2e-3
B_DENSE_SHARE = 0.99
# extract_features.main's preprocessing defaults, which extract() does
# not share (it defaults to grayscale, resize_max 1024)
B_MAIN_PRE = {"grayscale": False, "resize_max": None, "force_resize": False,
              "width": 640, "height": 480, "dfactor": 8,
              "interpolation": "cv2_area"}
B_DENSE_PRE = {"grayscale": True, "resize_max": 1024, "force_resize": False,
               "width": 640, "height": 480, "dfactor": 8}
# phase 16: SfmEngine on M_VIEWS 1600x1200 PNG views of one textured image,
# each through its own random_homography (the pairs' planted homographies
# H_j·H_i⁻¹), at the engine's defaults (bf16 SuperPoint at 4096 keypoints,
# mutual NN, RANSAC at 1024 hypotheses and 4 px). Each pair's verified
# matches: at least M_SHARE of them within M_PX of the planted homography
# and at least M_LEAST of them (set from the port's CPU run of the same
# views, PERF.md). The planted non-planar scene of M_SCENE (views, points,
# wrong share) for verification card against CPU, and its query (M_QUERY
# keypoints, 30 % wrong) for localisation within M_POSE_DEG and M_POSE_T
# (the JAX package's localisation test's gates).
M_VIEWS = 6
M_SIZE = (1600, 1200)
M_SEED = 1600
M_PX = 3.0
M_SHARE = 0.75
M_LEAST = 200
M_SCENE = (1601, 8, 2000, 0.25)
M_QUERY = 4096
M_POSE_DEG, M_POSE_T = 1.5, 0.1
M_RETRIEVAL_K = 3
# W8A8 and LightGlue in bf16 (phase 18). (a) The registry's duster,
# mast3r and roma at full width with precision "int8" on a planted Z_SIZE
# pair, roma also and dkm at int8_conv_min_ch W8_CONV_MIN_CH (their
# convolutions at least 256 wide: RoMa's VGG 256/512 layers, projections
# and refiners' 1 x 1 convolutions; DKM's ResNet-50 layers, projections and
# DFN; DKM has no linear, so without it int8 is DKM's bf16 run); DUSt3R
# and MASt3R with vit.ATTN_IMPL "fused". The W8A8 launches a request
# must equal what the tree implies: each quantised dict once, twice
# where its path component (W8_PER_VIEW) runs on each view; K14 launches
# W8_K14 times. The int8 maps against the bf16 ones: median |diff| within
# W8_SANITY of the largest (a sanity bound: seed-0 trees, no geometric
# gate); the card against the CPU: pointmaps and DKM as phase 12 in bf16
# (V_CPU_BF16), RoMa on a cut DINOv2 (two blocks) at 112^2: its tokens as
# the pointmaps, the random anchor decoder's warp and certainty within
# W8_ROMA_CPU (median |warp diff|, as the CPU tests' int8 bound against
# JAX; mean |certainty diff|: a re-quantised last-bit difference moves a
# cell to another anchor, and its certainty with it). (b) LightGlue at
# the flagship (BATCH planted LG_SIZE pairs on the CANVAS canvas,
# MAX_KPTS keypoints, N_LAYERS layers, the trained tree) in bf16 beside
# float32: the same gate, K3 and K4 in bf16 held as _bf16_attention_over
# says (at most LG_OVER of the outputs past one bf16 step), LG_REPS timed
# forwards each. (c) The new kernels' rows at
# W8_LINEAR (DUSt3R's fc1: tokens, din, dout) and W8_CONV (RoMa's VGG 3 x 3:
# batch, cin, h, w, cout).
W8_CONV_MIN_CH = 256
W8_ENTRIES = (("duster", None), ("mast3r", None), ("roma", None),
              ("roma", W8_CONV_MIN_CH), ("dkm", W8_CONV_MIN_CH))
W8_PER_VIEW = {"duster": ("enc_blocks", "decoder_embed", "patch_embed"),
               "mast3r": ("enc_blocks", "decoder_embed", "patch_embed"),
               "roma": ("dinov2", "encoder_cnn", "proj"),
               "dkm": ("encoder", "proj")}
W8_K14 = {"duster": V_K14, "mast3r": V_K14, "roma": 2 * 24, "dkm": 0}
W8_SANITY = 0.25
W8_ROMA_CPU = [0.35, 0.1]
W8_LINEAR = (768, 1024, 4096)
W8_CONV = (1, 256, 140, 140, 256)
LG_SEEDS = (100, 101, 102, 103)
LG_SIZE = (1024, 768)
LG_REPS = 20
LG_OVER = 1e-3
ALL_KERNELS = ("stem_tail", "stage_tail", "nms_cellmax", "fused_attention",
               "bidirectional_attention", "flash_attention",
               "qtiled_attention", "tap_matmul")
# The keys of the JAX package's run_matching pred dict, which the CLI's
# match command pickles.
PRED_KEYS = {"H", "geom_info", "image0_orig", "image1_orig", "keypoints0",
             "keypoints0_orig", "keypoints1", "keypoints1_orig", "mconf",
             "mkeypoints0", "mkeypoints0_orig", "mkeypoints1",
             "mkeypoints1_orig", "mmconf", "mmkeypoints0_orig",
             "mmkeypoints1_orig"}
# What the JAX package's surfaces import: the port reads YAML with PyYAML
# and the request schema with pydantic, and restates the rest.
# phase 17: JPEG on the card (PIL, which that machine has, encodes and is
# the reference; the port never imports it)
J_SEED = 1700
J_SIZE = (1600, 1200)
J_QUALITY = 95
J_REPS = 5
J_TIME_RATIO = 4.0     # the port's decode at most 4x PIL's on the same bytes
J_TINT = np.array([1.0, 0.85, 0.7])   # colour for the served JPEG bodies
SURFACE_PACKAGES = ("click", "yaml", "pydantic", "PIL", "fastapi", "uvicorn",
                    "matplotlib", "h5py")
# The times of the tap-sum kernel's first design (WMMA with cp.async,
# commit 35980e0), chip_smoke.py phase 6 of its run 3 on an NVIDIA H100
# 80GB HBM3 at 700.00 W, by probe shape (rows, N, taps, type, layout of w).
P_PREVIOUS_MS = {
    (524288, 128, 9, "bf16", "taps"): 0.924,
    (524288, 512, 2, "bf16", "taps"): 0.947,
    (524288, 1152, 1, "bf16", "taps"): 1.286,
    (524288, 2048, 1, "bf16", "taps"): 2.254,
    (4194304, 128, 9, "bf16", "taps"): 6.370,
    (4194304, 128, 9, "int8", "taps"): 7.238,
    (4194304, 128, 9, "bf16", "wide"): 6.420,
}
# SASS instructions that each tap-sum kernel must hold, by type: its wgmma
# (HGMMA bf16, IGMMA int8), TMA loads and TMA stores.
P_SASS = {"bf16": ("HGMMA", "UTMALDG", "UTMASTG"),
          "int8": ("IGMMA", "UTMALDG", "UTMASTG")}
# SASS instructions that each instance of the TMA attention template must
# hold: wgmma and TMA loads. Its instances: K14's and K5's bf16 ones.
Q_SASS = ("HGMMA", "UTMALDG")
QTILED_INSTANCES = {"<64><128><0>": "qtiled_attention",
                    "<64><128><1>": "flash_attention bf16, head dim 64",
                    "<128><64><1>": "flash_attention bf16, head dim 128"}
# ... and the conv kernels on stage_conv.cuh's tile (K1, the stem in both
# image types): wgmma and the TMA load of W_b.
CONV_SASS = ("HGMMA", "UTMALDG")
CONV_PATTERN = r"\d(stage_tail|stem_tail)_kernel(?:I(f|13__nv_bfloat16)E)?"
CONV_INSTANCES = ("stage_tail", "stem_tail<f>", "stem_tail<13__nv_bfloat16>")
# ... and each float32 kernel of K5 (attention.cu's tile): cp.async copies.
F_SASS = ("LDGSTS",)
F_INSTANCES = ("<8><64><64>", "<7><64><64>", "<4><64><64>", "<4><128><32>")


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


# --------------------------------------------------------------------------
# synthetic requests
# --------------------------------------------------------------------------

def textured_image(rng, h, w):
    """Grayscale uint8 (h, w): smoothed multi-scale noise under many
    overlapping rectangles, whose corners are what SuperPoint detects."""
    from scipy import ndimage

    img = np.zeros((h, w), np.float64)
    for sigma, amp in ((2.0, 0.3), (8.0, 0.6), (24.0, 1.0)):
        n = ndimage.gaussian_filter(rng.standard_normal((h, w)), sigma)
        img += amp * n / (n.std() + 1e-9)
    for _ in range(int(h * w / 1500)):
        y0, x0 = rng.integers(0, h), rng.integers(0, w)
        s = rng.integers(8, 48)
        img[y0:y0 + s, x0:x0 + int(s * rng.uniform(0.5, 2))] += \
            rng.uniform(-3, 3)
    img = ndimage.gaussian_filter(img, 0.7)
    img = (img - img.min()) / (img.max() - img.min() + 1e-9)
    return (img * 255).astype(np.uint8)


def random_homography(rng, h, w):
    """A moderate viewpoint change about the image centre: rotation up to
    10°, scale 0.85–1.15, a little perspective and translation."""
    a = np.deg2rad(rng.uniform(-10, 10))
    s = rng.uniform(0.85, 1.15)
    c = np.array([w / 2, h / 2])
    rot = np.array([[s * np.cos(a), -s * np.sin(a)],
                    [s * np.sin(a), s * np.cos(a)]])
    t = c - rot @ c + rng.uniform(-0.04, 0.04, 2) * np.array([w, h])
    hm = np.eye(3)
    hm[:2, :2] = rot
    hm[:2, 2] = t
    hm[2, :2] = rng.uniform(-1e-4, 1e-4, 2)
    return hm


def warp_image(img, hm, out_hw):
    """img warped by hm (img coords → output coords), bilinear, 0 outside."""
    from scipy import ndimage

    h, w = out_hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    pts = np.stack([xx.ravel(), yy.ravel(), np.ones(h * w)])
    src = np.linalg.inv(hm) @ pts
    src = src[:2] / src[2]
    out = ndimage.map_coordinates(img.astype(np.float64), [src[1], src[0]],
                                  order=1, cval=0.0)
    return out.reshape(h, w).astype(np.uint8)


def synthetic_pair(seed, w, h):
    """(image0 RGB uint8, image1 RGB uint8, H: image0 px → image1 px)."""
    rng = np.random.default_rng(seed)
    img0 = textured_image(rng, h, w)
    hm = random_homography(rng, h, w)
    img1 = warp_image(img0, hm, (h, w))
    return (np.repeat(img0[..., None], 3, -1),
            np.repeat(img1[..., None], 3, -1), hm)


def homography_views(seed, n, w, h, zoom=1):
    """``n`` RGB uint8 w × h views of one textured image of ``zoom`` times
    their size, each through its own random_homography after a 1/zoom
    scale, and those homographies (texture px → view px): view j =
    H_j·H_i⁻¹ of view i."""
    rng = np.random.default_rng(seed)
    base = textured_image(rng, h * zoom, w * zoom)
    scale = np.diag([1 / zoom, 1 / zoom, 1.0])
    hms = [random_homography(rng, h, w) @ scale for _ in range(n)]
    return [np.repeat(warp_image(base, hm, (h, w))[..., None], 3, -1)
            for hm in hms], hms


def _rot_y(a):
    return np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                     [-np.sin(a), 0, np.cos(a)]])


def _project(K, R, t, X):
    x = (X @ R.T + t) @ K.T
    return x[:, :2] / x[:, 2:]


def _epipolar_px(K, Ra, ta, Rb, tb, pa, pb):
    """Point-to-epipolar-line distances (px) both ways of correspondences
    pa (view a) ↔ pb (view b) under the true poses, the smaller of the
    two."""
    R = Rb @ Ra.T
    t = tb - R @ ta
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    Ki = np.linalg.inv(K)
    F = Ki.T @ tx @ R @ Ki
    ha = np.concatenate([pa, np.ones((len(pa), 1))], 1)
    hb = np.concatenate([pb, np.ones((len(pb), 1))], 1)
    lb, la = ha @ F.T, hb @ F
    num = np.abs((hb * lb).sum(1))
    return np.minimum(num / np.linalg.norm(lb[:, :2], axis=1),
                      num / np.linalg.norm(la[:, :2], axis=1))


def sfm_scene(seed, n_images, n_points, wrong, n_query=0, query_wrong=0.3,
              noise=0.3, query_noise=0.4, far_px=50.0, size=(1024, 768)):
    """A planted non-planar scene: ``n_points`` points in a box 4-8 units
    in front of ``n_images`` PINHOLE cameras (f 800) that turn about y and
    slide along x and z. Each view's keypoints are every point's
    projection with ``noise`` px of noise, in the view's own order. Every
    image pair has matches of 0.8·n_points points, ``wrong`` of them to
    the keypoint of another point at more than ``far_px`` from the
    epipolar line both ways, so that a 4 px gate keeps exactly the right
    ones (at 20 px the float32 F refit let 1-2 wrong ones through on
    adjacent views). Pair (a, b) is
    listed as (b, a) where a + b is divisible by 3 (the database stores it
    flipped). With ``n_query``, a query at a known pose with ``n_query``
    keypoints (the points' projections with ``query_noise`` px and random
    others) matched to the first three views: every point once,
    ``query_wrong`` of them to another point whose projection lies more
    than 3·far_px away. Keypoints in the files are the projections − 0.5
    (COLMAP's origin); the model's xys are the projections."""
    from imcui_tpu_torch.utils import read_write_model as rwm
    from imcui_tpu_torch.utils.geometry import rotmat2qvec

    rng = np.random.default_rng(seed)
    w, h = size
    K = np.array([[800.0, 0, w / 2], [0, 800.0, h / 2], [0, 0, 1]])
    X = rng.uniform([-2.0, -1.5, -2.0], [2.0, 1.5, 2.0], (n_points, 3)) \
        + np.array([0, 0, 6.0])
    cameras = {1: rwm.Camera(id=1, model="PINHOLE", width=w, height=h,
                             params=np.array([800.0, 800.0, w / 2, h / 2]))}
    names = [f"view{i}.png" for i in range(n_images)]
    poses, kpts, inv = [], {}, []
    images, tracks = {}, {j: ([], []) for j in range(n_points)}
    for i, name in enumerate(names):
        c = i - (n_images - 1) / 2
        R, t = _rot_y(0.08 * c), np.array([0.4 * c, 0.1 * np.sin(i),
                                            0.05 * c])
        poses.append((R, t))
        perm = rng.permutation(n_points)  # keypoint k shows point perm[k]
        xy = _project(K, R, t, X)[perm] + rng.normal(0, noise,
                                                     (n_points, 2))
        kpts[name] = (xy - 0.5).astype(np.float32)
        inv.append(np.argsort(perm))
        images[i + 1] = rwm.Image(
            id=i + 1, qvec=rotmat2qvec(R), tvec=t, camera_id=1, name=name,
            xys=kpts[name].astype(np.float64) + 0.5, point3D_ids=perm)
        for k, j in enumerate(perm):
            tracks[j][0].append(i + 1)
            tracks[j][1].append(k)
    points3D = {j: rwm.Point3D(
        id=j, xyz=X[j], rgb=np.array([128, 128, 128]), error=0.5,
        image_ids=np.array(tracks[j][0]), point2D_idxs=np.array(
            tracks[j][1])) for j in range(n_points)}

    pairs, matches, correct = [], {}, {}
    n_match = int(0.8 * n_points)
    n_wrong = int(round(wrong * n_match))
    for a in range(n_images):
        for b in range(a + 1, n_images):
            p, q = (b, a) if (a + b) % 3 == 0 else (a, b)
            (Rp, tp), (Rq, tq) = poses[p], poses[q]
            pts = rng.permutation(n_points)[:n_match]
            good, bad = pts[n_wrong:], pts[:n_wrong]
            m0 = np.full(n_points, -1, np.int16)
            m0[inv[p][good]] = inv[q][good]
            kp, kq = kpts[names[p]] + 0.5, kpts[names[q]] + 0.5
            for j in bad:
                while True:
                    k = rng.integers(n_points)
                    if k != j and _epipolar_px(
                            K, Rp, tp, Rq, tq, kp[inv[p][j]][None],
                            kq[inv[q][k]][None])[0] > far_px:
                        break
                m0[inv[p][j]] = inv[q][k]
            pair = (names[p], names[q])
            pairs.append(pair)
            matches[pair] = m0
            correct[pair] = {(int(inv[p][j]), int(inv[q][j])) for j in good}
    scene = {"K": K, "cameras": cameras, "images": images,
             "points3D": points3D, "names": names, "kpts": kpts,
             "pairs": pairs, "matches": matches, "correct": correct,
             "poses": poses, "size": size}
    if n_query:
        Rq, tq = _rot_y(0.07), np.array([0.15, 0.05, 0.2])
        proj = _project(K, Rq, tq, X)
        xy = np.concatenate([proj + rng.normal(0, query_noise,
                                               (n_points, 2)),
                             rng.uniform([0, 0], [w, h],
                                         (n_query - n_points, 2))])
        perm = rng.permutation(n_query)  # query keypoint k is row perm[k]
        qinv = np.argsort(perm)
        target = np.arange(n_points)
        for j in rng.permutation(n_points)[:int(round(query_wrong
                                                       * n_points))]:
            while True:
                k = rng.integers(n_points)
                if np.linalg.norm(proj[k] - proj[j]) > 3 * far_px:
                    break
            target[j] = k
        qmatches = {}
        for i in range(min(3, n_images)):
            m0 = np.full(n_query, -1, np.int16)
            m0[qinv[:n_points]] = inv[i][target]
            qmatches[names[i]] = m0
        scene.update(query={
            "name": "query.png", "R": Rq, "t": tq,
            "kpts": (xy[perm] - 0.5).astype(np.float32),
            "matches": qmatches,
            "inliers": {int(qinv[j]) for j in range(n_points)
                        if target[j] == j}})
    return scene


def inloc_scene(root, seed=31, n=120, wrong=0.2):
    """Two database scans (an XYZ map with a few NaN pixels and its
    alignment file: one DUC, one cse) and a query at a known pose whose
    keypoints are the projections of the scans' interpolated points with
    0.5 px of noise; ``wrong`` of the matches go to a point that projects
    more than 200 px away. Writes feats.h5, matches.h5 and retrieval.txt
    under ``root``; returns (query name, scan names, R, t, the inliers'
    indices into the query's keypoints)."""
    from pathlib import Path

    import scipy.io

    from imcui_tpu_torch.pipeline.localize_inloc import interpolate_scan
    from imcui_tpu_torch.utils import h5lite
    from imcui_tpu_torch.utils.geometry import qvec2rotmat
    from imcui_tpu_torch.utils.io import names_to_pair

    root = Path(root)
    rng = np.random.default_rng(seed)
    focal = 4032.0 * 28.0 / 36.0
    K = np.array([[focal, 0, 800.0], [0, focal, 600.0], [0, 0, 1]])
    Rq, tq = _rot_y(0.1), np.array([0.2, -0.1, 0.3])
    names = ["database/DUC1/cut_a.png", "database/cse2/cut_b.png"]
    hs, ws = 60, 80
    kd = np.array([[50.0, 0, 40], [0, 50.0, 30], [0, 0, 1]])
    feats, matches, inliers, qk = {}, {}, set(), []
    for i, r in enumerate(names):
        Rd, td = _rot_y(-0.05 + 0.1 * i), np.array([0.3 * i, 0, 0.1])
        qa = np.r_[1.0, 0.1 * rng.normal(size=3)]
        Ra = qvec2rotmat(qa / np.linalg.norm(qa))
        Tr = np.eye(4)
        Tr[:3, :3], Tr[:3, 3] = Ra, rng.normal(size=3)
        v, u = np.mgrid[0:hs, 0:ws].astype(np.float64)
        z = 5 + 0.5 * np.sin(u / 9) + 0.4 * np.cos(v / 7)
        xc = np.stack([u, v, np.ones_like(u)], -1) @ np.linalg.inv(kd).T \
            * z[..., None]
        world = (xc - td) @ Rd
        scan = (world - Tr[:3, 3]) @ Tr[:3, :3]
        scan[rng.integers(0, hs, 5), rng.integers(0, ws, 5)] = np.nan
        path = Path(root, r + ".mat")
        path.parent.mkdir(parents=True, exist_ok=True)
        scipy.io.savemat(path, {"XYZcut": scan})
        kind = "cse" if "cse" in r else "DUC"
        al = root / "database/alignments" / r.split("/")[1] / \
            "transformations" / f"{kind}_transformation.txt"
        al.parent.mkdir(parents=True, exist_ok=True)
        al.write_text("".join(f"# header {k}\n" for k in range(7))
                      + "".join(" ".join(repr(float(v)) for v in row) + "\n"
                                for row in Tr) + "# end\n")
        kpr = rng.uniform([1, 1], [ws - 2, hs - 2], (n, 2))
        xyz, valid = interpolate_scan(scan, kpr)
        xyz = xyz @ Tr[:3, :3].T + Tr[:3, 3]
        proj = _project(K, Rq, tq, xyz)
        target = np.arange(n)
        ok = np.flatnonzero(valid)
        for j in rng.permutation(ok)[:int(wrong * n)]:
            while True:
                k = rng.choice(ok)
                if np.linalg.norm(proj[k] - proj[j]) > 200:
                    break
            target[j] = k
        base = len(qk)
        qk += list(proj[target] + rng.normal(0, 0.5, (n, 2)))
        inliers |= {base + j for j in range(n)
                    if target[j] == j and valid[j]}
        feats[r] = kpr
        m0 = np.full(2 * n, -1, np.int16)
        m0[base:base + n] = np.arange(n)
        matches[r] = m0
    q = "query/iphone7/q0.png"
    feats[q] = np.array(qk)
    with h5lite.File(root / "feats.h5", "w") as fd:
        for name, k in feats.items():
            fd.create_group(name).create_dataset("keypoints", data=k)
    with h5lite.File(root / "matches.h5", "w") as fd:
        for r, m0 in matches.items():
            g = fd.create_group(names_to_pair(q, r))
            g.create_dataset("matches0", data=m0)
            g.create_dataset("matching_scores0",
                             data=np.ones(len(m0), np.float16))
    (root / "retrieval.txt").write_text("\n".join(f"{q} {r}" for r in names))
    return q, names, Rq, tq, inliers


def write_sfm_scene(root, scene):
    """The scene's files under ``root``: images/ (blank PNGs of its size),
    model/ (binary), feats.h5, matches.h5, pairs.txt and, with a query,
    queries.txt and retrieval.txt. Returns {name: path}."""
    from pathlib import Path

    from imcui_tpu_torch.utils import h5lite
    from imcui_tpu_torch.utils import read_write_model as rwm
    from imcui_tpu_torch.utils.io import names_to_pair
    from imcui_tpu_torch.utils.png import encode_png

    root = Path(root)
    f = {k: root / v for k, v in (
        ("images", "images"), ("model", "model"), ("feats", "feats.h5"),
        ("matches", "matches.h5"), ("pairs", "pairs.txt"),
        ("queries", "queries.txt"), ("retrieval", "retrieval.txt"))}
    f["images"].mkdir(parents=True, exist_ok=True)
    w, h = scene["size"]
    blank = encode_png(np.zeros((h, w), np.uint8))
    for name in scene["names"]:
        (f["images"] / name).write_bytes(blank)
    rwm.write_model(scene["cameras"], scene["images"], scene["points3D"],
                    f["model"], ext=".bin")
    kpts = dict(scene["kpts"])
    matches = {names_to_pair(*p): m for p, m in scene["matches"].items()}
    query = scene.get("query")
    if query:
        kpts[query["name"]] = query["kpts"]
        matches.update({names_to_pair(query["name"], n): m
                        for n, m in query["matches"].items()})
    with h5lite.File(f["feats"], "w") as fd:
        for name, k in kpts.items():
            fd.create_group(name).create_dataset("keypoints", data=k)
    with h5lite.File(f["matches"], "w") as fd:
        for pair, m in matches.items():
            g = fd.create_group(pair)
            g.create_dataset("matches0", data=m)
            g.create_dataset("matching_scores0",
                             data=(m != -1).astype(np.float16))
    f["pairs"].write_text("\n".join(f"{a} {b}" for a, b in scene["pairs"]))
    if query:
        cx, cy = scene["K"][0, 2], scene["K"][1, 2]
        f["queries"].write_text(
            f"{query['name']} PINHOLE {w} {h} 800 800 {cx} {cy}\n")
        f["retrieval"].write_text("\n".join(
            f"{query['name']} {n}" for n in query["matches"]))
    return f


def sqlite_rows(path, table):
    """Every row of ``table`` in the SQLite file ``path``, by first column."""
    import sqlite3

    db = sqlite3.connect(str(path))
    rows = db.execute(f"SELECT * FROM {table} ORDER BY 1").fetchall()
    db.close()
    return rows


def sfm_engine_gate(db_path, names, hms, px):
    """{(name_a, name_b): (verified matches, share within ``px`` of the
    planted homography hms[b]·hms[a]⁻¹)} of an SfmEngine database (its
    keypoints at COLMAP's origin, hence − 0.5)."""
    from imcui_tpu_torch.utils.database import (blob_to_array,
                                                pair_id_to_image_ids)

    kp = {i: blob_to_array(d, np.float32, (-1, 2)).astype(np.float64) - 0.5
          for i, _, _, d in sqlite_rows(db_path, "keypoints")}
    by_id = {i: n for i, n, *_ in sqlite_rows(db_path, "images")}
    out = {}
    for r in sqlite_rows(db_path, "two_view_geometries"):
        i0, i1 = pair_id_to_image_ids(r[0])
        a, b = names.index(by_id[i0]), names.index(by_id[i1])
        m = np.frombuffer(r[3], np.uint32).reshape(-1, 2)
        err = transfer_errors(hms[b] @ np.linalg.inv(hms[a]),
                              kp[i0][m[:, 0]], kp[i1][m[:, 1]])
        out[(names[a], names[b])] = (
            len(m), float((err <= px).mean()) if len(m) else 0.0)
    return out


def multipart_body(files):
    """(body, Content-Type) of a multipart/form-data request holding
    ``files`` = {field name: bytes}, as a browser or ``requests`` sends
    files."""
    boundary = "imcui-tpu-torch-" + os.urandom(8).hex()
    parts = [(f"--{boundary}\r\nContent-Disposition: form-data; "
              f"name=\"{name}\"; filename=\"{name}.png\"\r\nContent-Type: "
              "application/octet-stream\r\n\r\n").encode() + data + b"\r\n"
             for name, data in files.items()]
    return (b"".join(parts) + f"--{boundary}--\r\n".encode(),
            f"multipart/form-data; boundary={boundary}")


def free_port():
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def raw_match_iou(a, b, tol=0.5):
    """IoU of two raw match sets, each a pred dict's mkeypoints0_orig and
    mkeypoints1_orig: a match is common where both its points lie within
    ``tol`` px of one in the other set."""
    pa = np.concatenate([a["mkeypoints0_orig"], a["mkeypoints1_orig"]], 1)
    pb = np.concatenate([b["mkeypoints0_orig"], b["mkeypoints1_orig"]], 1)
    return common_points(pa, pb, tol)[0]


def common_points(a, b, tol):
    """Points of (n, 2) ``a`` and (m, 2) ``b`` within ``tol`` px of each
    other: (IoU of the two sets, indices into a, indices into b)."""
    if not len(a) or not len(b):
        return 0.0, np.zeros(0, int), np.zeros(0, int)
    d = np.abs(a[:, None, :] - b[None, :, :]).max(-1)
    j = d.argmin(1)
    ok = d[np.arange(len(a)), j] <= tol
    n = int(ok.sum())
    return n / (len(a) + len(b) - n), np.flatnonzero(ok), j[ok]


def transfer_errors(hm, mk0, mk1):
    """|H·mk0 − mk1| in px for (n, 2) correspondences."""
    p = np.concatenate([mk0, np.ones((len(mk0), 1))], 1) @ hm.T
    return np.linalg.norm(p[:, :2] / p[:, 2:] - mk1, axis=1)


def line_transfer_errors(hm, lines0, lines1):
    """For (n, 2, 2) matched segments: the larger distance in px of
    H·(an endpoint of lines0) to the infinite line through the matched
    lines1 segment (a matched line is right where it is small)."""
    if not len(lines0):
        return np.zeros(0)
    p = np.concatenate([lines0.reshape(-1, 2),
                        np.ones((2 * len(lines0), 1))], 1) @ hm.T
    p = (p[:, :2] / p[:, 2:]).reshape(-1, 2, 2)
    a, b = lines1[:, 0], lines1[:, 1]
    d = b - a
    n = np.stack([-d[:, 1], d[:, 0]], 1)
    n = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-9)
    dist = np.abs(((p - a[:, None]) * n[:, None]).sum(-1))
    return dist.max(1)


def gluestick_gate(pred, hm):
    """GlueStick's planted-pair numbers of one prediction: raw point
    matches, RANSAC inliers and their median transfer error, raw and
    matched lines, and the share of matched lines within N_LINE_PX of
    their match's line (``line_transfer_errors``)."""
    err = transfer_errors(hm, pred["mmkeypoints0_orig"],
                          pred["mmkeypoints1_orig"]) if "H" in pred \
        else np.zeros(0)
    lerr = line_transfer_errors(hm, np.asarray(pred["lines0_orig"][0]),
                                np.asarray(pred["lines1_orig"][0]))
    return {"raw_matches": len(pred["mkeypoints0_orig"]),
            "inliers": len(err),
            "median_px": round(float(np.median(err)), 4) if len(err)
            else None,
            "raw_lines": [len(pred["raw_lines0"][0]),
                          len(pred["raw_lines1"][0])],
            "line_matches": len(lerr),
            "line_share": round(float((lerr <= N_LINE_PX).mean()), 4)
            if len(lerr) else None}


# --------------------------------------------------------------------------
# measurement helpers
# --------------------------------------------------------------------------

def cuda_ms(fn, iters=20, warmup=3):
    """Median device time of ``fn`` in ms (CUDA events, one per run): the
    probes' own timer, so that every phase times the same way."""
    from imcui_tpu_torch.tools.tail_probes import event_ms

    return event_ms(fn, iters, warmup)


def cuda_ms_queued(fn):
    """Device ms of one call of ``fn``, from 20 calls queued between two
    CUDA events: without the host time of each call's wrapper, which
    cuda_ms counts when a launch finds the card idle."""
    from imcui_tpu_torch.tools.attention_times import queued_ms

    return queued_ms(fn)


def card_peaks(name):
    low = name.lower()
    if "pcie" in low:
        return "pcie", PEAKS["pcie"]
    if "nvl" in low:
        return "nvl", PEAKS["nvl"]
    return "sxm", PEAKS["sxm"]


def bound(flops, nbytes, peak_flops, peaks):
    """Least time in ms: the larger of compulsory bytes over HBM rate and
    the operations over the peak rate for their type."""
    t_ops = flops / peak_flops * 1e3
    t_mem = nbytes / peaks["bw"] * 1e3
    return max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes")


class StageTimer:
    """CUDA events around module functions, summed by label per request.
    ``wrap`` replaces ``mod.name`` (callers that look it up in the module
    see the wrapper); ``wrap_host`` does the same with the host clock, for
    host work that ends in a copy to the host; ``undo`` puts the functions
    back."""

    def __init__(self):
        self.events, self.host, self._undo = {}, {}, []

    def _replace(self, mod, name, wrapper):
        fn = getattr(mod, name)
        setattr(mod, name, wrapper(fn))
        self._undo.append(lambda: setattr(mod, name, fn))

    def wrap(self, mod, name, label):
        import torch

        def wrapper(fn):
            def timed(*a, **kw):
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
                out = fn(*a, **kw)
                ev[1].record()
                key = label(a) if callable(label) else label
                self.events.setdefault(key, []).append(ev)
                return out
            return timed

        self._replace(mod, name, wrapper)

    def wrap_host(self, mod, name, label):
        def wrapper(fn):
            def timed(*a, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                self.host[label] = self.host.get(label, 0.0) + (
                    time.perf_counter() - t0) * 1e3
                return out
            return timed

        self._replace(mod, name, wrapper)

    def clear(self):
        self.events.clear()
        self.host.clear()

    def ms(self):
        return {**{k: sum(a.elapsed_time(b) for a, b in v)
                   for k, v in self.events.items()}, **self.host}

    def undo(self):
        for fn in reversed(self._undo):
            fn()
        self._undo.clear()


def device_window(run, n):
    """Device busy ms per call of ``run`` and the profiler's events, from a
    torch.profiler window over ``n`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    # device activity only: the same kernels and busy ms as with the host's
    # operator events too, and a fraction of the window's wall time where a
    # request makes thousands of small launches (the SIFT entries)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            run(i)
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    return sum(e.self_device_time_total for e in evs) / (n * 1e3), evs


def attention_ptxas(source="attention.cu",
                    pattern=r"\d(attention|bidir_attention)_kernel"
                            r"ILi(\d+)E(?:Li(\d+)ELi(\d+)E)?fE"):
    """Registers and spill bytes of each kernel of ``source`` whose name
    matches ``pattern`` (groups: the name, then its template arguments),
    from the build's ptxas log: for K3, K4 and K5's float32 kernels (the
    tile's float instances, ``f`` in the mangled name; the bf16 ones are
    K3/K4's for LightGlue in bf16)
    {"attention<8><64><64>": {"registers": r, "spill_bytes": b,
    "stack_bytes": s}, "bidir_attention<8>": ..., ...}; for K14 and K5's
    bf16 kernels {"qtiled_attention<64><128><0>": ...}."""
    import re

    from imcui_tpu_torch.ops import _build

    text = _build.library_path().with_suffix(".log").read_text()
    text = text.split(f"== {source}", 1)[1].split("\n== ", 1)[0]
    out, name = {}, None
    for line in text.splitlines():
        hit = re.search(pattern, line)
        if "Compiling entry function" in line and hit:
            name = hit.group(1) + "".join(
                f"<{g}>" for g in hit.groups()[1:] if g is not None)
            out[name] = {"registers": None, "spill_bytes": 0,
                         "stack_bytes": 0}
        elif name and "spill stores" in line:
            out[name]["spill_bytes"] = sum(
                int(x) for x in re.findall(r"(\d+) bytes spill", line))
            out[name]["stack_bytes"] = int(
                re.search(r"(\d+) bytes stack frame", line).group(1))
        elif name and "registers" in line:
            out[name]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    return out


QTILED_PATTERN = r"(qtiled_attention)_kernelILi(\d+)ELi(\d+)ELb(\d)E"


def qtiled_launch(h, nq, nk):
    """K14's launch plan at this shape (query rows a CTA, CTAs, CTAs an SM
    holds, rounds, the busiest SM's rows) with its kernel's registers and
    spills."""
    from imcui_tpu_torch.ops import attention

    plan = attention.qtiled_plan(h, nq, nk)
    plan.update(attention_ptxas("qtiled_attention.cu", QTILED_PATTERN)[
        "qtiled_attention<64><128><0>"])
    return plan


def flash_launch(s, nq, dh, dtype):
    """K5's launch plan at this shape (query rows a block, blocks, blocks an
    SM holds, rounds) with its kernel's registers and spills: float32 on
    attention.cu's tile, bf16 on qtiled_attention.cu's body."""
    import torch

    from imcui_tpu_torch.ops import attention

    plan = attention.flash_plan(s, nq, dh, dtype)
    if dtype == torch.float32:
        key = f"attention<{plan['query_tile'] // 16}><{dh}><" \
              f"{64 if dh == 64 else 32}>"
        plan.update(attention_ptxas()[key])
    else:
        key = f"qtiled_attention<{dh}><{128 if dh == 64 else 64}><1>"
        plan.update(attention_ptxas("qtiled_attention.cu",
                                    QTILED_PATTERN)[key])
    plan["kernel"] = key
    return plan


def library_sdpa(*calls):
    """One PyTorch SDPA call per (q, k, v, key_mask, heads) on its 4-D
    view, on the fused backend that takes it, timed as cuda_ms times the
    kernels: {"ms", "backend"} (tools/attention_times.time_sdpa)."""
    from imcui_tpu_torch.tools.attention_times import time_sdpa

    return time_sdpa(cuda_ms, *calls)


def library_queued_sdpa(*calls):
    """The same SDPA calls' time queued as cuda_ms_queued times the
    kernels."""
    from imcui_tpu_torch.tools.attention_times import time_sdpa

    return time_sdpa(cuda_ms_queued, *calls)["ms"]


def attention_launch(kind, s, n, m=None):
    """K3's or K4's launch plan at this shape (query tile, blocks, blocks
    an SM holds, rounds) with its kernel's registers and spills."""
    from imcui_tpu_torch.ops import attention

    plan = attention.attention_plan(s, n, m)
    qr = plan["query_tile"] // 16
    plan.update(attention_ptxas()[
        f"attention<{qr}><64><64>" if kind == "fused"
        else f"bidir_attention<{qr}>"])
    return plan


def conv_ptxas():
    """Registers, spills and stack of K1's and the stem's kernels from the
    build's ptxas log: {"stage_tail": {...}, "stem_tail<f>": {...},
    "stem_tail<13__nv_bfloat16>": {...}}."""
    out = attention_ptxas("stage_tail.cu", CONV_PATTERN)
    out.update(attention_ptxas("stem_tail.cu", CONV_PATTERN))
    return out


def conv_launch(b, h, w, kernel):
    """The launch plan of stage_conv.cuh's tile at (B, H, W) (tile,
    strips, segments a strip, tiles a segment, CTAs, SMs, rounds) with
    ``kernel``'s registers and spills."""
    from imcui_tpu_torch.ops import cuda_stage1

    plan = cuda_stage1.conv_plan(b, h, w)
    plan.update(conv_ptxas()[kernel])
    return plan


NMS_PATTERN = r"(nms_cellmax)_kernelILi(\d+)E"


def nms_launch(b, h, w, radius):
    """K2's launch plan at (B, H, W, radius) (output rows and columns a
    block, region rows, blocks, blocks an SM holds, SMs, rounds, shared
    memory a block) with its kernel's registers, spills and stack."""
    from imcui_tpu_torch.ops import cuda_nms

    plan = cuda_nms.nms_plan(b, h, w, radius)
    plan.update(attention_ptxas("nms_cellmax.cu", NMS_PATTERN)[
        f"nms_cellmax<{radius}>"])
    return plan


def nms_heats(gen, b, h, w):
    """K2's inputs at one shape: torch.rand and a tie-heavy map of 4 bf16
    levels (every window holds equal values), both bf16."""
    import torch

    rand = torch.rand((b, h, w), generator=gen, device="cuda")
    levels = torch.tensor([0.125, 0.25, 0.5, 0.75], device="cuda")
    ties = levels[torch.randint(0, 4, (b, h, w), generator=gen,
                                device="cuda")]
    return {"rand": rand.to(torch.bfloat16), "ties": ties.to(torch.bfloat16)}


def nms_exact(heat, vwh, radius):
    """The largest difference of K2's two maps from the plain version's
    (the tolerance is 0); fails the run otherwise."""
    import torch

    from imcui_tpu_torch.ops import cuda_nms

    cm, cs = cuda_nms.nms_cellmax(heat, vwh, radius=radius)
    pm, ps = cuda_nms.nms_cellmax_plain(heat, vwh, radius=radius)
    err = max((cm - pm).abs().max().item(), (cs - ps).abs().max().item())
    if err != 0.0 or not (torch.equal(cm, pm) and torch.equal(cs, ps)):
        fail(f"nms_cellmax {tuple(heat.shape)} radius {radius} differs from "
             f"its plain version: {err}")
    return err, pm.abs().max().item()


def conv_sass():
    """Counts of the CONV_SASS instructions in K1's kernel and in each
    instance of the stem's; fails the run if one is missing from the
    library or lacks wgmma or the TMA load."""
    import re

    found = {}
    for frag in ("stage_tail_kernel", "stem_tail_kernel"):
        for name, counts in kernel_sass(frag, CONV_SASS).items():
            hit = re.search(CONV_PATTERN, name)
            found[hit.group(1) + (f"<{hit.group(2)}>" if hit.group(2)
                                  else "")] = counts
    log(f"  conv kernels' SASS: {found}")
    for inst in CONV_INSTANCES:
        missing = [op for op in CONV_SASS if not found.get(inst, {}).get(op)]
        if missing:
            fail(f"{inst}_kernel: no {', '.join(missing)} in its SASS")
    return found


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase0():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    log(smi_line)
    from imcui_tpu_torch.ops import _build

    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, nvcc: {nvcc}")
    t0 = time.perf_counter()
    _build.library()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds if _build.build_seconds else 0:.1f} s; "
        f"0 = already built)")
    t0 = time.perf_counter()
    _build.host_library()
    log(f"host library (csrc/host, {_build._cxx()}): "
        f"{time.perf_counter() - t0:.2f} s to build and load "
        f"{_build.host_library_path().name}")
    return smi_line


def phase1(params, peaks):
    """Each kernel against its plain version at the serving shapes."""
    import torch
    import torch.nn.functional as F

    from imcui_tpu_torch.models.extractors.superpoint import BF16_FUSED
    from imcui_tpu_torch.models.layers import full_fp32
    from imcui_tpu_torch.ops import attention, cuda_nms, cuda_stage1

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    sp = params["superpoint"]
    rows = []

    # K1: stage_tail at both stages of 2·BATCH images. Both are checked; the
    # row's times count the stages the default route runs through it (stage
    # 1 goes to the stem kernel when that is the default).
    b = 2 * BATCH
    k1_stages = 1 if BF16_FUSED == "stem" else 2
    k1 = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
          "library_ms": 0.0, "max_abs_err": 0.0, "max_plain": 0.0,
          "flops": 0.0, "bytes": 0.0}
    k1_sass = conv_sass()
    k1_launch = {}
    for pa, pb, hw in (("conv1a", "conv1b", CANVAS),
                       ("conv2a", "conv2b", CANVAS // 2)):
        y = (torch.randn((b, hw, hw, 64), generator=gen, device=dev) * 0.5
             ).to(torch.bfloat16)
        ba, wb, bb = sp[pa]["b"], sp[pb]["w"], sp[pb]["b"]
        with full_fp32():
            got = cuda_stage1.stage_tail(y, ba, wb, bb)
            want = cuda_stage1.stage_tail_plain(y, ba, wb, bb)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            # one bf16 rounding step of the result: 2^-7 relative
            tol = 1e-3 + 2.0 ** -7 * want.float().abs()
            if not bool((diff <= tol).all()):
                fail(f"stage_tail {hw}: max |err| {diff.max().item()} over "
                     f"tolerance (1e-3 + 2^-7·|plain|)")
            k1["max_abs_err"] = max(k1["max_abs_err"], diff.max().item())
            k1["max_plain"] = max(k1["max_plain"],
                                  want.float().abs().max().item())
            if hw == CANVAS and k1_stages == 1:
                del y, got, want, diff, tol
                torch.cuda.empty_cache()
                continue
            k1["ms"] += cuda_ms(lambda: cuda_stage1.stage_tail(y, ba, wb, bb))
            k1["device_ms"] += cuda_ms_queued(
                lambda: cuda_stage1.stage_tail(y, ba, wb, bb))
            k1_launch[f"{b}x{hw}x{hw}"] = conv_launch(b, hw, hw, "stage_tail")
            k1["plain_ms"] += cuda_ms(
                lambda: cuda_stage1.stage_tail_plain(y, ba, wb, bb))
        # library yardstick: bf16 channels-last cuDNN conv + relu + pool
        y_nchw = y.permute(0, 3, 1, 2)
        ba16, wb16, bb16 = (t.to(torch.bfloat16) for t in (ba, wb, bb))
        wb16 = wb16.contiguous(memory_format=torch.channels_last)
        k1["library_ms"] += cuda_ms(lambda: F.max_pool2d(torch.relu(F.conv2d(
            torch.relu(y_nchw + ba16.view(1, -1, 1, 1)), wb16, bb16,
            padding=1)), 2, 2))
        flops = 2.0 * b * hw * hw * 9 * 64 * 64
        nbytes = b * hw * hw * 64 * 2 + b * (hw // 2) ** 2 * 64 * 2 \
            + 9 * 64 * 64 * 2 + 2 * 64 * 4
        t, _ = bound(flops, nbytes, peaks["bf16"], peaks)
        k1["bound_ms"] += t
        k1["flops"] += flops
        k1["bytes"] += nbytes
        del y, got, want, diff, tol, y_nchw
        torch.cuda.empty_cache()
    rows.append({
        "name": "stage_tail", "route": "cuda",
        "source": "imcui_tpu_torch/csrc/stage_tail.cu",
        "replaces": "imcui_tpu/ops/pallas_stage1.py:164",
        "launches_per_step": k1_stages,
        "tolerance": "1e-3 + 2^-7*|plain| (bf16)",
        "max_abs_err": k1["max_abs_err"],
        "rel_err": k1["max_abs_err"] / k1["max_plain"], "ms": k1["ms"],
        "device_ms": k1["device_ms"], "launch": k1_launch, "sass": k1_sass,
        "plain_ms": k1["plain_ms"], "library_ms": k1["library_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": "operations"
        if k1["flops"] / peaks["bf16"] >= k1["bytes"] / peaks["bw"]
        else "bytes"})

    # K2: nms_cellmax on a heatmap of 2·BATCH canvases, some part-valid,
    # uniform and tie-heavy
    from imcui_tpu_torch.tools.nms_times import work as nms_work

    heats = nms_heats(gen, b, CANVAS, CANVAS)
    vwh = torch.tensor([[CANVAS, CANVAS], [1000, 752], [1024, 760],
                        [848, 640]] * (b // 4), dtype=torch.int32, device=dev)
    err, top = max(nms_exact(h_, vwh, 4) for h_ in heats.values())
    heat = heats["rand"]
    # bytes over the memory rate; the chain's maxes and compares over the
    # packed bf16 rate, two a lane a clock: the float32 FMA peak's count
    nbytes, ops = nms_work(b, CANVAS, CANVAS, 4)
    t, by = bound(ops, nbytes, peaks["fp32"], peaks)
    k2 = {
        "name": "nms_cellmax", "route": "cuda",
        "source": "imcui_tpu_torch/csrc/nms_cellmax.cu",
        "replaces": "imcui_tpu/ops/pallas_nms.py:243",
        "launches_per_step": 1, "tolerance": "exact", "max_abs_err": err,
        "rel_err": err / top, "checked": sorted(heats),
        "ms": cuda_ms(lambda: cuda_nms.nms_cellmax(heat, vwh)),
        "queued_ms": cuda_ms_queued(lambda: cuda_nms.nms_cellmax(heat, vwh)),
        "launch": nms_launch(b, CANVAS, CANVAS, 4),
        "plain_ms": cuda_ms(lambda: cuda_nms.nms_cellmax_plain(heat, vwh)),
        "library_ms": None, "bound_ms": t, "bound_by": by,
        "bytes_ms": nbytes / peaks["bw"] * 1e3,
        "operations_ms": ops / peaks["fp32"] * 1e3}
    k2["device_ms"] = k2["queued_ms"]  # the name the log below reads
    rows.append(k2)
    del heat, heats

    # K3 / K4: LightGlue attention at 1024 keypoints, f32
    n, dh = MAX_KPTS, 64
    mask_img = torch.ones((b, n), dtype=torch.bool, device=dev)
    mask_img[1, 700:] = False
    mask_img[2, :] = False          # an image without keypoints
    mask_img[5, 300:] = False

    def rnd(s, rows_):
        return torch.randn((s, rows_, dh), generator=gen, device=dev) * 2.0

    def check(name, got, want):
        """(max abs error, that over max|plain|); fails past the
        tolerance: f32 with the sums in another order."""
        top = max(w.abs().max().item() for w in want)
        e = max((g - w).abs().max().item() for g, w in zip(got, want))
        if e > 1e-5 * max(1.0, top):
            fail(f"{name}: max |err| {e} over 1e-5 · max(1, max|plain|)")
        return e, e / top

    s = b * HEADS
    q, k, v = rnd(s, n), rnd(s, n), rnd(s, n)
    with full_fp32():
        e3, rel3 = check("fused_attention",
                   [attention.fused_attention(q, k, v, mask_img, HEADS)],
                   [attention.fused_attention_plain(q, k, v, mask_img, HEADS)])
        ms3 = cuda_ms(lambda: attention.fused_attention(q, k, v, mask_img,
                                                        HEADS))
        dev3 = cuda_ms_queued(lambda: attention.fused_attention(
            q, k, v, mask_img, HEADS))
        plain3 = cuda_ms(lambda: attention.fused_attention_plain(
            q, k, v, mask_img, HEADS))
    lib3 = library_sdpa((q, k, v, mask_img, HEADS))
    flops3 = 4.0 * s * n * n * dh
    bytes3 = 4 * s * n * dh * 4 + b * n
    t3, by3 = bound(flops3, bytes3, peaks["fp32"], peaks)
    rows.append({
        "name": "fused_attention", "route": "cuda",
        "source": "imcui_tpu_torch/csrc/attention.cu",
        "replaces": "imcui_tpu/ops/attention.py:263",
        "launches_per_step": N_LAYERS, "tolerance": "1e-5*max(1,|plain|)",
        "max_abs_err": e3, "rel_err": rel3, "ms": N_LAYERS * ms3,
        "plain_ms": N_LAYERS * plain3, "library_ms": N_LAYERS * lib3["ms"],
        "library_backend": lib3["backend"],
        "bound_ms": N_LAYERS * t3, "bound_by": by3,
        "device_ms": N_LAYERS * dev3,
        "launch": attention_launch("fused", s, n)})
    del q, k, v

    s = BATCH * HEADS
    m0, m1 = mask_img[:BATCH], mask_img[BATCH:]
    a0, a1, v0, v1 = rnd(s, n), rnd(s, n), rnd(s, n), rnd(s, n)
    with full_fp32():
        e4, rel4 = check("bidirectional_attention",
                   attention.bidirectional_attention(a0, a1, v0, v1, m0, m1,
                                                     HEADS),
                   attention.bidirectional_attention_plain(a0, a1, v0, v1,
                                                           m0, m1, HEADS))
        ms4 = cuda_ms(lambda: attention.bidirectional_attention(
            a0, a1, v0, v1, m0, m1, HEADS))
        dev4 = cuda_ms_queued(lambda: attention.bidirectional_attention(
            a0, a1, v0, v1, m0, m1, HEADS))
        plain4 = cuda_ms(lambda: attention.bidirectional_attention_plain(
            a0, a1, v0, v1, m0, m1, HEADS))
    lib4 = library_sdpa((a0, a1, v1, m1, HEADS), (a1, a0, v0, m0, HEADS))
    flops4 = s * (2.0 * n * n * dh + 2 * 2.0 * n * n * dh)   # minimal work
    bytes4 = 6 * s * n * dh * 4 + 2 * BATCH * n
    t4, by4 = bound(flops4, bytes4, peaks["fp32"], peaks)
    rows.append({
        "name": "bidirectional_attention", "route": "cuda",
        "source": "imcui_tpu_torch/csrc/attention.cu",
        "replaces": "imcui_tpu/ops/attention.py:385",
        "launches_per_step": N_LAYERS, "tolerance": "1e-5*max(1,|plain|)",
        "max_abs_err": e4, "rel_err": rel4, "ms": N_LAYERS * ms4,
        "plain_ms": N_LAYERS * plain4, "library_ms": N_LAYERS * lib4["ms"],
        "library_backend": lib4["backend"],
        "bound_ms": N_LAYERS * t4, "bound_by": by4,
        "bound_ms_with_recompute": N_LAYERS * bound(
            flops4 * 4 / 3, bytes4, peaks["fp32"], peaks)[0],
        "device_ms": N_LAYERS * dev4,
        "launch": attention_launch("bidir", s, n, n)})
    for r in rows:
        r["per"] = "step of the serving path"
        log(f"  {r['name']}: err {r['max_abs_err']:.3g} (relative "
            f"{r['rel_err']:.3g}; tolerance {r['tolerance']}), "
            f"{r['ms']:.3f} ms/step vs plain {r['plain_ms']:.3f}, library "
            f"{r['library_ms']} ({r.get('library_backend')}), bound "
            f"{r['bound_ms']:.4f} "
            f"({r['bound_by']})")
        if "launch" in r:
            log(f"    {r['device_ms']:.3f} ms/step queued (no host time); "
                f"launch: {r['launch']}")
    return rows


def phase1_general(params, peaks):
    """The two kernels the general path adds (K5 and the stem) and K1, K2
    and K4 at the general path's shapes, each against its plain version."""
    import torch
    import torch.nn.functional as F

    from imcui_tpu_torch.models.extractors import superpoint as spm
    from imcui_tpu_torch.models.layers import full_fp32
    from imcui_tpu_torch.ops import attention, cuda_nms, cuda_stage1

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    sp = params["superpoint"]
    rows = []

    def rnd(s, n, dh, dtype=torch.float32):
        return (torch.randn((s, n, dh), generator=gen, device=dev) * 2.0
                ).to(dtype)

    # K5: flash_attention. The first case is the main path's launch: both
    # views of one pair, 4 heads each, 4096 keypoint slots, f32.
    sass = flash_sass()
    cases = [  # name, S, Nq, Nk, Dh, dtype
        ("self 4096", 2 * HEADS, G_KPTS, G_KPTS, 64, torch.float32),
        ("Nq 1024, Nk 4096", 2 * HEADS, 1024, G_KPTS, 64, torch.float32),
        ("ragged 4000", 2 * HEADS, 4000, 4000, 64, torch.float32),
        ("Dh 128", 2 * HEADS, 2048, 2048, 128, torch.float32),
        ("bf16", 2 * HEADS, G_KPTS, G_KPTS, 64, torch.bfloat16),
        ("bf16 ragged 4000", 2 * HEADS, 4000, 4000, 64, torch.bfloat16),
        ("bf16 Dh 128", 2 * HEADS, 2048, 2048, 128, torch.bfloat16),
    ]
    timed = {}
    for name, s, nq, nk, dh, dtype in cases:
        q, k, v = rnd(s, nq, dh, dtype), rnd(s, nk, dh, dtype), \
            rnd(s, nk, dh, dtype)
        mask = torch.ones((s // HEADS, nk), dtype=torch.bool, device=dev)
        mask[0, nk // 2:] = False
        mask[1, :] = False          # a view without keypoints: the mean of V
        with full_fp32():
            got = attention.flash_attention(q, k, v, mask, HEADS)
            want = attention.flash_attention_plain(q, k, v, mask, HEADS)
        torch.cuda.synchronize()
        top = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        # f32: the same arithmetic summed in another order; bf16: one
        # rounding step of the result on top
        tol = (1e-5 if dtype == torch.float32 else 2.0 ** -7) * max(1.0, top)
        mean_v = v[HEADS:].float().mean(1, keepdim=True).expand(-1, nq, -1)
        err_mean = (got[HEADS:].float() - mean_v).abs().max().item()
        launch = flash_launch(s, nq, dh, dtype)
        log(f"  flash_attention [{name}]: err {err:.3g} (tolerance {tol:.3g}),"
            f" masked view vs mean of V {err_mean:.3g}; launch {launch}")
        if not err <= tol or not err_mean <= tol:
            fail(f"flash_attention [{name}] differs from its plain version")
        if name not in ("self 4096", "bf16"):
            continue
        with full_fp32():
            t = {"ms": cuda_ms(lambda: attention.flash_attention(
                     q, k, v, mask, HEADS)),
                 "queued_ms": cuda_ms_queued(lambda: attention.flash_attention(
                     q, k, v, mask, HEADS)),
                 "plain_ms": cuda_ms(lambda: attention.flash_attention_plain(
                     q, k, v, mask, HEADS))}
        lib = library_sdpa((q, k, v, mask, HEADS))
        flops = 4.0 * s * nq * nk * dh
        nbytes = (2 * s * nq * dh + 2 * s * nk * dh) * q.element_size() \
            + mask.numel()
        t["bound_ms"], t["bound_by"] = bound(
            flops, nbytes,
            peaks["fp32" if dtype == torch.float32 else "bf16"], peaks)
        t.update(library_ms=lib["ms"], library_backend=lib["backend"],
                 library_queued_ms=library_queued_sdpa((q, k, v, mask, HEADS)),
                 launch=launch, max_abs_err=err, rel_err=err / top)
        timed[name] = t
        log(f"    {t['ms']:.3f} ms ({t['queued_ms']:.4f} queued) vs plain "
            f"{t['plain_ms']:.3f}, SDPA {t['library_ms']:.3f} "
            f"({t['library_queued_ms']:.4f} queued; {t['library_backend']}), "
            f"bound {t['bound_ms']:.4f} ({t['bound_by']})")
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": "imcui_tpu_torch/csrc/attention.cu",
        "replaces": "imcui_tpu/ops/attention.py:155",
        "tolerance": "1e-5*max(1,|plain|) f32, 2^-7*max(1,|plain|) bf16",
        **timed["self 4096"], "device_ms": timed["self 4096"]["queued_ms"],
        "sass": sass,
        "bf16_at_4096": {"source": "imcui_tpu_torch/csrc/qtiled_attention.cu",
                         **timed["bf16"]},
        "per": f"launch at {2 * HEADS} x {G_KPTS} x {G_KPTS} x 64 f32 "
               f"(one pair)"})
    del q, k, v, got, want
    torch.cuda.empty_cache()

    # the stem (K6/K7): both image types at the turbo batch, at a
    # 2048x1536 batch and at the general path's canvas
    pa, pb = sp["conv1a"], sp["conv1b"]
    conv_a = torch.nn.Conv2d(1, 64, 3, padding=1).to(dev, torch.bfloat16)
    conv_b = torch.nn.Conv2d(64, 64, 3, padding=1).to(dev, torch.bfloat16)
    with torch.no_grad():
        conv_a.weight.copy_(pa["w"])
        conv_a.bias.copy_(pa["b"])
        conv_b.weight.copy_(pb["w"])
        conv_b.bias.copy_(pb["b"])
    conv_a, conv_b = (c.to(memory_format=torch.channels_last)
                      for c in (conv_a, conv_b))
    stem_row = None
    decision = {}
    for b, h, w, dtype in ((2 * BATCH, CANVAS, CANVAS, torch.float32),
                           (2 * BATCH, CANVAS, CANVAS, torch.bfloat16),
                           (2, 1536, 2048, torch.float32),
                           (2, 1536, 2048, torch.bfloat16),
                           (1, *G_CANVAS, torch.bfloat16)):
        img = torch.rand((b, h, w), generator=gen, device=dev).to(dtype)
        args = (img, pa["w"], pa["b"], pb["w"], pb["b"])
        got = cuda_stage1.stem_tail(*args).float()
        want = cuda_stage1.stem_tail_plain(*args).float()
        torch.cuda.synchronize()
        diff = (got - want).abs()
        # one bf16 rounding step of the result, as stage_tail
        over = int((diff > 1e-3 + 2.0 ** -7 * want.abs()).sum())
        err, top = diff.max().item(), want.abs().max().item()
        del got, want, diff
        # the other route to the same function, conv1a + stage_tail, timed
        # in turns with the stem kernel (staged, stem, stem, staged)
        x16 = img.to(torch.bfloat16)[:, None]
        p16 = {k: {n: t.to(torch.bfloat16) for n, t in sp[k].items()}
               for k in ("conv1a", "conv1b")}

        def staged():
            return spm._stage(p16["conv1a"], p16["conv1b"], x16, True)

        def stem():
            return cuda_stage1.stem_tail(*args)

        turns = [cuda_ms(staged), cuda_ms(stem), cuda_ms(stem),
                 cuda_ms(staged)]
        staged_ms = (turns[0] + turns[3]) / 2
        stem_ms = (turns[1] + turns[2]) / 2
        queued = cuda_ms_queued(stem)
        kernel = "stem_tail<f>" if dtype == torch.float32 \
            else "stem_tail<13__nv_bfloat16>"
        launch = conv_launch(b, h, w, kernel)
        decision[f"{b}x{h}x{w} {str(dtype)[6:]}"] = {
            "stem_ms": stem_ms, "stem_queued_ms": queued,
            "conv1a_plus_stage_tail_ms": staged_ms}
        log(f"  stem_tail [{b}x{h}x{w} {str(dtype)[6:]}]: err {err:.3g} "
            f"(max|plain| {top:.3g}; {over} over 1e-3 + 2^-7*|plain|), "
            f"{stem_ms:.3f} ms ({queued:.4f} queued) vs conv1a + stage_tail "
            f"{staged_ms:.3f} ms; launch {launch}")
        if over:
            fail("stem_tail differs from its plain version")
        if (b, h, w) == (1, *G_CANVAS):
            plain = cuda_ms(lambda: cuda_stage1.stem_tail_plain(*args), 5, 1)
            xcl = x16.contiguous(memory_format=torch.channels_last)
            with torch.no_grad():
                lib = cuda_ms(lambda: F.max_pool2d(torch.relu(conv_b(
                    torch.relu(conv_a(xcl)))), 2, 2))
            flops = 2.0 * b * h * w * (9 * 64 + 9 * 64 * 64)
            nbytes = img.numel() * img.element_size() \
                + b * (h // 2) * (w // 2) * 64 * 2 + 9 * 64 * 64 * 2 \
                + 9 * 64 * 4 + 2 * 64 * 4
            t, by = bound(flops, nbytes, peaks["bf16"], peaks)
            stem_row = {
                "name": "stem_tail", "route": "cuda",
                "source": "imcui_tpu_torch/csrc/stem_tail.cu",
                "replaces": "imcui_tpu/ops/pallas_stage1.py:370 and "
                            "imcui_tpu/ops/pallas_conv.py:140",
                "tolerance": "1e-3 + 2^-7*|plain| (bf16)",
                "max_abs_err": err, "rel_err": err / top, "ms": stem_ms,
                "device_ms": queued, "launch": launch,
                "plain_ms": plain, "library_ms": lib, "bound_ms": t,
                "bound_by": by, "conv1a_plus_stage_tail_ms": staged_ms,
                "per": f"launch at {b} x {h} x {w} bf16 (one image)"}
        del img, x16, args
        torch.cuda.empty_cache()
    rows.append(stem_row)
    default = "stem" if spm.BF16_FUSED == "stem" else "conv1a + stage_tail"
    log(f"  stem decision: the bf16 default is {default}")

    # K1 and K2 at the general path's canvas and at a 2048x1536 batch
    # (nms_radius 3 is superpoint_aachen's and superpoint_max's)
    for b, h, w, radius in ((1, *G_CANVAS, 4), (2, 1536, 2048, 3)):
        y = (torch.randn((b, h, w, 64), generator=gen, device=dev) * 0.5
             ).to(torch.bfloat16)
        ba, wb, bb = pa["b"], pb["w"], pb["b"]
        with full_fp32():
            got = cuda_stage1.stage_tail(y, ba, wb, bb).float()
            want = cuda_stage1.stage_tail_plain(y, ba, wb, bb).float()
        diff = (got - want).abs()
        over = int((diff > 1e-3 + 2.0 ** -7 * want.abs()).sum())
        log(f"  stage_tail [{b}x{h}x{w}]: err {diff.max().item():.3g}, "
            f"{over} over tolerance, "
            f"{cuda_ms(lambda: cuda_stage1.stage_tail(y, ba, wb, bb)):.3f} ms"
            f" ({cuda_ms_queued(lambda: cuda_stage1.stage_tail(y, ba, wb, bb)):.4f}"
            f" queued); launch {conv_launch(b, h, w, 'stage_tail')}")
        if over:
            fail("stage_tail differs from its plain version")
        del y, got, want, diff
        heats = nms_heats(gen, b, h, w)
        vwh = torch.tensor([[1600, 1200], [w, h]][:b], dtype=torch.int32,
                           device=dev)
        err = max(nms_exact(h_, vwh, radius)[0] for h_ in heats.values())
        heat = heats["rand"]
        log(f"  nms_cellmax [{b}x{h}x{w}, radius {radius}]: exact on "
            f"{sorted(heats)} (err {err}), "
            f"{cuda_ms(lambda: cuda_nms.nms_cellmax(heat, vwh, radius=radius)):.4f} ms"
            f" ({cuda_ms_queued(lambda: cuda_nms.nms_cellmax(heat, vwh, radius=radius)):.4f}"
            f" queued); launch {nms_launch(b, h, w, radius)}")
        del heat, heats
        torch.cuda.empty_cache()

    # K4 at 4096 x 4096 (the JAX package leaves this size to XLA)
    s, n = HEADS, G_KPTS
    a0, a1, v0, v1 = (rnd(s, n, 64) for _ in range(4))
    m0 = torch.ones((1, n), dtype=torch.bool, device=dev)
    m1 = m0.clone()
    m1[0, 3000:] = False
    with full_fp32():
        got = attention.bidirectional_attention(a0, a1, v0, v1, m0, m1, HEADS)
        want = attention.bidirectional_attention_plain(a0, a1, v0, v1, m0,
                                                       m1, HEADS)
        top = max(t.abs().max().item() for t in want)
        err = max((g - t).abs().max().item() for g, t in zip(got, want))
        ms4 = cuda_ms(lambda: attention.bidirectional_attention(
            a0, a1, v0, v1, m0, m1, HEADS))
        dev4 = cuda_ms_queued(lambda: attention.bidirectional_attention(
            a0, a1, v0, v1, m0, m1, HEADS))
        plain4 = cuda_ms(lambda: attention.bidirectional_attention_plain(
            a0, a1, v0, v1, m0, m1, HEADS), 5, 1)
    lib4 = library_sdpa((a0, a1, v1, m1, HEADS), (a1, a0, v0))
    flops4 = s * 3 * 2.0 * n * n * 64          # minimal work
    bytes4 = 6 * s * n * 64 * 4 + 2 * n
    t4, by4 = bound(flops4, bytes4, peaks["fp32"], peaks)
    t4r = bound(flops4 * 4 / 3, bytes4, peaks["fp32"], peaks)[0]
    launch4 = attention_launch("bidir", s, n, n)
    # f32 sums over four times the keys of the serving shape: their
    # rounding error grows with the root of the count, so twice its bound
    tol = 2e-5 * max(1.0, top)
    log(f"  bidirectional_attention [{s} x {n} x {n}]: err {err:.3g} "
        f"(tolerance {tol:.3g}), {ms4:.3f} ms ({dev4:.3f} queued) vs plain "
        f"{plain4:.3f}, two "
        f"SDPA calls {lib4['ms']:.3f} ({lib4['backend']}), "
        f"bound {t4:.4f} ({by4}; {t4r:.4f} with the "
        f"recompute); launch {launch4}")
    if not err <= tol:
        fail("bidirectional_attention differs from its plain version at 4096")
    for r in rows:
        log(f"  {r['name']}: {r['ms']:.3f} ms per {r['per']} vs plain "
            f"{r['plain_ms']:.3f}, library {r['library_ms']:.3f} "
            f"({r.get('library_backend', 'cuDNN')}), bound "
            f"{r['bound_ms']:.4f} ({r['bound_by']})")
    return rows, {"stem_decision": decision, "bf16_default": default,
                  "bidir_4096": {
                      "ms": ms4, "device_ms": dev4, "plain_ms": plain4,
                      "library_ms": lib4["ms"],
                      "library_backend": lib4["backend"],
                      "bound_ms": t4, "bound_by": by4,
                      "bound_ms_with_recompute": t4r, "max_abs_err": err,
                      "launch": launch4}}


def phase2():
    """Serving through TurboMatcher: counters and the homography gate."""
    import torch

    from imcui_tpu_torch.api.turbo import TurboMatcher
    from imcui_tpu_torch.models.extractors.superpoint import BF16_FUSED
    from imcui_tpu_torch.ops import attention, cuda_nms, cuda_stage1

    tm = TurboMatcher(device="cuda", canvas=CANVAS, max_keypoints=MAX_KPTS,
                      n_layers=N_LAYERS, batch_size=BATCH,
                      num_hypotheses=HYPOTHESES)
    log(f"  weights: {tm.meta}")
    if not (tm.meta["superpoint"]["pretrained"]
            and tm.meta["lightglue"]["pretrained"]):
        fail("serving did not load the weights/ npz trees")
    pairs = [synthetic_pair(100 + i, *REQUEST_SIZES[i % len(REQUEST_SIZES)])
             for i in range(N_REQUESTS)]
    batches = [0]
    run = tm._batcher.run_batch

    def counted(items):
        batches[0] += 1
        return run(items)

    tm._batcher.run_batch = counted
    kernels = (cuda_stage1.stage_tail, cuda_stage1.stem_tail,
               cuda_nms.nms_cellmax, attention.fused_attention,
               attention.bidirectional_attention)
    stem = int(BF16_FUSED == "stem")  # stage 1 through the stem kernel
    per_batch = (2 - stem, stem, 1, N_LAYERS, N_LAYERS)
    for kfn in kernels:
        kfn.launches = 0
    results = [None] * N_REQUESTS
    errors = []

    def worker(t):
        for i in range(t, N_REQUESTS, N_THREADS):
            try:
                results[i] = tm.match(pairs[i][0], pairs[i][1])
            except Exception as e:  # reported below; the run then fails
                errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(N_THREADS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    tm.close()
    if errors or any(th.is_alive() for th in threads) or None in results:
        fail(f"serving requests failed: {errors[:3]}")
    log(f"  {N_REQUESTS} requests from {N_THREADS} threads in {wall:.2f} s, "
        f"{batches[0]} batches; launches {launches}")
    for kfn, per in zip(kernels, per_batch):
        if batches[0] == 0 or kfn.launches != per * batches[0]:
            fail(f"{kfn.__name__}: {kfn.launches} launches for "
                 f"{batches[0]} batches (expected {per} per batch)")
    for i, (res, (_, _, hm)) in enumerate(zip(results, pairs)):
        for key in ("mkeypoints0_orig", "mkeypoints1_orig", "mconf", "M"):
            if not np.isfinite(res[key]).all():
                fail(f"request {i}: non-finite {key}")
        err = transfer_errors(hm, res["mkeypoints0_orig"],
                              res["mkeypoints1_orig"])
        med = float(np.median(err)) if len(err) else float("inf")
        log(f"  request {i} {REQUEST_SIZES[i % len(REQUEST_SIZES)]}: "
            f"{res['num_inliers']} inliers, {len(res['keypoints0_orig'])}/"
            f"{len(res['keypoints1_orig'])} keypoints, median transfer "
            f"error {med:.3f} px")
        if len(err) < GATE_MIN_INLIERS or med > GATE_MEDIAN_PX:
            fail(f"request {i}: gate is >= {GATE_MIN_INLIERS} inliers with "
                 f"median error <= {GATE_MEDIAN_PX} px")
    return launches


def phase3(params):
    """match_step at bench.py's operating point: pairs/s and stage split."""
    import torch

    from imcui_tpu_torch.models.extractors import superpoint as sp
    from imcui_tpu_torch.models.matchers import lightglue as lg
    from imcui_tpu_torch.ops import ransac as ransac_ops
    from imcui_tpu_torch.pipeline import two_view

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    valid = torch.tensor([[CANVAS, CANVAS]] * BATCH, dtype=torch.int32,
                         device=dev)
    warmup, iters = 3, 20

    def images():
        return (torch.rand((BATCH, 1, CANVAS, CANVAS), generator=gen,
                           device=dev),
                torch.rand((BATCH, 1, CANVAS, CANVAS), generator=gen,
                           device=dev))

    def step():
        im0, im1 = images()
        return two_view.match_step(params, im0, im1, valid, valid, gen,
                                   max_keypoints=MAX_KPTS,
                                   num_hypotheses=HYPOTHESES,
                                   ransac="fundamental", device=dev)

    with torch.inference_mode():
        for _ in range(warmup):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            out = step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if not all(torch.isfinite(out[k].float()).all()
                   for k in ("matching_scores0", "M")):
            fail("match_step produced non-finite outputs")

        # per-stage split with CUDA events, the same calls match_step makes
        split = {"superpoint": [], "lightglue": [], "ransac": []}
        for it in range(warmup + iters):
            im0, im1 = images()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            f = sp.apply(params["superpoint"], torch.cat([im0, im1]),
                         torch.cat([valid, valid]), max_keypoints=MAX_KPTS,
                         keypoint_threshold=0.0005, device=dev)
            ev[1].record()
            m = lg.forward_pair(
                params["lightglue"], f["keypoints"][:BATCH],
                f["keypoints"][BATCH:],
                f["descriptors"][:BATCH].transpose(1, 2),
                f["descriptors"][BATCH:].transpose(1, 2), f["mask"][:BATCH],
                f["mask"][BATCH:], valid.float(), valid.float(), device=dev)
            ev[2].record()
            m0 = m["matches0"].long()
            p1 = torch.gather(f["keypoints"][BATCH:], 1,
                              m0.clamp(0, MAX_KPTS - 1)[..., None]
                              .expand(-1, -1, 2))
            ransac_ops.ransac(f["keypoints"][:BATCH], p1, m0 > -1, gen,
                              threshold=4.0, num_hypotheses=HYPOTHESES,
                              device=dev)
            ev[3].record()
            ev[3].synchronize()
            if it >= warmup:
                for j, key in enumerate(split):
                    split[key].append(ev[j].elapsed_time(ev[j + 1]))
        # where the device time goes: a short profiler window
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            for _ in range(3):
                step()
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t1) * 1e3
    # device-side events only (kernels, copies, memsets); the CPU-side ops
    # that launched them carry the same time again
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    device_ms = sum(e.self_device_time_total for e in events) / 3e3
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:15]
    split = {k: float(np.median(v)) for k, v in split.items()}
    pairs_per_s = BATCH * iters / dt
    ms_step = dt / iters * 1e3
    log(f"  match_step: {pairs_per_s:.2f} pairs/s, {ms_step:.2f} ms/step "
        f"({BATCH} pairs, {CANVAS}^2, {MAX_KPTS} keypoints, {N_LAYERS} "
        f"layers, {HYPOTHESES} hypotheses)")
    log("  stage split (ms, CUDA events, median): "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    idle = 1 - device_ms / ms_step
    log(f"  profiler (3 steps, {window_ms / 3:.2f} ms/step under the "
        f"profiler): device busy {device_ms:.2f} ms/step, idle share "
        f"{idle:.3f} of the unprofiled step; top device time per step:")
    for e in top:
        log(f"    {e.self_device_time_total / 3e3:9.3f} ms  "
            f"x{e.count / 3:g}  {e.key[:100]}")
    return {"pairs_per_s": pairs_per_s, "ms_per_step": ms_step,
            "split_ms": split, "device_busy_ms": device_ms,
            "device_idle_share": idle}


def phase4():
    """The general path through ImageMatchingAPI: gate, counters, stage
    times, idle share, and the host cost of the adaptive loop."""
    import torch

    from imcui_tpu_torch.api.core import ImageMatchingAPI
    from imcui_tpu_torch.models.matchers import lightglue as lg
    from imcui_tpu_torch.ops import attention, cuda_nms, cuda_stage1
    from imcui_tpu_torch.ui import utils as ui

    def api_for(max_keypoints, fused=None):
        conf = ui.parse_match_config({"feature": G_FEATURE,
                                      "matcher": G_MATCHER, "dense": False})
        if fused is not None:
            conf["feature"]["model"]["fused"] = fused
        api = ImageMatchingAPI(conf, device="cuda",
                               max_keypoints=max_keypoints,
                               detect_threshold=G_DETECT_THRESHOLD)
        if not (api.extractor.meta["pretrained"]
                and api.matcher.meta["pretrained"]):
            fail("the general path did not load the weights/ npz trees")
        return api

    api = api_for(G_KPTS)
    log(f"  conf: feature {api.conf['feature']['model']}, preprocessing "
        f"{api.conf['feature']['preprocessing']}, matcher "
        f"{api.conf['matcher']['model']}, ransac {api.conf['ransac']}")
    pairs = [synthetic_pair(200 + i, w, h) for i, (w, h) in enumerate(G_SIZES)]
    api(*pairs[0][:2])  # warm-up: cuDNN's algorithm choice, allocator

    stops, events, captured = [], {}, {}

    def mark(name):
        def hook(*_):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.setdefault(name, []).append(ev)
        return hook

    def watch(target):
        return [
            target.extractor.register_forward_pre_hook(mark("sp_in")),
            target.extractor.register_forward_hook(mark("sp_out")),
            target.matcher.register_forward_pre_hook(mark("lg_in")),
            target.matcher.register_forward_hook(mark("lg_out")),
            target.matcher.register_forward_pre_hook(
                lambda mod, args: captured.update(data=args[0])),
            target.matcher.register_forward_hook(
                lambda mod, args, out: stops.append(
                    int(out["stop_layer"][0]))),
        ]

    kernels = (cuda_stage1.stage_tail, cuda_stage1.stem_tail,
               cuda_nms.nms_cellmax, attention.fused_attention,
               attention.bidirectional_attention, attention.flash_attention)
    for kfn in kernels:
        kfn.launches = 0

    def gate(tag, res, hm):
        for key in ("mkeypoints0_orig", "mmkeypoints0_orig",
                    "mmkeypoints1_orig", "mconf", "mmconf", "H"):
            if res[key] is None or not np.isfinite(res[key]).all():
                fail(f"{tag}: {key} is missing or not finite")
        err = transfer_errors(hm, res["mmkeypoints0_orig"],
                              res["mmkeypoints1_orig"])
        med = float(np.median(err)) if len(err) else float("inf")
        log(f"  {tag}: {len(res['keypoints0_orig'])}/"
            f"{len(res['keypoints1_orig'])} keypoints, "
            f"{len(res['mkeypoints0_orig'])} raw matches, {len(err)} inliers,"
            f" median transfer error {med:.3f} px, stop_layer {stops[-1]}")
        if len(err) < GATE_MIN_INLIERS or med > GATE_MEDIAN_PX:
            fail(f"{tag}: gate is >= {GATE_MIN_INLIERS} inliers with median "
                 f"error <= {GATE_MEDIAN_PX} px")

    # requests at 4096 keypoints, timed per stage
    hooks = watch(api)
    split = {"superpoint": [], "lightglue": [], "ransac": [], "request": [],
             "request_wall": []}
    for i, (img0, img1, hm) in enumerate(pairs):
        events.clear()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        res = api(img0, img1)
        end.record()
        end.synchronize()
        split["request_wall"].append((time.perf_counter() - t0) * 1e3)
        split["superpoint"].append(sum(
            a.elapsed_time(b) for a, b in zip(events["sp_in"],
                                              events["sp_out"])))
        split["lightglue"].append(
            events["lg_in"][0].elapsed_time(events["lg_out"][0]))
        split["ransac"].append(events["lg_out"][0].elapsed_time(end))
        split["request"].append(start.elapsed_time(end))
        gate(f"request {i} {G_SIZES[i]} at {G_KPTS} keypoints", res, hm)
        if min(len(res["keypoints0_orig"]),
               len(res["keypoints1_orig"])) <= G_MIN_KEYPOINTS:
            fail(f"request {i} found no more than {G_MIN_KEYPOINTS} "
                 f"keypoints in a view")
    stops_4096 = list(stops)

    # the adaptive loop's host cost: the matcher on the last request's
    # features, against the static forward cut to the depth it stopped at
    # (the same layers and head, no confidence heads, no host wait)
    data, depth = captured["data"], stops[-1]
    p = api.matcher.params
    cut = {**p, "transformers": p["transformers"][:depth],
           "log_assignment": p["log_assignment"][:depth]}
    f = {k: torch.as_tensor(v, device="cuda") for k, v in data.items()
         if v is not None and k != "image0" and k != "image1"}
    h, w = data["image0"].shape[-2:]
    size = torch.tensor([[w, h]], dtype=torch.float32, device="cuda")
    largs = (f["keypoints0"], f["keypoints1"],
             f["descriptors0"].transpose(1, 2),
             f["descriptors1"].transpose(1, 2), f["mask0"], f["mask1"], size,
             size)
    saved = {k.__name__: k.launches for k in kernels}

    def wall_ms(fn, iters=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters * 1e3

    adaptive_ms = wall_ms(lambda: lg.forward_pair_adaptive(
        p, *largs, match_threshold=0.2, depth_confidence=0.95))
    static_ms = wall_ms(lambda: lg.forward_pair(cut, *largs,
                                                match_threshold=0.2))
    for kfn in kernels:  # the comparison's launches do not count
        kfn.launches = saved[kfn.__name__]
    log(f"  adaptive loop at depth {depth}: {adaptive_ms:.2f} ms against "
        f"{static_ms:.2f} ms for the static forward of the same depth "
        f"({(adaptive_ms - static_ms) / depth:.3f} ms per layer for the "
        f"confidence heads and the host wait)")

    # the device's idle share: a profiler window over two requests
    from torch.profiler import ProfilerActivity, profile

    n_prof = 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for i in range(n_prof):
            api(*pairs[i][:2])
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t1) * 1e3 / n_prof
    evs = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    device_ms = sum(e.self_device_time_total for e in evs) / (n_prof * 1e3)
    for h_ in hooks:
        h_.remove()
    med = {k: float(np.median(v)) for k, v in split.items()}
    idle = 1 - device_ms / med["request_wall"]
    log("  stage split per request (ms, CUDA events, median of "
        f"{len(pairs)}): SuperPoint x2 {med['superpoint']:.2f}, LightGlue "
        f"{med['lightglue']:.2f}, RANSAC F+H {med['ransac']:.2f}, whole "
        f"request {med['request']:.2f} (host clock {med['request_wall']:.2f},"
        " preprocessing on the host included)")
    log(f"  profiler ({n_prof} requests, {window_ms:.1f} ms/request under the"
        f" profiler): device busy {device_ms:.2f} ms/request, idle share "
        f"{idle:.3f} of the unprofiled request; top device time per request:")
    for e in sorted(evs, key=lambda e: e.self_device_time_total,
                    reverse=True)[:12]:
        log(f"    {e.self_device_time_total / (n_prof * 1e3):9.3f} ms  "
            f"x{e.count / n_prof:g}  {e.key[:100]}")
    # the two profiled requests ran the same pairs again
    stops_4096 += stops[len(stops_4096):]

    # one request at 1024 keypoints (self-attention through K3) and one
    # through each route of the stem, which must find the same keypoints
    n_before = len(stops)
    small = api_for(MAX_KPTS)
    hooks = watch(small)
    gate(f"request at {MAX_KPTS} keypoints",
         small(*pairs[0][:2]), pairs[0][2])
    for h_ in hooks:
        h_.remove()
    stops_1024 = stops[n_before:]
    kept = {}
    for route in (True, "stem"):
        routed = api_for(G_KPTS, fused=route)
        hooks = watch(routed)
        res = routed(*pairs[1][:2])
        gate(f"request with fused={route!r}", res, pairs[1][2])
        kept[route] = [{tuple(k) for k in np.round(res[key], 3).tolist()}
                       for key in ("keypoints0_orig", "keypoints1_orig")]
        for h_ in hooks:
            h_.remove()
    ious = [len(a & b) / len(a | b) for a, b in zip(kept[True], kept["stem"])]
    log(f"  keypoint sets of the two stem routes: IoU {ious[0]:.4f} / "
        f"{ious[1]:.4f}")
    # The routes round conv_a's output at different places (once in the
    # stem kernel; to bf16 before and after the bias in conv1a + stage_tail),
    # so a peak near the threshold or a tie can differ: the sets must agree
    # as the bf16 trunk agrees across devices, IoU >= 0.9.
    if min(ious) < 0.9:
        fail("the stem route and the conv1a + stage_tail route disagree")
    stops_routes = stops[n_before + len(stops_1024):]

    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    n_extract = 2 * (len(stops_4096) + len(stops_1024) + len(stops_routes))
    expected = {
        # stage 2 on every image, stage 1 unless the stem kernel ran it
        "stage_tail": 2 * n_extract - launches["stem_tail"],
        "nms_cellmax": n_extract,
        "fused_attention": sum(stops_1024),
        "bidirectional_attention": sum(stops),
        "flash_attention": sum(stops_4096) + sum(stops_routes),
    }
    log(f"  launches {launches}; stop layers {stops}")
    for name, want in expected.items():
        if launches[name] == 0 or launches[name] != want:
            fail(f"{name}: {launches[name]} launches on the general path, "
                 f"expected {want}")
    if launches["stem_tail"] < 2:
        fail("the stem kernel was not launched on the general path")

    # one bf16 request at nms_radius 2, outside K2's gate (C1): SuperPoint
    # takes the reference's per-pixel NMS chain and launches no K2; the
    # same gate on the matches
    conf = ui.parse_match_config({"feature": G_FEATURE, "matcher": G_MATCHER,
                                  "dense": False})
    conf["feature"]["model"]["nms_radius"] = 2
    near = ImageMatchingAPI(conf, device="cuda", max_keypoints=G_KPTS,
                            detect_threshold=G_DETECT_THRESHOLD)
    if near.extractor.conf["precision"] != "bf16":
        fail("the radius-2 request does not run the bf16 SuperPoint")
    hooks = watch(near)
    k2_before = cuda_nms.nms_cellmax.launches
    res = near(*pairs[2][:2])
    gate("request at nms_radius 2", res, pairs[2][2])
    for h_ in hooks:
        h_.remove()
    if cuda_nms.nms_cellmax.launches != k2_before:
        fail("the nms_radius 2 request launched nms_cellmax outside its "
             "gate")
    radius2 = {"keypoints": [len(res["keypoints0_orig"]),
                             len(res["keypoints1_orig"])],
               "nms_cellmax_launches": 0}
    timing = {
        "keypoints": G_KPTS, "sizes": G_SIZES, "split_ms": med,
        "stop_layers": stops_4096, "device_busy_ms": device_ms,
        "device_idle_share": idle, "adaptive_ms": adaptive_ms,
        "static_same_depth_ms": static_ms, "adaptive_depth": depth,
        "stem_route_keypoint_iou": ious, "nms_radius_2_request": radius2}
    return launches, timing


def phase1_dense(peaks):
    """K14 (the q-tiled attention of the ViT blocks): its SASS must hold
    wgmma and TMA loads; against its plain version at the dense path's
    shapes, with its launch plan, registers and spills; timed beside K5 on
    the same bf16 inputs and SDPA's flash backend on the 4-D view. K3
    through mha_auto at 1601 tokens."""
    import torch

    from imcui_tpu_torch.models.layers import full_fp32
    from imcui_tpu_torch.ops import attention

    sass = qtiled_sass()["<64><128><0>"]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)

    def rnd(h, n, dtype):
        return (torch.randn((h, n, 64), generator=gen, device=dev) * 1.5
                ).to(dtype)

    bf16 = torch.bfloat16
    timed = {}
    main = None
    for name, h, nq, nk in (("dinov2-560", D_HEADS, D_TOKENS, D_TOKENS),
                            ("vit 16 x 1024", 16, 1024, 1024),
                            ("vit 12 x 1024", 12, 1024, 1024),
                            ("cross 1024 over 1601", 12, 1024, D_TOKENS),
                            ("ragged 50 over 77", 3, 50, 77),
                            # DUSt3R's and MASt3R's encoder and decoder
                            # blocks at the registry's 768 tokens
                            ("dust3r encoder 16 x 768", 16, 768, 768),
                            ("dust3r decoder 12 x 768", 12, 768, 768)):
        q, k, v = rnd(h, nq, bf16), rnd(h, nk, bf16), rnd(h, nk, bf16)
        got = attention.qtiled_attention(q, k, v).float()
        want = attention.qtiled_attention_plain(q, k, v).float()
        torch.cuda.synchronize()
        diff = (got - want).abs()
        # one bf16 rounding step of the output, plus the weights the kernel
        # rounds to bf16 before its tensor-core readout
        tol = 2.0 ** -7 * want.abs().clamp_min(1.0) \
            + 2.0 ** -9 * v.float().abs().max()
        over = int((diff > tol).sum())
        err, top = diff.max().item(), want.abs().max().item()
        launch = qtiled_launch(h, nq, nk)
        log(f"  qtiled_attention [{name}: {h} x {nq} x {nk} x 64 bf16]: err "
            f"{err:.3g} (max|plain| {top:.3g}; {over} over 2^-7*max(1,|plain|)"
            f" + 2^-9*max|v|); launch {launch}")
        if over or not torch.isfinite(got).all():
            fail(f"qtiled_attention [{name}] differs from its plain version")
        if nq != nk or (h != 16 and nq != 768):
            continue
        t = {"ms": cuda_ms(lambda: attention.qtiled_attention(q, k, v)),
             "queued_ms": cuda_ms_queued(
                 lambda: attention.qtiled_attention(q, k, v)),
             "plain_ms": cuda_ms(
                 lambda: attention.qtiled_attention_plain(q, k, v)),
             "k5_bf16_ms": cuda_ms(
                 lambda: attention.flash_attention(q, k, v, None, h))}
        lib = library_sdpa((q, k, v))
        t.update(library_ms=lib["ms"], library_backend=lib["backend"],
                 library_queued_ms=library_queued_sdpa((q, k, v)))
        # once more in the other order: K5, K14
        t["k5_bf16_ms"] = (t["k5_bf16_ms"] + cuda_ms(
            lambda: attention.flash_attention(q, k, v, None, h))) / 2
        t["ms"] = (t["ms"] + cuda_ms(
            lambda: attention.qtiled_attention(q, k, v))) / 2
        flops = 4.0 * h * nq * nk * 64
        nbytes = (2 * h * nq * 64 + 2 * h * nk * 64) * 2
        t["bound_ms"], t["bound_by"] = bound(flops, nbytes, peaks["bf16"],
                                             peaks)
        t["launch"] = launch
        timed[name] = t
        log(f"    {t['ms']:.3f} ms ({t['queued_ms']:.4f} queued) vs K5 on the "
            f"same bf16 inputs {t['k5_bf16_ms']:.3f}, SDPA "
            f"{t['library_ms']:.4f} ({t['library_queued_ms']:.4f} queued; "
            f"{t['library_backend']}), "
            f"plain {t['plain_ms']:.3f}, bound {t['bound_ms']:.4f} "
            f"({t['bound_by']})")
        if name == "dinov2-560":
            main = {"max_abs_err": err, "rel_err": err / top, **t}
    row = {
        "name": "qtiled_attention", "route": "cuda",
        "source": "imcui_tpu_torch/csrc/qtiled_attention.cu",
        "replaces": "tools/try_vit_attn.py:27",
        "tolerance": "2^-7*max(1,|plain|) + 2^-9*max|v| (bf16)", **main,
        "sass": sass, "at_16x1024": timed["vit 16 x 1024"],
        "at_16x768": timed["dust3r encoder 16 x 768"],
        "at_12x768": timed["dust3r decoder 12 x 768"],
        "per": f"launch at {D_HEADS} x {D_TOKENS} x {D_TOKENS} x 64 bf16 "
               f"(one DINOv2 block of one view)"}

    # K3 at the ragged 1601 tokens, f32, the way the f32 tree reaches it
    q, k, v = (torch.randn((D_HEADS, D_TOKENS, 64), generator=gen, device=dev)
               for _ in range(3))
    before = attention.fused_attention.launches
    with full_fp32():
        got = attention.mha_auto(q, k, v)
        want = attention.mha(q, k, v)
        torch.cuda.synchronize()
        if attention.fused_attention.launches != before + 1:
            fail("mha_auto did not send f32 x 1601 x 64 to fused_attention")
        err = (got - want).abs().max().item()
        top = want.abs().max().item()
        # both plain versions in one run: the unmasked mha (what mha_auto
        # computes) and K3's own plain version with an all-valid mask
        ones = torch.ones((1, D_TOKENS), dtype=torch.bool, device=dev)
        ms3 = cuda_ms(lambda: attention.mha_auto(q, k, v))
        plain3 = cuda_ms(lambda: attention.mha(q, k, v))
        plain3_masked = cuda_ms(lambda: attention.fused_attention_plain(
            q, k, v, ones, D_HEADS))
        ms3 = (ms3 + cuda_ms(lambda: attention.mha_auto(q, k, v))) / 2
        dev3 = cuda_ms_queued(lambda: attention.mha_auto(q, k, v))
    lib3 = library_sdpa((q, k, v))
    t3, by3 = bound(4.0 * D_HEADS * D_TOKENS ** 2 * 64,
                    4 * D_HEADS * D_TOKENS * 64 * 4, peaks["fp32"], peaks)
    launch3 = attention_launch("fused", D_HEADS, D_TOKENS)
    log(f"  fused_attention through mha_auto [{D_HEADS} x {D_TOKENS} x 64 "
        f"f32]: err {err:.3g} (tolerance 1e-5*max(1,|plain|), max|plain| "
        f"{top:.3g}), {ms3:.3f} ms ({dev3:.3f} queued) vs plain mha "
        f"{plain3:.3f} and "
        f"fused_attention_plain {plain3_masked:.3f}, SDPA {lib3['ms']:.3f} "
        f"({lib3['backend']}), "
        f"bound {t3:.4f} ({by3}); launch {launch3}")
    if not err <= 1e-5 * max(1.0, top):
        fail("fused_attention at 1601 tokens differs from the plain mha")
    k3_at_1601 = {"max_abs_err": err, "ms": ms3, "device_ms": dev3,
                  "plain_ms": plain3,
                  "plain_masked_ms": plain3_masked,
                  "library_ms": lib3["ms"], "library_backend": lib3["backend"],
                  "bound_ms": t3, "bound_by": by3, "launch": launch3}
    return row, k3_at_1601


def phase5():
    """The dense path through ImageMatchingAPI at RoMa's published widths,
    float32 and bfloat16, on seeded random weights."""
    import torch

    from imcui_tpu_torch.api.core import ImageMatchingAPI
    from imcui_tpu_torch.models.backbones import dinov2
    from imcui_tpu_torch.models.layers import full_fp32
    from imcui_tpu_torch.models.matchers import roma
    from imcui_tpu_torch.ops import attention
    from imcui_tpu_torch.ui import utils as ui
    from imcui_tpu_torch.utils.weights import to_device

    dev = torch.device("cuda")
    kernels = (attention.qtiled_attention, attention.fused_attention,
               attention.flash_attention, attention.bidirectional_attention)
    problems = []
    log("  the planted-homography gate is NOT applied on this path: the "
        "trained checkpoints (roma_outdoor.pth, dinov2_vitl14_pretrain.pth) "
        "are not in the repository, so the weights are a seeded random "
        "initialisation and the matches mean nothing geometrically")

    def api_for(precision):
        conf = ui.parse_match_config({"matcher": D_MATCHER, "dense": True})
        conf["matcher"]["model"]["precision"] = precision
        api = ImageMatchingAPI(conf, device="cuda")
        meta = api.matcher.meta
        log(f"  [{precision or 'f32'}] weights: {meta}")
        if meta["pretrained"] is not False:
            fail("the dense path claims trained weights that do not exist")
        # LayerScale starts at 1e-5, which would hide the attention and the
        # MLP of every DINOv2 block: draw it in [0.5, 1.5] from a seed
        gen = torch.Generator().manual_seed(7)
        for blk in api.matcher.params["dinov2"]["blocks"]:
            for ls in ("ls1", "ls2"):
                g = blk[ls]["gamma"]
                g.copy_((torch.rand(g.shape, generator=gen) + 0.5).to(g))
        return api

    pairs = [synthetic_pair(300 + i, w, h) for i, (w, h) in enumerate(D_SIZES)]
    per_request = D_BLOCKS * 2
    result = {}
    warps = {}
    apis = {}
    for precision in (None, "bf16"):
        tag = precision or "f32"
        api = apis[tag] = api_for(precision)
        model = api.matcher
        conf = model.conf
        if (conf["dinov2_variant"], tuple(conf["coarse_res"])) != (
                "vitl14", (560, 560)):
            fail(f"the registry's roma is not at full width: {conf}")
        want_k = int(conf["max_keypoints"])
        api(*pairs[0][:2])                       # warm-up
        captured = []
        timer = StageTimer()
        stages = timer.events
        timer.wrap(roma.dinov2, "apply", "dinov2 x2")
        timer.wrap(roma.vgg, "apply", "vgg19 x2")
        timer.wrap(roma, "coarse_match", "gp + decoder")
        timer.wrap(roma, "refiner_apply",
                   lambda a: f"refiner {560 // a[2].shape[1]}")
        timer.wrap(roma, "sample", "sample")
        match = model.match
        model.match = lambda a, b: (captured.append(match(a, b)),
                                    captured[-1])[1]
        for kfn in kernels:
            kfn.launches = 0
        walls, rows, tails = [], [], []
        for i, (img0, img1, _) in enumerate(pairs):
            before = {k.__name__: k.launches for k in kernels}
            stages.clear()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            t0 = time.perf_counter()
            start.record()
            res = api(img0, img1)
            end.record()
            end.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            rows.append(timer.ms())
            tails.append(stages["sample"][-1][1].elapsed_time(end))
            delta = {k.__name__: k.launches - before[k.__name__]
                     for k in kernels}
            # (a) what comes out
            for key in ("mkeypoints0_orig", "mkeypoints1_orig", "mconf"):
                if not np.isfinite(res[key]).all():
                    fail(f"[{tag}] request {i}: {key} is not finite")
            n = len(res["mkeypoints0_orig"])
            # at the model's resolution: the preprocessing's 320 x 240 on
            # its 320 x 256 canvas
            canvas = np.array([320 - 1, 256 - 1]) + 1e-3
            k0, k1 = res["mkeypoints0"], res["mkeypoints1"]
            inside0 = bool(((k0 >= 0) & (k0 <= canvas)).all())
            inside1 = float(((k1 >= 0) & (k1 <= canvas)).all(1).mean())
            conf_ok = bool(((res["mconf"] >= 0) & (res["mconf"] <= 1)).all())
            cert = captured[-1][1]
            log(f"  [{tag}] request {i} {D_SIZES[i]}: {n} correspondences, "
                f"image-0 points inside: {inside0}, image-1 points inside "
                f"{inside1:.3f} (an untrained warp is not confined), "
                f"certainty in [{float(cert.min()):.3g}, "
                f"{float(cert.max()):.3g}], RANSAC kept "
                f"{len(res['mmkeypoints0_orig'])}; {walls[-1]:.1f} ms; "
                f"launches {delta}")
            if n != want_k or not inside0 or not conf_ok or \
                    captured[-1][0].shape != (560, 560, 2) or \
                    not torch.isfinite(captured[-1][0]).all():
                problems.append(f"[{tag}] request {i}: expected {want_k} "
                                f"finite correspondences from image 0's grid "
                                f"with certainty in [0, 1]")
            # (b) the kernels this precision must go through, and no other
            expect = {"qtiled_attention": per_request if precision else 0,
                      "fused_attention": 0 if precision else per_request,
                      "flash_attention": 0, "bidirectional_attention": 0}
            if delta != expect:
                fail(f"[{tag}] request {i}: launches {delta}, expected "
                     f"{expect}")
        launches = {k.__name__: k.launches for k in kernels}
        warps[tag] = captured[-1][0].float()

        # device busy time and idle share over two more requests
        device_ms, evs = device_window(lambda i: api(*pairs[i][:2]), 2)
        timer.undo()
        model.match = match
        med = {k: float(np.median([r[k] for r in rows])) for k in rows[0]}
        med["ransac + host tail"] = float(np.median(tails))
        wall = float(np.median(walls))
        idle = 1 - device_ms / wall
        log(f"  [{tag}] {wall:.2f} ms per request (host clock, median of "
            f"{len(walls)}); stages (ms, CUDA events): "
            + ", ".join(f"{k} {v:.2f}" for k, v in med.items()))
        log(f"  [{tag}] device busy {device_ms:.2f} ms/request, idle share "
            f"{idle:.3f}; top device time per request:")
        for e in sorted(evs, key=lambda e: e.self_device_time_total,
                        reverse=True)[:10]:
            log(f"    {e.self_device_time_total / 2e3:9.3f} ms  "
                f"x{e.count / 2:g}  {e.key[:100]}")
        result[tag] = {"ms_per_request": wall, "split_ms": med,
                       "device_busy_ms": device_ms,
                       "device_idle_share": idle, "launches": launches}

    # (e) bf16 against f32 on the card, the last request's warp
    dw = (warps["bf16"] - warps["f32"]).abs()
    med_dw = float(dw.median())
    log(f"  bf16 against f32, warp of the last request: median |diff| "
        f"{med_dw:.4f} normalised ({med_dw * 280:.1f} px at 560), 90th "
        f"percentile {float(dw.flatten().kthvalue(int(dw.numel() * 0.9))[0]):.4f}"
        f" (bound on the median {D_BF16_MEDIAN_WARP})")
    if not med_dw <= D_BF16_MEDIAN_WARP:
        problems.append("bf16 and f32 warps differ by more than the bound")
    result["bf16_vs_f32_median_warp"] = med_dw

    # (c) the property that holds without training, at full width: on an
    # identical pair the GP posterior of the embedded grid is the grid. It
    # holds where the tokens tell the cells apart: the JAX test's condition,
    # a uniform-noise image through the initialisation (LayerScale 1e-5),
    # is the one held to the bound. The other three cases are reported: a
    # textured image gives neighbouring patches similar tokens, and with
    # LayerScale near 1 the 24 random blocks add the same mean of values to
    # every token, so the kernel matrix fills up and the posterior tends to
    # the targets' mean.
    p32 = apis["f32"].matcher.params
    img = torch.as_tensor(pairs[0][0], device=dev).permute(2, 0, 1).float()
    img = roma.resize_ops.resize(img / 255.0, (560, 560))
    noise = torch.rand((3, 560, 560), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(3))
    at_init = {**p32["dinov2"], "blocks": [
        {**blk, "ls1": {"gamma": torch.full_like(blk["ls1"]["gamma"], 1e-5)},
         "ls2": {"gamma": torch.full_like(blk["ls2"]["gamma"], 1e-5)}}
        for blk in p32["dinov2"]["blocks"]]}
    gp = {}
    with torch.inference_mode(), full_fp32():
        for iname, image in (("noise image", noise), ("textured image", img)):
            for tname, tree in (("LayerScale 1e-5", at_init),
                                ("LayerScale in [0.5, 1.5]", p32["dinov2"])):
                tokens, (hp, wp) = dinov2.apply(tree, image, "vitl14")
                emb = roma.fourier_embed(roma.coord_grid(hp, wp, dev),
                                         p32["gps"]["16"]["pos_conv"])
                k11 = roma.cos_kernel(tokens, tokens)
                off = float((k11.sum() - k11.diagonal().sum())
                            / (k11.numel() - k11.shape[0]))
                name = f"{iname}, {tname}"
                gp[name] = float((roma.gp_posterior(tokens, tokens, emb)
                                  - emb).abs().max())
                log(f"  identical pair, ViT-L/14 at 560x560, {name}: max |GP "
                    f"posterior - target| {gp[name]:.4f}, mean off-diagonal "
                    f"kernel value {off:.4f}")
    if not gp["noise image, LayerScale 1e-5"] < D_GP_BOUND:
        problems.append(f"the GP posterior of an identical pair misses its "
                        f"targets (bound {D_GP_BOUND})")
    result["gp_identity_err"] = gp

    # (d) the card against the CPU on the same weights, float32: DINOv2 at
    # 560x560 cut to two blocks (K3 on the card, its plain version on the
    # CPU), and the stride-16 refiner on random features
    cut = {**p32["dinov2"], "blocks": p32["dinov2"]["blocks"][:2]}
    gen = torch.Generator().manual_seed(11)
    f0, f1 = (torch.randn((512, 40, 40), generator=gen) for _ in range(2))
    warp = torch.rand((40, 40, 2), generator=gen) * 2 - 1
    cert = torch.randn((40, 40), generator=gen)
    ref16 = p32["conv_refiner"]["16"]
    with torch.inference_mode(), full_fp32():
        tok_card, _ = dinov2.apply(cut, img, "vitl14")
        tok_cpu, _ = dinov2.apply(to_device(cut, "cpu"), img.cpu(), "vitl14")
        w_card, c_card = roma.refiner_apply(
            ref16, roma.REFINERS["16"], f0.to(dev), f1.to(dev), warp.to(dev),
            cert.to(dev))
        w_cpu, c_cpu = roma.refiner_apply(
            to_device(ref16, "cpu"), roma.REFINERS["16"], f0, f1, warp, cert)
    e_tok = float((tok_card.cpu() - tok_cpu).abs().max())
    top_tok = float(tok_cpu.abs().max())
    e_w = float((w_card.cpu() - w_cpu).abs().max())
    top_w = float((w_cpu - warp).abs().max())
    e_c = float((c_card.cpu() - c_cpu).abs().max())
    top_c = float((c_cpu - cert).abs().max())
    log(f"  card against CPU, f32: DINOv2 (2 blocks, 560x560) {e_tok:.3g} of "
        f"max {top_tok:.3g}; stride-16 refiner warp {e_w:.3g} of a largest "
        f"change {top_w:.3g}, certainty {e_c:.3g} of {top_c:.3g} (tolerance "
        f"{D_CPU_TOL} of each maximum)")
    if not (e_tok <= D_CPU_TOL * max(1.0, top_tok)
            and e_w <= D_CPU_TOL * top_w and e_c <= D_CPU_TOL * top_c):
        problems.append("the card and the CPU disagree in float32")
    result["card_vs_cpu"] = {"dinov2": e_tok, "refiner_warp": e_w,
                             "refiner_cert": e_c}
    if problems:
        fail("; ".join(problems))
    return result


def phase7():
    """The LoFTR dense path through ImageMatchingAPI at the registry's
    width on the trained tree, bf16 and f32: gate, card against the port's
    CPU run, stage times and the idle share; then one request of each
    LoFTR-family matcher and of RoMa's fpn-corr backbone on seeded random
    weights, each held to finite outputs and to its CPU run."""
    import torch

    from imcui_tpu_torch.api import core as api_core
    from imcui_tpu_torch.api.core import ImageMatchingAPI
    from imcui_tpu_torch.models.layers import full_fp32
    from imcui_tpu_torch.models.matchers import loftr, roma
    from imcui_tpu_torch.utils import image as image_utils
    from imcui_tpu_torch.ui import utils as ui
    from imcui_tpu_torch.utils.weights import to_device

    pairs = [synthetic_pair(s, *L_SIZE) for s in L_SEEDS]
    trained = f"local:{os.path.join(ROOT, L_TRAINED)}"
    result = {}
    problems = []

    def api_for(name, device="cuda", **model):
        conf = ui.parse_match_config({"matcher": name, "dense": True})
        conf["matcher"]["model"].update(model)
        return ImageMatchingAPI(conf, device=device)

    def coarse(run):
        """``run()`` with loftr.coarse_match recorded: its two token
        matrices (on the CPU) and its valid (idx0, idx1) pairs."""
        out = {}
        fn = loftr.coarse_match

        def rec(*a, **kw):
            out["tokens"] = [t.float().cpu() for t in a[:2]]
            out["m"] = fn(*a, **kw)
            return out["m"]

        loftr.coarse_match = rec
        try:
            run()
        finally:
            loftr.coarse_match = fn
        i0, i1, _, valid = (t.cpu() for t in out["m"])
        return out["tokens"], {(int(a), int(b))
                               for a, b in zip(i0[valid], i1[valid])}

    for precision in ("bf16", "fp32"):
        api = api_for(L_MATCHER, precision=precision)
        model = api.matcher
        pre = api.match_conf["preprocessing"]
        log(f"  [{precision}] weights: {model.meta}; preprocessing {pre}; "
            f"model {api.match_conf['model']}")
        if model.meta != {"pretrained": True, "source": trained}:
            fail(f"loftr did not load {trained} by the offline route")
        if (pre["width"], pre["height"], pre["force_resize"],
                model.pair_conf["max_matches"],
                model.pair_conf["match_threshold"]) != (640, 480, True, 2000,
                                                        0.2):
            fail(f"the registry's loftr is not at full width: {pre}, "
                 f"{model.pair_conf}")
        want_dt = torch.bfloat16 if precision == "bf16" else torch.float32
        if model.params["backbone"]["conv1"]["w"].dtype != want_dt:
            fail(f"[{precision}] the tree is not {want_dt}")
        api(*pairs[0][:2])                       # warm-up
        timer = StageTimer()
        timer.wrap(loftr, "backbone_apply", "backbone")
        timer.wrap(loftr, "coarse_transform", "coarse transformer")
        timer.wrap(loftr, "coarse_match", "coarse_match")
        timer.wrap(loftr, "fine_preprocess", "fine windows")
        timer.wrap(loftr, "fine_match", "fine_match")
        timer.wrap_host(image_utils, "preprocess", "preprocessing (host)")
        timer.wrap_host(api_core, "filter_matches", "ransac (host clock)")
        walls, rows, gates = [], [], []
        for i, (img0, img1, hm) in enumerate(pairs):
            timer.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = api(img0, img1)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            rows.append(timer.ms())
            for key in ("mkeypoints0_orig", "mkeypoints1_orig", "mconf",
                        "mmkeypoints0_orig", "mmkeypoints1_orig", "H"):
                if res[key] is None or not np.isfinite(res[key]).all():
                    fail(f"[{precision}] request {i}: {key} is missing or "
                         f"not finite")
            raw = transfer_errors(hm, res["mkeypoints0_orig"],
                                  res["mkeypoints1_orig"])
            err = transfer_errors(hm, res["mmkeypoints0_orig"],
                                  res["mmkeypoints1_orig"])
            med = float(np.median(err)) if len(err) else float("inf")
            gates.append({"raw": len(raw), "inliers": len(err),
                          "median_px": med,
                          "raw_within_2px": float((raw <= 2).mean())})
            log(f"  [{precision}] request {i} {L_SIZE}: {len(raw)} raw "
                f"matches ({gates[-1]['raw_within_2px']:.3f} within 2 px), "
                f"{len(err)} inliers, median transfer error {med:.3f} px; "
                f"{walls[-1]:.2f} ms")
            if len(err) < GATE_MIN_INLIERS or med > GATE_MEDIAN_PX:
                problems.append(f"[{precision}] request {i}: gate is >= "
                                f"{GATE_MIN_INLIERS} inliers with median "
                                f"error <= {GATE_MEDIAN_PX} px")
        device_ms, evs = device_window(lambda i: api(*pairs[i][:2]), 2)
        timer.undo()
        med = {k: float(np.median([r[k] for r in rows])) for k in rows[0]}
        wall = float(np.median(walls))
        idle = 1 - device_ms / wall
        log(f"  [{precision}] {wall:.2f} ms per request (host clock, median "
            f"of {len(walls)}); stages (ms, CUDA events): "
            + ", ".join(f"{k} {v:.3f}" for k, v in med.items()))
        log(f"  [{precision}] device busy {device_ms:.2f} ms/request, idle "
            f"share {idle:.3f}; top device time per request:")
        for e in sorted(evs, key=lambda e: e.self_device_time_total,
                        reverse=True)[:8]:
            log(f"    {e.self_device_time_total / 2e3:9.3f} ms  "
                f"x{e.count / 2:g}  {e.key[:100]}")
        # card against the port's CPU run on the first pair
        _, card = coarse(lambda: api(*pairs[0][:2]))
        cpu_api = api_for(L_MATCHER, "cpu", precision=precision)
        _, cpu = coarse(lambda: cpu_api(*pairs[0][:2]))
        iou = len(card & cpu) / max(1, len(card | cpu))
        log(f"  [{precision}] card against CPU, pair 0: {len(card)} and "
            f"{len(cpu)} valid coarse pairs, IoU {iou:.4f} (bound "
            f"{L_COARSE_IOU[precision]})")
        if iou < L_COARSE_IOU[precision]:
            problems.append(f"[{precision}] card and CPU coarse matches: IoU "
                            f"{iou:.4f}")
        result[precision] = {"ms_per_request": wall, "split_ms": med,
                             "device_busy_ms": device_ms,
                             "device_idle_share": idle, "gate": gates,
                             "coarse_iou_card_vs_cpu": iou}

    # the family, one request each at the registry conf, then the model on
    # that request's inputs on the card and on the CPU
    for name, thr in L_FAMILY.items():
        api = api_for(name)
        model = api.matcher
        if model.meta["pretrained"] is not False:
            fail(f"{name} claims trained weights that do not exist")
        seen = {}
        hook = model.register_forward_pre_hook(
            lambda mod, args: seen.update(data=args[0]))
        t0 = time.perf_counter()
        res = api(*pairs[0][:2])
        ms = (time.perf_counter() - t0) * 1e3
        hook.remove()
        n = len(res["mkeypoints0_orig"])
        if not all(np.isfinite(res[k]).all() and len(res[k]) == n for k in (
                "mkeypoints0_orig", "mkeypoints1_orig", "mconf")):
            fail(f"{name}: outputs not finite or of unequal length")
        cpu_model = type(model)(api.match_conf["model"], device="cpu")
        outs, tokens = [], []
        for m in (model, cpu_model):
            m.pair_conf["match_threshold"] = thr
            got = {}
            tok, _ = coarse(lambda: got.update(m(seen["data"])))
            outs.append({k: v[0].cpu().numpy() for k, v in got.items()})
            tokens.append(tok)
        rel = torch.cat([(a - b).abs().amax(1) / b.abs().max()
                         for a, b in zip(*tokens)])
        e_tok, near = float(rel.max()), float((rel <= L_FAMILY_TOL).float(
            ).mean())
        slots = outs[0]["keypoints0"].shape[0]
        if slots != model.pair_conf["max_matches"]:
            fail(f"{name}: {slots} match slots")
        k0, k1 = ([o[k][o["mask"]] for o in outs]
                  for k in ("keypoints0", "keypoints1"))
        iou, ia, ib = common_points(k0[0], k0[1], L_FAMILY_PX)
        dk = float(np.median(np.abs(k1[0][ia] - k1[1][ib]).max(1))) \
            if len(ia) else float("inf")
        log(f"  {name}: {n} raw matches at the registry's threshold "
            f"{api.match_conf['model']['match_threshold']}, {ms:.1f} ms; card "
            f"against CPU: coarse tokens within {L_FAMILY_TOL} of the largest"
            f" {near:.4f} (largest {e_tok:.2e}); at threshold {thr} "
            f"{len(k0[0])} matches on the card, {len(k0[1])} on the CPU, IoU "
            f"{iou:.4f}, median image-1 difference {dk:.2e} px")
        if not len(k0[0]) or near < L_FAMILY_NEAR or iou < L_FAMILY_IOU or \
                dk > L_FAMILY_PX:
            problems.append(f"{name}: card and CPU disagree")
        result[name] = {"ms_per_request": ms, "raw_matches": n,
                        "tokens_near": near, "token_err_card_vs_cpu": e_tok,
                        "iou_card_vs_cpu": iou, "median_px": dk}

    # rdd(sparse): the rdd extractor with mutual NN, one request, then the
    # extractor on that request's view 0 on the card and on the CPU
    conf = ui.parse_match_config({"feature": "rdd", "matcher": "NN-mutual",
                                  "dense": False})
    api = ImageMatchingAPI(conf, device="cuda")
    if api.extractor.meta["pretrained"] is not False:
        fail("rdd claims trained weights that do not exist")
    seen = {}
    hook = api.extractor.register_forward_pre_hook(
        lambda mod, args: seen.setdefault("data", args[0]))
    t0 = time.perf_counter()
    res = api(*pairs[0][:2])
    ms = (time.perf_counter() - t0) * 1e3
    hook.remove()
    n = len(res["mkeypoints0_orig"])
    if not (n and all(np.isfinite(res[k]).all() for k in (
            "keypoints0_orig", "mkeypoints0_orig", "mkeypoints1_orig"))):
        fail(f"rdd(sparse): {n} raw matches, or outputs not finite")
    cpu_ext = type(api.extractor)(api.extractor.conf, device="cpu")
    outs = [{k: v[0].cpu().numpy() for k, v in m(seen["data"]).items()}
            for m in (api.extractor, cpu_ext)]
    kp = [o["keypoints"][o["mask"]] for o in outs]
    iou, ia, ib = common_points(kp[0], kp[1], L_FAMILY_PX)
    dd = [o["descriptors"][:, o["mask"]] for o in outs]
    e_d = float(np.abs(dd[0][:, ia] - dd[1][:, ib]).max()) if len(ia) \
        else float("inf")
    log(f"  rdd(sparse): {len(res['keypoints0_orig'])} keypoints, {n} raw "
        f"matches, {len(res['mmkeypoints0_orig'])} RANSAC inliers, {ms:.1f} "
        f"ms; card against CPU on view 0: {len(kp[0])} and {len(kp[1])} "
        f"keypoints, IoU {iou:.4f} (bound {L_RDD_IOU}), descriptors within "
        f"{e_d:.2e} (bound {L_RDD_DESC})")
    if iou < L_RDD_IOU or e_d > L_RDD_DESC:
        problems.append("rdd(sparse): card and CPU disagree")
    result["rdd(sparse)"] = {"ms_per_request": ms, "raw_matches": n,
                             "iou_card_vs_cpu": iou, "desc_err": e_d}

    # RoMa's fpn-corr backbone at the registry's roma entry
    api = api_for("roma", backbone="fpn-corr")
    model = api.matcher
    if model.meta["pretrained"] is not False or \
            model.meta["backbone"] != "fpn-corr":
        fail(f"roma fpn-corr weights: {model.meta}")
    seen = {}
    hook = model.register_forward_pre_hook(
        lambda mod, args: seen.update(data=args[0]))
    res = api(*pairs[0][:2])
    hook.remove()
    x0, x1 = (model._prepare(seen["data"][k])[0] for k in ("image0", "image1"))
    cpu_params = to_device(model.params, "cpu")
    with torch.inference_mode(), full_fp32():
        w_card, c_card = model.match(x0, x1)
        w_cpu, c_cpu = roma.match(cpu_params, x0.cpu(), x1.cpu())
    e_w = float((w_card.cpu() - w_cpu).abs().max())
    e_c = float((c_card.cpu() - c_cpu).abs().max())
    n = len(res["mkeypoints0_orig"])
    cells = x0.shape[-2] // 8 * (x0.shape[-1] // 8)
    log(f"  roma fpn-corr: {n} correspondences on a {tuple(w_card.shape[:2])} "
        f"grid, card against CPU: warp {e_w:.2e}, certainty {e_c:.2e} "
        f"(tolerance {L_FPN_TOL})")
    if n != min(cells, api.match_conf["model"]["max_keypoints"]) or \
            not np.isfinite(res["mkeypoints1_orig"]).all():
        problems.append(f"roma fpn-corr: {n} correspondences")
    if not (e_w <= L_FPN_TOL and e_c <= L_FPN_TOL):
        problems.append("roma fpn-corr: card and CPU disagree")
    result["roma fpn-corr"] = {"correspondences": n, "warp_err": e_w,
                               "cert_err": e_c}
    if problems:
        fail("; ".join(problems))
    return result


def _planted_pose_checks():
    """Phase 9 (a): the planted chain on 3 synthetic scenes and PnP on a
    planted scene, on the card. Returns the errors."""
    import torch

    from imcui_tpu_torch.eval import synthpose
    from imcui_tpu_torch.ops import pnp, pose

    def card(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device="cuda")

    rng = np.random.default_rng(0)
    errs = []
    for trial in range(3):
        scene = synthpose.sample_scene(rng, 640, 480)
        u0, u1 = synthpose.gt_correspondences(scene, 640, 480, rng, n=512)
        p0, p1 = (np.zeros((512, 2), np.float32) for _ in range(2))
        m = np.zeros(512, bool)
        p0[:len(u0)], p1[:len(u0)], m[:len(u0)] = u0, u1, True
        out = pose.estimate_pose(
            p0, p1, m, scene["K"], scene["K"],
            torch.Generator(device="cuda").manual_seed(trial),
            threshold_px=0.75, num_hypotheses=2048, device="cuda")
        errs.append(float(pose.pose_error(out["R"], out["t"],
                                          card(scene["R"]),
                                          card(scene["t"]))))
    log(f"  (a) planted chain, 3 scenes at 640x480 ({len(u0)} GT matches "
        f"the last): pose errors {[round(e, 4) for e in errs]} degrees "
        f"(bound {E_CHAIN_DEG})")
    if max(errs) >= E_CHAIN_DEG:
        fail(f"the planted pose chain did not close: {errs}")

    # tests/test_ops_pnp.py's scene: 80 points, 40 outliers, 0.5 px noise,
    # and the last 8 correspondences masked out
    r = np.random.RandomState(0)
    K = np.array([[900.0, 0, 480], [0, 900.0, 360], [0, 0, 1]])
    a, b = 0.4, 0.2
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                  [0, 0, 1]]) @ np.array([[1, 0, 0],
                                          [0, np.cos(b), -np.sin(b)],
                                          [0, np.sin(b), np.cos(b)]])
    t = np.array([0.3, -0.2, 4.0])
    X = r.uniform(-3, 3, (80, 3)) + np.array([0, 0, 2.0])
    x = (X @ R.T + t) @ K.T
    p2 = np.concatenate([x[:, :2] / x[:, 2:] + r.randn(80, 2) * 0.5,
                         r.uniform(0, 900, (40, 2))]).astype(np.float32)
    p3 = np.concatenate([X, r.uniform(-3, 3, (40, 3)) + np.array(
        [0, 0, 2.0])]).astype(np.float32)
    mask = np.ones(120, bool)
    mask[-8:] = False
    out = pnp.ransac_pnp(p2, p3, mask, K,
                         torch.Generator(device="cuda").manual_seed(0),
                         threshold_px=4.0, num_hypotheses=512,
                         device="cuda")
    inl = out["inliers"].cpu().numpy()
    e_r = float(pose.rotation_angle_deg(out["R"], card(R)))
    e_t = float(np.linalg.norm(out["t"].cpu().numpy() - t))
    log(f"  (a) PnP: {int(out['num_inliers'])} inliers ({int(inl[:80].sum())}"
        f" of the 80 planted, {int(inl[80:].sum())} of the outliers, "
        f"{int(inl[-8:].sum())} masked), rotation error {e_r:.4f} degrees, "
        f"|t - t_gt| {e_t:.4f}")
    if not (bool(out["success"]) and inl[:80].sum() >= 72
            and inl[80:].sum() <= 3 and not inl[-8:].any()
            and e_r < E_PNP_DEG and e_t < E_PNP_T):
        fail("PnP did not recover the planted pose within the mask")
    return {"chain_err_deg": errs, "pnp_rot_err_deg": e_r, "pnp_t_err": e_t}


def _eval_run(api, pairs, kernels, tag):
    """evaluate_pairs through ``api`` on the card as the main path: every
    count at 0 before, read after; seconds per pair on the host clock, the
    device busy ms per pair from a profiler window over two pairs, and the
    idle share of the unprofiled pair time. Returns the result with
    those."""
    import torch

    from imcui_tpu_torch.eval import megadepth

    fn = megadepth.api_matcher_fn(api)

    def run(ps):
        return megadepth.evaluate_pairs(fn, ps, E_RANSAC_PX, device="cuda")

    for kfn in kernels:
        kfn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run(pairs)
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t0) / len(pairs)
    launches = {k.__name__: k.launches for k in kernels}
    device_ms, evs = device_window(lambda i: run(pairs[i:i + 1]), 2)
    idle = 1 - device_ms / (sec * 1e3)
    summary = {k: v for k, v in res.items() if k != "errors"}
    log(f"  {tag}: {json.dumps(summary)}; {sec:.4f} s per pair (host "
        f"clock, mean of {len(pairs)}); device busy {device_ms:.2f} ms per "
        f"pair, idle share {idle:.3f}; launches {launches}; top device "
        f"time per pair:")
    for e in sorted(evs, key=lambda e: e.self_device_time_total,
                    reverse=True)[:6]:
        log(f"    {e.self_device_time_total / 2e3:9.3f} ms  x{e.count / 2:g}"
            f"  {e.key[:90]}")
    if res["auc@20"] < E_AUC20_MIN or res["median_err_deg"] > E_MEDIAN_MAX:
        fail(f"{tag}: AUC@20 {res['auc@20']:.4f} (bar {E_AUC20_MIN}), "
             f"median {res['median_err_deg']:.3f} degrees (bar "
             f"{E_MEDIAN_MAX})")
    return {**summary, "errors": res["errors"], "s_per_pair": sec,
            "device_busy_ms": device_ms, "device_idle_share": idle,
            "launches": launches}


def phase9():
    """Pose and evaluation on the card: (a) the planted chain and PnP; (b)
    ``eval pose`` on the flagship in a subprocess as a user runs it, then
    its pairs in this process as the main path (launch counts, each kernel
    against its plain version on the path's arguments, seconds per pair,
    device busy and idle share); (c) the same pairs through loftr; (d)
    evaluate_warp on the trained flagship; (e) the card against the CPU.
    Returns (launches of the main path, measurements)."""
    import re
    import tempfile

    from imcui_tpu_torch.api.core import ImageMatchingAPI
    from imcui_tpu_torch.eval import megadepth, warp
    from imcui_tpu_torch.utils.png import encode_png

    t_phase = time.perf_counter()
    out = {"planted": _planted_pose_checks()}
    mods = _served_modules(EVAL_KERNELS)
    kernels = [getattr(mods[n][0], n) for n in EVAL_KERNELS]
    cwd = os.getcwd()
    os.chdir(ROOT)  # the zoo of config/app.yaml, as the CLI from the root
    try:
        with tempfile.TemporaryDirectory() as tmp:
            corpus = os.path.join(tmp, "corpus")
            os.makedirs(corpus)
            for i, seed in enumerate(E_CORPUS):
                img = textured_image(np.random.default_rng(seed), *E_SIZE)
                with open(os.path.join(corpus, f"photo{i}.png"), "wb") as f:
                    f.write(encode_png(np.repeat(img[..., None], 3, -1)))
            res_dir = os.path.join(tmp, "out")
            proc, sec = _cli(
                "eval", "pose", "--corpus", corpus, "--n-images",
                str(len(E_CORPUS)), "--n-poses", str(E_POSES), "--height",
                str(E_SIZE[0]), "--width", str(E_SIZE[1]), "--subpixel",
                "--ransac-threshold-px", str(E_RANSAC_PX), "--out", res_dir,
                "--device", "cuda")
            if proc.returncode:
                fail(f"eval pose: exit {proc.returncode}: "
                     f"{proc.stderr[-2000:]}")
            line = next((ln for ln in proc.stdout.splitlines()
                         if ln.startswith("pose eval [")), "")
            hit = re.fullmatch(r"pose eval \[superpoint\+lightglue\] on "
                               r"synthpose\((\d+) photos x (\d+) poses\): "
                               r"(\{.*\})", line)
            with open(os.path.join(res_dir,
                                   "pose_superpoint+lightglue.json")) as f:
                rec = json.load(f)
            keys = {"matcher", "source", "n_pairs", "auc@5", "auc@10",
                    "auc@20", "median_err_deg", "mean_matches", "errors"}
            if not hit or set(rec) != keys or json.loads(hit.group(3))[
                    "auc@20"] != round(rec["auc@20"], 4):
                fail(f"eval pose printed {line!r}, wrote {sorted(rec)}")
            log(f"  (b) eval pose (subprocess, {sec:.1f} s from process "
                f"start): {line}")
            log(f"      the JAX package on the CPU, same pairs: "
                f"{E_JAX_CPU['superpoint+lightglue']}")
            if rec["auc@20"] < E_AUC20_MIN or \
                    rec["median_err_deg"] > E_MEDIAN_MAX:
                fail(f"eval pose misses the bars: {line}")
            out["cli"] = {"seconds": sec, "n_pairs": rec["n_pairs"],
                          **{k: rec[k] for k in keys if k.startswith("auc")
                             or k in ("median_err_deg", "mean_matches")}}
            with open(os.path.join(res_dir, "pairs", "pairs.json")) as f:
                pairs = json.load(f)

            # the main path in this process: the flagship's API, its
            # kernels checked on a warm-up pair's arguments, then counted
            conf = megadepth.matcher_conf("superpoint+lightglue",
                                          {"subpixel": True})
            api = ImageMatchingAPI(conf, device="cuda")
            if not (api.extractor.meta["pretrained"]
                    and api.matcher.meta["pretrained"]):
                fail("the flagship did not load the weights/ npz trees")
            fn = megadepth.api_matcher_fn(api)
            seen = _capture_kernel_args(
                lambda: fn(pairs[0]["img0"], pairs[0]["img1"]), EVAL_KERNELS)
            out["kernel_checks"] = _check_served_kernels(seen, "eval pair")
            del seen
            out["superpoint+lightglue"] = _eval_run(
                api, pairs, kernels, "(b) in process, superpoint+lightglue")
            launches = out["superpoint+lightglue"]["launches"]
            missing = [n for n in EVAL_KERNELS if not launches[n]]
            if missing:
                fail(f"the eval path launched no {missing}")

            # (e) the card against the port's CPU run, raw matches
            cpu_fn = megadepth.api_matcher_fn(ImageMatchingAPI(
                conf, device="cpu"))
            ious = []
            for p in pairs[:E_CPU_PAIRS]:
                a, b = fn(p["img0"], p["img1"]), cpu_fn(p["img0"], p["img1"])
                ious.append(raw_match_iou(
                    {"mkeypoints0_orig": a[0], "mkeypoints1_orig": a[1]},
                    {"mkeypoints0_orig": b[0], "mkeypoints1_orig": b[1]},
                    S_TOL_PX))
            log(f"  (e) card against CPU, raw matches of pairs "
                f"0..{E_CPU_PAIRS - 1}: IoU {[round(i, 4) for i in ious]} "
                f"(bound {S_IOU})")
            if min(ious) < S_IOU:
                fail("eval pairs: card and CPU raw matches disagree")
            out["raw_iou_card_vs_cpu"] = ious

            # (c) loftr, the dense branch on its trained tree
            api_l = ImageMatchingAPI(megadepth.matcher_conf("loftr"),
                                     device="cuda")
            if not api_l.matcher.meta["pretrained"]:
                fail(f"loftr weights: {api_l.matcher.meta}")
            log(f"      the JAX package on the CPU, same pairs: "
                f"{E_JAX_CPU['loftr']}")
            out["loftr"] = _eval_run(api_l, pairs, kernels,
                                     "(c) in process, loftr (bf16)")
            del api_l
    finally:
        os.chdir(cwd)

    # (d) evaluate_warp on the trained flagship (test_accuracy_warp.py's)
    wconf = {
        "feature": {"output": "feats-superpoint",
                    "model": {"name": "superpoint", "max_keypoints": 1024,
                              "keypoint_threshold": 5e-4, "checkpoint_npz":
                              os.path.join(ROOT, SP_TRAINED)},
                    "preprocessing": {"grayscale": True, "resize_max": 480,
                                      "dfactor": 8}},
        "matcher": {"output": "matches-lightglue",
                    "model": {"name": "lightglue", "features": "superpoint",
                              "match_threshold": 0.1, "checkpoint_npz":
                              os.path.join(ROOT, LG_TRAINED)}},
        "dense": False, "standalone": False}
    img = textured_image(np.random.default_rng(E_WARP_SEED), *E_SIZE)
    per, agg = warp.evaluate_warp(ImageMatchingAPI(wconf, device="cuda"),
                                  np.repeat(img[..., None], 3, -1),
                                  device="cuda")
    log(f"  (d) evaluate_warp, 5 warps of a 480x640 photo: {agg}; per warp "
        f"{per}; gate {E_WARP_GATE}")
    g = E_WARP_GATE
    if agg["median_recall"] < g["median_recall"] or agg["median_matches"] < \
            g["median_matches"] or agg["median_h_corner_err"] > \
            g["median_h_corner_err"]:
        fail(f"evaluate_warp misses its gate: {agg}")
    out["warp"] = agg
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 9: {out['phase_s']:.1f} s")
    return launches, out


def _http(url, body=None, ctype="application/json"):
    """(status, parsed JSON, bytes of the response) of a GET, or of a POST
    of ``body``."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            raw = resp.read()
            return resp.status, json.loads(raw), len(raw)
    except urllib.error.HTTPError as e:
        raw = e.read()
        return e.code, json.loads(raw), len(raw)


def _cli(*args, timeout=300):
    """``python -m imcui_tpu_torch.cli.main *args`` from the repository
    root: (completed process, wall seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "imcui_tpu_torch.cli.main", *args], cwd=ROOT,
        capture_output=True, text=True, timeout=timeout)
    return proc, time.perf_counter() - t0


def _cli_match(tag, a, b, out, *extra):
    """The CLI's match command as a user runs it: its printed line, the
    pickle's keys and numpy values, its wall time."""
    import pickle
    import re

    proc, sec = _cli("match", a, b, "-o", out, *extra)
    if proc.returncode:
        fail(f"CLI {tag}: exit {proc.returncode}: {proc.stderr[-2000:]}")
    line = next((ln for ln in proc.stdout.splitlines()
                 if ln.startswith("raw matches:")), "")
    hit = re.fullmatch(r"raw matches: (\d+), ransac inliers: (\d+)", line)
    with open(out, "rb") as f:
        pred = pickle.load(f)  # written by the subprocess just above
    if not hit or set(pred) != PRED_KEYS or \
            int(hit.group(1)) != len(pred["mkeypoints0_orig"]):
        fail(f"CLI {tag}: printed {line!r}, pickled keys {sorted(pred)}")
    if not all(isinstance(v, (np.ndarray, dict)) for v in pred.values()):
        fail(f"CLI {tag}: pickle holds {[type(v) for v in pred.values()]}")
    log(f"  CLI {tag}: {line} ({sec:.1f} s from process start to exit)")
    return {"raw": int(hit.group(1)), "inliers": int(hit.group(2)),
            "seconds": sec}


def phase8():
    """The user surfaces on the card: the HTTP server on the packaged
    api.yaml (bf16 SuperPoint + mutual NN) answers planted PNG pairs sent
    by the client (gate, K1 and K2 launched on every request, the time split
    inside the server, device busy and idle share, card against CPU, the
    multipart route, /v1/extract and the 500 envelope), then the CLI as a
    user runs it in subprocesses (--version, match twice, serve). Returns
    (launches of the served requests, measurements)."""
    import importlib.util
    import tempfile

    import torch

    import imcui_tpu_torch
    from imcui_tpu_torch.api import client, server
    from imcui_tpu_torch.ops import attention, cuda_nms, cuda_stage1
    from imcui_tpu_torch.utils.png import decode_png, encode_png

    present = {m: importlib.util.find_spec(m) is not None
               for m in SURFACE_PACKAGES}
    log(f"  packages the JAX surfaces import, present here: {present}")
    kernels = (cuda_stage1.stage_tail, cuda_stage1.stem_tail,
               cuda_nms.nms_cellmax, attention.fused_attention,
               attention.bidirectional_attention, attention.flash_attention)
    result = {"packages_present": present}
    with tempfile.TemporaryDirectory() as tmp:
        files = []
        for seed in S_SEEDS:
            img0, img1, hm = synthetic_pair(seed, *S_SIZE)
            names = [os.path.join(tmp, f"{seed}_{k}.png") for k in "ab"]
            for name, img in zip(names, (img0, img1)):
                with open(name, "wb") as f:
                    f.write(encode_png(img))
            files.append((names, img0, img1, hm))

        png_ms = {}
        for label, ftype in (("up", 2), ("paeth", 4)):
            data = encode_png(files[0][1], ftype)
            t0 = time.perf_counter()
            decode_png(data)
            png_ms[label] = (time.perf_counter() - t0) * 1e3
        log(f"  PNG decode of one {S_SIZE[0]}x{S_SIZE[1]} RGB image on the "
            f"host: {png_ms['up']:.1f} ms (Up rows, the client's), "
            f"{png_ms['paeth']:.1f} ms (Paeth rows, as PIL writes them)")
        result["png_decode_ms"] = png_ms
        t0 = time.perf_counter()
        service = server.MatchingService(device="cuda")
        sp = service.api.extractor
        log(f"  service on the packaged api.yaml in "
            f"{time.perf_counter() - t0:.1f} s: extractor {sp.conf}, "
            f"weights {sp.meta}; matcher {service.api.matcher.conf}")
        if (sp.conf["precision"], sp.conf["nms_radius"],
                sp.conf["max_keypoints"], service.api.extract_conf[
                    "preprocessing"]["resize_max"], sp.meta["pretrained"],
                type(service.api.matcher).__name__) != (
                    "bf16", 4, 1024, 1024, True, "NearestNeighbor"):
            fail("the service does not serve api.yaml's configuration")
        port = free_port()
        httpd = server.serve_stdlib(service, "127.0.0.1", port)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{port}"
        try:
            result.update(_serve_checks(url, service, server, client, files,
                                        kernels, tmp))
            launches = result.pop("launches")
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=30)
        result["cli"] = _cli_checks(files, tmp)
    return launches, result


def _serve_checks(url, service, server, client, files, kernels, tmp):
    import torch

    import imcui_tpu_torch

    if _http(f"{url}/")[:2] != (200, {"message": "OK"}) or \
            _http(f"{url}/version")[:2] != (
                200, {"version": imcui_tpu_torch.__version__}) or \
            _http(f"{url}/nope")[0] != 404:
        fail("GET /, /version or the 404 answered wrongly")
    # the warm-up request, recording the arguments of every launch of the
    # path's kernels; each kernel against its plain version on them
    served = _capture_kernel_args(
        lambda: client.send_request_match(*files[0][0], base_url=url))
    kernel_checks = _check_served_kernels(served)
    del served

    # the main path: every count at 0, the planted pairs served, the counts
    # read after; the split at the client and inside the server by wrapping
    # what each calls (preprocessing and RANSAC are part of the API's time)
    from imcui_tpu_torch.api import core as api_core
    from imcui_tpu_torch.utils import image as image_utils

    targets = [(client, "read_image", "client read"),
               (client, "encode_png", "client encode"),
               (server, "to_base64_nparray", "decode"),
               (server, "decode_image_bytes", "decode"),
               (service, "api", "api"),
               (image_utils, "preprocess", "preprocessing"),
               (api_core, "filter_matches", "ransac"),
               (server, "_encode", "json encode")]
    split = {label: 0.0 for _, _, label in targets}
    sizes = []
    real = [getattr(mod, name) for mod, name, _ in targets]

    def timed(label, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if label == "api":
                torch.cuda.synchronize()
            split[label] += (time.perf_counter() - t0) * 1e3
            if label == "json encode":
                sizes.append(len(out))
            return out
        return run

    for (mod, name, label), fn in zip(targets, real):
        setattr(mod, name, timed(label, fn))
    for kfn in kernels:
        kfn.launches = 0
    rows, walls, per_request, gates = [], [], [], []
    try:
        for i, (names, img0, img1, hm) in enumerate(files):
            for k in split:
                split[k] = 0.0
            before = {k.__name__: k.launches for k in kernels}
            t0 = time.perf_counter()
            res = client.send_request_match(*names, base_url=url)
            walls.append((time.perf_counter() - t0) * 1e3)
            rows.append(dict(split))
            per_request.append({k.__name__: k.launches - before[k.__name__]
                                for k in kernels})
            for key in ("mkeypoints0_orig", "mmkeypoints0_orig",
                        "mmkeypoints1_orig", "H"):
                if not np.isfinite(np.asarray(res.get(key), float)).all():
                    fail(f"served request {i}: {key} missing or not finite")
            err = transfer_errors(hm, res["mmkeypoints0_orig"],
                                  res["mmkeypoints1_orig"])
            med = float(np.median(err)) if len(err) else float("inf")
            log(f"  served request {i} (seed {S_SEEDS[i]}, {S_SIZE}): "
                f"{len(res['keypoints0_orig'])}/{len(res['keypoints1_orig'])}"
                f" keypoints, {len(res['mkeypoints0_orig'])} raw matches, "
                f"{len(err)} inliers, median transfer error {med:.3f} px; "
                f"{walls[-1]:.1f} ms at the client ("
                + ", ".join(f"{k} {v:.1f}" for k, v in rows[-1].items())
                + f" ms); launches {per_request[-1]}")
            gates.append({"raw": len(res["mkeypoints0_orig"]),
                          "inliers": len(err), "median_px": med})
            if len(err) < GATE_MIN_INLIERS or med > GATE_MEDIAN_PX:
                fail(f"served request {i}: gate is >= {GATE_MIN_INLIERS} "
                     f"inliers with median error <= {GATE_MEDIAN_PX} px")
            if not all(per_request[-1][k] for k in SERVED_KERNELS):
                fail(f"served request {i} did not launch each of "
                     f"{SERVED_KERNELS}: {per_request[-1]}")
            if i == 0:
                first = res
        torch.cuda.synchronize()
        launches = {k.__name__: k.launches for k in kernels}
        payload = len(json.dumps({"image0": client.read_image_to_base64(
            files[0][0][0]), "image1": client.read_image_to_base64(
                files[0][0][1])}))
        device_ms, evs = device_window(
            lambda i: client.send_request_match(*files[i][0], base_url=url),
            1)
        multipart = _multipart_checks(url, client, files[1], split)
    finally:
        for (mod, name, _), fn in zip(targets, real):
            setattr(mod, name, fn)
    wall = float(np.median(walls))
    med_split = {k: float(np.median([r[k] for r in rows])) for k in split}
    idle = 1 - device_ms / wall
    log(f"  {wall:.1f} ms per request at the client (host clock, median of "
        f"{len(walls)} after a warm-up); split "
        + ", ".join(f"{k} {v:.1f}" for k, v in med_split.items())
        + f" ms; request {payload} bytes, response {sizes[0]} bytes; device "
        f"busy {device_ms:.2f} ms/request, idle share {idle:.3f}; "
        f"launches {launches}; top device time per request:")
    for e in sorted(evs, key=lambda e: e.self_device_time_total,
                    reverse=True)[:8]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:g}  "
            f"{e.key[:100]}")

    # card against the port's CPU service on pair 0
    cpu = server.MatchingService(device="cpu")
    t0 = time.perf_counter()
    want = cpu.match(files[0][1], files[0][2])
    cpu_ms = (time.perf_counter() - t0) * 1e3
    iou = raw_match_iou(first, want, S_TOL_PX)
    log(f"  card against CPU on pair 0: {len(first['mkeypoints0_orig'])} and "
        f"{len(want['mkeypoints0_orig'])} raw matches, IoU {iou:.4f} (bound "
        f"{S_IOU}); the CPU service took {cpu_ms:.0f} ms")
    if iou < S_IOU:
        fail(f"card and CPU raw matches: IoU {iou:.4f}")
    jpeg_res = _jpeg_bodies(url, files[2])

    # /v1/extract (it rewrites the extractor's conf, so it comes last), the
    # 500 envelope, and the server still answering
    names = files[1][0]
    payload_x = {"data": [client.read_image_to_base64(n) for n in names],
                 "max_keypoints": list(S_EXTRACT_KPTS), "binarize": True}
    code, preds, _ = _http(f"{url}/v1/extract",
                           json.dumps(payload_x).encode())
    counts = [len(p.get("keypoints", [])) for p in preds] if code == 200 \
        else preds
    ok = code == 200 and counts == list(S_EXTRACT_KPTS) and all(
        len(p["keypoints_orig"]) == n and np.asarray(p["descriptors"]).shape
        == (n, 256) for p, n in zip(preds, S_EXTRACT_KPTS))
    log(f"  /v1/extract: status {code}, keypoints {counts}")
    if not ok:
        fail("/v1/extract answered wrongly")
    errors = {}
    for tag, body in (("malformed JSON", b"{not json"),
                      ("truncated JPEG body", json.dumps(
                          {"image0": _JPEG_B64,
                           "image1": _JPEG_B64}).encode())):
        code, out, _ = _http(f"{url}/v1/match", body)
        errors[tag] = out.get("detail")
        log(f"  {tag}: status {code}, detail {out.get('detail')!r}")
        if code != 500 or not out.get("detail"):
            fail(f"{tag}: no 500 envelope")
    if "JPEG" not in errors["truncated JPEG body"] or \
            _http(f"{url}/")[:2] != (200, {"message": "OK"}):
        fail("the truncated JPEG's detail does not name JPEG, or the server "
             "stopped answering")
    jpeg_res["truncated_detail"] = errors["truncated JPEG body"]
    return {"jpeg": jpeg_res, "launches": launches, "launches_per_request": per_request,
            "ms_per_request": wall, "request_ms": walls,
            "split_ms": med_split, "device_busy_ms": device_ms,
            "device_idle_share": idle, "request_bytes": payload,
            "response_bytes": sizes[0],
            "gate": gates, "iou_card_vs_cpu": iou,
            "cpu_request_ms": cpu_ms, "extract_keypoints": counts,
            "errors": errors, "multipart": multipart,
            "served_kernel_checks": kernel_checks}


def pil_jpeg(image, **kw):
    """PIL's JPEG of a uint8 image at J_QUALITY (PIL's 4:2:0 unless
    ``subsampling`` says otherwise)."""
    import io

    import PIL.Image

    buf = io.BytesIO()
    PIL.Image.fromarray(image).save(buf, format="JPEG", quality=J_QUALITY,
                                    **kw)
    return buf.getvalue()


def _jpeg_bodies(url, pair):
    """/v1/match on a JPEG body (PIL's q95 of the tinted planted pair) and
    on the PNG of PIL's decode of it: both answer 200, with the same
    keypoints and raw matches."""
    import base64
    import io

    import PIL.Image

    from imcui_tpu_torch.utils.png import encode_png

    jpgs = [pil_jpeg((img * J_TINT).astype(np.uint8)) for img in pair[1:3]]
    pngs = [encode_png(np.asarray(PIL.Image.open(io.BytesIO(j)).convert(
        "RGB"))) for j in jpgs]
    outs = {}
    for tag, (b0, b1) in (("JPEG", jpgs), ("PNG of PIL's decode", pngs)):
        body = json.dumps({"image0": base64.b64encode(b0).decode(),
                           "image1": base64.b64encode(b1).decode()}).encode()
        code, outs[tag], _ = _http(f"{url}/v1/match", body)
        if code != 200:
            fail(f"/v1/match on a {tag} body: status {code}, "
                 f"{str(outs[tag])[:300]}")
    keys = ("keypoints0_orig", "keypoints1_orig", "mkeypoints0_orig",
            "mkeypoints1_orig")
    same = {k: outs["JPEG"][k] == outs["PNG of PIL's decode"][k]
            for k in keys}
    n = len(outs["JPEG"]["mkeypoints0_orig"])
    log(f"  JPEG body ({len(jpgs[0])} + {len(jpgs[1])} bytes): status 200, "
        f"{n} raw matches; equal to the PNG of PIL's decode: {same}")
    if not all(same.values()) or n == 0:
        fail("the JPEG body's answer differs from the PNG body's")
    return {"jpeg_bytes": [len(j) for j in jpgs], "raw_matches": n,
            "equal_to_png": same}


def _served_modules(names=SERVED_KERNELS):
    """{name: (the module that defines the wrapper, the modules whose
    attribute the path calls)} of each wrapper in ``names`` (LightGlue
    imports the attention wrappers by name)."""
    from imcui_tpu_torch.models.matchers import lightglue
    from imcui_tpu_torch.ops import attention, cuda_nms, cuda_stage1, w8a8

    where = {"stem_tail": (cuda_stage1, [cuda_stage1]),
             "stage_tail": (cuda_stage1, [cuda_stage1]),
             "nms_cellmax": (cuda_nms, [cuda_nms]),
             "fused_attention": (attention, [lightglue, attention]),
             "bidirectional_attention": (attention, [lightglue]),
             "flash_attention": (attention, [lightglue]),
             "qtiled_attention": (attention, [attention]),
             "linear_int8": (w8a8, [w8a8]),
             "conv2d_int8": (w8a8, [w8a8])}
    return {name: where[name] for name in names}


def _capture_kernel_args(run, names=SERVED_KERNELS, counts=None):
    """The arguments of every launch of the kernels ``names`` (K6, K1 and
    K2 by default) while ``run`` runs, copied on the card: {name: [(args,
    kwargs), ...]}. Each wrapper is replaced, in the modules the path
    calls it from, by one that records and calls it; where the wrapper's
    own module is among them, the wrapper adds its launches to the
    replacement's count (which starts at 0), elsewhere to its own.
    ``counts``, if given, receives each kernel's launches during ``run``:
    the replacement's count plus what the wrapper's own count gained."""
    import torch

    def copy(x):
        return x.clone() if isinstance(x, torch.Tensor) else x

    mods = _served_modules(names)
    real = {name: getattr(mod, name) for name, (mod, _) in mods.items()}
    seen = {name: [] for name in mods}

    def recording(name):
        def call(*a, **kw):
            seen[name].append((tuple(map(copy, a)),
                               {k: copy(v) for k, v in kw.items()}))
            return real[name](*a, **kw)
        call.launches = 0
        return call

    recorders = {name: recording(name) for name in mods}
    before = {name: real[name].launches for name in mods}
    for name, (_, callers) in mods.items():
        for mod in callers:
            setattr(mod, name, recorders[name])
    try:
        run()
    finally:
        for name, (_, callers) in mods.items():
            for mod in callers:
                setattr(mod, name, real[name])
        if counts is not None:
            counts.update({n: r.launches + real[n].launches - before[n]
                           for n, r in recorders.items()})
    return seen


def _check_served_kernels(seen, what="served request", log_each=True):
    """Each recorded launch again, the kernel against its plain version on
    the same card tensors: K6 and K1 within one bf16 rounding step of the
    result (1e-3 + 2^-7·|plain|, as phase 1), K2 exact, K3, K4 and K5
    within 1e-5·max(1, max|plain|) (float32 sums in another order, as
    phase 1; K4 with 4096 keys a side within 2e-5·, as phase 1 at 4096²),
    the W8A8 linear and convolution bit for bit.
    Fails on any excess, or on a kernel of the path that ``what`` did not
    launch."""
    import torch

    from imcui_tpu_torch.models.layers import full_fp32

    mods = _served_modules(tuple(seen))
    out = {}
    for name, calls in seen.items():
        if not calls:
            fail(f"the {what} launched no {name}")
        kernel, plain = (getattr(mods[name][0], name),
                         getattr(mods[name][0], f"{name}_plain"))
        for args, kw in calls:
            pargs = args
            if name == "fused_attention" and args[3] is None:
                # an unmasked launch (mha_auto's ViT blocks): the plain
                # version takes the all-valid mask the wrapper's CPU
                # route builds
                q, heads = args[0], args[4]
                pargs = args[:3] + (torch.ones(
                    (q.shape[0] // heads, q.shape[1]), dtype=torch.bool,
                    device=q.device),) + args[4:]
            with full_fp32():
                got, want = kernel(*args, **kw), plain(*pargs, **kw)
            torch.cuda.synchronize()
            if name == "nms_cellmax":
                err = max((g - w).abs().max().item()
                          for g, w in zip(got, want))
                top = want[0].abs().max().item()
                over = sum(int((g != w).sum()) for g, w in zip(got, want))
                tol = "exact"
            elif name == "qtiled_attention":
                q, _, v = args
                diff = (got.float() - want.float()).abs()
                err, top = diff.max().item(), want.float().abs().max().item()
                over = int((diff > 2.0 ** -7 * want.float().abs().clamp_min(
                    1.0) + 2.0 ** -9 * v.float().abs().max()).sum())
                tol = "2^-7*max(1,|plain|) + 2^-9*max|v|"
            elif name in ("linear_int8", "conv2d_int8"):
                diff = (got.float() - want.float()).abs()
                err, top = diff.max().item(), want.float().abs().max().item()
                over = int((got != want).sum())
                tol = "exact"
            elif name.endswith("attention"):
                if isinstance(got, torch.Tensor):
                    got, want = (got,), (want,)
                err = max((g - w).abs().max().item()
                          for g, w in zip(got, want))
                top = max(w.abs().max().item() for w in want)
                # K4 over 4096 keys a side: phase 1's 2e-5 at that shape
                f = 2e-5 if name == "bidirectional_attention" and max(
                    args[0].shape[1], args[1].shape[1]) >= 4096 else 1e-5
                over = int(err > f * max(1.0, top))
                tol = f"{f:g}*max(1,max|plain|)"
                if over:
                    # where the float32 plain version is itself that far
                    # from exact (large logits), both are held against the
                    # plain version in float64: the kernel within twice
                    # the float32 plain version's own error
                    e_k, e_p = _float64_errors(plain, pargs, got, want)
                    over = int(e_k > max(f * max(1.0, top), 2 * e_p))
                    tol += (f"; against float64: kernel {e_k:.3g}, plain "
                            f"float32 {e_p:.3g} (bound twice that)")
            else:
                diff = (got.float() - want.float()).abs()
                err, top = diff.max().item(), want.float().abs().max().item()
                over = int((diff > 1e-3 + 2.0 ** -7 * want.float().abs())
                           .sum())
                tol = "1e-3 + 2^-7*|plain|"
            shape = "x".join(map(str, args[0].shape))
            dtype = str(args[0].dtype)[6:]
            out.setdefault(name, []).append(
                {"shape": f"{shape} {dtype}", "max_abs_err": err,
                 "max_plain": top, "over": over})
            if log_each:
                log(f"  {what} shapes: {name} [{shape} {dtype}]: err "
                    f"{err:.3g} (max|plain| {top:.3g}; {over} over {tol})")
            if over:
                fail(f"{name} [{shape} {dtype}] of the {what} differs from "
                     f"its plain version")
        if not log_each:
            cs = out[name]
            log(f"  {what}: {len(cs)} {name} launches held ({tol}): shapes "
                f"{sorted({c['shape'] for c in cs})}, max err "
                f"{max(c['max_abs_err'] for c in cs):.3g}, "
                f"{sum(c['over'] for c in cs)} over")
    return out


def _float64_errors(plain, args, got, want):
    """Largest |kernel − exact| and |plain float32 − exact| of one launch,
    "exact" the plain version run in float64 on the same inputs."""
    import torch

    ref = plain(*(a.double() if isinstance(a, torch.Tensor) and
                  a.is_floating_point() else a for a in args))
    if isinstance(ref, torch.Tensor):
        ref = (ref,)
    return (max((g.double() - r).abs().max().item()
                for g, r in zip(got, ref)),
            max((w.double() - r).abs().max().item()
                for w, r in zip(want, ref)))


def _zoo_conf(key):
    """The conf of the zoo entry ``key`` (Z_SOURCE says from where)."""
    from imcui_tpu_torch.ui import utils as ui

    src = Z_SOURCE.get(key, "packaged")
    if src == "registry":
        feature, matcher = key.split("+")
        return ui.parse_match_config({"feature": feature, "matcher": matcher,
                                      "dense": False})
    where = ("imcui_tpu_torch", "config") if src == "packaged" else (
        "config",)
    return ui.get_matcher_zoo(ui.load_config(os.path.join(
        ROOT, *where, "app.yaml"))["matcher_zoo"])[key]


def _zoo_api(key, device):
    """ImageMatchingAPI on ``device`` for the zoo entry ``key``, at the
    API's defaults (and Z_FEATURE_CONF's overrides)."""
    from imcui_tpu_torch.api.core import ImageMatchingAPI

    conf = _zoo_conf(key)
    if key in Z_FEATURE_CONF:
        conf["feature"]["model"].update(Z_FEATURE_CONF[key])
    return ImageMatchingAPI(conf, device=device)


def _feature_model(api):
    """The model that detects: the API's extractor, or the extractor
    inside a standalone XFeat pipeline."""
    return api.extractor if api.extractor is not None else \
        api.matcher.extractor


def _set_threshold(api, value):
    """``match_threshold`` of the matcher and of every model inside it."""
    for mod in api.matcher.modules():
        if "match_threshold" in getattr(mod, "conf", {}):
            mod.conf["match_threshold"] = value


def _copy_trees(src, dst):
    """Every parameter tree of the model ``src`` (and the models inside
    it) into the same place of ``dst``, on the CPU."""
    from imcui_tpu_torch.utils import weights

    for a, b in zip(src.modules(), dst.modules()):
        if getattr(a, "params", None) is not None:
            b.params = weights.to_device(a.params, "cpu")


def zoo_flops(run):
    """Floating-point operations of the ATen calls (convolutions and
    matrix products) ``run`` makes, by torch's FlopCounterMode: the
    hand-written kernels' work is not in it."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        run()
    return counter.get_total_flops()


def _wrappers(names=ALL_KERNELS):
    """{name: the wrapper} of every hand-written kernel in ``names``."""
    from imcui_tpu_torch.ops import (attention, cuda_nms, cuda_stage1,
                                     tap_matmul, w8a8)

    mods = (cuda_stage1, cuda_nms, attention, tap_matmul, w8a8)
    return {n: next(getattr(m, n) for m in mods if hasattr(m, n))
            for n in names}


def _zoo_card_vs_cpu(key, api, img0, img1):
    """The entry on the card against the port's CPU run on the same tree
    and image: the extraction of view 0 (keypoint IoU within Z_KPT_PX,
    descriptors at the common keypoints), the raw matches of the pair
    (Z_LOW's learned matchers at Z_LOW_THRESHOLD on both devices), and
    for SuperGlue its log assignment on the card's matcher inputs, for
    Z_SAME_INPUTS the matcher on the card's inputs. Z_CPU_RESIZE's entries
    run at a cut resize_max on both devices."""
    import torch

    from imcui_tpu_torch.pipeline import extract_features

    cpu = _zoo_api(key, "cpu")
    for a, c in ((api.extractor, cpu.extractor), (api.matcher, cpu.matcher)):
        if a is not None:
            _copy_trees(a, c)
    conf = api.match_conf if api.extractor is None else api.extract_conf
    pre = dict(conf.get("preprocessing", {}))
    if key in Z_CPU_RESIZE:
        pre["resize_max"] = Z_CPU_RESIZE[key]
        for a in (api, cpu):
            a.extract_conf["preprocessing"] = pre
    if key in Z_LOW:
        for a in (api, cpu):
            _set_threshold(a, Z_LOW_THRESHOLD)
    captured, feats = {}, [[], []]
    hooks = [api.matcher.register_forward_pre_hook(
        lambda mod, args: captured.update(data=args[0]))]
    if api.extractor is not None:
        # view 0's extraction is the request's first extractor call
        hooks += [a.extractor.register_forward_hook(
            lambda mod, args, o, f=f: f.append(
                {k: v.detach().cpu().numpy() for k, v in o.items()}))
            for a, f in zip((api, cpu), feats)]
    preds = [a(img0, img1) for a in (api, cpu)]
    for h in hooks:
        h.remove()
    if api.extractor is None:  # a standalone pipeline: view 0 alone
        feats = [extract_features.extract(_feature_model(a), img0, pre)
                 for a in (api, cpu)]
    else:
        feats = [f[0] for f in feats]
    kp = [f["keypoints"][0][f["mask"][0]] for f in feats]
    if "oris" in feats[0]:  # SIFT: one point may hold several angles
        iou, ia, ib = oriented_pairs(
            kp[0], np.degrees(feats[0]["oris"][0][feats[0]["mask"][0]]),
            kp[1], np.degrees(feats[1]["oris"][0][feats[1]["mask"][0]]),
            Z_KPT_PX)
    else:
        iou, ia, ib = common_points(kp[0], kp[1], Z_KPT_PX)
    desc = [f["descriptors"][0][:, f["mask"][0]] for f in feats]
    derr = float(np.abs(desc[0][:, ia] - desc[1][:, ib]).max()) \
        if len(ia) else float("inf")
    out = {"kpt_iou": iou, "desc_err": derr, "keypoints": [len(k) for k in kp],
           "match_iou": raw_match_iou(preds[0], preds[1], S_TOL_PX),
           "raw_matches": [len(p["mkeypoints0_orig"]) for p in preds],
           "resize_max": pre.get("resize_max"),
           "match_threshold": Z_LOW_THRESHOLD if key in Z_LOW else None}
    if key in Z_SAME_INPUTS:
        data = captured["data"]
        m = [a.matcher(data)["matches0"][0].cpu().numpy() for a in (api, cpu)]
        valid = np.asarray(data["mask0"][0]).astype(bool)
        out["same_inputs_agree"] = float((m[0] == m[1])[valid].mean())
        out["same_inputs_matches"] = [int((x[valid] > -1).sum()) for x in m]
    if key.endswith("sphereglue"):
        out.update(_sphere_graphs(captured["data"]))
    if key == "superglue":
        data = captured["data"]
        z = [m.log_assignment(data).float().cpu().numpy()
             for m in (api.matcher, cpu.matcher)]
        m0 = np.pad(np.asarray(data["mask0"]), ((0, 0), (0, 1)),
                    constant_values=True)
        m1 = np.pad(np.asarray(data["mask1"]), ((0, 0), (0, 1)),
                    constant_values=True)
        valid = m0[:, :, None] & m1[:, None, :]
        out["log_assignment_err"] = float(
            np.abs(z[0] - z[1])[valid].max()
            / max(1.0, np.abs(z[1][valid]).max()))
    del cpu
    torch.cuda.empty_cache()
    return out


def _sphere_graphs(data):
    """SphereGlue's kNN graph of view 0 on the card and the CPU. From the
    same cosines (the card's ``dots``) the two must be equal; from each
    device's own ``xyz @ xyzᵀ`` a last-bit difference can move a row's
    KNN-th neighbour, so those rows are counted, not gated."""
    import torch

    from imcui_tpu_torch.models.layers import full_fp32
    from imcui_tpu_torch.models.matchers import sphereglue as sg
    from imcui_tpu_torch.models.matchers.nearest_neighbor import pair_sizes

    dots = {}
    for dev in ("cuda", "cpu"):
        kp = torch.as_tensor(data["keypoints0"], dtype=torch.float32,
                             device=dev)
        mask = torch.as_tensor(data["mask0"], device=dev).bool()
        xyz = sg.to_sphere(kp, pair_sizes(data, kp, kp)[0])
        with full_fp32():
            dots[dev] = sg.masked_dots(xyz, mask)
    card = sg.knn_adjacency(dots["cuda"]).cpu()
    same = sg.knn_adjacency(dots["cuda"].cpu())
    own = sg.knn_adjacency(dots["cpu"])
    return {"graph_equal_from_same_dots": bool(torch.equal(card, same)),
            "graph_rows_differ_from_own_dots": int(
                (card != own).any(-1).sum())}


def phase10(peaks, entries=Z_ENTRIES, label="phase 10"):
    """The sparse zoo on the card: each ``entries`` entry through
    ImageMatchingAPI at the API's defaults on a planted Z_SIZE pair: finite
    outputs of the expected shape, each kernel the request launches held
    against its plain version on the request's own tensors, every count at
    0 before three timed requests and read after (a launch of a kernel that
    was not held fails; LightGlue's K5 and K4 once each per layer it ran),
    ms per request, device busy and idle share, the ATen operations of one
    request and their float32 bound, the card against the port's CPU run,
    and superpoint+adalam's gate on every pair of Z_SEEDS. Returns
    (launches of the main path, measurements)."""
    import torch

    t_phase = time.perf_counter()
    pairs = [synthetic_pair(seed, *Z_SIZE) for seed in Z_SEEDS]
    fns = _wrappers()
    capture = SERVED_KERNELS + ("fused_attention", "bidirectional_attention",
                                "flash_attention")
    launches, out = {}, {}
    for key in entries:
        t0 = time.perf_counter()
        api = _zoo_api(key, "cuda")
        feat, mat = _feature_model(api), api.matcher
        cap = getattr(feat, "_max_kpts", feat.conf.get("max_keypoints"))
        log(f"  {key}: {type(feat).__name__} {feat.conf} (keypoint slots "
            f"{cap}), weights {feat.meta}; {type(mat).__name__} {mat.conf}, "
            f"weights {mat.meta}; built in {time.perf_counter() - t0:.1f} s")
        if key in ("aliked+lightglue", "xfeat+lightglue") and cap != 4096:
            fail(f"{key}: the extractor serves {cap} slots, not the 4096 its "
                 f"conf gives")
        img0, img1, hm = pairs[0]
        steps = {"build": time.perf_counter() - t0}
        t_step = time.perf_counter()
        api(img0, img1)  # warm-up: cuDNN's choices, the allocator
        steps["warm-up"] = time.perf_counter() - t_step
        t_step = time.perf_counter()
        seen = _capture_kernel_args(lambda: api(img0, img1), capture)
        seen = {n: c for n, c in seen.items() if c}
        checks = _check_served_kernels(seen, f"{key} request") if seen \
            else {}
        del seen
        # what the timed requests detect and how deep LightGlue runs
        found, stops = [], []
        hooks = [feat.register_forward_hook(lambda m, a, o: found.append(
            int(o["mask"][0].sum())))]
        hooks += [m.register_forward_hook(lambda m, a, o: stops.append(
            int(o["stop_layer"].sum()) if "stop_layer" in o
            else len(m.params["transformers"])))
            for m in mat.modules() if type(m).__name__ == "LightGlue"]
        for fn in fns.values():
            fn.launches = 0
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            pred = api(img0, img1)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
        got = {n: fn.launches for n, fn in fns.items() if fn.launches}
        for h in hooks:
            h.remove()
        for n, c in got.items():
            launches[n] = launches.get(n, 0) + c
        if set(got) - set(checks):
            fail(f"{key}: launched {sorted(set(got) - set(checks))} without "
                 f"holding it against its plain version")
        missing = [n for n in Z_EXPECTED.get(key, ()) if not got.get(n)]
        if missing:
            fail(f"{key}: the request launched no {missing}")
        self_k = next((n for n in ("flash_attention", "fused_attention")
                       if n in Z_EXPECTED.get(key, ())), None)
        if stops and self_k and not (
                got.get(self_k) == got.get("bidirectional_attention")
                == sum(stops)):
            fail(f"{key}: {self_k} {got.get(self_k)} and K4 "
                 f"{got.get('bidirectional_attention')} launches, not one each "
                 f"per layer run ({sum(stops)} layers in 3 requests)")
        for k in ("keypoints0_orig", "keypoints1_orig", "mkeypoints0_orig",
                  "mkeypoints1_orig", "mconf"):
            v = np.asarray(pred[k])
            if not np.isfinite(v).all() or (v.ndim == 2 and v.shape[1] != 2):
                fail(f"{key}: {k} is not finite or not (n, 2): {v.shape}")
        if not found or min(found) < 1 or max(found) > cap:
            fail(f"{key}: {found} keypoints in {cap} slots")
        med = float(np.median(ms))
        steps["capture and 3 timed"] = time.perf_counter() - t_step
        t_step = time.perf_counter()
        busy, evs = device_window(lambda i: api(img0, img1), 1)
        steps["profiler window"] = time.perf_counter() - t_step
        t_step = time.perf_counter()
        flops = zoo_flops(lambda: api(img0, img1))
        steps["ATen count"] = time.perf_counter() - t_step
        res = {"ms_per_request": med, "ms_runs": ms,
               "device_busy_ms": busy, "device_idle_share": 1 - busy / med,
               "keypoints": found[-2:],
               "raw_matches": len(pred["mkeypoints0_orig"]),
               "launches_per_request": {n: c / 3 for n, c in got.items()},
               "lightglue_layers": stops,
               "aten_tflop": flops / 1e12,
               "aten_fp32_bound_ms": flops / peaks["fp32"] * 1e3,
               "kernel_checks": checks}
        log(f"  {key}: {med:.2f} ms per request (median of 3 after a "
            f"warm-up; {[round(m, 2) for m in ms]}), device busy "
            f"{busy:.2f} ms, idle share {res['device_idle_share']:.3f}; "
            f"{res['keypoints']} keypoints, {res['raw_matches']} raw matches;"
            f" launches per request {res['launches_per_request']}"
            + (f" (LightGlue layers run {stops})" if stops else "")
            + f"; ATen work {res['aten_tflop']:.4f} TFLOP a request, "
            f"{res['aten_fp32_bound_ms']:.2f} ms at the float32 peak; top "
            f"device time per request:")
        for e in sorted(evs, key=lambda e: e.self_device_time_total,
                        reverse=True)[:5]:
            log(f"    {e.self_device_time_total / 1e3:9.3f} ms  "
                f"x{e.count:g}  {e.key[:90]}")

        if key == "superpoint+adalam":
            gates = []
            for seed, (a, b, h) in zip(Z_SEEDS, pairs):
                p = api(a, b)
                err = transfer_errors(h, p["mmkeypoints0_orig"],
                                      p["mmkeypoints1_orig"])
                gm = float(np.median(err)) if len(err) else float("inf")
                gates.append({"seed": seed, "raw_matches": len(
                    p["mkeypoints0_orig"]), "inliers": len(err),
                    "median_px": gm})
                log(f"  {key} pair {seed}: {len(p['mkeypoints0_orig'])} raw "
                    f"matches, {len(err)} inliers, median transfer error "
                    f"{gm:.4f} px (the JAX package on the CPU: "
                    f"{Z_JAX_CPU[seed]})")
                if len(err) < GATE_MIN_INLIERS or gm > GATE_MEDIAN_PX:
                    fail(f"{key} pair {seed}: gate is >= {GATE_MIN_INLIERS} "
                         f"inliers at a median <= {GATE_MEDIAN_PX} px")
            res["gate"] = gates

        t_step = time.perf_counter()
        vs = _zoo_card_vs_cpu(key, api, img0, img1)
        steps["card against CPU"] = time.perf_counter() - t_step
        b = Z_BOUNDS["bf16" if key.startswith("superpoint") or key ==
                     "superglue" else "sift" if key in Z_SIFT else
                     "exact" if key in R_ENTRIES else "f32"]
        log(f"  {key}: card against CPU on pair {Z_SEEDS[0]}"
            + (f" at resize_max {vs['resize_max']}" if key in Z_CPU_RESIZE
               else "")
            + (f", the matcher at threshold {vs['match_threshold']:g}"
               if vs["match_threshold"] is not None else "")
            + f": keypoint IoU {vs['kpt_iou']:.4f} (bound {b['kpt_iou']}; "
            f"keypoints {vs['keypoints']}), descriptors within "
            f"{vs['desc_err']:.3g} at the common keypoints (bound "
            f"{b['desc']}), raw-match IoU {vs['match_iou']:.4f} (bound "
            f"{b['match_iou']}; raw matches {vs['raw_matches']})"
            + (" (not gated: Z_PAIR_UNGATED)" if key in Z_PAIR_UNGATED
               else "")
            + (f", the matcher on the card's inputs agrees on "
               f"{vs['same_inputs_agree']:.4f} of view 0's slots (bound "
               f"{Z_BOUNDS['f32']['match_iou']}; matches "
               f"{vs['same_inputs_matches']})"
               if "same_inputs_agree" in vs else "")
            + (f", kNN graphs from the same cosines equal: "
               f"{vs['graph_equal_from_same_dots']} (rows that differ from "
               f"each device's own cosines: "
               f"{vs['graph_rows_differ_from_own_dots']})"
               if "graph_equal_from_same_dots" in vs else "")
            + (f", log assignment within {vs['log_assignment_err']:.3g} of "
               f"the largest (bound {Z_BOUNDS['log_assignment']})"
               if "log_assignment_err" in vs else ""))
        if vs["kpt_iou"] < b["kpt_iou"] or vs["desc_err"] > b["desc"] or (
                max(vs["raw_matches"]) and vs["match_iou"] < b["match_iou"]
                and key not in Z_PAIR_UNGATED) \
                or vs.get("same_inputs_agree", 1.0) < Z_BOUNDS["f32"][
                    "match_iou"] \
                or not vs.get("graph_equal_from_same_dots", True) \
                or vs.get("log_assignment_err", 0) > Z_BOUNDS[
                    "log_assignment"]:
            fail(f"{key}: the card and the CPU disagree: {vs}")
        res["card_vs_cpu"] = vs
        res["seconds"] = time.perf_counter() - t0
        res["step_s"] = steps
        log(f"  {key}: {res['seconds']:.1f} s ("
            + ", ".join(f"{k} {v:.1f}" for k, v in steps.items()) + ")")
        out[key] = res
        del api
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  {label}: {out['phase_s']:.1f} s")
    return launches, out


def _pointmap_maps(model, x0, x1):
    """The dense maps a pointmap model's matching reads, for one prepared
    pair: DUSt3R's view-1 pointmap and confidence, MASt3R's view-1
    descriptors and their confidence, all float32."""
    import torch

    from imcui_tpu_torch.models.layers import full_fp32
    from imcui_tpu_torch.models.matchers import duster, mast3r

    c, p = model.conf, model.params
    with torch.inference_mode(), full_fp32():
        t0, grid = duster.encode(p, x0, c)
        t1, _ = duster.encode(p, x1, c)
        h0, h1 = duster.decode(p, t0, t1, grid, c)
        if type(model).__name__ == "Mast3r":
            return mast3r.desc_head_apply(
                p["downstream_head2"]["head_local_features"], h1[0], h1[-1],
                grid, c["patch"], c["desc_dim"])
        return duster.head_to_pointmap(p["downstream_head2"], h1, grid,
                                       c["patch"])


@contextlib.contextmanager
def _handing_over(model):
    """While the context lasts, ``weights.seeded_init``, which draws a
    seed-0 tree, hands over the card model's tree, copied to the CPU,
    instead of drawing one on the host."""
    from imcui_tpu_torch.utils import weights

    real = weights.seeded_init
    tree = weights.to_device(model.params, "cpu")
    weights.seeded_init = lambda *a, **k: tree
    try:
        yield tree
    finally:
        weights.seeded_init = real


def _cpu_twin(api_conf, model, **kw):
    """ImageMatchingAPI on the CPU (``kw`` its other arguments) with the
    card model's tree (``_handing_over``)."""
    from imcui_tpu_torch.api.core import ImageMatchingAPI

    with _handing_over(model):
        return ImageMatchingAPI(api_conf, device="cpu", **kw)


def _dense_request_times(api, img0, img1, fns):
    """Counts at 0, three timed requests (ms each), the launches they made,
    then one profiler window: (ms runs, launches, device busy ms, events,
    the last prediction)."""
    import torch

    for fn in fns.values():
        fn.launches = 0
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pred = api(img0, img1)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
    got = {n: fn.launches for n, fn in fns.items() if fn.launches}
    busy, evs = device_window(lambda i: api(img0, img1), 1)
    return ms, got, busy, evs, pred


def _check_dense_pred(tag, pred, least=1):
    for k in ("mkeypoints0_orig", "mkeypoints1_orig", "mconf"):
        v = np.asarray(pred[k])
        if not np.isfinite(v).all() or (v.ndim == 2 and v.shape[1] != 2):
            fail(f"{tag}: {k} is not finite or not (n, 2): {v.shape}")
    if len(pred["mkeypoints0_orig"]) < least:
        fail(f"{tag}: {len(pred['mkeypoints0_orig'])} matches, fewer than "
             f"{least}")


def _log_dense(tag, ms, busy, evs, pred, got):
    med = float(np.median(ms))
    log(f"  {tag}: {med:.2f} ms per request (median of 3 after a warm-up; "
        f"{[round(m, 2) for m in ms]}), device busy {busy:.2f} ms, idle "
        f"share {1 - busy / med:.3f}; {len(pred['mkeypoints0_orig'])} "
        f"matches; launches per request "
        f"{ {n: c / 3 for n, c in got.items()} }; top device time:")
    for e in sorted(evs, key=lambda e: e.self_device_time_total,
                    reverse=True)[:4]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:g}  "
            f"{e.key[:90]}")
    return {"ms_per_request": med, "ms_runs": ms, "device_busy_ms": busy,
            "device_idle_share": 1 - busy / med,
            "matches": len(pred["mkeypoints0_orig"]),
            "launches_per_request": {n: c / 3 for n, c in got.items()}}


def phase12_pointmaps(pairs, fns):
    """DUSt3R and MASt3R through ImageMatchingAPI at the registry's conf
    and full ViT-L width, in float32 (no kernel launched) and in bfloat16
    with vit.ATTN_IMPL = "fused" (every K14 launch of a request held
    against its plain version, V_K14 a request), each timed, and the card
    against the CPU at V_CPU_RESIZE. Returns (launches, measurements)."""
    import torch

    from imcui_tpu_torch.api.core import ImageMatchingAPI
    from imcui_tpu_torch.models.backbones import vit
    from imcui_tpu_torch.ui import utils as ui

    img0, img1, _ = pairs[0]
    launches, out = {}, {}
    for name in V_ENTRIES:
        for precision in ("fp32", "bf16"):
            tag = f"{name} {precision}"
            t0 = time.perf_counter()
            conf = ui.parse_match_config({"matcher": name, "dense": True})
            conf["matcher"]["model"]["precision"] = \
                None if precision == "fp32" else "bf16"
            api = ImageMatchingAPI(conf, device="cuda")
            model = api.matcher
            impl = "xla" if precision == "fp32" else "fused"
            vit.ATTN_IMPL = impl
            try:
                api(img0, img1)  # warm-up
                checks = {}
                if precision == "bf16":
                    seen = _capture_kernel_args(lambda: api(img0, img1),
                                                ("qtiled_attention",))
                    if len(seen["qtiled_attention"]) != V_K14:
                        fail(f"{tag}: {len(seen['qtiled_attention'])} K14 "
                             f"launches in a request, not {V_K14}")
                    shapes = sorted({tuple(a[0].shape) for a, _ in
                                     seen["qtiled_attention"]})
                    checks = _check_served_kernels(seen, f"{tag} request")
                    log(f"  {tag}: K14 shapes {shapes}")
                    del seen
                ms, got, busy, evs, pred = _dense_request_times(
                    api, img0, img1, fns)
            finally:
                vit.ATTN_IMPL = "xla"
            want = {"qtiled_attention": 3 * V_K14} if precision == "bf16" \
                else {}
            if got != want:
                fail(f"{tag}: three requests launched {got}, not {want}")
            _check_dense_pred(tag, pred)
            res = _log_dense(tag, ms, busy, evs, pred, got)
            res["kernel_checks"] = checks
            for n, c in got.items():
                launches[n] = launches.get(n, 0) + c

            # card against CPU at V_CPU_RESIZE, on the card's tree
            t1 = time.perf_counter()
            conf["matcher"]["preprocessing"]["resize_max"] = V_CPU_RESIZE
            cpu = _cpu_twin(conf, model)
            small = {}
            for dev, a in (("cuda", api), ("cpu", cpu)):
                a.match_conf["preprocessing"]["resize_max"] = V_CPU_RESIZE
                d = [_canvas(im, a.match_conf["preprocessing"])
                     for im in (img0, img1)]
                x = [a.matcher._prepare(t[None])[0] for t in d]
                small[dev] = [t.float().cpu().numpy()
                              for t in _pointmap_maps(a.matcher, *x)]
            errs = []
            for g, w in zip(small["cuda"], small["cpu"]):
                diff = np.abs(g - w)
                top = float(np.abs(w).max())
                errs.append(float(diff.max() / top if precision == "fp32"
                                  else np.median(diff) / top))
            bound_ = V_CPU_TOL if precision == "fp32" else V_CPU_BF16
            log(f"  {tag}: card against CPU at resize_max {V_CPU_RESIZE} "
                f"({small['cpu'][0].shape[:2]} px): view 1's maps within "
                f"{[f'{e:.3g}' for e in errs]} of the largest ("
                + ("max" if precision == "fp32" else "median")
                + f"; bound {bound_})")
            if not all(e <= bound_ for e in errs):
                fail(f"{tag}: the card and the CPU disagree: {errs}")
            res["card_vs_cpu"] = {"resize_max": V_CPU_RESIZE, "errs": errs,
                                  "bound": bound_,
                                  "s": time.perf_counter() - t1}
            res["seconds"] = time.perf_counter() - t0
            out[tag] = res
            del api, cpu, model
            torch.cuda.empty_cache()
    return launches, out


def _canvas(image, pre):
    """One view preprocessed as the dense pipeline does it: the (3 or 1,
    H, W) float32 canvas."""
    import torch

    from imcui_tpu_torch.utils import image as image_utils

    pconf = image_utils.load_conf(pre)
    d = image_utils.preprocess(
        np.asarray(image), grayscale=pconf.grayscale,
        resize_max=pconf.resize_max, force_resize=pconf.force_resize,
        width=pconf.width, height=pconf.height, dfactor=pconf.dfactor)
    return torch.from_numpy(d["image"][0])


def phase12_dkm(pairs, fns):
    """DKM through ImageMatchingAPI at the registry's conf and at
    coarse_res K_COARSE, three timed requests each (no kernel launched),
    and the card against the CPU on the registry's request."""
    import torch

    from imcui_tpu_torch.api.core import ImageMatchingAPI
    from imcui_tpu_torch.models.matchers import dkm
    from imcui_tpu_torch.ui import utils as ui

    img0, img1, _ = pairs[0]
    out = {}
    for tag, coarse in (("dkm", None), (f"dkm at {K_COARSE}", K_COARSE)):
        t0 = time.perf_counter()
        conf = ui.parse_match_config({"matcher": "dkm", "dense": True})
        conf["matcher"]["model"]["coarse_res"] = coarse
        api = ImageMatchingAPI(conf, device="cuda")
        api(img0, img1)  # warm-up
        ms, got, busy, evs, pred = _dense_request_times(api, img0, img1, fns)
        if got:
            fail(f"{tag}: launched {got}; no kernel lies on DKM's path")
        _check_dense_pred(tag, pred, 1000)
        res = _log_dense(tag, ms, busy, evs, pred, got)
        if coarse is None:
            t1 = time.perf_counter()
            cpu = _cpu_twin(conf, api.matcher)
            maps = {}
            for dev, a in (("cuda", api), ("cpu", cpu)):
                pre = a.match_conf["preprocessing"]
                d = [_canvas(im, pre)[None]
                     for im in (img0, img1)]
                size = dkm.coarse_size(a.matcher.conf, *d[0].shape[-2:])
                x = [a.matcher._prepare(t, size)[0] for t in d]
                with torch.inference_mode():
                    maps[dev] = [t.float().cpu().numpy()
                                 for t in a.matcher.match(*x)]
            errs = [float(np.abs(g - w).max() / np.abs(w).max())
                    for g, w in zip(maps["cuda"], maps["cpu"])]
            log(f"  {tag}: card against CPU at {maps['cpu'][1].shape}: warp "
                f"and certainty within {[f'{e:.3g}' for e in errs]} of the "
                f"largest (bound {K_CPU_TOL})")
            if not all(e <= K_CPU_TOL for e in errs):
                fail(f"{tag}: the card and the CPU disagree: {errs}")
            res["card_vs_cpu"] = {"errs": errs, "bound": K_CPU_TOL,
                                  "s": time.perf_counter() - t1}
            del cpu
        res["seconds"] = time.perf_counter() - t0
        out[tag] = res
        del api
        torch.cuda.empty_cache()
    return out


def phase12(peaks):
    """REKD and RaCo through phase 10's loop, then DUSt3R, MASt3R and DKM
    (each timed, each held to the CPU). Returns (launches, measurements)."""
    t_phase = time.perf_counter()
    launches, out = phase10(peaks, R_ENTRIES, "phase 12, REKD and RaCo")
    pairs = [synthetic_pair(Z_SEEDS[0], *Z_SIZE)]
    fns = _wrappers()
    more, out["pointmaps"] = phase12_pointmaps(pairs, fns)
    for n, c in more.items():
        launches[n] = launches.get(n, 0) + c
    out["dkm"] = phase12_dkm(pairs, fns)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 12: {out['phase_s']:.1f} s")
    return launches, out


# --------------------------------------------------------------------------
# phase 13: the line matchers, LISRD and the wrappers on RoMa
# --------------------------------------------------------------------------

def _n_conf(key):
    """The conf of phase 13's entry ``key`` (N_SOURCE says from where)."""
    from imcui_tpu_torch.ui import utils as ui

    src = N_SOURCE[key]
    if src == "registry":
        return ui.parse_match_config({"matcher": key, "dense": True})
    where = ("imcui_tpu_torch", "config") if src == "packaged" else (
        "config",)
    return ui.get_matcher_zoo(ui.load_config(os.path.join(
        ROOT, *where, "app.yaml"))["matcher_zoo"])[key]


def segment_rows(lines):
    """(n, 2, 2) segments → unoriented (n, 4) rows (the endpoint with the
    smaller x, then y, first)."""
    x = np.asarray(lines, np.float64).reshape(-1, 2, 2)
    flip = (x[:, 0, 0] > x[:, 1, 0]) | ((x[:, 0, 0] == x[:, 1, 0])
                                        & (x[:, 0, 1] > x[:, 1, 1]))
    return np.where(flip[:, None, None], x[:, ::-1], x).reshape(-1, 4)


def _line_pairs(pred):
    """Matched segment pairs of a prediction as unoriented (n, 8) rows."""
    l0 = np.asarray(pred["lines0"]).reshape(-1, 2, 2)
    l1 = np.asarray(pred["lines1"]).reshape(-1, 2, 2)
    return np.concatenate([segment_rows(l0), segment_rows(l1)], 1)


def _detector_of(model):
    """The model inside a phase-13 matcher that detects keypoints."""
    return getattr(model, "sp", None) or getattr(model, "detector", None)


@contextlib.contextmanager
def _recording(module, name, into):
    """``module.name`` appends each call's result to ``into`` while the
    context lasts."""
    real = getattr(module, name)

    def recorded(*args, **kwargs):
        into.append(real(*args, **kwargs))
        return into[-1]
    setattr(module, name, recorded)
    try:
        yield
    finally:
        setattr(module, name, real)


def _warp_cells(card, host):
    """Cell by cell, a (warp, certainty) pair from the card against the
    CPU's: the share of cells whose warp (normalised units, max over x
    and y) and certainty both lie within L_FPN_TOL, the warp error's
    median and largest, the certainty's largest."""
    ew = (card[0].cpu() - host[0]).abs().amax(-1)
    ec = (card[1].cpu() - host[1]).abs()
    return {"cells_within_tol": float(((ew <= L_FPN_TOL)
                                       & (ec <= L_FPN_TOL)).float().mean()),
            "warp_err_median": float(ew.median()),
            "warp_err_max": float(ew.max()), "cert_err_max": float(ec.max())}


def _warps_ok(cells):
    """Whether ``_warp_cells``' readings meet N_BOUNDS' warp bounds."""
    return (cells["cells_within_tol"] >= N_BOUNDS["warp_cells"]
            and cells["warp_err_median"] <= N_BOUNDS["warp_median"]
            and cells["warp_err_max"] <= N_BOUNDS["warp_max"])


def _dad_card_vs_cpu(api, img0, img1):
    """DaD's request on the card against the same request on the CPU, on
    the card's tree and prepared pair at the registry's conf (what
    ``DadRoma._forward`` runs on a pair): the two RoMa warps (image 0 to 1
    and 1 to 0) cell by cell, and the final correspondences as sets within
    S_TOL_PX; then the wrapper alone on both devices from the card's
    warps, as sets within 1e-3 px."""
    import torch

    from imcui_tpu_torch.models.layers import full_fp32
    from imcui_tpu_torch.models.matchers import dad_roma, roma
    from imcui_tpu_torch.utils import weights

    model = api.matcher
    x = [model._prepare(_canvas(im, api.match_conf["preprocessing"])
                        [None])[0] for im in (img0, img1)]
    k = int(model.conf["max_keypoints"])
    trees = {"cuda": model.params,
             "cpu": weights.to_device(model.params, "cpu")}
    real = roma.match
    warps, points, secs = {}, {}, {}

    def correspondences(o):
        m = o["mask"].cpu().numpy()
        return np.concatenate([o["keypoints0"].cpu().numpy()[m],
                               o["keypoints1"].cpu().numpy()[m]], 1)

    for dev in ("cuda", "cpu"):
        t = time.perf_counter()
        with _recording(roma, "match", warps.setdefault(dev, [])), \
                torch.inference_mode(), full_fp32():
            points[dev] = correspondences(dad_roma.apply_pair(
                trees[dev], x[0].to(dev), x[1].to(dev), k))
        secs[dev] = time.perf_counter() - t
    wrapper = {}
    try:
        for dev in ("cuda", "cpu"):
            ws = iter([tuple(t.to(dev) for t in w) for w in warps["cuda"]])
            roma.match = lambda *a, **kw: next(ws)
            with torch.inference_mode():
                wrapper[dev] = correspondences(dad_roma.apply_pair(
                    None, x[0].to(dev), x[1].to(dev), k))
    finally:
        roma.match = real
    cells = [_warp_cells(c, h) for c, h in zip(warps["cuda"], warps["cpu"])]
    res = {"warps": {key: (min if key == "cells_within_tol" else max)(
        c[key] for c in cells) for key in cells[0]},
           "matches": [len(points["cuda"]), len(points["cpu"])],
           "match_iou": common_points(points["cuda"], points["cpu"],
                                      S_TOL_PX)[0],
           "wrapper_iou": common_points(wrapper["cuda"], wrapper["cpu"],
                                        1e-3)[0],
           "request_s": secs}
    res["ok"] = (_warps_ok(res["warps"])
                 and res["match_iou"] >= N_BOUNDS["match_iou"]
                 and res["wrapper_iou"] >= N_BOUNDS["dad_iou"])
    return res


def _n_card_vs_cpu(key, api, img0, img1):
    """Phase 13's entry on the card against the port's CPU run on the same
    trees and the same served request: view 0's keypoints, the raw
    matches, and the lines (GlueStick's LSD segments equal, line matches
    as sets). DaD: ``_dad_card_vs_cpu``. RoMaV2: also the request's final
    warp and certainty, cell by cell (``_warp_cells``)."""
    import torch

    from imcui_tpu_torch.api.core import ImageMatchingAPI
    from imcui_tpu_torch.models.matchers import romav2

    t0 = time.perf_counter()
    model = api.matcher
    if key == "dad(RoMa)":
        res = _dad_card_vs_cpu(api, img0, img1)
        res["s"] = time.perf_counter() - t0
        return res
    feats, warps = [[], []], [[], []]
    if key == "sold2":  # the card's tree handed over, not drawn again
        cpu = _cpu_twin(_n_conf(key), model)
    else:
        cpu = ImageMatchingAPI(_n_conf(key), device="cpu")
        _copy_trees(model, cpu.matcher)
    hooks = [_detector_of(a.matcher).register_forward_hook(
        lambda mod, args, o, f=f: f.append(
            {k: v.detach().cpu().numpy() for k, v in o.items()}))
        for a, f in zip((api, cpu), feats)
        if _detector_of(a.matcher) is not None]
    preds = []
    for a, w in zip((api, cpu), warps):
        with _recording(romav2, "warp_pair", w):
            preds.append(a(img0, img1))
    for hk in hooks:
        hk.remove()
    res = {"raw_matches": [len(p["mkeypoints0_orig"]) for p in preds],
           "match_iou": raw_match_iou(preds[0], preds[1], S_TOL_PX)}
    bf16 = key in ("gluestick", "lisrd", "LISRD+SuperPoint")
    ok = not max(res["raw_matches"]) or res["match_iou"] >= N_BOUNDS[
        "match_iou_bf16" if bf16 else "match_iou"]
    if key == "RoMaV2":
        res["warps"] = _warp_cells(warps[0][0], warps[1][0])
        ok = ok and _warps_ok(res["warps"])
    if key not in ("sold2", "RoMaV2"):
        kp = [f[0]["keypoints"][0][f[0]["mask"][0]] for f in feats]
        if key == "LISRD+SIFT":
            res["kpt_iou"] = oriented_pairs(
                kp[0], np.degrees(feats[0][0]["oris"][0][
                    feats[0][0]["mask"][0]]),
                kp[1], np.degrees(feats[1][0]["oris"][0][
                    feats[1][0]["mask"][0]]), Z_KPT_PX)[0]
        else:
            res["kpt_iou"] = common_points(kp[0], kp[1], Z_KPT_PX)[0]
        res["keypoints"] = [len(k) for k in kp]
        ok = ok and res["kpt_iou"] >= N_BOUNDS[
            "kpt_iou_bf16" if bf16 else "kpt_iou"]
    if "raw_lines0" in preds[0]:
        for i in "01":
            r = [segment_rows(p[f"raw_lines{i}"]) for p in preds]
            res[f"raw_lines{i}"] = [len(v) for v in r]
            res[f"raw_lines{i}_iou"] = common_points(r[0], r[1], 1e-4
                                                     if key == "gluestick"
                                                     else 1e-3)[0]
        lp = [_line_pairs(p) for p in preds]
        res["line_matches"] = [len(v) for v in lp]
        res["line_match_iou"] = common_points(lp[0], lp[1], 1e-3)[0] \
            if len(lp[0]) or len(lp[1]) else 1.0
        if key == "gluestick":  # LSD is exact on both devices
            ok = ok and res["raw_lines0_iou"] == res["raw_lines1_iou"] == 1.0
        else:
            ok = ok and min(res["raw_lines0_iou"],
                            res["raw_lines1_iou"]) >= N_BOUNDS["line_iou"]
        ok = ok and res["line_match_iou"] >= N_BOUNDS["line_iou"]
    res["ok"] = ok
    res["s"] = time.perf_counter() - t0
    del cpu
    torch.cuda.empty_cache()
    return res


def _lsd_stages(size=N_LSD_SIZE):
    """``ops/lsd.py`` on one planted view at ``size`` on the card against
    its CPU run (segments, widths and precisions equal), each device
    stage's CUDA-event time, each stage's wall time on the card and the
    CPU, and the host's share."""
    import torch

    from imcui_tpu_torch.ops import lsd

    img = synthetic_pair(N_SEEDS[0], *size)[0][..., 0]
    u = torch.from_numpy(img).cuda()
    lsd.detect(u)  # warm-up
    wall = {"cuda": {}, "cpu": {}}
    card = lsd.detect(u, wall["cuda"])
    cpu = lsd.detect(u.cpu(), wall["cpu"])
    same = all(np.array_equal(a, b) for a, b in zip(card, cpu))
    blurred = lsd.gaussian_blur_u8(u)
    scaled = lsd.resize_linear_exact_u8(blurred)
    device = {"blur": cuda_ms(lambda: lsd.gaussian_blur_u8(u)),
              "resize": cuda_ms(lambda: lsd.resize_linear_exact_u8(blurred)),
              "gradient": cuda_ms(lambda: lsd.gradient(scaled))}
    total = sum(wall["cuda"].values())
    host = sum(wall["cuda"][k] for k in ("copy", "sort", "grow"))
    out = {"size": list(size), "segments": len(card[0]), "equal": same,
           "device_ms": device,
           "wall_ms_card": {k: v * 1e3 for k, v in wall["cuda"].items()},
           "wall_ms_cpu": {k: v * 1e3 for k, v in wall["cpu"].items()},
           "host_share_card": host / total}
    log(f"  LSD on a {size[0]} x {size[1]} view: {len(card[0])} segments, "
        f"card and CPU equal: {same}; device ms by stage "
        f"{ {k: round(v, 4) for k, v in device.items()} }; wall ms on the "
        f"card {({k: round(v, 2) for k, v in out['wall_ms_card'].items()})}"
        f", on the CPU "
        f"{({k: round(v, 2) for k, v in out['wall_ms_cpu'].items()})}; "
        f"host share on the card {out['host_share_card']:.3f}")
    if not same or len(card[0]) < 100:
        fail("LSD: the card and the CPU disagree, or too few segments")
    return out


def _gluestick_gates(api, first):
    """GlueStick's planted gate on every pair of N_SEEDS beside the JAX
    package's CPU numbers: at least GATE_MIN_INLIERS inliers and 0.8 of
    the JAX package's, a median transfer error at most GATE_MEDIAN_PX, and
    a share of lines within N_LINE_PX at least the JAX package's less
    0.1. ``first`` is the timed requests' prediction on the first pair."""
    gates = []
    for seed in N_SEEDS:
        a, b, hm = synthetic_pair(seed, *Z_SIZE)
        g = gluestick_gate(first if seed == N_SEEDS[0] else api(a, b), hm)
        g["seed"] = seed
        want = N_JAX_CPU.get(seed, {})
        log(f"  gluestick pair {seed}: {g['raw_matches']} raw matches, "
            f"{g['inliers']} inliers at a median {g['median_px']} px, "
            f"{g['line_matches']} matched lines ({g['raw_lines']} raw), "
            f"{g['line_share']} within {N_LINE_PX} px (the JAX package on "
            f"the CPU: {want})")
        if g["inliers"] < max(GATE_MIN_INLIERS,
                              0.8 * want.get("inliers", 0)) \
                or g["median_px"] is None \
                or g["median_px"] > GATE_MEDIAN_PX \
                or g["line_share"] is None \
                or g["line_share"] < want.get("line_share", 0.5) - 0.1:
            fail(f"gluestick pair {seed}: the planted gate fails: {g}")
        gates.append(g)
    return gates


def phase13():
    """The line matchers, LISRD and the wrappers on RoMa through
    ImageMatchingAPI on the card, each N_ENTRIES entry on a planted Z_SIZE
    pair: the kernels its request launches held against their plain
    versions on the request's tensors (N_EXPECTED's must be among them),
    counts at 0 before three timed requests and read after, finite
    outputs, ms per request, device busy and idle share, the card against
    the port's CPU run; then LSD's stages and GlueStick's planted gate.
    Returns (launches of the main path, measurements)."""
    import torch

    from imcui_tpu_torch.api.core import ImageMatchingAPI

    t_phase = time.perf_counter()
    img0, img1, _ = synthetic_pair(N_SEEDS[0], *Z_SIZE)
    fns = _wrappers()
    capture = SERVED_KERNELS + ("fused_attention",)
    launches, out = {}, {}
    for key in N_ENTRIES:
        t0 = time.perf_counter()
        api = ImageMatchingAPI(_n_conf(key), device="cuda")
        model = api.matcher
        log(f"  {key}: {type(model).__name__} {model.conf}, weights "
            f"{model.meta}; built in {time.perf_counter() - t0:.1f} s")
        # the first request, whose kernel launches are recorded, is also
        # the warm-up of the timed ones (cuDNN's choices, the allocator)
        seen = _capture_kernel_args(lambda: api(img0, img1), capture)
        seen = {n: c for n, c in seen.items() if c}
        if key == "dad(RoMa)" and len(seen.get("fused_attention", ())) \
                != N_K3:
            fail(f"{key}: {len(seen.get('fused_attention', ()))} K3 "
                 f"launches in a request, not {N_K3}")
        checks = _check_served_kernels(seen, f"{key} request") if seen \
            else {}
        del seen
        ms, got, busy, evs, pred = _dense_request_times(api, img0, img1, fns)
        for n, c in got.items():
            launches[n] = launches.get(n, 0) + c
        if set(got) - set(checks):
            fail(f"{key}: launched {sorted(set(got) - set(checks))} without "
                 f"holding it against its plain version")
        missing = [n for n in N_EXPECTED.get(key, ()) if not got.get(n)]
        if missing:
            fail(f"{key}: the request launched no {missing}")
        _check_dense_pred(key, pred, 0 if key == "sold2" else 1)
        if "raw_lines0" in pred and not len(pred["raw_lines0"][0] if key
                                            == "gluestick" else
                                            pred["raw_lines0"]):
            fail(f"{key}: no line detected")
        res = _log_dense(key, ms, busy, evs, pred, got)
        res["kernel_checks"] = checks
        vs = _n_card_vs_cpu(key, api, img0, img1)
        log(f"  {key}: card against CPU: {vs}")
        if not vs["ok"]:
            fail(f"{key}: the card and the CPU disagree: {vs}")
        res["card_vs_cpu"] = vs
        if key == "gluestick":
            res["gate"] = _gluestick_gates(api, pred)
        res["seconds"] = time.perf_counter() - t0
        log(f"  {key}: {res['seconds']:.1f} s")
        out[key] = res
        del api, model
        torch.cuda.empty_cache()
    out["lsd"] = _lsd_stages()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 13: {out['phase_s']:.1f} s")
    return launches, out


# --------------------------------------------------------------------------
# phase 14: the root zoo's last matchers and the global descriptors
# --------------------------------------------------------------------------

def _o_conf(key):
    """The root config/app.yaml's entry ``key``, enabled or not, resolved
    by its conf."""
    from imcui_tpu_torch.ui import utils as ui

    raw = ui.load_config(os.path.join(ROOT, "config", "app.yaml"))[
        "matcher_zoo"][key]
    return ui.parse_match_config(raw)


def _o_api(key, device="cuda", card=None):
    """ImageMatchingAPI on ``device`` for phase 14's entry ``key`` at
    O_THRESHOLD's match_threshold (the API's 0.2 elsewhere); with
    ``card`` (the card's matcher), on the CPU with its trees."""
    from imcui_tpu_torch.api.core import ImageMatchingAPI

    kw = {"match_threshold": O_THRESHOLD.get(key, 0.2)}
    if card is None:
        return ImageMatchingAPI(_o_conf(key), device=device, **kw)
    api = _cpu_twin(_o_conf(key), card, **kw)
    _copy_trees(card, api.matcher)
    return api


def _o_card_vs_cpu(key, api, img0, img1):
    """Phase 14's entry on the card against the port's CPU run on the same
    trees and the same request: the raw matches; OmniGlue's SuperPoint
    keypoints of both views; MicKey's pose; COTR's two decoder passes."""
    import torch

    from imcui_tpu_torch.models.matchers import cotr

    t0 = time.perf_counter()
    cpu = _o_api(key, card=api.matcher)
    feats, outs, decoded = [[], []], [[], []], [[], []]
    hooks = []
    for a, f, o in zip((api, cpu), feats, outs):
        hooks.append(a.matcher.register_forward_hook(
            lambda mod, args, out, o=o: o.append(
                {k: v.detach().cpu() for k, v in out.items()})))
        if key == "omniglue":
            hooks.append(a.matcher.sp.register_forward_hook(
                lambda mod, args, out, f=f: f.append(
                    {k: v.detach().float().cpu().numpy()
                     for k, v in out.items()})))
    preds = []
    try:
        for a, d in zip((api, cpu), decoded):
            with _recording(cotr, "decode", d):
                preds.append(a(img0, img1))
    finally:
        for hk in hooks:
            hk.remove()
    res = {"raw_matches": [len(p["mkeypoints0_orig"]) for p in preds],
           "match_iou": raw_match_iou(preds[0], preds[1], S_TOL_PX)
           if max(len(p["mkeypoints0_orig"]) for p in preds) else 1.0}
    ok = res["match_iou"] >= S_IOU
    if key == "omniglue":
        res["keypoints"], res["kpt_iou"] = [], []
        for v in (0, 1):
            kp = [f[v]["keypoints"][0][f[v]["mask"][0].astype(bool)]
                  for f in feats]
            res["keypoints"].append([len(k) for k in kp])
            res["kpt_iou"].append(common_points(kp[0], kp[1], Z_KPT_PX)[0])
        ok = ok and min(res["kpt_iou"]) >= Z_BOUNDS["bf16"]["kpt_iou"]
    if key == "mickey":
        for k in ("R", "t"):
            res[f"{k}_err"] = float((outs[0][0][k] - outs[1][0][k]).abs()
                                    .max())
        ok = ok and max(res["R_err"], res["t_err"]) <= O_POSE_TOL
    if key == "cotr":
        res["decoded_err"] = max(float((c.cpu() - h).abs().max())
                                 for c, h in zip(decoded[0], decoded[1]))
        res["decoder_passes"] = [len(d) for d in decoded]
        ok = ok and res["decoder_passes"] == [2, 2] \
            and res["decoded_err"] <= O_COTR_TOL
    res["ok"] = ok
    res["s"] = time.perf_counter() - t0
    del cpu
    torch.cuda.empty_cache()
    return res


def _ret_cpu_twin(conf, card):
    """The extractor of ``conf`` on the CPU with the card model's tree
    (``_handing_over``)."""
    from imcui_tpu_torch.ui import utils as ui

    with _handing_over(card) as tree:
        model = ui.get_feature_model(conf, "cpu")
    model.params = tree
    return model


def _retrieval(key, image):
    """One retrieval conf through extract() on the card: built, a warm-up,
    three timed extractions, a profiler window, and the card against the
    port's CPU run on the card's tree."""
    import torch

    from imcui_tpu_torch.pipeline import extract_features as ef
    from imcui_tpu_torch.ui import utils as ui

    conf = ef.confs[key]
    t0 = time.perf_counter()
    model = ui.get_feature_model(conf, "cuda")
    built = time.perf_counter() - t0
    pre = conf["preprocessing"]
    got = ef.extract(model, image, pre)
    out_key = "local_descriptor" if key == "fire_local" \
        else "global_descriptor"
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = ef.extract(model, image, pre)
        ms.append((time.perf_counter() - t1) * 1e3)
    busy, evs = device_window(lambda i: ef.extract(model, image, pre), 1)
    # the model's forward alone between two CUDA events: the device time
    # where the profiler's window drops kernels (it kept only NetVLAD's
    # last gemv in one whole-script run)
    data = {"image": got["image"], "valid_wh": got["size"][None]}

    def forward():
        with torch.inference_mode():
            model(data)

    forward_ms = cuda_ms(forward, iters=3, warmup=1)
    med = float(np.median(ms))
    g = got[out_key]
    if not np.isfinite(g).all():
        fail(f"{key}: the {out_key} is not finite")
    t1 = time.perf_counter()
    cpu = _ret_cpu_twin(conf, model)
    h = ef.extract(cpu, image, pre)[out_key]
    res = {"model": type(model).__name__, "meta": model.meta,
           "canvas": list(got["image"].shape[2:]), "shape": list(g.shape),
           "built_s": built, "ms_per_extract": med, "ms_runs": ms,
           "device_busy_ms": busy, "device_idle_share": 1 - busy / med,
           "forward_event_ms": forward_ms,
           "cpu_s": time.perf_counter() - t1,
           "max_abs_err": float(np.abs(g - h).max())}
    if key == "fire_local":
        res["set_iou"] = common_points(g[0], h[0], RET_ABS)[0]
        res["ok"] = g.shape == h.shape and res["set_iou"] >= RET_SET_IOU
    else:
        res["cos"] = float((g * h).sum() / np.linalg.norm(g)
                           / np.linalg.norm(h))
        res["ok"] = res["cos"] >= RET_COS and res["max_abs_err"] <= RET_ABS
    vs = {k: res[k] for k in ("cos", "set_iou", "max_abs_err") if k in res}
    log(f"  {key}: {res['model']} on a {res['canvas']} canvas → "
        f"{res['shape']}: {med:.2f} ms per extract (median of 3 after a "
        f"warm-up; {[round(m, 2) for m in ms]}), device busy {busy:.2f} ms, "
        f"idle share {1 - busy / med:.3f}, the forward {forward_ms:.2f} ms "
        f"between CUDA events; card against CPU: {vs}; top device time:")
    for e in sorted(evs, key=lambda e: e.self_device_time_total,
                    reverse=True)[:3]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:g}  "
            f"{e.key[:90]}")
    if not res["ok"]:
        fail(f"{key}: the card and the CPU disagree: {res}")
    del model, cpu
    torch.cuda.empty_cache()
    return res


def phase14():
    """The root zoo's last matchers (O_ENTRIES) through ImageMatchingAPI
    on the card on a planted Z_SIZE pair, as phase 13 serves its entries
    (kernels held against their plain versions, O_EXPECTED's among them,
    counts at 0 before three timed requests and read after, ms per
    request, device busy and idle share, the card against the port's CPU
    run); then the seven retrieval confs through extract() on view 0.
    Returns (launches of the main path, measurements)."""
    import torch

    t_phase = time.perf_counter()
    img0, img1, _ = synthetic_pair(N_SEEDS[0], *Z_SIZE)
    fns = _wrappers()
    capture = SERVED_KERNELS + ("fused_attention",)
    launches, out = {}, {}
    for key in O_ENTRIES:
        t0 = time.perf_counter()
        api = _o_api(key)
        model = api.matcher
        log(f"  {key}: {type(model).__name__} {model.conf}, weights "
            f"{model.meta}; built in {time.perf_counter() - t0:.1f} s")
        seen = _capture_kernel_args(lambda: api(img0, img1), capture)
        seen = {n: c for n, c in seen.items() if c}
        checks = _check_served_kernels(seen, f"{key} request") if seen \
            else {}
        del seen
        ms, got, busy, evs, pred = _dense_request_times(api, img0, img1, fns)
        for n, c in got.items():
            launches[n] = launches.get(n, 0) + c
        if set(got) - set(checks):
            fail(f"{key}: launched {sorted(set(got) - set(checks))} without "
                 f"holding it against its plain version")
        missing = [n for n in O_EXPECTED.get(key, ()) if not got.get(n)]
        if missing:
            fail(f"{key}: the request launched no {missing}")
        _check_dense_pred(key, pred, 1 if key in O_THRESHOLD else 0)
        res = _log_dense(key, ms, busy, evs, pred, got)
        res["kernel_checks"] = checks
        vs = _o_card_vs_cpu(key, api, img0, img1)
        log(f"  {key}: card against CPU: {vs}")
        if not vs["ok"]:
            fail(f"{key}: the card and the CPU disagree: {vs}")
        res["card_vs_cpu"] = vs
        res["seconds"] = time.perf_counter() - t0
        log(f"  {key}: {res['seconds']:.1f} s")
        out[key] = res
        del api, model
        torch.cuda.empty_cache()
    for key in RET_ENTRIES:
        t0 = time.perf_counter()
        out[key] = _retrieval(key, img0)
        out[key]["seconds"] = time.perf_counter() - t0
        log(f"  {key}: {out[key]['seconds']:.1f} s")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 14: {out['phase_s']:.1f} s")
    return launches, out


def _batch_stages(conf, f, imgs, overwrite):
    """The batch pipelines in order on the card, each a callable."""
    from imcui_tpu_torch.pipeline import extract_features as ef
    from imcui_tpu_torch.pipeline import match_dense as md
    from imcui_tpu_torch.pipeline import match_features as mf
    from imcui_tpu_torch.pipeline import pairs_from_exhaustive as pe
    from imcui_tpu_torch.pipeline import pairs_from_retrieval as pr

    return {
        "extract": lambda: ef.main(conf["sp"], imgs, feature_path=f["feats"],
                                   overwrite=overwrite),
        "pairs": lambda: pe.main(f["pairs"], features=f["feats"]),
        "match": lambda: mf.main(conf["lg"], f["pairs"], f["feats"],
                                 matches=f["matches"], overwrite=overwrite),
        "global": lambda: ef.main(conf["nv"], imgs, feature_path=f["global"],
                                  overwrite=overwrite),
        "retrieval": lambda: pr.main(f["global"], f["retrieval"],
                                     B_RETRIEVAL_K),
        "dense": lambda: md.main(conf["lo"], f["planted"], imgs,
                                 features=f["dense_feats"],
                                 matches=f["dense_matches"],
                                 overwrite=overwrite)}


def _run_stages(stages):
    """({stage: its return value}, {stage: wall s}), one after another."""
    import torch

    out, walls = {}, {}
    for k, fn in stages.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[k] = fn()
        torch.cuda.synchronize()
        walls[k] = time.perf_counter() - t0
    return out, walls


def _rows(a, b, scores=None):
    """(n, 4|5) float64 rows [a, b(, score)], lexicographically sorted."""
    cols = [np.asarray(a, np.float64), np.asarray(b, np.float64)]
    if scores is not None:
        cols.append(np.asarray(scores, np.float64)[:, None])
    r = np.concatenate(cols, 1) if len(cols[0]) else np.zeros(
        (0, 4 + (scores is not None)))
    return r[np.lexsort(r.T[::-1])]


def _batch_file_checks(conf, f, imgs, names, planted):
    """Each file against the same models in memory on the card; the
    planted gate on both match files; the retrieval pairs against the
    CPU. Returns the measurements."""
    from scipy.spatial import cKDTree

    from imcui_tpu_torch.pipeline import extract_features as ef
    from imcui_tpu_torch.pipeline import match_dense as md
    from imcui_tpu_torch.pipeline import match_features as mf
    from imcui_tpu_torch.pipeline import pairs_from_retrieval as pr
    from imcui_tpu_torch.ui import utils as ui
    from imcui_tpu_torch.utils import h5lite, io
    from imcui_tpu_torch.utils.image import keypoints_to_original, read_image

    res = {}
    # extraction: keypoints at the original resolution (float64), scores
    # and descriptors as float16, the uncertainty attribute
    for key, out_keys in (("sp", ("keypoints", "scores", "descriptors")),
                          ("nv", ("global_descriptor",))):
        pre = {**B_MAIN_PRE, **conf[key]["preprocessing"]}
        model = ui.get_feature_model(conf[key], "cuda")
        path = f["feats" if key == "sp" else "global"]
        with h5lite.File(path) as fd:
            for name in names:
                pred = ef.extract(model, read_image(imgs / name,
                                                    pre["grayscale"]), pre)
                want = ef.trim_valid(pred)
                scale = pred["original_size"] / pred["size"]
                if "keypoints" in want:
                    want["keypoints"] = keypoints_to_original(
                        want["keypoints"], scale)
                want = {k: v.astype(np.float16) if v.dtype == np.float32
                        else v for k, v in want.items()}
                grp = fd[name]
                if sorted(grp.keys()) != sorted(out_keys):
                    fail(f"{key} file: {name} holds {grp.keys()}")
                for k in out_keys:
                    got = np.asarray(grp[k])
                    if got.dtype != want[k].dtype or not np.array_equal(
                            got, want[k]):
                        fail(f"{key} file: {name}/{k} differs from the "
                             f"in-memory extract(): {got.dtype} "
                             f"{got.shape} against {want[k].dtype} "
                             f"{want[k].shape}")
                if key == "sp":
                    u = grp["keypoints"].attrs["uncertainty"]
                    if u != np.mean(scale) or np.asarray(u).dtype != \
                            np.float64:
                        fail(f"{name}: uncertainty {u!r} is not "
                             f"{np.mean(scale)!r} as float64")
        res[f"{key}_groups_equal"] = len(names)
        del model
    n_kpts = {n: len(io.get_keypoints(f["feats"], n)) for n in names}
    res["keypoints_per_image"] = n_kpts
    # sparse matches: the file's pairs in their stored order through
    # match_images on the features as the file holds them, padded to the
    # run's one bucket
    model = ui.get_model(conf["lg"], "cuda")
    n_slots = mf.kpt_bucket(max(n_kpts.values()))
    res["slots"] = n_slots
    pairs = [tuple(p.split()) for p in f["pairs"].read_text().split("\n")]
    with h5lite.File(f["feats"]) as ff, h5lite.File(f["matches"]) as fm:
        feats = {}
        for name in names:
            pad, _ = mf._read_features(ff, name, n_slots)
            feats[name] = {k: v[None] for k, v in pad.items()}
            feats[name].update(original_size=np.ones(2), size=np.ones(2))
        for n0, n1 in pairs:
            pair, rev = io.find_pair(fm, n0, n1)
            a, b = (n1, n0) if rev else (n0, n1)
            m0 = np.asarray(fm[pair]["matches0"])
            s0 = np.asarray(fm[pair]["matching_scores0"])
            idx = np.flatnonzero(m0 != -1)
            ka, kb = (feats[n]["keypoints"][0] for n in (a, b))
            got = _rows(ka[idx], kb[m0[idx]], s0[idx])
            pred = mf.match_images(model, feats[a], feats[b])
            want = _rows(pred["mkeypoints0"], pred["mkeypoints1"],
                         pred["mconf"].astype(np.float16))
            if got.shape != want.shape or not np.array_equal(got, want):
                fail(f"sparse match file: {pair} ({len(got)} matches) "
                     f"differs from match_images ({len(want)})")
    res["sparse_pairs_equal"] = len(pairs)
    del model
    # dense: every stored match within B_DENSE_PX of a rounded in-memory
    # correspondence with its score, one per image-0 cell
    model = ui.get_model(conf["lo"], "cuda")
    pre = {**B_DENSE_PRE, **conf["lo"]["preprocessing"]}
    dense = {}
    for n0, n1, _ in planted:
        ret = md.match_images(model, read_image(imgs / n0, True),
                              read_image(imgs / n1, True), pre)
        k0, k1 = (np.round(ret[k]) for k in ("mkeypoints0_orig",
                                             "mkeypoints1_orig"))
        m, s = io.get_matches(f["dense_matches"], n0, n1)
        d0 = io.get_keypoints(f["dense_feats"], n0)
        d1 = io.get_keypoints(f["dense_feats"], n1)
        want = np.concatenate([k0, k1], 1)
        got = np.concatenate([d0[m[:, 0]], d1[m[:, 1]]], 1)
        dist, j = cKDTree(want).query(got, p=np.inf)
        ok = (dist <= B_DENSE_PX) & (np.abs(
            s.astype(np.float64) - ret["mconf"][j]) <= B_DENSE_SCORE)
        cells = len(np.unique(k0, axis=0))
        dense[n0] = {"matches": len(m), "cells": cells,
                     "share": float(ok.mean()) if len(ok) else 0.0}
        if dense[n0]["share"] < B_DENSE_SHARE or abs(len(m) - cells) > \
                0.01 * cells:
            fail(f"dense match file: {n0}-{n1}: {dense[n0]} against the "
                 "in-memory match_images")
    res["dense_vs_memory"] = dense
    del model
    # the planted gate on both match files, after the API's RANSAC
    gates = {}
    for tag, feats_path, matches_path in (
            ("sparse", f["feats"], f["matches"]),
            ("dense", f["dense_feats"], f["dense_matches"])):
        for n0, n1, hm in planted:
            m, _ = io.get_matches(matches_path, n0, n1)
            k0 = io.get_keypoints(feats_path, n0)[m[:, 0]].astype(np.float64)
            k1 = io.get_keypoints(feats_path, n1)[m[:, 1]].astype(np.float64)
            _, inl = ui.proc_ransac_matches(
                k0, k1, ransac_reproj_threshold=ui.DEFAULT_RANSAC_REPROJ_THRESHOLD,
                ransac_max_iter=ui.DEFAULT_RANSAC_MAX_ITER, device="cuda")
            err = transfer_errors(hm, k0[inl], k1[inl])
            med = float(np.median(err)) if len(err) else float("inf")
            gates[f"{tag} {n0}"] = {"matches": len(m), "inliers": len(err),
                                    "median_px": med}
            log(f"  {tag} file {n0}-{n1}: {len(m)} matches, {len(err)} "
                f"inliers, median transfer error {med:.3f} px")
            if len(err) < GATE_MIN_INLIERS or med > GATE_MEDIAN_PX:
                fail(f"{tag} file {n0}-{n1}: gate is >= {GATE_MIN_INLIERS} "
                     f"inliers with median error <= {GATE_MEDIAN_PX} px")
    res["gates"] = gates
    # the retrieval pairs against the CPU's top-k on the same file
    got = [tuple(p.split()) for p in
           f["retrieval"].read_text().split("\n")]
    want = pr.main(f["global"], f["retrieval"].with_suffix(".cpu"),
                   B_RETRIEVAL_K, device="cpu")
    if got != want or len(got) != B_RETRIEVAL_K * len(names):
        fail(f"retrieval pairs {got} differ from the CPU's {want}")
    res["retrieval_pairs"] = got
    return res


def phase15(smi_line):
    """The batch pipelines (extract_features, pairs_from_exhaustive,
    match_features, pairs_from_retrieval, match_dense main()s) on six
    1024x768 PNG views of B_SEEDS' planted pairs in a temporary
    directory, through the port's own HDF5 files: counts at 0, one run
    with every kernel launch recorded (the main path: its counts), each
    launch held against its plain version; the files against the same
    models in memory, the planted gate on both match files, the retrieval
    pairs against the CPU; then a second run (overwrite) timed stage by
    stage with its counts, and a profiler window over the extraction,
    the matching and the dense stage. Returns (launches of the main path,
    measurements)."""
    import tempfile
    from pathlib import Path

    import scipy
    import torch

    from imcui_tpu_torch.pipeline import extract_features as ef
    from imcui_tpu_torch.pipeline import match_dense as md
    from imcui_tpu_torch.pipeline import match_features as mf
    from imcui_tpu_torch.utils.png import encode_png

    t_phase = time.perf_counter()
    log(f"  scipy {scipy.__version__} (match_dense.assign_keypoints' KDTree)")
    conf = {"sp": ef.confs["superpoint_aachen"], "nv": ef.confs["netvlad"],
            "lg": mf.confs["superpoint-lightglue"], "lo": md.confs["loftr"]}
    res = {"scipy": scipy.__version__, "card": smi_line}
    with tempfile.TemporaryDirectory(prefix="imcui-batch-") as tmp:
        tmp = Path(tmp)
        imgs = tmp / "images"
        imgs.mkdir()
        planted = []
        for seed in B_SEEDS:
            a, b, hm = synthetic_pair(seed, *B_SIZE)
            names = (f"s{seed}_0.png", f"s{seed}_1.png")
            (imgs / names[0]).write_bytes(encode_png(a))
            (imgs / names[1]).write_bytes(encode_png(b))
            planted.append((*names, hm))
        names = sorted(n for p in planted for n in p[:2])
        f = {k: tmp / v for k, v in (
            ("feats", "feats.h5"), ("pairs", "pairs.txt"),
            ("matches", "matches.h5"), ("global", "global.h5"),
            ("retrieval", "retrieval.txt"), ("planted", "planted.txt"),
            ("dense_feats", "dense_feats.h5"),
            ("dense_matches", "dense_matches.h5"))}
        f["planted"].write_text("\n".join(f"{a} {b}" for a, b, _ in planted))
        # the main path: counts at 0 (the recorders'), every launch copied
        launches, walls = {}, {}
        seen = _capture_kernel_args(
            lambda: walls.update(_run_stages(
                _batch_stages(conf, f, imgs, False))[1]),
            B_KERNELS, launches)
        launches = {n: c for n, c in launches.items() if c}
        log(f"  batch run: {launches} launches; stage seconds "
            f"{ {k: round(v, 2) for k, v in walls.items()} }")
        checks = _check_served_kernels({n: c for n, c in seen.items() if c},
                                       "batch launch")
        del seen
        torch.cuda.empty_cache()
        for need in ("stem_tail", "stage_tail", "nms_cellmax",
                     "bidirectional_attention"):
            if not launches.get(need):
                fail(f"the batch run launched no {need}")
        if not (launches.get("fused_attention")
                or launches.get("flash_attention")):
            fail("the batch run launched neither K3 nor K5")
        res.update(launches=launches, first_run_s=walls,
                   kernel_checks=checks)
        res.update(_batch_file_checks(conf, f, imgs, names, planted))
        # the timed run: the same work again (overwrite), counts at 0
        fns = _wrappers()
        for fn in fns.values():
            fn.launches = 0
        stages = _batch_stages(conf, f, imgs, True)
        _, walls = _run_stages(stages)
        again = {n: fn.launches for n, fn in fns.items() if fn.launches}
        log(f"  timed run: {again} launches")
        if set(again) != set(launches):
            fail(f"the timed run launched {sorted(again)}, the first "
                 f"{sorted(launches)}")
        n_pairs = len(f["pairs"].read_text().split("\n"))
        per = {"extract": len(names), "match": n_pairs,
               "global": len(names), "dense": len(planted)}
        busy = {k: device_window(lambda i, k=k: stages[k](), 1)[0]
                for k in ("extract", "match", "dense")}
        timing = {}
        for k, s in walls.items():
            timing[k] = {"s": s}
            line = f"  {k}: {s:.3f} s"
            if k in per:
                ms = s * 1e3 / per[k]
                unit = "image" if k in ("extract", "global") else "pair"
                timing[k].update(ms_per_item=ms, items=per[k])
                line += f", {ms:.2f} ms per {unit}"
            if k in busy:
                timing[k].update(device_busy_ms_per_item=busy[k] / per[k],
                                 device_idle_share=1 - busy[k] / (s * 1e3))
                line += (f", device busy {busy[k] / per[k]:.2f} ms per "
                         f"{unit}, idle share {1 - busy[k] / (s * 1e3):.3f}")
            log(line)
        res.update(timing=timing, timed_launches=again)
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"  {smi_line}")
    log(f"  phase 15: {res['phase_s']:.1f} s")
    return launches, res


def _sfm_database_checks(res, names):
    """The engine's database against its feature, match and pairs files:
    one SIMPLE_RADIAL camera [1.2·max(w, h), w/2, h/2, 0] of M_SIZE, the
    images by sorted name, each image's keypoints + 0.5 as float32, each
    pair's matches (flipped where the first id is the larger)."""
    from pathlib import Path

    from imcui_tpu_torch.utils.database import image_ids_to_pair_id
    from imcui_tpu_torch.utils.io import get_keypoints, get_matches

    out = Path(res["sfm_dir"]).parent
    feats, matches = (out / "features" / "feats-superpoint.h5",
                      out / "features" / "matches.h5")
    db = res["database"]
    w, h = M_SIZE
    cams = sqlite_rows(db, "cameras")
    want = np.array([1.2 * max(w, h), w / 2, h / 2, 0.0]).tobytes()
    if [c[:4] for c in cams] != [(1, 2, w, h)] or cams[0][4] != want:
        fail(f"sfm database cameras {[c[:4] for c in cams]}")
    images = sqlite_rows(db, "images")
    ids = {n: i for i, n, *_ in images}
    if [(i, n, c) for i, n, c, *_ in images] != [
            (k + 1, n, 1) for k, n in enumerate(names)]:
        fail(f"sfm database images {images}")
    kp = {i: d for i, _, _, d in sqlite_rows(db, "keypoints")}
    n_kpts = {}
    for n in names:
        k = get_keypoints(feats, n)
        n_kpts[n] = len(k)
        if kp[ids[n]] != np.asarray(k + 0.5, np.float32).tobytes():
            fail(f"sfm database keypoints of {n} differ from the file's")
    rows = {r[0]: r[3] for r in sqlite_rows(db, "matches")}
    pairs = [tuple(p.split()) for p in (out / "pairs-sfm.txt").read_text()
             .split("\n")]
    for n0, n1 in pairs:
        m, _ = get_matches(matches, n0, n1)
        if ids[n0] > ids[n1]:
            m = m[:, ::-1]
        if rows[image_ids_to_pair_id(ids[n0], ids[n1])] != np.asarray(
                m, np.uint32).tobytes():
            fail(f"sfm database matches of {n0} {n1} differ from the file's")
    return {"keypoints": n_kpts, "pairs": len(pairs)}


def _verified_sets(db):
    """{pair_id: verified matches as bytes} of a database."""
    return {r[0]: r[3] for r in sqlite_rows(db, "two_view_geometries")}


def _planted_sets(scene):
    """{pair_id: the planted correct matches in stored order, as bytes}."""
    from imcui_tpu_torch.utils.database import image_ids_to_pair_id

    ids = {n: i + 1 for i, n in enumerate(scene["names"])}
    out = {}
    for (n0, n1), m0 in scene["matches"].items():
        idx = np.flatnonzero(m0 != -1)
        keep = np.array([(i, m0[i]) in scene["correct"][(n0, n1)]
                         for i in idx])
        m = np.stack([idx, m0[idx]], 1)[keep]
        if ids[n0] > ids[n1]:
            m = m[:, ::-1]
        out[image_ids_to_pair_id(ids[n0], ids[n1])] = np.asarray(
            m, np.uint32).tobytes()
    return out


def _expect_mapper_error(fn, what):
    """Run ``fn``; it must end in the pycolmap ImportError."""
    try:
        fn()
    except ImportError as e:
        if "pycolmap" not in str(e):
            fail(f"{what}: {e}")
        return str(e)
    fail(f"{what} did not stop at the missing pycolmap")


def _sfm_scene_checks(tmp):
    """(c) and (d): reconstruction.main and triangulation.main on the
    planted non-planar scene, card against CPU and against the planted
    sets; localize_sfm.main and localize_inloc's pose_from_scan_cluster
    on the card against the CPU and the planted pose."""
    from imcui_tpu_torch.pipeline import localize_inloc as li
    from imcui_tpu_torch.pipeline import localize_sfm as ls
    from imcui_tpu_torch.pipeline import reconstruction as rec
    from imcui_tpu_torch.pipeline import triangulation as tri
    from imcui_tpu_torch.utils.geometry import qvec2rotmat

    seed, n_img, n_pts, wrong = M_SCENE
    scene = sfm_scene(seed, n_img, n_pts, wrong, n_query=M_QUERY)
    f = write_sfm_scene(tmp / "scene", scene)
    res = {}
    args = (f["images"], f["pairs"], f["feats"], f["matches"])
    dbs = {}
    for tag, d in (("card", "cuda"), ("cpu", "cpu")):
        out = tmp / f"rec_{tag}"
        _expect_mapper_error(lambda: rec.main(out, *args, device=d),
                             f"reconstruction.main on {d}")
        dbs[tag] = out / "database.db"
    for t in ("cameras", "images", "keypoints", "matches"):
        if sqlite_rows(dbs["card"], t) != sqlite_rows(dbs["cpu"], t):
            fail(f"reconstruction: the card's {t} table differs from the "
                 "CPU's")
    planted = _planted_sets(scene)
    card, host = _verified_sets(dbs["card"]), _verified_sets(dbs["cpu"])
    same = sum(card[k] == host[k] for k in planted)
    exact = sum(card[k] == planted[k] for k in planted)
    log(f"  reconstruction (planted scene, {n_img} views, {n_pts} points, "
        f"{wrong:.0%} wrong): verified sets equal to the CPU's on "
        f"{same}/{len(planted)} pairs, to the planted on {exact}")
    if same != len(planted) or exact != len(planted) or set(card) != set(
            planted):
        fail("reconstruction: the card's verified sets differ from the "
             "CPU's or the planted ones")
    res["reconstruction"] = {"pairs": len(planted), "equal_cpu": same,
                             "equal_planted": exact}
    out = tmp / "tri"
    msg = _expect_mapper_error(
        lambda: tri.main(out, f["model"], *args), "triangulation.main")
    tv = _verified_sets(out / "database.db")
    if tv != planted:
        fail("triangulation: the verified sets differ from the planted")
    log(f"  triangulation: {len(tv)} verified sets equal the planted "
        f"(host code); {msg[:60]}...")
    res["triangulation_pairs"] = len(tv)

    q = scene["query"]
    model = ls.read_model(f["model"])
    qcam = ls.Camera(-1, "PINHOLE", *scene["size"],
                     np.array([800.0, 800.0, *scene["K"][:2, 2]]))
    loc = {}
    for tag, d in (("card", "cuda"), ("cpu", "cpu")):
        poses, _ = ls.main(f["model"], f["queries"], f["retrieval"],
                           f["feats"], f["matches"], tmp / f"loc_{tag}.txt",
                           ransac_thresh=6.0, device=d)
        ret, log_ = ls.pose_from_cluster(
            q["name"], qcam, [1, 2, 3], model[1], model[2], f["feats"],
            f["matches"], thresh_px=6.0, device=d)
        inl = {int(k) for k, ok in zip(log_["keypoint_index_to_db"][0],
                                       ret["inliers"]) if ok}
        qv, tv_ = poses[q["name"]]
        R = qvec2rotmat(qv)
        deg = float(np.degrees(np.arccos(np.clip(
            (np.trace(R.T @ q["R"]) - 1) / 2, -1, 1))))
        loc[tag] = {"deg": deg, "t_err": float(np.linalg.norm(tv_ - q["t"])),
                    "inliers": inl}
    card, host = loc["card"], loc["cpu"]
    log(f"  localize_sfm: {M_QUERY} query keypoints, {len(q['inliers'])} "
        f"planted inliers; card {len(card['inliers'])} inliers, "
        f"{card['deg']:.4f} deg, t {card['t_err']:.4f}; CPU "
        f"{len(host['inliers'])}, {host['deg']:.4f} deg, "
        f"t {host['t_err']:.4f}")
    for tag in loc:
        if loc[tag]["deg"] > M_POSE_DEG or loc[tag]["t_err"] > M_POSE_T:
            fail(f"localize_sfm on the {tag}: pose off by {loc[tag]}")
    if loc["card"]["inliers"] != loc["cpu"]["inliers"] or \
            loc["card"]["inliers"] != q["inliers"]:
        fail("localize_sfm: the card's inliers differ from the CPU's or the "
             "planted")
    res["localize_sfm"] = {t: {k: v if k != "inliers" else len(v)
                               for k, v in loc[t].items()} for t in loc}

    qn, scans, Rq, tq, inliers = inloc_scene(tmp / "inloc")
    inloc = {}
    for tag, d in (("card", "cuda"), ("cpu", "cpu")):
        got = li.pose_from_scan_cluster(
            tmp / "inloc", qn, scans, tmp / "inloc" / "feats.h5",
            tmp / "inloc" / "matches.h5", device=d)[3]
        R = qvec2rotmat(got["qvec"])
        inloc[tag] = {"num_inliers": got["num_inliers"],
                      "deg": float(np.degrees(np.arccos(np.clip(
                          (np.trace(R.T @ Rq) - 1) / 2, -1, 1)))),
                      "t_err": float(np.linalg.norm(got["tvec"] - tq))}
    log(f"  localize_inloc (planted scans): card {inloc['card']}, CPU "
        f"{inloc['cpu']}, planted inliers {len(inliers)}")
    for tag in inloc:
        if inloc[tag]["num_inliers"] != len(inliers) or \
                inloc[tag]["deg"] > M_POSE_DEG or \
                inloc[tag]["t_err"] > M_POSE_T:
            fail(f"localize_inloc on the {tag}: {inloc[tag]}")
    res["localize_inloc"] = inloc
    return res, scene, f


def _sfm_stage_timer(profiled):
    """A StageTimer over SfmEngine's stages and localisation's PnP (the
    labels of the per-item times), or, with ``profiled``, wrappers that
    run each stage under the profiler and add its device-busy ms."""
    from imcui_tpu_torch.pipeline import extract_features as ef
    from imcui_tpu_torch.pipeline import localize_sfm as ls
    from imcui_tpu_torch.pipeline import match_features as mf
    from imcui_tpu_torch.pipeline import reconstruction as rec

    stages = ((ef, "main", "extract"), (mf, "main", "match"),
              (rec, "geometric_verification", "verify"),
              (ls, "pose_from_cluster", "localize"))
    timer = StageTimer()
    if not profiled:
        for mod, name, label in stages:
            timer.wrap(mod, name, label)
        return timer

    def busy(label):
        def wrapper(fn):
            def run(*a, **kw):
                box = {}

                def once(_):
                    box["out"] = fn(*a, **kw)
                ms, _ = device_window(once, 1)
                timer.host[label] = timer.host.get(label, 0.0) + ms
                return box["out"]
            return run
        return wrapper

    for mod, name, label in stages:
        timer._replace(mod, name, busy(label))
    return timer


def phase16(smi_line):
    """SfM and localisation on the batch files, served through SfmEngine:
    (a) SfmEngine(device="cuda").call on M_VIEWS planted 1600x1200 PNG
    views at the engine's defaults, counts at 0 and every launch recorded
    (the main path: its counts), each launch held against its plain
    version, the database against the engine's files, the planted gate on
    every pair's verified matches; (b) the retrieval branch (netvlad,
    top_k M_RETRIEVAL_K), its pairs file against the CPU's top-k; (c) and
    (d) the planted non-planar scene (_sfm_scene_checks); (e) second runs
    of (a) and of the localisation, stage by stage: CUDA-event ms per
    item, then device-busy ms per item under the profiler, and the idle
    share. Returns (launches of the main path, measurements)."""
    import tempfile
    from pathlib import Path

    import torch

    from imcui_tpu_torch.pipeline import extract_features as ef
    from imcui_tpu_torch.pipeline import localize_sfm as ls
    from imcui_tpu_torch.pipeline import pairs_from_retrieval as pr
    from imcui_tpu_torch.ui.sfm import SfmEngine
    from imcui_tpu_torch.utils.png import encode_png

    t_phase = time.perf_counter()
    res = {"card": smi_line}
    with tempfile.TemporaryDirectory(prefix="imcui-sfm-") as tmp:
        tmp = Path(tmp)
        views, hms = homography_views(M_SEED, M_VIEWS, *M_SIZE)
        files = []
        for i, v in enumerate(views):
            files.append(tmp / f"view{i}.png")
            files[-1].write_bytes(encode_png(v))
        names = [p.name for p in files]
        del views

        def engine_run(tag, **kw):
            (tmp / tag).mkdir()
            return SfmEngine({"outputs": tmp / tag}, device="cuda").call(
                "sfm", files, **kw)

        # (a) the main path: counts at 0 (the recorders'), every launch
        launches, box = {}, {}
        t0 = time.perf_counter()
        seen = _capture_kernel_args(
            lambda: box.update(engine_run("a")), SERVED_KERNELS, launches)
        wall = time.perf_counter() - t0
        log(f"  SfmEngine.call: {launches} launches, {wall:.2f} s; "
            f"status {box['status']!r}")
        if box.get("status") != "database-only (mapper backend unavailable)":
            fail(f"SfmEngine.call returned {box}")
        for name in SERVED_KERNELS:
            if launches.get(name) != M_VIEWS:
                fail(f"the sfm run launched {name} {launches.get(name)} "
                     f"times, not once a view ({M_VIEWS})")
        res["kernel_checks"] = _check_served_kernels(seen, "sfm launch")
        del seen
        torch.cuda.empty_cache()
        res.update(launches=launches, first_run_s=wall,
                   database=_sfm_database_checks(box, names))
        gate = sfm_engine_gate(box["database"], names, hms, M_PX)
        for (a, b), (n, share) in gate.items():
            log(f"  {a}-{b}: {n} verified, {share:.3f} within {M_PX} px of "
                "the planted homography")
        worst = (min(n for n, _ in gate.values()),
                 min(s for _, s in gate.values()))
        if len(gate) != M_VIEWS * (M_VIEWS - 1) // 2 or \
                worst[0] < M_LEAST or worst[1] < M_SHARE:
            fail(f"sfm gate: least {worst[0]} verified (>= {M_LEAST}), "
                 f"least share {worst[1]:.3f} (>= {M_SHARE})")
        res["gate"] = {f"{a}-{b}": v for (a, b), v in gate.items()}

        # (b) the retrieval branch
        ret = engine_run("b", scene_graph="retrieval",
                         global_feature="netvlad", top_k=M_RETRIEVAL_K)
        got = [tuple(p.split()) for p in (tmp / "b" / "pairs-sfm.txt")
               .read_text().split("\n")]
        glob = tmp / "b" / "features" / (ef.confs["netvlad"]["output"]
                                         + ".h5")
        want = pr.main(glob, tmp / "b" / "cpu.txt", M_RETRIEVAL_K,
                       device="cpu")
        n_want = min(M_RETRIEVAL_K, M_VIEWS - 1) * M_VIEWS
        if got != want or len(got) != n_want or \
                ret.get("status") != box["status"]:
            fail(f"retrieval branch: pairs {got} against the CPU's {want}, "
                 f"status {ret.get('status')!r}")
        log(f"  retrieval branch: {len(got)} pairs, equal to the CPU's")
        res["retrieval_pairs"] = len(got)

        # (c), (d)
        scene_res, scene, f = _sfm_scene_checks(tmp)
        res.update(scene_res)

        # (e) timed runs: events, then device busy under the profiler
        per = {"extract": M_VIEWS, "match": len(gate), "verify": len(gate),
               "localize": 1}

        def timed_run(tag):
            walls = {}
            t0 = time.perf_counter()
            engine_run(tag)
            torch.cuda.synchronize()
            walls["engine"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            ls.main(f["model"], f["queries"], f["retrieval"], f["feats"],
                    f["matches"], tmp / f"{tag}.txt", ransac_thresh=6.0,
                    device="cuda")
            torch.cuda.synchronize()
            walls["localize_main"] = time.perf_counter() - t0
            return walls

        timer = _sfm_stage_timer(False)
        try:
            walls = timed_run("e1")
            torch.cuda.synchronize()
            ms = timer.ms()
        finally:
            timer.undo()
        timer = _sfm_stage_timer(True)
        try:
            timed_run("e2")
            busy = dict(timer.host)
        finally:
            timer.undo()
        timing = {"walls_s": walls}
        for k, n in per.items():
            timing[k] = {"items": n, "ms_per_item": ms[k] / n,
                         "device_busy_ms_per_item": busy[k] / n,
                         "device_idle_share": 1 - busy[k] / ms[k]}
            log(f"  {k}: {ms[k] / n:.2f} ms per item (CUDA events), device "
                f"busy {busy[k] / n:.2f} ms, idle share "
                f"{1 - busy[k] / ms[k]:.3f}")
        res["timing"] = timing
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"  {smi_line}")
    log(f"  phase 16: {res['phase_s']:.1f} s")
    return launches, res


def _jpeg_exactness(tmp, files):
    """(a) of phase 17: each JPEG of ``files`` ({tag: bytes}) read by the
    port against PIL's decode, bit for bit: read_image (EXIF orientation
    applied) against ImageOps.exif_transpose, the HTTP route against
    convert("RGB"), gray against the Y plane of draft("YCbCr")."""
    import io

    import PIL.Image
    import PIL.ImageOps

    from imcui_tpu_torch.utils.image import decode_image_bytes, read_image

    out = {}
    for tag, data in files.items():
        path = tmp / f"{tag.replace(' ', '_')}.jpg"
        path.write_bytes(data)

        def pil(draft=False, turn=False):
            im = PIL.Image.open(io.BytesIO(data))
            if draft:
                im.draft("YCbCr", im.size)
            if turn:
                im = PIL.ImageOps.exif_transpose(im)
            return np.asarray(im)[..., 0] if draft else np.asarray(
                im.convert("RGB"))

        checks = {
            "read_image": (read_image(path), pil(turn=True)),
            "read_image gray": (read_image(path, True),
                                pil(draft=True, turn=True)),
            "HTTP route": (decode_image_bytes(data, orientation=False),
                           pil()),
            "HTTP route gray": (decode_image_bytes(data, True,
                                                   orientation=False),
                                pil(draft=True))}
        bad = {k: int((a != b).sum()) if a.shape == b.shape else
               f"shape {a.shape} against {b.shape}"
               for k, (a, b) in checks.items()}
        shape = checks["read_image"][0].shape
        log(f"  (a) {tag}: {len(data)} bytes, read as {shape}; pixels "
            f"differing from PIL's: {bad}")
        if any(bad.values()):
            fail(f"JPEG {tag}: the port's decode differs from PIL's: {bad}")
        out[tag] = {"bytes": len(data), "shape": list(shape)}
    return out


def _jpeg_times(data, smi_line):
    """(b) of phase 17: median of J_REPS decodes of ``data`` to RGB by the
    port and by PIL on this host, in turns, after one of each."""
    import io

    import PIL.Image

    from imcui_tpu_torch.utils.jpeg import decode_jpeg

    def pil():
        return np.asarray(PIL.Image.open(io.BytesIO(data)).convert("RGB"))

    fns = {"port": lambda: decode_jpeg(data), "PIL": pil}
    ts = {tag: [] for tag in fns}
    for rep in range(J_REPS + 1):
        for tag in (("port", "PIL") if rep % 2 else ("PIL", "port")):
            t0 = time.perf_counter()
            fns[tag]()
            ts[tag].append((time.perf_counter() - t0) * 1e3)
    times = {tag: float(np.median(t[1:])) for tag, t in ts.items()}
    ratio = times["port"] / times["PIL"]
    cpu = f"{platform.machine()}, {os.cpu_count()} cores"
    log(f"  (b) decode of the {J_SIZE[0]}x{J_SIZE[1]} 4:2:0 q{J_QUALITY} "
        f"file ({len(data)} bytes) on the host ({cpu}), median of "
        f"{J_REPS}: port {times['port']:.2f} ms, PIL "
        f"{times['PIL']:.2f} ms, ratio {ratio:.3f} (bound {J_TIME_RATIO}); "
        f"card {smi_line}")
    if ratio > J_TIME_RATIO:
        fail(f"the port's JPEG decode takes {ratio:.2f}x PIL's time")
    return {"port_ms": times["port"], "pil_ms": times["PIL"],
            "ratio": ratio, "bytes": len(data), "reps": J_REPS, "cpu": cpu}


def phase17(smi_line, served):
    """JPEG on the card: (a) _jpeg_exactness on PIL's q95 files of a colour
    J_SIZE textured view (4:2:0, 4:4:4, progressive, orientation 6); (b)
    _jpeg_times on the 4:2:0 file; (c) SfmEngine(device="cuda").call on
    M_VIEWS JPEG views of phase 16's planted scene, counts at 0 and every
    launch recorded (the main path: its counts), each launch held against
    its plain version, the database against the engine's files, the
    planted gate, then the same run on PNG copies of PIL's gray decode of
    those files (what the engine's gray SuperPoint reads): keypoints and
    matches equal; (d) phase 8's JPEG bodies
    (``served``), reported. Returns (launches of the main path,
    measurements)."""
    import io
    import tempfile
    from pathlib import Path

    import PIL.Image
    import torch

    from imcui_tpu_torch.ui.sfm import SfmEngine
    from imcui_tpu_torch.utils.io import get_keypoints, get_matches
    from imcui_tpu_torch.utils.png import encode_png

    t_phase = time.perf_counter()
    res = {"card": smi_line}
    rng = np.random.default_rng(J_SEED)
    w, h = J_SIZE
    colour = np.stack([textured_image(rng, h, w) for _ in range(3)], -1)
    exif = PIL.Image.Exif()
    exif[0x0112] = 6
    files = {"4:2:0": pil_jpeg(colour, subsampling=2),
             "4:4:4": pil_jpeg(colour, subsampling=0),
             "progressive": pil_jpeg(colour, subsampling=2, progressive=True),
             "orientation 6": pil_jpeg(colour, subsampling=2,
                                       exif=exif.tobytes())}
    with tempfile.TemporaryDirectory(prefix="imcui-jpeg-") as tmp:
        tmp = Path(tmp)
        res["exact"] = _jpeg_exactness(tmp, files)
        res["decode"] = _jpeg_times(files["4:2:0"], smi_line)
        del colour, files

        # (c) the batch path on JPEG files
        views, hms = homography_views(M_SEED, M_VIEWS, *M_SIZE)
        jfiles, pfiles = [], []
        for i, v in enumerate(views):
            data = pil_jpeg(v)
            jfiles.append(tmp / f"view{i}.jpg")
            jfiles[-1].write_bytes(data)
            im = PIL.Image.open(io.BytesIO(data))
            im.draft("L", im.size)
            pfiles.append(tmp / f"view{i}.png")
            pfiles[-1].write_bytes(encode_png(np.asarray(im)))
        del views
        jnames = [p.name for p in jfiles]

        def engine_run(tag, images):
            (tmp / tag).mkdir()
            return SfmEngine({"outputs": tmp / tag}, device="cuda").call(
                "sfm", images)

        launches, box = {}, {}
        t0 = time.perf_counter()
        seen = _capture_kernel_args(
            lambda: box.update(engine_run("jpg", jfiles)), SERVED_KERNELS,
            launches)
        wall = time.perf_counter() - t0
        log(f"  (c) SfmEngine.call on {M_VIEWS} JPEG views: {launches} "
            f"launches, {wall:.2f} s; status {box.get('status')!r}")
        for name in SERVED_KERNELS:
            if launches.get(name) != M_VIEWS:
                fail(f"the JPEG sfm run launched {name} "
                     f"{launches.get(name)} times, not once a view")
        res["kernel_checks"] = _check_served_kernels(seen, "JPEG sfm launch")
        del seen
        torch.cuda.empty_cache()
        res.update(launches=launches, sfm_s=wall,
                   database=_sfm_database_checks(box, jnames))
        gate = sfm_engine_gate(box["database"], jnames, hms, M_PX)
        worst = (min(n for n, _ in gate.values()),
                 min(s for _, s in gate.values()))
        log(f"  (c) planted gate: {len(gate)} pairs, least {worst[0]} "
            f"verified, least share {worst[1]:.3f} within {M_PX} px")
        if len(gate) != M_VIEWS * (M_VIEWS - 1) // 2 or \
                worst[0] < M_LEAST or worst[1] < M_SHARE:
            fail(f"JPEG sfm gate: least {worst[0]} verified (>= {M_LEAST}), "
                 f"least share {worst[1]:.3f} (>= {M_SHARE})")
        res["gate"] = {f"{a}-{b}": v for (a, b), v in gate.items()}

        png = engine_run("png", pfiles)
        same = {"keypoints": 0, "matches": 0}
        for tag in ("jpg", "png"):
            if not (tmp / tag / "features" / "feats-superpoint.h5").exists():
                fail(f"the {tag} run wrote no feature file")
        for i in range(M_VIEWS):
            k = [get_keypoints(tmp / t / "features" / "feats-superpoint.h5",
                               f"view{i}.{t}") for t in ("jpg", "png")]
            same["keypoints"] += int(np.array_equal(*k))
        pairs = [tuple(p.split()) for p in (tmp / "jpg" / "pairs-sfm.txt")
                 .read_text().split("\n")]
        for n0, n1 in pairs:
            m = [get_matches(tmp / t / "features" / "matches.h5",
                             n0.replace(".jpg", "." + t),
                             n1.replace(".jpg", "." + t))[0]
                 for t in ("jpg", "png")]
            # as sets: the two runs' pair files may list a pair either way
            same["matches"] += int(len(m[0]) == len(m[1]) and set(
                map(tuple, m[0])) == set(map(tuple, m[1])))
        log(f"  (c) against the PNG copies: keypoints equal on "
            f"{same['keypoints']}/{M_VIEWS} views, matches on "
            f"{same['matches']}/{len(pairs)} pairs")
        if same != {"keypoints": M_VIEWS, "matches": len(pairs)} or \
                png.get("status") != box["status"]:
            fail("the JPEG run's features or matches differ from the PNG "
                 "copies'")
        res["equal_to_png"] = same
    log(f"  (d) HTTP (phase 8): JPEG body {served.get('raw_matches')} raw "
        f"matches, equal to the PNG body's {served.get('equal_to_png')}; "
        f"truncated body: {served.get('truncated_detail')!r}")
    res["http"] = served
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"  {smi_line}")
    log(f"  phase 17: {res['phase_s']:.1f} s")
    return launches, res


def oriented_pairs(pa, aa, pb, ab, tol):
    """Keypoints of a and b paired by point (within ``tol`` px, max norm)
    and then by the nearest angle (one point can hold several
    orientations; degrees): (IoU, indices into a, indices into b)."""
    from scipy.spatial import cKDTree

    near = cKDTree(pb).query_ball_point(pa, tol, p=np.inf)
    cand = sorted((abs((aa[i] - ab[j] + 180) % 360 - 180), i, j)
                  for i, js in enumerate(near) for j in js)
    used_a, used_b, ia, ib = set(), set(), [], []
    for _, i, j in cand:
        if i not in used_a and j not in used_b:
            used_a.add(i)
            used_b.add(j)
            ia.append(i)
            ib.append(j)
    n = len(ia)
    return (n / max(len(pa) + len(pb) - n, 1), np.array(ia, int),
            np.array(ib, int))


def _sift_stages(x):
    """ops/sift.py's stages on the float32 uint8-valued (H, W) tensor
    ``x``, each one's output kept: the pyramids, the candidates, the
    refined keypoints, the oriented keypoints and their descriptors."""
    from imcui_tpu_torch.ops import sift as ops

    gauss, dogs = ops.build_pyramids(x)
    cand = ops.find_candidates(dogs, T_CONTRAST)
    dog, gst = ops.Flat(dogs), ops.Flat(gauss)
    refined = ops.refine(dog, cand, T_CONTRAST, 10.0)
    kp = ops.orientations(gst, refined)
    return {"gauss": gauss, "dogs": dogs, "cand": cand, "refined": refined,
            "kp": kp, "desc": ops.describe(gst, kp)}


def _sift_stage_times(x, reps=3):
    """Median CUDA-event ms of each SIFT stage on ``x`` (the stages run
    in turn; the host waits at each stage's end), and the host
    synchronisations of one full detection and description, counted by
    torch's sync debug mode."""
    import warnings

    import torch

    from imcui_tpu_torch.ops import sift as ops

    def staged():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        gauss, dogs = ops.build_pyramids(x)
        ev[1].record()
        cand = ops.find_candidates(dogs, T_CONTRAST)
        ev[2].record()
        dog, gst = ops.Flat(dogs), ops.Flat(gauss)
        kp = ops.refine(dog, cand, T_CONTRAST, 10.0)
        ev[3].record()
        kp = ops.orientations(gst, kp)
        ev[4].record()
        kp = ops.take(ops.retain_best(kp, 1024), 1024)
        ops.describe(gst, kp)
        ev[5].record()
        torch.cuda.synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(5)]

    staged()
    runs = [staged() for _ in range(reps)]
    names = ("pyramids", "candidates", "refine", "orientations",
             "cut and describe 1024")
    times = {n: float(np.median([r[i] for r in runs]))
             for i, n in enumerate(names)}
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            kp, gst = ops.detect(x, T_CONTRAST, n_features=1024)
            ops.describe(gst, ops.take(kp, 1024))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message).split("\n")[0] for w in seen
             if "called a synchronizing CUDA operation" in str(w.message)]
    return times, syncs


def phase11():
    """SIFT's stages (ops/sift.py) on the card against the port's CPU run
    on one textured T_SIZE image: the Gaussian and DoG pyramids per
    octave, the candidate counts per octave, the refined keypoints, the
    angles and integer descriptors of the common keypoints, each beside
    its bound; then each stage's time on the card at T_FULL and the host
    synchronisations of a view."""
    import torch

    t_phase = time.perf_counter()
    img = textured_image(np.random.default_rng(T_SEED), T_SIZE[1],
                         T_SIZE[0]).astype(np.float32)
    runs = {dev: _sift_stages(torch.from_numpy(img).to(dev))
            for dev in ("cuda", "cpu")}
    card, cpu = runs["cuda"], runs["cpu"]
    out = {"octaves": [list(g.shape[1:]) for g in cpu["gauss"]]}
    if not any(h % 2 or w % 2 for h, w in out["octaves"]):
        fail(f"phase 11: no odd-sized octave in {out['octaves']}")
    out["gauss_max_abs"] = [float((a.cpu() - b).abs().max())
                            for a, b in zip(card["gauss"], cpu["gauss"])]
    out["dog_max_abs"] = [float((a.cpu() - b).abs().max())
                          for a, b in zip(card["dogs"], cpu["dogs"])]
    n_oct = len(cpu["gauss"])
    out["candidates"] = {dev: np.bincount(r["cand"][0].cpu().numpy(),
                                          minlength=n_oct).tolist()
                         for dev, r in runs.items()}

    def points(kp):
        return (torch.stack([kp["x"], kp["y"]], -1) * 0.5).cpu().numpy()

    out["refined"] = [len(r["refined"]["x"]) for r in (card, cpu)]
    out["refined_iou"] = common_points(points(card["refined"]),
                                       points(cpu["refined"]), Z_KPT_PX)[0]
    iou, ia, ib = oriented_pairs(
        points(card["kp"]), card["kp"]["angle"].cpu().numpy(),
        points(cpu["kp"]), cpu["kp"]["angle"].cpu().numpy(), Z_KPT_PX)
    out["keypoints"] = [len(r["kp"]["x"]) for r in (card, cpu)]
    out["oriented_iou"] = iou
    da = card["kp"]["angle"].cpu().numpy()[ia] - cpu["kp"]["angle"].numpy()[ib]
    out["angle_max_deg"] = float(np.abs((da + 180) % 360 - 180).max())
    dd = np.abs(card["desc"].cpu().numpy()[ia] - cpu["desc"].numpy()[ib])
    out["desc_same_share"] = float((dd.max(1) == 0).mean())
    out["desc_max_step"] = float(dd.max())
    log(f"  SIFT stages on a textured {T_SIZE[0]} x {T_SIZE[1]} image, the "
        f"card against the CPU: octaves {out['octaves']}; Gaussian pyramid "
        f"max |d| per octave {out['gauss_max_abs']}, DoG "
        f"{out['dog_max_abs']} (bound {T_PYRAMID}); candidates per octave "
        f"{out['candidates']} (bound: equal); refined keypoints "
        f"{out['refined']}, IoU {out['refined_iou']:.4f} within {Z_KPT_PX} "
        f"px (bound {T_KPT_IOU}); oriented keypoints {out['keypoints']}, "
        f"IoU {iou:.4f} (bound {T_KPT_IOU}), angles within "
        f"{out['angle_max_deg']:.3g} deg (bound {T_ANGLE_DEG}), descriptors"
        f" equal on {out['desc_same_share']:.4f} of the common keypoints "
        f"(bound {T_DESC_SAME}), none off by more than "
        f"{out['desc_max_step']:g} (bound {T_DESC_STEP})")
    if max(out["gauss_max_abs"] + out["dog_max_abs"]) > T_PYRAMID \
            or out["candidates"]["cuda"] != out["candidates"]["cpu"] \
            or out["refined_iou"] < T_KPT_IOU or iou < T_KPT_IOU \
            or out["angle_max_deg"] > T_ANGLE_DEG \
            or out["desc_same_share"] < T_DESC_SAME \
            or out["desc_max_step"] > T_DESC_STEP:
        fail(f"phase 11: SIFT's stages on the card and the CPU disagree: "
             f"{out}")
    del runs, card, cpu
    big = textured_image(np.random.default_rng(T_SEED + 1), T_FULL[1],
                         T_FULL[0]).astype(np.float32)
    times, syncs = _sift_stage_times(torch.from_numpy(big).cuda())
    out["stage_ms_full"] = times
    out["host_syncs_per_view"] = len(syncs)
    out["host_sync_sites"] = sorted(set(syncs))
    log(f"  SIFT stages on the card at {T_FULL[0]} x {T_FULL[1]} (median of "
        f"3 after a warm-up, ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in times.items())
        + f"; {len(syncs)} host synchronisations a view (detect and "
        f"describe 1024)")
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 11: {out['phase_s']:.1f} s")
    return out


def _multipart_checks(url, client, pair, split):
    """Pair 1 through the multipart route, its PNGs written with the
    client's Up rows and with rows of all five filters in turn (PIL,
    libpng and browsers choose a filter per row, Paeth and Average among
    them): each gives the JSON route's matches; the median wall time and
    split of 3 rounds of each."""
    from imcui_tpu_torch.utils.png import encode_png

    names, img0, img1, _ = pair
    json_res = client.send_request_match(*names, base_url=url)
    keys = ("image0", "image1")
    bodies = {
        "up": multipart_body(dict(zip(keys, map(_read, names)))),
        "mixed": multipart_body({
            k: encode_png(im, np.arange(im.shape[0]) % 5)
            for k, im in zip(keys, (img0, img1))})}
    runs = {tag: [] for tag in bodies}
    for _ in range(3):
        for tag, (body, ctype) in bodies.items():
            for k in split:
                split[k] = 0.0
            t0 = time.perf_counter()
            code, res, _ = _http(f"{url}/v1/match", body, ctype)
            runs[tag].append(((time.perf_counter() - t0) * 1e3, dict(split)))
            if code != 200 or not all(
                    np.array_equal(np.array(res[k]), json_res[k])
                    for k in ("mkeypoints0_orig", "mkeypoints1_orig")):
                fail(f"the multipart route ({tag} rows, status {code}) and "
                     f"the JSON route disagree")
    out = {}
    for tag, rs in runs.items():
        out[tag] = {
            "ms": float(np.median([r[0] for r in rs])),
            "request_ms": [r[0] for r in rs],
            "split_ms": {k: float(np.median([r[1][k] for r in rs]))
                         for k in ("decode", "api", "json encode")},
            "request_bytes": len(bodies[tag][0])}
        log(f"  multipart on pair 1, {tag} rows: {out[tag]['ms']:.1f} ms "
            f"(median of 3; decode {out[tag]['split_ms']['decode']:.1f}, api "
            f"{out[tag]['split_ms']['api']:.1f}, json encode "
            f"{out[tag]['split_ms']['json encode']:.1f} ms), "
            f"{out[tag]['request_bytes']} bytes; the JSON route's matches")
    return out


def _read(path):
    with open(path, "rb") as f:
        return f.read()


# the first bytes of a JPEG file (SOI, APP0 JFIF): enough to be told apart
_JPEG_B64 = "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAgGBgcGBQgHBwcJCQgKDBQNDAsL"


def _cli_checks(files, tmp):
    """The CLI in subprocesses from the repository root, timed from process
    start: --version, match with the default matcher and with
    superpoint+mnn (the root config/app.yaml's zoo), and serve on a free
    port until it answers one match request."""
    import imcui_tpu_torch
    from imcui_tpu_torch.api import client

    out = {}
    proc, sec = _cli("--version")
    want = f"imcui-tpu-torch, version {imcui_tpu_torch.__version__}"
    if proc.returncode or proc.stdout.strip() != want:
        fail(f"CLI --version: {proc.returncode} {proc.stdout!r}")
    log(f"  CLI --version: {proc.stdout.strip()!r} in {sec:.1f} s")
    out["version_s"] = sec
    (a, b), hm = files[0][0], files[0][3]
    out["match"] = _cli_match("match (superpoint+lightglue)", a, b,
                              os.path.join(tmp, "lg.pkl"))
    jpgs = []
    for name, img in zip((a, b), files[0][1:3]):
        jpgs.append(os.path.splitext(name)[0] + ".jpg")
        with open(jpgs[-1], "wb") as f:
            f.write(pil_jpeg(img))
    out["match_mnn"] = _cli_match("match --matcher superpoint+mnn on .jpg",
                                  *jpgs, os.path.join(tmp, "mnn.pkl"),
                                  "--matcher", "superpoint+mnn")
    if out["match_mnn"]["inliers"] < GATE_MIN_INLIERS:
        fail("CLI match on .jpg files: too few inliers")
    port = free_port()
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "imcui_tpu_torch.cli.main", "serve", "--host",
         "127.0.0.1", "--port", str(port), "--device", "cuda"], cwd=ROOT,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    url = f"http://127.0.0.1:{port}"
    try:
        while True:
            if proc.poll() is not None:
                fail(f"CLI serve exited with {proc.returncode}: "
                     f"{proc.stderr.read()[-2000:]}")
            if time.perf_counter() - t0 > 240:
                fail("CLI serve did not answer GET / within 240 s")
            try:
                up = _http(f"{url}/")[:2] == (200, {"message": "OK"})
            except OSError:
                up = False
            if up:
                break
            time.sleep(0.25)
        ready = time.perf_counter() - t0
        t1 = time.perf_counter()
        res = client.send_request_match(a, b, base_url=url)
        first_ms = (time.perf_counter() - t1) * 1e3
        err = transfer_errors(hm, res["mmkeypoints0_orig"],
                              res["mmkeypoints1_orig"])
        log(f"  CLI serve: answered GET / {ready:.1f} s after the process "
            f"started; its first match request {first_ms:.0f} ms, "
            f"{len(err)} inliers, median {np.median(err):.3f} px")
        if len(err) < GATE_MIN_INLIERS or np.median(err) > GATE_MEDIAN_PX:
            fail("CLI serve: the served pair fails the gate")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
        proc.stderr.close()
    out["serve"] = {"ready_s": ready, "first_request_ms": first_ms}
    return out


def _probe_library(x, w, probe):
    """One cuBLAS call of the probe's function on the same inputs, with
    what it needs built outside the timed call: x @ w_0 for one tap, else
    the K = 128 R concatenation of x against the taps stacked to
    (128 R, N) (the concatK form of try_tail_mini2.py); torch.matmul in
    bf16, torch._int_mm (int32 out) in int8."""
    import torch

    from imcui_tpu_torch.ops import tap_matmul as tm

    taps = tm._taps(w, probe.layout)
    a = x if probe.taps == 1 else torch.cat([x] * probe.taps, -1)
    b = taps.reshape(probe.taps * 128, probe.n).contiguous()
    mm = torch.matmul if probe.dtype == "bf16" else torch._int_mm
    return lambda: mm(a, b)


def kernel_sass(fragment, ops):
    """Counts of each SASS instruction of ``ops`` in every kernel of the
    built library whose name holds ``fragment`` (cuobjdump -sass):
    {mangled name: {op: count}}."""
    import re
    from pathlib import Path

    from imcui_tpu_torch.ops import _build

    _build.library()
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(_build.library_path())],
                          capture_output=True, text=True, check=True).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        if fragment in name:
            counts[name] = {op: len(re.findall(rf"\b{op}\b", part))
                            for op in ops}
    return counts


def tap_matmul_sass():
    """Counts of the P_SASS instructions in each tap_matmul kernel of the
    built library, by type; fails the run if a kernel lacks one of its
    type's, or a type has no kernel."""
    ops = sorted(set(sum(P_SASS.values(), ())))
    counts = {"bf16" if "bfloat16" in name else "int8": c for name, c in
              kernel_sass("tap_matmul_kernel", ops).items()}
    log(f"  tap_matmul SASS: {counts}")
    for dtype, needed in P_SASS.items():
        missing = [op for op in needed if not counts.get(dtype, {}).get(op)]
        if missing:
            fail(f"tap_matmul {dtype} kernel: no {', '.join(missing)} in "
                 f"its SASS")
    return counts


def qtiled_sass():
    """Counts of the Q_SASS instructions in each instance of the TMA
    attention template (K14 and K5's two bf16 kernels); fails the run if
    one is missing from the library or lacks wgmma or TMA loads."""
    import re

    found = {}
    for name, counts in kernel_sass("qtiled_attention_kernel", Q_SASS).items():
        hit = re.search(QTILED_PATTERN, name)
        found["<{}><{}><{}>".format(*hit.groups()[1:])] = counts
    log(f"  qtiled_attention SASS: {found}")
    for inst, kernel in QTILED_INSTANCES.items():
        counts = found.get(inst)
        if counts is None:
            fail(f"{kernel}: no qtiled_attention_kernel{inst} in the built "
                 f"library")
        missing = [op for op in Q_SASS if not counts[op]]
        if missing:
            fail(f"{kernel} (qtiled_attention_kernel{inst}): no "
                 f"{', '.join(missing)} in its SASS")
    return found


def flash_sass():
    """K5's SASS: each float32 kernel (attention.cu's tile at every height
    K5 launches) must hold cp.async copies (LDGSTS), each bf16 one wgmma
    and TMA loads (qtiled_sass). Returns the counts; fails the run
    otherwise."""
    import re

    f32 = {}
    for name, counts in kernel_sass("attention_kernel", F_SASS).items():
        hit = re.search(r"\d(attention)_kernelILi(\d+)ELi(\d+)ELi(\d+)EfE",
                        name)
        if hit:
            f32["<{}><{}><{}>".format(*hit.groups()[1:])] = counts
    log(f"  flash_attention float32 SASS: {f32}")
    for inst in F_INSTANCES:
        if not f32.get(inst, {}).get("LDGSTS"):
            fail(f"flash_attention float32 (attention_kernel{inst}): no "
                 f"LDGSTS in its SASS")
    bf16 = {k: v for k, v in qtiled_sass().items() if k.endswith("<1>")}
    return {"float32": f32, "bf16": bf16}


def phase6(peaks):
    """The stage-tail probes at the scripts' shapes. The path is
    tail_probes.run_all, which runs every probe through tap_matmul and
    times the first of each group; then each probe's output is held
    against its plain version, and each group is timed in its plain
    version and in one cuBLAS call, beside its bound."""
    import torch

    from imcui_tpu_torch.ops import tap_matmul as tm
    from imcui_tpu_torch.tools import tail_probes as tp

    sass = tap_matmul_sass()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tm.tap_matmul.launches = 0
    results = tp.run_all("cuda", P_SEED)
    total = tm.tap_matmul.launches
    if total == 0 or total != sum(r["launches"] for r in results):
        fail(f"tap_matmul: {total} launches on the probes' path, "
             f"{[r['launches'] for r in results]} by probe")
    variants, yardsticks = [], {}
    for p, res in zip(tp.PROBES, results):
        got = res.pop("out")
        x, w = tp.make_inputs(p, P_SEED, "cuda")
        want = tm.tap_matmul_plain(x, w, layout=p.layout)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        below = None
        if p.dtype == "int8":
            tol_text = "exact"
            ok = torch.equal(got, want)
        else:
            # one bf16 step of the output; the floor is the size of one
            # product term (1 for unit-scale inputs), below which an output
            # is a cancellation of f32 partial sums up to 1e5 times larger
            # (K11's x·50, w·20), rounded in another order
            floor = p.x_scale * p.w_scale
            tol_text = f"2^-7*max({floor:g},|plain|)"
            ok = bool((diff <= 2.0 ** -7 * want.float().abs().clamp_min(
                floor)).all())
            # the room the floor leaves: the largest error where it applies
            below = torch.where(want.float().abs() < floor, diff,
                                0.0).max().item()
        ok = ok and bool(torch.isfinite(got.float()).all())
        top = want.float().abs().max().item()
        del got, want, diff
        if p.group not in yardsticks:  # the first probe of its shape
            y = dict(zip(("bound_ms", "bound_by"), bound(
                *p.work(), peaks[p.dtype], peaks)))
            y["plain_ms"] = cuda_ms(lambda: tm.tap_matmul_plain(
                x, w, layout=p.layout))
            lib = _probe_library(x, w, p)
            try:
                y["library_ms"] = cuda_ms(lib)
            except RuntimeError as exc:
                log(f"  library call refused for {p.kernel} {p.label}: "
                    f"{str(exc).splitlines()[0]}")
                y["library_ms"] = None
            del lib
            yardsticks[p.group] = y
        v = {"kernel": p.kernel, "label": p.label, "body": p.body,
             "dtype": p.dtype, "launches": res["launches"],
             "max_abs_err": err,
             "max_plain": top, "tolerance": tol_text,
             "max_abs_err_below_floor": below, "ms": res["ms"],
             "tflops": res["tflops"], **yardsticks[p.group]}
        if "timed_with" in res:
            v["timed_with"] = res["timed_with"]
        del x, w
        torch.cuda.empty_cache()
        variants.append(v)
        log(f"  {p.kernel:3s} {p.label:24s} [{p.rows} x 128 -> {p.n}, "
            f"{p.taps} taps, {p.dtype}, {p.layout}]: err {err:.3g} (max|plain| "
            f"{top:.3g}, {tol_text}"
            + ("" if below is None else f"; below the floor {below:.3g}")
            + f"), launches {res['launches']}, "
            f"{res['ms']:.3f} ms (first design, 35980e0 run 3: "
            f"{P_PREVIOUS_MS[p.group]:.3f}), "
            f"{res['tflops']:.1f} T/s"
            + (f" (timed with {v['timed_with']})" if "timed_with" in v else
               "") + f"; bound {v['bound_ms']:.3f} ({v['bound_by']}), plain "
            f"{v['plain_ms']:.3f}, library {v['library_ms']}")
        if not ok:
            fail(f"tap_matmul [{p.kernel} {p.label}] differs from its "
                 f"plain version")
    # one row per TPU kernel: the numbers of its first variant, all
    # variants beside them; ``timed_with`` names the launch whose time the
    # first variant shares
    rows = []
    for kernel in dict.fromkeys(p.kernel for p in tp.PROBES):
        mine = [v for v in variants if v["kernel"] == kernel]
        first = mine[0]
        p = next(p for p in tp.PROBES if p.kernel == kernel)
        rows.append({
            "name": f"tap_matmul {kernel}", "route": "cuda",
            "source": "imcui_tpu_torch/csrc/tap_matmul.cu",
            "replaces": p.site,
            "launches": sum(v["launches"] for v in mine),
            "max_abs_err": max(v["max_abs_err"] for v in mine),
            **{k: first[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")},
            "sass": sass[first["dtype"]],
            "per": f"launch of {kernel} {first['label'].strip()} "
                   f"({p.rows} x 128 -> {p.n}, {p.taps} taps, {p.dtype})",
            **({"timed_with": first["timed_with"]}
               if "timed_with" in first else {}),
            "variants": mine})
    log(f"  phase 6: {total} launches, {time.perf_counter() - t0:.1f} s")
    return rows, {r["name"]: r["launches"] for r in rows}


# --------------------------------------------------------------------------
# phase 18: W8A8 (precision="int8") and LightGlue in bf16
# --------------------------------------------------------------------------

def _w8_expected(name, params):
    """{kernel: launches a request} that the int8 tree implies: each
    quantised linear (2-D w_q) and convolution (4-D) once a request, twice
    where the path holds it for each view (W8_PER_VIEW)."""
    from imcui_tpu_torch.utils import weights

    out = {"linear_int8": 0, "conv2d_int8": 0}
    for k, v in weights.flatten_tree(params).items():
        if k.endswith(".w_q"):
            uses = 2 if k.split(".")[0] in W8_PER_VIEW[name] else 1
            out["linear_int8" if v.dim() == 2 else "conv2d_int8"] += uses
    return out


@contextlib.contextmanager
def _drawn_on_the_card():
    """While the context lasts, ``weights.seeded_init`` draws its seed-0
    tree on the card, as the card's model did, and hands it to the caller
    on the CPU: a CPU model built then starts from the card model's float32
    tree and quantises it itself."""
    from imcui_tpu_torch.utils import weights

    real = weights.seeded_init
    weights.seeded_init = lambda init, device, *a: weights.to_device(
        real(init, "cuda", *a), "cpu")
    try:
        yield
    finally:
        weights.seeded_init = real


def _w8_conf(name, precision, conv_min_ch=None):
    from imcui_tpu_torch.ui import utils as ui

    conf = ui.parse_match_config({"matcher": name, "dense": True})
    conf["matcher"]["model"]["precision"] = precision
    conf["matcher"]["model"]["int8_conv_min_ch"] = conv_min_ch
    return conf


def _w8_maps(api, img0, img1, size=None):
    """The dense maps the entry's matching reads on one prepared pair,
    float32 on the host: view 1's pointmap and confidence (DUSt3R), its
    descriptors and confidence (MASt3R), the warp and certainty (RoMa,
    DKM). ``size`` resizes the canvas (the CPU comparisons)."""
    import torch

    from imcui_tpu_torch.models.matchers import dkm

    if size is not None:
        api.match_conf["preprocessing"]["resize_max"] = size
    pre = api.match_conf["preprocessing"]
    d = [_canvas(im, pre)[None] for im in (img0, img1)]
    m = api.matcher
    kind = type(m).__name__
    with torch.inference_mode():
        if kind in ("Duster", "Mast3r"):
            x = [m._prepare(t)[0] for t in d]
            maps = _pointmap_maps(m, *x)
        elif kind == "DKMv3":
            s = dkm.coarse_size(m.conf, *d[0].shape[-2:])
            maps = m.match(*(m._prepare(t, s)[0] for t in d))
        else:
            maps = m.match(*(m._prepare(t)[0] for t in d))
    return [t.float().cpu().numpy() for t in maps]


def _w8_roma_cut(api, conf, img0, img1):
    """RoMa with the card's tree cut to its first two DINOv2 blocks at
    coarse_res 112 x 112 (so that the CPU run takes seconds), on the card
    and on the CPU from the same float32 tree quantised on each device:
    [view 0's DINOv2 tokens, the warp, the certainty] of each, float32 on
    the host."""
    import torch

    from imcui_tpu_torch.api.core import ImageMatchingAPI
    from imcui_tpu_torch.models.matchers import roma
    from imcui_tpu_torch.ops import resize

    cpu = ImageMatchingAPI(conf, device="cpu")
    out = []
    for a in (api, cpu):
        p = dict(a.matcher.params)
        p["dinov2"] = {**p["dinov2"], "blocks": p["dinov2"]["blocks"][:2]}
        x = [resize.resize(a.matcher._prepare(_canvas(im, a.match_conf[
            "preprocessing"])[None]).float(), (112, 112), "bilinear")[0]
            .to(torch.bfloat16) for im in (img0, img1)]
        with torch.inference_mode():
            tokens = roma.encode(p, x[0], a.matcher.conf)[0]
            maps = roma.match_gp(p, *x, a.matcher.conf)
        out.append([t.float().cpu().numpy() for t in (tokens, *maps)])
    return out


def phase18_w8a8(pair, fns):
    """Each W8_ENTRIES entry through ImageMatchingAPI(device="cuda") at the
    registry's conf with precision "int8": the W8A8 launches of a request
    (and DUSt3R's and MASt3R's K14 launches) counted against what the tree
    implies and each held against its plain version (W8A8 bit for bit);
    ms a request and device busy beside the bf16 entry, in turns; the int8
    maps against the bf16 maps (W8_SANITY); the card against the CPU on a
    copy of the card's tree. Returns (launches, measurements)."""
    import torch

    from imcui_tpu_torch.api.core import ImageMatchingAPI
    from imcui_tpu_torch.models.backbones import vit

    img0, img1, _ = pair
    launches, out, bf16_api = {}, {}, {}
    for name, cmc in W8_ENTRIES:
        tag = f"{name} int8" + (f" conv>={cmc}" if cmc else "")
        t0 = time.perf_counter()
        pointmap = name in ("duster", "mast3r")
        vit.ATTN_IMPL = "fused" if pointmap else "xla"
        try:
            api = ImageMatchingAPI(_w8_conf(name, "int8", cmc), device="cuda")
            api(img0, img1)  # warm-up
            want = _w8_expected(name, api.matcher.params)
            if W8_K14[name]:
                want["qtiled_attention"] = W8_K14[name]
            counts = {}
            seen = _capture_kernel_args(lambda: api(img0, img1),
                                        tuple(want), counts)
            if counts != want:
                fail(f"{tag}: a request launched {counts}, the tree implies "
                     f"{want}")
            checks = _check_served_kernels(
                {k: v for k, v in seen.items() if v}, f"{tag} request",
                log_each=False)
            del seen
            torch.cuda.synchronize()
            if name not in bf16_api:  # one bf16 entry for both roma runs
                bf16_api.clear()
                torch.cuda.empty_cache()
                bf16_api[name] = ImageMatchingAPI(_w8_conf(name, "bf16"),
                                                  device="cuda")
                bf16_api[name](img0, img1)  # warm-up
            bf = bf16_api[name]
            runs = {"int8": [], "bf16": []}
            for prec in ("int8", "bf16", "bf16", "int8"):
                a = api if prec == "int8" else bf
                ms, got, busy, evs, pred = _dense_request_times(
                    a, img0, img1, fns)
                runs[prec].append((ms, got, busy, evs, pred))
            res = {}
            for prec, rs in runs.items():
                ms = [m for r in rs for m in r[0]]
                got = {n: sum(r[1].get(n, 0) for r in rs) / 2
                       for n in set().union(*(r[1] for r in rs))}
                _check_dense_pred(f"{tag} ({prec} run)", rs[-1][4])
                res[prec] = _log_dense(f"{tag} ({prec} run)", ms,
                                       float(np.mean([r[2] for r in rs])),
                                       rs[-1][3], rs[-1][4], got)
            if res["int8"]["launches_per_request"] != {
                    k: float(v) for k, v in want.items() if v}:
                fail(f"{tag}: timed requests launched "
                     f"{res['int8']['launches_per_request']}, not {want}")
            # one captured request and the timed int8 runs
            for n, c in counts.items():
                launches[n] = launches.get(n, 0) + c + sum(
                    r[1].get(n, 0) for r in runs["int8"])
            # the int8 maps against the bf16 maps, on the card
            m8, m16 = _w8_maps(api, img0, img1), _w8_maps(bf, img0, img1)
            sanity = [float(np.median(np.abs(a - b)) / max(
                1e-30, np.abs(b).max())) for a, b in zip(m8, m16)]
            log(f"  {tag}: int8 against bf16 maps: median |diff| "
                f"{[f'{s:.3g}' for s in sanity]} of the largest (bound "
                f"{W8_SANITY})")
            if not all(np.isfinite(a).all() for a in m8) or \
                    max(sanity) > W8_SANITY:
                fail(f"{tag}: the int8 maps are not near the bf16 maps")
            del bf
            # the card against the CPU on a copy of the card's tree
            t1 = time.perf_counter()
            if name == "roma":
                card, host = _w8_roma_cut(
                    api, _w8_conf(name, "int8", cmc), img0, img1)
                errs = [float(np.median(np.abs(card[0] - host[0]))
                              / np.abs(host[0]).max()),
                        float(np.median(np.abs(card[1] - host[1]))),
                        float(np.abs(card[2] - host[2]).mean())]
                bound_ = [V_CPU_BF16, *W8_ROMA_CPU]
            else:
                with _drawn_on_the_card():
                    cpu = ImageMatchingAPI(_w8_conf(name, "int8", cmc),
                                           device="cpu")
                size = V_CPU_RESIZE if pointmap else None
                card = _w8_maps(api, img0, img1, size)
                host = _w8_maps(cpu, img0, img1, size)
                errs = [float(np.median(np.abs(g - w)) / np.abs(w).max())
                        for g, w in zip(card, host)]
                bound_ = [V_CPU_BF16, V_CPU_BF16]
                del cpu
            log(f"  {tag}: card against CPU: {[f'{e:.3g}' for e in errs]} "
                f"(bounds {bound_}; " + ("a cut DINOv2 at 112^2: median "
                "|token diff| of the largest, median |warp diff|, mean "
                "|certainty diff|" if name == "roma" else
                "median |diff| of the largest") + ")")
            if not all(e <= b for e, b in zip(errs, bound_)):
                fail(f"{tag}: the card and the CPU disagree: {errs}")
            res["card_vs_cpu"] = {"errs": errs, "bounds": bound_,
                                  "s": time.perf_counter() - t1}
            res["int8_vs_bf16_maps"] = sanity
            res["kernel_checks"] = {k: len(v) for k, v in checks.items()}
            res["expected_launches"] = want
            res["speedup_vs_bf16"] = (res["bf16"]["ms_per_request"]
                                      / res["int8"]["ms_per_request"])
            res["seconds"] = time.perf_counter() - t0
            out[tag] = res
        finally:
            vit.ATTN_IMPL = "xla"
        del api
        torch.cuda.empty_cache()
    bf16_api.clear()
    torch.cuda.empty_cache()
    return launches, out


def _planted_canvas(seed):
    """A planted LG_SIZE pair, gray in [0, 1] on a CANVAS x CANVAS canvas
    (top left), with its homography."""
    img0, img1, hm = synthetic_pair(seed, *LG_SIZE)
    out = []
    for im in (img0, img1):
        c = np.zeros((CANVAS, CANVAS), np.float32)
        c[:LG_SIZE[1], :LG_SIZE[0]] = im[..., 0] / 255.0
        out.append(c)
    return out[0], out[1], hm


def _bf16_attention_over(got, want, v):
    """K3/K4 bf16 launches against the plain version: (max |err|, outputs
    past one bf16 step 2^-7 · max(1, |plain|), outputs past that plus one
    bf16 step of one weight of P times max|v| (2^-8 · max|v|: the two
    float32 softmaxes may round a weight at a bf16 edge apart))."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    step = 2.0 ** -7 * w.abs().clamp_min(1.0)
    return (diff.max().item(), int((diff > step).sum()),
            int((diff > step + 2.0 ** -8 * v.float().abs().max()).sum()),
            diff.numel())


def phase18_lightglue():
    """LightGlue at the flagship operating point (BATCH planted pairs,
    MAX_KPTS bf16 SuperPoint keypoints on the CANVAS canvas, the trained
    N_LAYERS-layer tree) in float32 and in bf16: K3 and K4 launch in bf16
    N_LAYERS times each per pair batch, every launch held against its
    plain version (_bf16_attention_over; at most LG_OVER of the outputs
    past one bf16 step, none past the P-rounding bound); both runs'
    matches through RANSAC pass the planted gate; the IoU of the bf16
    matches against the float32 ones and both forwards' times."""
    import torch

    from imcui_tpu_torch.models.extractors import superpoint as sp
    from imcui_tpu_torch.models.matchers import lightglue as lg
    from imcui_tpu_torch.ops import attention
    from imcui_tpu_torch.ops import ransac as ransac_ops
    from imcui_tpu_torch.pipeline import two_view

    dev = torch.device("cuda")
    params, meta = two_view.load_pretrained(n_layers=N_LAYERS, device=dev)
    if not meta["lightglue"]["pretrained"]:
        fail("phase 18: the trained LightGlue tree was not found")
    pairs = [_planted_canvas(s) for s in LG_SEEDS]
    im0 = torch.tensor(np.stack([p[0] for p in pairs])[:, None], device=dev)
    im1 = torch.tensor(np.stack([p[1] for p in pairs])[:, None], device=dev)
    valid = torch.tensor([LG_SIZE] * BATCH, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        f = sp.apply(params["superpoint"], torch.cat([im0, im1]),
                     torch.cat([valid, valid]), max_keypoints=MAX_KPTS,
                     keypoint_threshold=0.0005, device=dev)
    args = (params["lightglue"], f["keypoints"][:BATCH],
            f["keypoints"][BATCH:], f["descriptors"][:BATCH].transpose(1, 2),
            f["descriptors"][BATCH:].transpose(1, 2), f["mask"][:BATCH],
            f["mask"][BATCH:], valid.float(), valid.float())

    def run(precision):
        with torch.inference_mode():
            return lg.forward_pair(*args, device=dev, precision=precision)

    run("bf16")  # warm-up
    counts = {}
    seen = _capture_kernel_args(lambda: run("bf16"), (
        "fused_attention", "bidirectional_attention"), counts)
    want = {"fused_attention": N_LAYERS, "bidirectional_attention": N_LAYERS}
    if counts != want:
        fail(f"phase 18 LightGlue bf16: launched {counts}, not {want}")
    checks = {}
    for name, calls in seen.items():
        kernel = getattr(attention, name)
        plain = getattr(attention, f"{name}_plain")
        for a, kw in calls:
            if a[0].dtype != torch.bfloat16:
                fail(f"{name} took {a[0].dtype} in the bf16 forward")
            got, ref = kernel(*a, **kw), plain(*a, **kw)
            torch.cuda.synchronize()
            vs = (a[2],) if name == "fused_attention" else (a[3], a[2])
            for g, r, v in zip(*(x if isinstance(x, tuple) else (x,)
                                 for x in (got, ref)), vs):
                err, past, out_, n = _bf16_attention_over(g, r, v)
                checks.setdefault(name, []).append(
                    {"shape": "x".join(map(str, a[0].shape)),
                     "max_abs_err": err, "past_step": past,
                     "past_bound": out_, "outputs": n})
                if out_ or past > LG_OVER * n:
                    fail(f"{name} bf16 [{tuple(a[0].shape)}]: {past} of {n} "
                         f"outputs past one bf16 step, {out_} past the "
                         f"P-rounding bound")
    del seen
    for name, cs in checks.items():
        log(f"  LightGlue bf16 {name}: {len(cs)} launches at "
            f"{cs[0]['shape']} held: max |err| "
            f"{max(c['max_abs_err'] for c in cs):.3g}, outputs past one bf16 "
            f"step {sum(c['past_step'] for c in cs)} of "
            f"{sum(c['outputs'] for c in cs)}, past the P-rounding bound 0")
    res = {"kernel_checks": checks, "launches_per_batch": counts}
    gen = torch.Generator(device=dev)
    matches, launches = {}, {}
    k34 = (attention.fused_attention, attention.bidirectional_attention)
    for precision in ("fp32", "bf16"):
        for fn in k34:
            fn.launches = 0
        ms = []
        for _ in range(LG_REPS + 2):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            m = run(precision)
            ev[1].record()
            ev[1].synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
        ms = ms[2:]
        for fn in k34:
            if fn.launches != N_LAYERS * (LG_REPS + 2):
                fail(f"LightGlue {precision}: {fn.__name__} launched "
                     f"{fn.launches} times in {LG_REPS + 2} forwards")
            key = fn.__name__ + ("[bf16]" if precision == "bf16" else "")
            launches[key] = fn.launches + (
                counts[fn.__name__] if precision == "bf16" else 0)
        m0 = m["matches0"].long()
        p1 = torch.gather(f["keypoints"][BATCH:], 1, m0.clamp(
            0, MAX_KPTS - 1)[..., None].expand(-1, -1, 2))
        gen.manual_seed(2)
        ver = ransac_ops.ransac(f["keypoints"][:BATCH], p1, m0 > -1, gen,
                                threshold=4.0, num_hypotheses=HYPOTHESES,
                                device=dev)
        gates = []
        for i, (_, _, hm) in enumerate(pairs):
            keep = ver["inliers"][i].cpu().numpy()
            err = transfer_errors(hm, f["keypoints"][i].cpu().numpy()[keep],
                                  p1[i].cpu().numpy()[keep])
            med = float(np.median(err)) if len(err) else float("inf")
            gates.append({"inliers": int(keep.sum()), "median_px": med})
            if len(err) < GATE_MIN_INLIERS or med > GATE_MEDIAN_PX:
                fail(f"phase 18 LightGlue {precision}, pair {i}: "
                     f"{len(err)} inliers at a median {med:.3f} px (gate "
                     f">= {GATE_MIN_INLIERS} at <= {GATE_MEDIAN_PX} px)")
        matches[precision] = m0.cpu().numpy()
        res[precision] = {"ms_median": float(np.median(ms)), "ms_runs": ms,
                          "matches": int((m0 > -1).sum()), "gate": gates}
        log(f"  LightGlue {precision} ({BATCH} pairs, {MAX_KPTS} keypoints, "
            f"{N_LAYERS} layers): {np.median(ms):.3f} ms a forward (median "
            f"of {LG_REPS}, CUDA events), {int((m0 > -1).sum())} matches; "
            f"gate " + ", ".join(f"{g['inliers']} at {g['median_px']:.3f} px"
                                 for g in gates))
    both = {(b, i, j) for b, row in enumerate(matches["bf16"])
            for i, j in enumerate(row) if j > -1}
    ref = {(b, i, j) for b, row in enumerate(matches["fp32"])
           for i, j in enumerate(row) if j > -1}
    res["iou_bf16_vs_fp32"] = len(both & ref) / max(1, len(both | ref))
    log(f"  LightGlue bf16 against fp32: match IoU "
        f"{res['iou_bf16_vs_fp32']:.4f}")
    return launches, res


def phase18_times(peaks):
    """The new kernels' rows: W8A8 linear at DUSt3R's fc1 (768 tokens of
    1024 into 4096, bf16) and convolution at RoMa's VGG 256 -> 256 3 x 3 at
    140 x 140 (bf16), K3 and K4 in bf16 at the flagship's LightGlue shapes;
    each a median of 20 CUDA-event timings beside its plain version, its
    library call and its bound."""
    import torch

    from imcui_tpu_torch.models import layers
    from imcui_tpu_torch.ops import attention, w8a8

    gen = torch.Generator(device="cuda").manual_seed(18)
    rows = []

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    # linear
    m, k, n = W8_LINEAR
    q = layers.quantize_linear_int8({"w": rnd(n, k, dtype=torch.float32),
                                     "b": rnd(n, dtype=torch.float32)})
    x = rnd(m, k)
    got = w8a8.linear_int8(x, q["w_q"], q["w_s"], q["b"])
    want = w8a8.linear_int8_plain(x, q["w_q"], q["w_s"], q["b"])
    if not torch.equal(got, want):
        fail("linear_int8 differs from its plain version at the timed shape")
    wt = q["w_q"].t()

    def library():
        xq, sx = w8a8.quantize_rows(x)
        acc = torch._int_mm(xq, wt)
        return (acc.float() * sx * q["w_s"] + q["b"]).to(x.dtype)

    if not torch.equal(library(), want):
        fail("torch._int_mm and the epilogue differ from the plain version")
    t, by = bound(2.0 * m * n * k, 2 * m * k + n * k + 8 * n + 2 * m * n,
                  peaks["int8"], peaks)
    rows.append({
        "name": "linear_int8", "route": "cuda",
        "source": "imcui_tpu_torch/csrc/w8a8.cu",
        "replaces": "none (XLA in the JAX package: "
                    "imcui_tpu/models/layers.py:123 _linear_int8)",
        "shape": f"{m}x{k} bf16 by {n}x{k} int8", "tolerance": "exact",
        "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: w8a8.linear_int8(x, q["w_q"], q["w_s"],
                                               q["b"])),
        "plain_ms": cuda_ms(lambda: w8a8.linear_int8_plain(
            x, q["w_q"], q["w_s"], q["b"])),
        "library_ms": cuda_ms(library),
        "library": "torch._int_mm and the epilogue",
        "bound_ms": t, "bound_by": by})
    # convolution
    b, c, h, w, co = W8_CONV
    q = layers.quantize_conv_int8({"w": rnd(co, c, 3, 3, dtype=torch.float32),
                                   "b": rnd(co, dtype=torch.float32)})
    x = rnd(b, c, h, w)
    pad = ((1, 1), (1, 1))
    got = w8a8.conv2d_int8(x, q["w_q"], q["w_s"], q["b"], 1, pad, 1, 1)
    want = w8a8.conv2d_int8_plain(x, q["w_q"], q["w_s"], q["b"], 1, pad, 1, 1)
    if not torch.equal(got, want):
        fail("conv2d_int8 differs from its plain version at the timed shape")
    mm, kk = b * h * w, c * 9
    t, by = bound(2.0 * mm * co * kk, 2 * b * c * h * w + co * kk + 8 * co
                  + 2 * mm * co, peaks["int8"], peaks)
    rows.append({
        "name": "conv2d_int8", "route": "cuda",
        "source": "imcui_tpu_torch/csrc/w8a8.cu",
        "replaces": "none (XLA in the JAX package: "
                    "imcui_tpu/models/layers.py:150 _conv2d_int8)",
        "shape": f"{b}x{c}x{h}x{w} bf16, 3x3 to {co}", "tolerance": "exact",
        "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: w8a8.conv2d_int8(x, q["w_q"], q["w_s"],
                                               q["b"], 1, pad, 1, 1)),
        "plain_ms": cuda_ms(lambda: w8a8.conv2d_int8_plain(
            x, q["w_q"], q["w_s"], q["b"], 1, pad, 1, 1)),
        "library_ms": None, "library": "none on CUDA",
        "bound_ms": t, "bound_by": by})
    # K3 and K4 in bf16 at LightGlue's flagship shapes
    nk = MAX_KPTS
    mask = torch.ones((2 * BATCH, nk), dtype=torch.bool, device="cuda")
    mask[1, nk * 2 // 3:] = False
    s3 = 2 * BATCH * HEADS
    q3, k3, v3 = rnd(s3, nk, 64), rnd(s3, nk, 64), rnd(s3, nk, 64)
    e3 = _bf16_attention_over(
        attention.fused_attention(q3, k3, v3, mask, HEADS),
        attention.fused_attention_plain(q3, k3, v3, mask, HEADS), v3)
    t, by = bound(4.0 * s3 * nk * nk * 64, 4 * s3 * nk * 64 * 2
                  + 2 * BATCH * nk, peaks["bf16"], peaks)
    lib = library_sdpa((q3, k3, v3, mask, HEADS))
    rows.append({
        "name": "fused_attention[bf16]", "route": "cuda",
        "source": "imcui_tpu_torch/csrc/attention.cu",
        "replaces": "imcui_tpu/ops/attention.py:263",
        "shape": f"{s3}x{nk}x64 bf16", "max_abs_err": e3[0],
        "tolerance": "2^-7*max(1,|plain|), P-rounding 2^-8*max|v|",
        "ms": cuda_ms(lambda: attention.fused_attention(q3, k3, v3, mask,
                                                        HEADS)),
        "plain_ms": cuda_ms(lambda: attention.fused_attention_plain(
            q3, k3, v3, mask, HEADS)),
        "library_ms": lib["ms"], "library": f"SDPA ({lib['backend']})",
        "bound_ms": t, "bound_by": by})
    s4 = BATCH * HEADS
    m0, m1 = mask[:BATCH], mask[BATCH:]
    a0, a1, v0, v1 = (rnd(s4, nk, 64) for _ in range(4))
    got = attention.bidirectional_attention(a0, a1, v0, v1, m0, m1, HEADS)
    ref = attention.bidirectional_attention_plain(a0, a1, v0, v1, m0, m1,
                                                  HEADS)
    e4 = max(_bf16_attention_over(g, r, v)[0]
             for g, r, v in zip(got, ref, (v1, v0)))
    t, by = bound(s4 * 6.0 * nk * nk * 64, 6 * s4 * nk * 64 * 2
                  + 2 * BATCH * nk, peaks["bf16"], peaks)
    lib = library_sdpa((a0, a1, v1, m1, HEADS), (a1, a0, v0, m0, HEADS))
    rows.append({
        "name": "bidirectional_attention[bf16]", "route": "cuda",
        "source": "imcui_tpu_torch/csrc/attention.cu",
        "replaces": "imcui_tpu/ops/attention.py:385",
        "shape": f"{s4}x{nk}x{nk}x64 bf16", "max_abs_err": e4,
        "tolerance": "2^-7*max(1,|plain|), P-rounding 2^-8*max|v|",
        "ms": cuda_ms(lambda: attention.bidirectional_attention(
            a0, a1, v0, v1, m0, m1, HEADS)),
        "plain_ms": cuda_ms(lambda: attention.bidirectional_attention_plain(
            a0, a1, v0, v1, m0, m1, HEADS)),
        "library_ms": lib["ms"], "library": f"SDPA ({lib['backend']})",
        "bound_ms": t, "bound_by": by})
    for r in rows:
        log(f"  {r['name']} [{r['shape']}]: {r['ms']:.4f} ms (median of 20 "
            f"CUDA-event timings), plain {r['plain_ms']:.4f}, library "
            f"{r['library_ms']} ({r['library']}), bound {r['bound_ms']:.4f} "
            f"({r['bound_by']}); max |err| {r['max_abs_err']:.3g}")
    return rows


def phase18(peaks):
    """(a) W8A8 through the dense API, (b) LightGlue in bf16 at the
    flagship, (c) the new kernels' times. Returns (rows, launches,
    measurements)."""
    t_phase = time.perf_counter()
    fns = _wrappers(ALL_KERNELS + ("linear_int8", "conv2d_int8"))
    launches, out = phase18_w8a8(synthetic_pair(Z_SEEDS[0], *Z_SIZE), fns)
    more, out["lightglue_bf16"] = phase18_lightglue()
    for n, c in more.items():
        launches[n] = launches.get(n, 0) + c
    rows = phase18_times(peaks)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 18: {out['phase_s']:.1f} s")
    return rows, launches, out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from imcui_tpu_torch.pipeline import two_view

    smi_line = phase0()
    name = torch.cuda.get_device_name(0)
    part, peaks = card_peaks(name)
    log(f"phase 1: kernels vs plain versions (peaks of an H100 {part})")
    params, _ = two_view.load_pretrained(n_layers=N_LAYERS, device="cuda")
    rows = phase1(params, peaks)
    more_rows, kernel_notes = phase1_general(params, peaks)
    rows += more_rows
    k14_row, k3_at_1601 = phase1_dense(peaks)
    rows.append(k14_row)
    next(r for r in rows if r["name"] == "fused_attention")[
        "through_mha_auto_at_1601"] = k3_at_1601
    log("phase 2: serving")
    launches = phase2()
    log("phase 3: timing at the bench operating point")
    timing = phase3(params)
    log("phase 4: the general path (ImageMatchingAPI, adaptive LightGlue at "
        f"{G_KPTS} keypoints)")
    launches_general, timing["general"] = phase4()
    timing["kernels"] = kernel_notes
    log(f"phase 5: the dense path (ImageMatchingAPI, {D_MATCHER} at full "
        "width, f32 and bf16)")
    timing["dense"] = phase5()
    log("phase 6: the stage-tail probes (K8-K13) at the scripts' shapes")
    probe_rows, launches_probes = phase6(peaks)
    rows += probe_rows
    log(f"phase 7: the LoFTR dense path (ImageMatchingAPI, {L_MATCHER} at "
        "640x480 on the trained tree, bf16 and f32), the LoFTR family and "
        "RoMa's fpn-corr")
    timing["loftr"] = phase7()
    log("phase 8: the user surfaces (the HTTP server on api.yaml, the client,"
        " the CLI)")
    t8 = time.perf_counter()
    launches_surfaces, timing["surfaces"] = phase8()
    timing["surfaces"]["phase_s"] = time.perf_counter() - t8
    log(f"  phase 8: {timing['surfaces']['phase_s']:.1f} s")
    log("phase 9: pose and evaluation (the planted chain, PnP, eval pose on "
        "the flagship, loftr, evaluate_warp)")
    launches_eval, timing["eval"] = phase9()
    log("phase 10: the sparse zoo (ImageMatchingAPI on "
        f"{', '.join(Z_ENTRIES)})")
    launches_zoo, timing["zoo"] = phase10(peaks)
    log("phase 11: SIFT's stages on the card against the CPU")
    timing["sift"] = phase11()
    log("phase 12: REKD, raco+lightglue, DUSt3R and MASt3R (ViT-L, f32 and "
        "bf16 through K14) and DKM (ImageMatchingAPI)")
    launches_12, timing["zoo_12"] = phase12(peaks)
    log("phase 13: GlueStick on LSD, LISRD, SOLD2, DaD-RoMa and RoMaV2 "
        f"(ImageMatchingAPI on {', '.join(N_ENTRIES)}), LSD's stages")
    launches_13, timing["zoo_13"] = phase13()
    log("phase 14: the root zoo's last matchers (ImageMatchingAPI on "
        f"{', '.join(O_ENTRIES)}) and the retrieval confs (extract() on "
        f"{', '.join(RET_ENTRIES)})")
    launches_14, timing["zoo_14"] = phase14()
    log("phase 15: the batch pipelines (extract_features, "
        "pairs_from_exhaustive, match_features, pairs_from_retrieval, "
        "match_dense) through the port's HDF5 files")
    launches_15, timing["batch"] = phase15(smi_line)
    log("phase 16: SfM and localisation (SfmEngine on the batch files, "
        "reconstruction and triangulation up to the mapper, localize_sfm, "
        "localize_inloc)")
    launches_16, timing["sfm"] = phase16(smi_line)
    log("phase 17: JPEG on the card (the port's decoder against PIL, its "
        "time, SfmEngine on JPEG views against PNG copies, the HTTP bodies)")
    launches_17, timing["jpeg"] = phase17(smi_line,
                                          timing["surfaces"]["jpeg"])
    log("phase 18: W8A8 (precision int8: duster, mast3r, roma, dkm through "
        "ImageMatchingAPI) and LightGlue in bf16 at the flagship")
    rows_18, launches_18, timing["int8_bf16"] = phase18(peaks)
    rows += rows_18
    for r in rows:
        by_path = {
            "turbo": launches.get(r["name"], 0),
            "general": launches_general.get(r["name"], 0),
            "dense f32": timing["dense"]["f32"]["launches"].get(r["name"], 0),
            "dense bf16": timing["dense"]["bf16"]["launches"].get(
                r["name"], 0),
            "probes": launches_probes.get(r["name"], 0),
            "surfaces": launches_surfaces.get(r["name"], 0),
            "eval": launches_eval.get(r["name"], 0),
            "zoo": launches_zoo.get(r["name"], 0),
            "zoo 12": launches_12.get(r["name"], 0),
            "zoo 13": launches_13.get(r["name"], 0),
            "zoo 14": launches_14.get(r["name"], 0),
            "batch": launches_15.get(r["name"], 0),
            "sfm": launches_16.get(r["name"], 0),
            "jpeg": launches_17.get(r["name"], 0),
            "int8/bf16": launches_18.get(r["name"], 0)}
        r["launches_by_path"] = by_path
        r["launches"] = sum(by_path.values())
        if r["launches"] == 0:
            fail(f"{r['name']} was launched on no path")
    log(json.dumps({"timing": timing, "card": smi_line}))
    log(json.dumps({"kernels": rows}))
    log(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
