#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``hairci_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:
  1. device  -- the card's name and power limit; TF32 off for matmul and conv.
  2. build   -- nvcc builds every kernel from csrc/, one process per source,
                all started together; ptxas' registers and spills, and the
                occupancy that follows for the conv3x3 tensor-core kernel
                and the bn_stats kernel. g++ builds the C++ batch image
                decoder (hairci_torch/native/imageio.cpp) where libjpeg and
                libpng are installed, else its message is printed and the
                loaders decode with PIL; every loading phase below checks
                that its images took that route (the decoder's counter).
  3. kernels -- each kernel against its plain PyTorch twin on the card, at the
                shapes of the serving, training and evaluation paths (the
                top-k on both its routes, each where plan() sends it and
                at its edges, timed at Q = 1, 16, 64, 256 on the route
                plan() takes; and at the face width, 103,945 x 512, at
                Q = 1 and 256, f32 and bf16). Two
                times per kernel and shape: the card's (50 calls back to back
                inside one pair of CUDA events while the host is ahead) and
                the host's (perf_counter round one call, no synchronise);
                the twin's median time, the least time the card could take
                for the same bytes and operations, and, where one PyTorch
                call computes the same function, that call's time. bn_stats
                and conv3x3 are also run twice for equal bits; conv3x3
                reports which of its two kernels each shape took, and a
                Conv2d whose weight was updated in place must read the new
                weights. Rotate is held bitwise without the blur and within
                2e-6 with it at the step's batch, at seven odd shapes
                (contiguous and in NCHW order) and on the step's own
                strided SimCLR view, and timed on both routes. conv3x3 bf16
                also at (64 / 48 / 47, 224, 224, 64), the CIFAR-stem
                ResNet-18's layer1, and bn_stats at the 20 BN inputs of one
                SupCon forward (layer1 at 128 x 224 x 224 rows), at the 4
                of one MSN step (the head's (64, 2048) and (640, 2048)
                bf16, twice each), at BYOL's two head inputs (128 and 96 x
                4096 bf16) and the ResNet-50 trunk's inputs at 96 and 48
                rows, and at SiameseIM's f32 PermuteBN inputs (64 x 79,
                64 x 275, 64 x 197 rows of 512; at 48 rows a token too);
                conv3x3 also at (128 / 96, 56, 56, 64), BYOL's momentum
                forward, and DualViewHair's f32 shapes: conv3x3 at (32, 56,
                56, 64) f32 (its EMA teacher, the fma kernel), bn_stats at
                the 56 f32 BN inputs of its student at B=32, the top-k at
                103,945 x 256 f32 at Q = 1 (fma) and 256 (mma).
  3b. bn-apply -- the fused BatchNorm apply and its backward
                (ops/bn_apply.py): the module's output and running stats
                bit for bit against the formula it replaced (train and eval,
                with no epilogue, ReLU, residual add and ReLU; bf16 and
                f32; on and off the 16-byte path), its backward the same
                bits twice; each kernel against its twin on the card (the
                apply and the input gradient bit for bit) and timed at the
                53 trunk BN inputs of one ResNet-50 SHAM forward at 768
                rows (bf16) and of DualViewHair's student at 32 (f32),
                beside its bound, its twin and F.batch_norm + relu; a
                ResNet-50 SHAM step in each stage at B=64 must launch 53
                train-mode and 53 eval-mode applies (106 in mine) and 53 of
                each backward kernel, and phase 6's run 53 of each a step.
  4. serve   -- a full-width ViT-B/16 HairEncoder (bf16, seeded random
                weights) behind ``hairci_torch.serve.api.serve``: index the
                repo's images, answer /health, /search, /embed, /reload, then
                search a 103,945-row gallery, one query at a time and 256 in
                one request; the kernels' launch counters must show that
                /search went through both routes of the top-k.
  5. parity  -- the same weights in f32 on the CPU against bf16 on the card.
  4d. serve-face -- for VIT and VITs: a full-width FaceEncoder (dim 512,
                depth 20, 8 heads x 64, mlp 2048, 112 px, bf16, seeded random
                weights) built and served exactly as ``api.main --encoder
                face`` wires them; /health (dim 512), /embed, /search on the
                repo's images, then 22 searches of 1-4 queries and one of 256
                over a 103,945 x 512 gallery: the launch counters must show
                22 on the fma route and 1 on the mma route. The embed at
                batch 64 (CUDA events, median of 10 after 3; FLOPs by
                FlopCounterMode), and bf16 on the card against f32 on the CPU
                on 8 images (cosine >= 0.99). Then ``python -m
                hairci_torch.cli.face_retrieval`` once (its top-5 printed).
  4e. faiss-native-demo -- phase 4's 103,945 x 768 gallery written as the
                reference demo's FAISS pair (index_hair_region.index +
                paths_hair_region.pkl) and imported; the hair CLI with
                --faiss_index --retrieve_only launches the top-k once and
                prints GalleryIndex.search's top-5; NativeFlatIndex (g++
                into native/_build, a failed build raises) on the same rows
                gives the card's top-5 at Q = 1 and 256 (scores within 1e-5),
                each side's ms printed; DemoPipeline with the full-width
                HairEncoder imports the artifact (a face encoder's width is
                refused) and retrieves one image through the Otsu mask with
                one top-k launch.
  6. train   -- ResNet-50 SHAM at 224, bf16, B=64, seeded random weights,
                through ``hairci_torch.cli.mainpretrain.main`` for 3 epochs
                of 2 steps (warmup, mine, mined) on the repo's 64 hair crops
                listed twice (the strides of the view the step hands to
                positive_transform are printed); the launch counters must
                show every step went
                through the rotate kernel and every train-mode BN through the
                stats kernel, and every forward without gradient (the EMA
                teacher's) through the conv3x3 kernel. Then 10 timed warmup
                and mined steps each.
  7. knn     -- ``hairci_torch.cli.knn_classification.main`` on the
                checkpoint phase 6 wrote: ResNet-50 at 224, bf16, batches of
                48 (the last of each loader padded), the 128-row manifest as
                train and the 64 images as test, all seven ks; every eval
                forward must launch the conv3x3 kernel 3 times and the stats
                kernel never; unit-norm features; self-retrieval at k=1.
  7b. train-vit -- SHAM with --S2R2 on ViT-B/16 at 224, bf16, B=64, seeded
                random weights, block remat, through mainpretrain.main for 3
                epochs of 2 steps on phase 6's manifest: one rotate and two
                bn_stats (the head's BNs) launches a step, no conv3x3; the
                S2R2 term in [0, 1]. Then 10 timed warmup and mined steps
                and the peak memory for remat False, True, "selective" and
                "half", and one step at the config's B=256 with remat=True
                (whether it fits, its peak memory and ms).
  7c. knn-vit -- knn_classification.main on phase 7b's checkpoint: ViT-B/16
                at 224, bf16, batches of 48, all seven ks; no kernel
                launch; unit-norm 768-d features; self-retrieval at k=1.
  7d. train-simclr -- SimCLR (configs/pretrain_simclr.yaml: ResNet-50,
                temperature 0.7) through mainpretrain.main, bf16, seeded
                random weights, B=48 for 2 epochs on phase 6's manifest, so
                each epoch ends in a padded batch (48 + 48 + 32): 55 bn_stats
                launches a step, no rotate, no conv3x3; the "Loss =" log line
                and a checkpoint without an EMA. Then 10 timed steps after 3
                at B=64 with the peak memory, and one step at the config's
                B=256 where the B=64 peak, scaled by rows, is below 75 GiB.
  7e. train-supcon -- SupCon (configs/pretrain_simclr_supcon.yaml: the
                CIFAR-stem ResNet-18, temperature 0.07) the same way: 20
                bn_stats launches a step; timed at B=64 and B=128; B=256
                only where twice the B=128 peak is below 75 GiB, else the
                extrapolated peak and "does not fit".
  7f. eval-baselines -- knn_classification.main on 7d's and 7e's
                checkpoints with each --eval_type (knn, linear_prob,
                visualization, inter_intra_distance), batches of 48: 3
                conv3x3 launches an eval forward for ResNet-50, 4 for the
                CIFAR-stem ResNet-18, no bn_stats; the result file of each;
                unit-norm features; the probe's accuracy and the variance
                ratio printed.
  7g. train-mae -- MAE (configs/pretrain_mae.yaml as flags: ViT-B/16 at
                full width and depth with the 8 x 512 decoder, lr 1e-3)
                through mainpretrain.main, bf16, seeded random weights, B cut
                from 256 to 64, 2 epochs of 2 steps on phase 6's manifest: no
                kernel launch (no BatchNorm, rotation, 3x3 conv or gallery
                search on this path); a finite "Loss =" line each epoch and a
                checkpoint. Then 10 steps timed after 3 by
                utils.profiling.StepTimer, the peak memory, the step's GFLOP
                an image by FlopCounterMode, and one step at the config's
                B=256 where the B=64 peak, scaled by rows, is below 75 GiB.
                Then knn_classification.main --mode mae on the checkpoint (as
                phase 7c: no launch, unit-norm 768-d features,
                self-retrieval at k=1).
  7h. train-simmim -- the same for SimMIM (ViT-B/16 over all 196 tokens,
                mask ratio 0.6); its features are the mean of the normed
                tokens. Near-duplicate crops' features of this barely
                trained model lie within rounding of each other, so
                self-retrieval is printed, not held; instead the features of
                16 test images, less their mean, must agree f32 card against
                f32 CPU.
  7i. train-dinov2 -- DINOv2 (configs/pretrain_dinov2.yaml as flags:
                ViT-S/16 with LayerScale 1e-5, the 2048-2048-256 head into
                65,536 prototypes shared by DINO and iBOT, 2 global + 8
                local 96-px views, lr 1e-3, weight decay 0.04) through
                mainpretrain.main, bf16, seeded random weights, the config's
                B=128 for 2 epochs of 1 step on phase 6's manifest: no
                kernel launch, a finite "Loss =" line each epoch (the DINO,
                iBOT and KoLeo terms printed), both centres (1, 65536) in the
                checkpoint. Then the step timed by StepTimer at B=128 with
                block remat (the recipe's default) and without it where the
                peak at B=32, scaled by rows, is below 75 GiB; peak memory and
                GFLOP an image. Then knn_classification.main --mode dinov2
                (no launch, unit-norm 384-d features; self-retrieval printed,
                the features held f32 card against CPU as SimMIM's).
  7j. train-msn -- MSN (ViT-B/16, the (Linear + BN + GELU) x 2 + Linear head
                2048 -> 256, 1,024 prototypes, 2 views + 10 focal 96-px
                views, mask ratio 0.15) the same way at B=64, 2 epochs of 2
                steps: exactly 4 bn_stats launches a step (the head's BNs
                over the anchors, then the focal views), none of the other
                three. Timed at B=64 and at the largest of 128 and 256 whose
                scaled peak fits. Then knn_classification.main --mode MSN:
                the target branch's features, no launch, self-retrieval at
                k=1.
  7k. train-byol -- BYOL (ResNet-50 at full width, the 2048 -> 4096 -> 256
                projection and 256 -> 4096 -> 256 prediction heads, the
                momentum branch its EMA at the per-epoch cosine momentum)
                through mainpretrain.main at 224, bf16, seeded random
                weights, B=48 for 2 epochs on phase 6's manifest (the last
                batch of each padded): exactly 55 bn_stats (the trunk's 53
                over both views and the heads' two 4096-wide BNs) and 3
                conv3x3 launches (the momentum branch's forward without
                gradient) a step, no rotate, no top-k; the heads' widths; a
                finite "Loss =" line each epoch; the checkpoint's keys. Then
                the step timed by StepTimer at B=64 and at the config's B=256
                where the B=64 peak scaled by rows fits (peak memory, GFLOP
                an image by FlopCounterMode), and one step at B=64 under
                torch.profiler.
  7l. train-densecl -- DenseCL (ResNet-50 kept spatial, 2048 -> 2048 -> 512
                global and local heads, banks of 4096 x 512) the same way:
                53 bn_stats and 3 conv3x3 launches a step; the loss and its
                global and local terms each epoch; both banks and pointers
                in the checkpoint (6 x 48 rows filled). Timed the same way.
                Then knn_classification.main --mode DenseCL --model resnet50
                on the checkpoint: 3 conv3x3 launches a forward, no other;
                unit-norm 2048-d features, held f32 card against CPU.
  7m. train-siameseim -- SiameseIM (ViT-B/16 without a final norm, the
                512-wide decoder of 16 heads, 2 projector and 4 predictor
                PermuteBN blocks, blockwise mask ratio 0.6, the per-epoch
                cosine momentum) through mainpretrain.main at 224, bf16,
                seeded random weights, B=48 for 2 epochs on phase 6's
                manifest (the last batch of each padded): exactly 16
                bn_stats launches a step, all on f32 inputs, none of the
                other three; a finite "Loss =" line each epoch; the momentum
                branch's PermuteBN statistics in the checkpoint. Then the
                step timed by StepTimer at B=64 and at 256 where the scaled
                peak fits (peak memory, GFLOP an image), one step at B=64
                under torch.profiler; knn_classification.main --mode siaMIM
                on the checkpoint (no launch, 768-d raw cls features, held
                f32 card against CPU) and on a reference-layout .pth written
                from the same weights (the same features).
  7n. train-sham-v1 -- SHAM v1 (ViT-B/16, the global and local projectors,
                the cross block; the depth-2 decoder in reconstruction mode)
                through build_recipe("SHAM_v1") and the Trainer, as the JAX
                package reaches it, in both modes at 224, bf16, B=48 for 2
                epochs: no kernel launch, finite global, local (and recon)
                terms; each mode timed at B=64 and at 256 where it fits.
  7o. train-dualview -- DualViewHair (ResNet-50 at full width, the 256-d
                embedding and 128-d projection heads, f32 as its CLI always
                runs) through ``hairci_torch.experiments.dualview.train.main``
                at 224, B=32, seeded random weights, on the repo's 64 (full,
                hair) pairs: 2 epochs of infonce with --save_path, then 1
                epoch each of queue, asymmetric, multiscale + hybrid and
                partbased: exactly 56 bn_stats launches a step (53 for the
                enhanced encoders), all f32, and 3 conv3x3 on its fma kernel
                (the EMA teacher), no rotate, no top-k; a finite loss each
                epoch. The step timed by StepTimer at B=32 and at 256 where
                the scaled peak fits (else 128), GFLOP an image, one step
                under torch.profiler. Then quantitative_eval.main --model
                dualview on the checkpoint for both towers (a benchmark
                written from the 64 stems; Recall@K / mAP@K at 10, 20, 50,
                the top-100 file; no top-k launch at k = 100, 3 conv3x3 an
                embed batch), the student's embeddings f32 card vs CPU
                (cosine >= 0.9999), and HairstyleRetrievalModel.retrieve(k=5)
                at Q = 1 and 64 (one fma and one mma launch, the kernel
                held against its twin on those queries).
  8. knn at full size -- ``knn_predict_multi`` on seeded clustered features,
                103,945 x 2048 gallery, 61 classes, 4096 queries, the seven
                ks; 512 queries against the port on the CPU; exact ties by
                index; top-k + tie repair against a stable sort of the scores.
  8b. probe at full size -- ``linear_probe_fit_predict`` on the same
                features (500 iterations, TF32 off): seconds, the final
                objective, objective evaluations an iteration; on 8192 rows
                the card against the CPU (predictions >= 99.5 % equal, the
                objective within rtol 1e-4).
  8c. mining at full size -- ``train.mining`` on the same features:
                estimate_k_by_pca, run_kmeans (niter 20) and
                mine_hard_negatives, timed; no anchor its own negative but
                where JAX's rule leaves one; on 8,192 rows (K = 64) Lloyd card vs CPU from the same k-means++
                indices, and the mined ids from the same centroids and
                offsets equal.
  9. embed   -- ResNet-50 eval forward at 224, bf16, batch 64: with the
                conv3x3 kernel and with those three convs sent to F.conv2d;
                bf16 on the card against f32 on the CPU.
 10. train parity -- one warmup step of ResNet-50 at 224, B=8, f32, on the
                card and on the CPU from identical weights, views and draws;
                then the same for ViT-B/16 with the S2R2 term, one SimCLR
                step (ResNet-50), one SupCon step (CIFAR-stem ResNet-18), and
                one MAE and one SimMIM step (ViT-B/16) from identical
                weights, view and mask, one DINOv2 and one MSN step at
                full width (every loss term, and DINOv2's centres), one
                BYOL and one DenseCL step (ResNet-50, every loss term), one
                SiameseIM step for each block norm and one SHAM v1 step in
                each mode (ViT-B/16, every loss term), and one DualViewHair
                step (ResNet-50) each of infonce, queue, multiscale + hybrid
                and partbased (every loss term, the queue's rows, the EMA).
                BYOL's prediction-head ReLU inputs whose sign the card and
                the CPU set apart are counted, and its CPU step is taken
                again from weights moved by 1e-7 and 1e-5 of themselves:
                how far that moves the gradient that differs most between
                card and CPU is printed beside the difference.
 11. dp     -- data parallelism: SHAM's ResNet-50 step at 224, bf16, B=64
                (phase 6's configuration) in each stage (warmup, mine,
                mined) and an f32 warmup step at B=16, without a process
                group and then through a one-rank NCCL group (the data-
                parallel code that runs at W ranks: global BN statistics,
                gathered NT-Xent views, negatives and mining features,
                global loss means, the coalesced gradient mean; NCCL takes
                one rank a card). The group's steps must launch exactly the
                kernels the steps without it launch (55 bn_stats, 1
                rotate, 3 conv3x3 a step, 6 in mine), issue all-gathers and
                all-reduces, and the f32 step must equal the step without a
                group at rtol 1e-5 (every metric, BN statistic and clipped
                gradient); both sets of steps timed (10 warmup and mined
                steps each). Then ShardedGalleryIndex over the 103,945 x
                768 gallery on the one-rank mesh against GalleryIndex at
                Q = 1 and 256, k=5: one top-k launch a search, the answer
                the plain twin's under the near-tie rule, both timed. Then
                one f32 step at 224, B=8, of DINOv2 (ViT-S/16, 65,536
                prototypes, 2 + 8 views; the LayerScale gammas drawn first
                so that KoLeo is not rounding noise), SiameseIM (ViT-B/16,
                PermuteBN decoder), SHAM on ViT-B/16 with S2R2 (warmup) and
                SimCLR with S2R2 (ResNet-50), SupCon (CIFAR-stem
                ResNet-18), MSN (ViT-B/16, 10 focal views), BYOL and
                DenseCL (ResNet-50), MAE, SimMIM and SHAM v1 in its
                reconstruction mode (ViT-B/16), each without a group and
                through the one-rank group: the same kernel launches (0;
                16 bn_stats; 1 rotate + 2 bn_stats; 55 bn_stats; 20; 4;
                55 bn_stats + 3 conv3x3; 53 + 3; none for the last three),
                the group's collectives called (the all-gathers exactly
                DP_RECIPES'), and the step equal at rtol 1e-5 (every
                metric, gradient, BN statistic, DINOv2's centres and
                DenseCL's banks and pointers). Then the dry run's
                tensor-parallel CosFace head (``cli.dryrun_multichip.
                part_tp``) over the one-rank mesh's ``model`` group, held
                against the unsharded head.
The last four lines are the card's name and power limit again, the serving
numbers of phases 4d and 4e as one JSON object, the kernels' JSON record
and ``{"ok": true, "device": {...}}``. Imports nothing of JAX.

With ``--bn-apply`` it runs phases 1, 2 and 3b only.

With ``--kernel-times [DIR]`` it only times the bn_stats, Conv2d, top-k and
rotate wrappers of the ``hairci_torch`` package under DIR (see
``kernel_times``).

With ``--ranks N`` (N cards or more) it runs phases 1-2 and then phase 11
on N cards, one NCCL rank a card (``_dp_rank``): SHAM and SimCLR on
ResNet-50 at 224, bf16, at the global B=256 split over the N ranks, and on
one card where it fits, each timed; the same for DINOv2 (B=128, its
config's), SiameseIM, SHAM on ViT-B/16 with S2R2, SimCLR with S2R2,
SupCon and MSN (B=128), BYOL, DenseCL, MAE, SimMIM and SHAM v1 (B=256);
the ranks' parameters equal after a step; the sharded search over N ranks
against GalleryIndex on one card; then ``python -m
hairci_torch.cli.dryrun_multichip`` on the N cards and on one. With
``--ranks N --profile`` SHAM's and SiameseIM's N-card steps are also
traced on rank 0 and timed at fewer intra-op threads a rank, beside a
traced one-card step at the same rows a rank (``_dp_profile``).
"""

from __future__ import annotations

import base64
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))
DATASET = os.path.join(REPO, "HairPretraining", "data", "hair_regions")
GALLERY_ROWS = 103_945   # the kNN gallery size of the README's benchmark
WIDTH = 768              # ViT-B/16 embedding width
FACE_WIDTH = 512         # ViT_face / ViTs_face embedding width
SEED = 0
TRAIN_BATCH = 64         # the SHAM step's batch on one card (config: 256)
SIZE = 224
KERNELS = ("topk", "rotate", "bn_stats", "conv3x3", "bn_apply")
KNN_BATCH = 64           # the embed batch of the full-width kNN phases
DV_BATCH = 32            # DualViewHair's CLI default batch
DV_WIDTH = 256           # DualViewHair's embedding width
CLI_BATCH = 48           # the batch the kNN CLI is driven at (pads a last one)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM: HBM3
# dense tensor-core bf16 and TF32; f32 FMAs outside the tensor cores
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}


def _bound(nbytes: float, flops: float, kind: str) -> tuple:
    """(least ms the card could take, what bounds it): the larger of the
    bytes over the memory rate and the operations over the peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _median_ms(fn, runs: int = 30, warmup: int = 5) -> float:
    """Median device time of ``fn`` over ``runs`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


BACK_TO_BACK = 50   # calls inside one event pair for a kernel's card time


def _host_ms(fn, n: int = BACK_TO_BACK, warmup: int = 5) -> float:
    """Median host time of one call of ``fn``: ``time.perf_counter`` round
    each of ``n`` calls, no synchronise inside. What the wrapper and the
    launch cost the thread that drives the card."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    times.sort()
    return times[len(times) // 2]


def _card_ms(fn, host_ms: float, n: int = BACK_TO_BACK) -> float:
    """The card's time for one call of ``fn``: ``n`` calls back to back
    inside one pair of CUDA events, divided by ``n``. The card first spins
    in a sleep kernel for longer than the host needs to enqueue all ``n``
    (``host_ms`` each), so it never waits for the host between two calls;
    that the host stayed ahead is checked (the start event has not been
    reached when the last call is enqueued; else the round is made again
    with a longer sleep). Two rounds, the lower one."""
    import torch

    best, rounds, spin = float("inf"), 0, 2.0 * n * host_ms + 2.0
    for attempt in range(6):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        # at most 2e6 cycles a ms at the card's clock
        torch.cuda._sleep(int(2e6 * spin))
        start.record()
        for _ in range(n):
            fn()
        ahead = not start.query()
        end.record()
        end.synchronize()
        if not ahead:       # the host was held up: spin longer, try again
            spin *= 2.0
            continue
        best = min(best, start.elapsed_time(end) / n)
        rounds += 1
        if rounds == 2:
            return best
    raise AssertionError("the card caught up with the host inside a "
                         "back-to-back timing, six times")


def _kernel_times(fn) -> tuple:
    """(the card's ms, the host's ms) of one call of a kernel's wrapper."""
    host = _host_ms(fn)
    return _card_ms(fn, host), host


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------

def _card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def phase_device() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    print(_card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------

def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    from hairci_torch.ops import _build

    with ThreadPoolExecutor(len(KERNELS)) as pool:
        built = list(pool.map(_build.build, KERNELS))
    for name, (path, seconds, log) in zip(KERNELS, built):
        print(f"build {name}: {seconds:.2f} s -> "
              f"{os.path.relpath(path, REPO)}")
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())
            if "registers" in line:
                _print_occupancy(entry, line)
    # the C++ batch image decoder (g++, libjpeg, libpng): the loaders take
    # it where it builds and PIL where it does not; the phases below check
    # that the route they took is that one
    from hairci_torch.native import imageio

    t0 = time.perf_counter()
    if imageio.available():
        print(f"build imageio: {time.perf_counter() - t0:.2f} s -> "
              f"{os.path.relpath(imageio.library_path(), REPO)}")
    else:
        print("build imageio: not built, the loaders decode with PIL: "
              + " | ".join(imageio.unavailable_reason().splitlines()[:6]))


# threads per block and dynamic shared memory of the kernels this script
# reports the occupancy of (csrc/conv3x3.cu, csrc/bn_stats.cu, and
# csrc/topk.cu's batched route for an f32 and a bf16 gallery)
OCCUPANCY_OF = {"conv3x3_mma_kernel": (256, 155648),
                "bn_stats_kernel": (256, 0),
                "bn_apply_kernel": (256, 0),
                "bn_grad_sums_kernel": (256, 0),
                "bn_grad_input_kernel": (256, 0),
                "topk_tc_kernelIf": (256, 206848),
                "topk_tc_kernelIt": (256, 178176)}


def _print_occupancy(entry: str, ptxas_line: str) -> None:
    """Blocks and warps an SM holds of a kernel, from ptxas' registers and
    static shared memory: 65,536 registers (a warp's are allotted in units of
    256), 233,472 bytes of shared memory less 1,024 a block, 2,048 threads."""
    import re

    found = [k for k in OCCUPANCY_OF if k in entry]
    regs = re.search(r"Used (\d+) registers", ptxas_line)
    if not found or not regs:
        return
    threads, dynamic = OCCUPANCY_OF[found[0]]
    smem = re.search(r"(\d+) bytes smem", ptxas_line)
    shared = dynamic + (int(smem.group(1)) if smem else 0)
    warps = threads // 32
    per_warp = -(-int(regs.group(1)) * 32 // 256) * 256
    blocks = min(65536 // (per_warp * warps), 233472 // (shared + 1024),
                 2048 // threads, 32)
    print(f"  occupancy: {blocks} blocks = {blocks * warps} warps an SM "
          f"({threads} threads, {regs.group(1)} registers, {shared} bytes of "
          f"shared memory a block)")


# ---------------------------------------------------------------------------
# phase 3: kernel against its twin
# ---------------------------------------------------------------------------

def _check_topk(q, g, k, atol, n_valid=None, exact=False,
                route=None) -> tuple:
    """Kernel against the twin on one input; returns the max score error and
    the route the search took. ``route``: the route ``plan`` must have
    chosen."""
    import torch

    from hairci_torch.ops.topk import (
        topk_gallery_search,
        topk_gallery_search_reference,
    )

    n = g.shape[0] if n_valid is None else n_valid
    before = dict(topk_gallery_search.routes)
    s, i = topk_gallery_search(q, g, k, n_valid=n_valid)
    torch.cuda.synchronize()
    took = [r for r, c in topk_gallery_search.routes.items()
            if c != before[r]]
    if route is not None and took != [route]:
        raise AssertionError(f"topk took {took}, not the {route} route "
                             f"(Q={q.shape[0]} D={q.shape[1]})")
    kk = min(k, n)
    rs, ri = topk_gallery_search_reference(q, g[:n], min(kk + 1, n))
    if s.shape != (q.shape[0], kk) or i.dtype != torch.int64:
        raise AssertionError(f"topk shape {tuple(s.shape)} {i.dtype}")
    err = (s - rs[:, :kk]).abs().max().item()
    if not err <= atol:
        raise AssertionError(f"topk scores differ by {err} > {atol} "
                             f"(Q={q.shape[0]} N={n} k={k} {g.dtype})")
    if exact:
        same = torch.equal(i, ri[:, :kk])
    else:
        # an index may differ only where the twin's neighbouring scores are
        # within 1e-5: the two sum in other orders
        inf = torch.full_like(rs[:, :1], float("inf"))
        prev = torch.cat([inf, rs[:, :-1] - rs[:, 1:]], 1)[:, :kk]
        nxt = torch.cat([rs[:, :-1] - rs[:, 1:], inf], 1)[:, :kk]
        clear = torch.minimum(prev, nxt) > 1e-5
        same = bool(((i == ri[:, :kk]) | ~clear).all())
    if not same:
        raise AssertionError(f"topk indices differ (Q={q.shape[0]} N={n} "
                             f"k={k} {g.dtype})")
    return err, took[0]


# queries timed, each on the route plan() takes: the serving path's single
# query, the batched route's threshold, and the TPU kernel's design point
TOPK_TIMED_Q = (1, 16, 64, 256)
# --kernel-times: the sweep the threshold was set from
TOPK_SWEEP_Q = (1, 4, 8, 16, 32, 64, 256)


def _topk_bound(Q: int, kind: str, route: str, width: int = WIDTH) -> tuple:
    """The least time of a route's work at Q x 103,945 x ``width``: gallery
    and queries read once, k = 5 scores and indices written; one f32 FMA per
    product (fma), or three tensor-core products (mma: TF32 for an f32
    gallery, bf16 for a bf16 one)."""
    nbytes = ((4 if kind == "f32" else 2) * GALLERY_ROWS * width
              + 4 * Q * width + Q * 5 * 12)
    flops = 2.0 * Q * GALLERY_ROWS * width
    if route == "fma":
        return _bound(nbytes, flops, "f32")
    return _bound(nbytes, 3 * flops, "tf32" if kind == "f32" else "bf16")


def phase_topk() -> dict:
    import torch

    from hairci_torch.ops.topk import (
        BATCHED_MIN_Q,
        topk_gallery_search,
        topk_gallery_search_reference,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def unit(n, d=WIDTH):
        x = torch.randn(n, d, device=dev, generator=gen)
        return x / x.norm(dim=1, keepdim=True)

    def near(g, Q):
        # queries near gallery rows, so each has a clear nearest neighbour
        rows = torch.randint(0, g.shape[0], (Q,), device=dev, generator=gen)
        q = g[rows] + 0.3 * unit(Q, g.shape[1]) / g.shape[1] ** 0.5
        return (q / q.norm(dim=1, keepdim=True)).contiguous()

    g32 = unit(GALLERY_ROWS)
    galleries = {"f32": (g32, 1e-5), "bf16": (g32.bfloat16(), 1e-4)}
    max_err = {(r, name): 0.0 for r in ("fma", "mma") for name in galleries}

    def check(name, *args, **kw):
        err, took = _check_topk(*args, **kw)
        max_err[(took, name)] = max(max_err[(took, name)], err)

    for Q in (1, 256):
        q = near(g32, Q)
        for name, (g, atol) in galleries.items():
            for k in (1, 5, 8, 16):
                check(name, q, g, k, atol)
            check(name, q, g, 5, atol, n_valid=GALLERY_ROWS - 1000)
    # exact ties: rows i and i + half are equal, the lower index must win
    half = unit(2048)
    dup = torch.cat([half, half]).contiguous()
    _check_topk(half[:64].contiguous(), dup, 4, 1e-5, exact=True)
    _, i = topk_gallery_search(half[:64].contiguous(), dup, 2)
    want = torch.arange(64, device=dev)
    if not (torch.equal(i[:, 0], want) and torch.equal(i[:, 1], want + 2048)):
        raise AssertionError("topk tie order: the lower index must win")
    # fewer rows than k
    _check_topk(unit(4), unit(3), 8, 1e-5, exact=True)

    # the batched route's edges: Q at the threshold and just below it, a
    # ragged n_valid, fewer rows than k, D = 96 (a K slice and a zero-filled
    # half) and D = 45 (not a 16-byte multiple: the fma route), ties in a
    # bf16 gallery
    for name, (g, atol) in galleries.items():
        for Q, route in ((BATCHED_MIN_Q, "mma"), (BATCHED_MIN_Q - 1, "fma"),
                         (300, "mma")):
            check(name, near(g32, Q), g, 8, atol, route=route)
        check(name, near(g32, 256), g, 16, atol,
              n_valid=GALLERY_ROWS // 2 + 1, route="mma")
        dtype = g.dtype
        _check_topk(unit(BATCHED_MIN_Q), unit(5).to(dtype), 8, atol,
                    exact=True, route="mma")
        _check_topk(unit(130), unit(200).to(dtype), 16, atol, route="mma")
        for D, route in ((96, "mma"), (45, "fma")):
            small = unit(20_000, D).to(dtype)
            check(name, near(small.float(), 256), small, 5, atol, route=route)
        dup16 = dup.to(dtype)
        _check_topk(half[:256].contiguous(), dup16, 4, atol, exact=True,
                    route="mma")
        _, i = topk_gallery_search(half[:256].contiguous(), dup16, 2)
        want = torch.arange(256, device=dev)
        if not (torch.equal(i[:, 0], want)
                and torch.equal(i[:, 1], want + 2048)):
            raise AssertionError(f"topk tie order at Q=256 {name}: the lower "
                                 "index must win")
    print(f"topk vs twin: ok (both routes, threshold Q={BATCHED_MIN_Q}); max "
          "|score err| " + ", ".join(f"{r} {name} {e:.3g}"
                                     for (r, name), e in max_err.items()))

    times = {}
    for Q in TOPK_TIMED_Q:
        q = unit(Q)
        for name, (g, _) in galleries.items():
            twin = _median_ms(lambda: topk_gallery_search_reference(q, g, 5),
                              runs=15)
            before = dict(topk_gallery_search.routes)
            kern, host = _kernel_times(lambda: topk_gallery_search(q, g, 5))
            route, = [r for r, c in topk_gallery_search.routes.items()
                      if c != before[r]]
            bound = _topk_bound(Q, name, route)
            times[(Q, name)] = (kern, twin, host, bound, route)
            print(f"topk Q={Q} N={GALLERY_ROWS} D={WIDTH} k=5 {name}, "
                  f"{route} route: {kern:.4f} ms on the card "
                  f"({BACK_TO_BACK} calls back to back, "
                  f"{100 * bound[0] / kern:.1f} % of its bound "
                  f"{bound[0]:.4f} ms by {bound[1]}), {host:.4f} ms on "
                  f"the host; twin {twin:.4f} ms")
    del g32, galleries

    # the face encoder's width: 103,945 x 512, a single query (fma) and a
    # batched /search (mma), each held against the twin and timed
    g512 = unit(GALLERY_ROWS, FACE_WIDTH)
    face = {"f32": (g512, 1e-5), "bf16": (g512.bfloat16(), 1e-4)}
    face_err = {(r, name): 0.0 for r in ("fma", "mma") for name in face}
    face_times = {}
    for Q, route in ((1, "fma"), (256, "mma")):
        q = near(g512, Q)
        for name, (g, atol) in face.items():
            for k in (1, 5, 8):
                err, _ = _check_topk(q, g, k, atol, route=route)
                face_err[(route, name)] = max(face_err[(route, name)], err)
            twin = _median_ms(lambda: topk_gallery_search_reference(q, g, 5),
                              runs=15)
            kern, host = _kernel_times(lambda: topk_gallery_search(q, g, 5))
            bound = _topk_bound(Q, name, route, FACE_WIDTH)
            face_times[(Q, name)] = (kern, twin, host, bound, route)
            print(f"topk Q={Q} N={GALLERY_ROWS} D={FACE_WIDTH} k=5 {name}, "
                  f"{route} route: {kern:.4f} ms on the card "
                  f"({100 * bound[0] / kern:.1f} % of its bound "
                  f"{bound[0]:.4f} ms by {bound[1]}), {host:.4f} ms on the "
                  f"host; twin {twin:.4f} ms; max |score err| "
                  f"{face_err[(route, name)]:.3g}")
    del g512, face
    # DualViewHair's embedding width, 103,945 x 256 f32: a single query
    # (fma) and a batched one (mma), held against the twin and timed
    g256 = unit(GALLERY_ROWS, DV_WIDTH)
    d256_err, d256_times = {"fma": 0.0, "mma": 0.0}, {}
    for Q, route in ((1, "fma"), (256, "mma")):
        q = near(g256, Q)
        for k in (1, 5, 8):
            err, _ = _check_topk(q, g256, k, 1e-5, route=route)
            d256_err[route] = max(d256_err[route], err)
        twin = _median_ms(lambda: topk_gallery_search_reference(q, g256, 5),
                          runs=15)
        kern, host = _kernel_times(lambda: topk_gallery_search(q, g256, 5))
        bound = _topk_bound(Q, "f32", route, DV_WIDTH)
        d256_times[Q] = (kern, twin, host, bound, route)
        print(f"topk Q={Q} N={GALLERY_ROWS} D={DV_WIDTH} k=5 f32, {route} "
              f"route: {kern:.4f} ms on the card ({100 * bound[0] / kern:.1f}"
              f" % of its bound {bound[0]:.4f} ms by {bound[1]}), "
              f"{host:.4f} ms on the host; twin {twin:.4f} ms; max |score "
              f"err| {d256_err[route]:.3g}")
    del g256
    torch.cuda.empty_cache()
    return {"max_abs_err": max_err, "times": times, "face_err": face_err,
            "face_times": face_times, "d256_err": d256_err,
            "d256_times": d256_times}


def resnet50_bn_shapes(rows: int, size: int) -> list:
    """(M, C, count) of every train-mode BN of a ResNet-50 forward over
    ``rows`` images of ``size`` px, in the order of the trunk."""
    out, hw = [], size // 2
    out.append((rows * hw * hw, 64, 1))                  # stem
    hw //= 2                                             # max pool
    for i, blocks in enumerate((3, 4, 6, 3)):
        f = 64 * 2 ** i
        for j in range(blocks):
            out.append((rows * hw * hw, f, 1))           # bn1, before stride
            if i > 0 and j == 0:
                hw //= 2
            out.append((rows * hw * hw, f, 1))           # bn2
            out.append((rows * hw * hw, 4 * f, 1))       # bn3
            if j == 0:
                out.append((rows * hw * hw, 4 * f, 1))   # downsample
    shapes = {}
    for m, c, n in out:
        shapes[(m, c)] = shapes.get((m, c), 0) + n
    return [(m, c, n) for (m, c), n in shapes.items()]


def siameseim_bn_shapes(batch: int) -> list:
    """(rows, 512, launches) of the f32 PermuteBN inputs of one SiameseIM
    step at ``batch``: the projector's 2 blocks x 2 norms over cls + the
    kept 40 % of the tokens, the predictor's 4 x 2 over those + all
    tokens, the momentum projector's 2 x 2 over cls + all tokens."""
    n = (SIZE // 16) ** 2
    keep = 1 + int(n * (1 - 0.6))
    return [(batch * keep, 512, 4), (batch * (keep + n), 512, 8),
            (batch * (1 + n), 512, 4)]


def resnet18_cifar_bn_shapes(rows: int, size: int) -> list:
    """(M, C, count) of every train-mode BN of a CIFAR-stem ResNet-18
    forward (SupCon's encoder: a 3x3/1 stem and no max pool, so layer1 runs
    at the full ``size``) over ``rows`` images."""
    out, hw = [(rows * size * size, 64, 1)], size          # stem
    for i in range(4):
        f = 64 * 2 ** i
        for j in range(2):
            if i > 0 and j == 0:
                hw //= 2                # BasicBlock strides on conv1
                out.append((rows * hw * hw, f, 1))         # downsample
            out.append((rows * hw * hw, f, 2))             # bn1, bn2
    shapes = {}
    for m, c, n in out:
        shapes[(m, c)] = shapes.get((m, c), 0) + n
    return [(m, c, n) for (m, c), n in shapes.items()]


# the shapes the rotate kernel's band tiling cares about, both routes, as in
# tests/test_torch_rotate.py: (B, H, W, C, max_degrees, fill)
ROTATE_ODD = ((5, 33, 31, 3, 15.0, 0.0), (7, 32, 32, 1, 15.0, 0.0),
              (7, 17, 15, 4, 15.0, -1.0), (7, 5, 12, 3, 15.0, 0.0),
              (7, 40, 6, 3, 45.0, 0.5), (7, 9, 7, 5, 15.0, 0.0),
              (7, 3, 2, 1, 45.0, -1.0))


def _step_view(gen, B: int):
    """The positive view the SHAM step hands to ``positive_transform``: the
    port's SimCLR view of a uint8 batch on the card, in the strides its last
    op left."""
    import torch

    from hairci_torch.aug.pipelines import simclr_transform

    view = simclr_transform(SIZE).views[0]
    images = torch.randint(0, 256, (B, SIZE + 32, SIZE + 32, 3),
                           dtype=torch.uint8, device="cuda", generator=gen)
    cpu_gen = torch.Generator().manual_seed(SEED)
    return view.apply(images, view.draw(cpu_gen, B, SIZE + 32, SIZE + 32))


def _check_rotate(x, theta, sigma, max_degrees, fill=0.0) -> dict:
    """The kernel against the twin on both routes: bitwise without the blur,
    within 2e-6 with it. Returns each route's max |error|."""
    import torch

    from hairci_torch.ops.rotate import rotate_shear, rotate_shear_reference

    err = {}
    for key, blur in (("plain", None), ("blur", sigma)):
        got = rotate_shear(x, theta, fill, max_degrees, blur)
        want = rotate_shear_reference(x, theta, fill, max_degrees, blur)
        torch.cuda.synchronize()
        err[key] = (got - want).abs().max().item()
        shape = tuple(x.shape)
        if blur is None and not torch.equal(got, want):
            raise AssertionError(f"rotate differs from its twin at {shape}, "
                                 f"strides {x.stride()}: {err[key]}")
        if not err[key] <= 2e-6:
            raise AssertionError(f"rotate+blur differs by {err[key]} > 2e-6 "
                                 f"at {shape}, strides {x.stride()}")
    return err


def phase_rotate() -> dict:
    import torch

    from hairci_torch.aug.pipelines import positive_transform
    from hairci_torch.ops.rotate import rotate_shear, rotate_shear_reference

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    B = TRAIN_BATCH
    x = torch.randn(B, SIZE, SIZE, 3, device=dev, generator=gen)
    # the +-15 degree grid, extremes included, and -2 atan(1/8): an exact
    # half shift at odd heights
    theta = torch.linspace(-15, 15, B, device=dev) * (math.pi / 180)
    theta[B // 2] = -0.24870999
    sigma = torch.rand(B, device=dev, generator=gen) * 0.4 + 0.1
    err = _check_rotate(x, theta, sigma, 15.0)
    for b, h, w, c, max_deg, fill in ROTATE_ODD:
        xo = torch.randn(b, h, w, c, device=dev, generator=gen)
        m = max_deg * math.pi / 180
        to = (torch.rand(b, device=dev, generator=gen) * 2 - 1) * m
        to[:4] = torch.tensor([m, -0.24870999, -1.5 * m, 2.0 * m])
        so = torch.rand(b, device=dev, generator=gen) * 0.4 + 0.1
        for xin in (xo, xo.permute(0, 3, 1, 2).contiguous().permute(
                0, 2, 3, 1)):
            for key, e in _check_rotate(xin, to, so, max_deg, fill).items():
                err[key] = max(err[key], e)
    print(f"rotate vs twin at {len(ROTATE_ODD)} odd shapes, contiguous and "
          f"in NCHW order: ok")
    # the step's own input: the SimCLR view, strided as the step sees it
    xv = _step_view(gen, B)
    print(f"rotate input of the step (SimCLR view at {SIZE}): shape "
          f"{tuple(xv.shape)} strides {xv.stride()} contiguous "
          f"{xv.is_contiguous()}")
    for key, e in _check_rotate(xv, theta, sigma, 15.0).items():
        err[key] = max(err[key], e)
    times = {}
    for key, blur in (("plain", None), ("blur", sigma)):
        kern, host = _kernel_times(lambda: rotate_shear(
            x, theta, max_degrees=15.0, blur_sigma=blur))
        twin = _median_ms(lambda: rotate_shear_reference(
            x, theta, max_degrees=15.0, blur_sigma=blur))
        times[key] = (kern, twin, host)
    # with the blur: the batch read and written once, angles and sigmas read;
    # per value two 3-tap passes of 5 operations each. Without: no arithmetic
    bounds = {"plain": _bound(2 * x.numel() * 4 + B * 4, 0.0, "f32"),
              "blur": _bound(2 * x.numel() * 4 + 2 * B * 4,
                             10.0 * x.numel(), "f32")}
    for key, (kern, twin, host) in times.items():
        bound = bounds[key]
        print(f"rotate {B}x{SIZE}x{SIZE}x3 f32 {key}: kernel {kern:.4f} ms "
              f"on the card ({100 * bound[0] / kern:.1f} % of its bound "
              f"{bound[0]:.4f} ms by {bound[1]}), {host:.4f} ms on the host; "
              f"twin {twin:.4f} ms, max |err| {err[key]:.3g}")
    clone_ms = _kernel_times(lambda: x.clone())[0]
    print(f"the same bytes moved by a copy (torch clone of the batch, no "
          f"rotation): {clone_ms:.4f} ms on the card")
    d = {"theta": theta, "sigma": sigma}
    step_ms = _kernel_times(lambda: positive_transform(xv, d))
    copy_ms = _kernel_times(lambda: xv.contiguous())
    print(f"positive_transform on the step's strided view: {step_ms[0]:.4f} "
          f"ms on the card, {step_ms[1]:.4f} ms on the host; the contiguous "
          f"copy it no longer makes ({2 * xv.numel() * 4 / 1e6:.1f} MB "
          f"moved): {copy_ms[0]:.4f} ms on the card")
    print("rotate vs twin: ok (bitwise without blur)")
    return {"max_abs_err": max(err.values()), "times": times,
            "bound": bounds["blur"], "bounds": bounds}


def _check_bn(x, atol_mean, atol_var) -> float:
    import torch

    from hairci_torch.ops.bn_stats import bn_stats, bn_stats_reference

    s, q = bn_stats(x)
    rs, rq = bn_stats_reference(x)
    torch.cuda.synchronize()
    n = x.shape[0]
    mean, rmean = s / n, rs / n
    var, rvar = q / n - mean * mean, rq / n - rmean * rmean
    # the tolerances of tools/bn_stats_bench.py:122-125
    if not (torch.allclose(mean, rmean, rtol=1e-4, atol=atol_mean)
            and torch.allclose(var, rvar, rtol=1e-3, atol=atol_var)):
        raise AssertionError(f"bn_stats differs from its twin at "
                             f"{tuple(x.shape)} {x.dtype}")
    # one launch whose last block adds in index order: the same bits again
    for _ in range(2):
        s2, q2 = bn_stats(x)
        if not (torch.equal(s, s2) and torch.equal(q, q2)):
            raise AssertionError(f"bn_stats differs from run to run at "
                                 f"{tuple(x.shape)} {x.dtype}")
    return max((mean - rmean).abs().max().item(),
               (var - rvar).abs().max().item())


def _var_mean_ms(x) -> float:
    """The card's ms of ``torch.var_mean(x, dim=0, correction=0)``, timed
    as a kernel: the one PyTorch call that computes the TPU kernel's
    function (per-channel mean and biased variance,
    ``tools/bn_stats_bench.py:55-58``) on an f32 (M, C) input; timed here,
    used nowhere in the port."""
    import torch

    return _kernel_times(lambda: torch.var_mean(x, dim=0, correction=0))[0]


def phase_bn_stats() -> dict:
    import torch

    from hairci_torch.ops.bn_stats import (
        bn_stats,
        bn_stats_reference,
        plan,
        vector_width,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def blocks(x):
        vec = vector_width(x.shape[1], x.element_size(), x.data_ptr())
        log_tg, splits, _ = plan(x.shape[0], x.shape[1], vec, sms)
        tiles = -(-x.shape[1] // (vec << log_tg))
        return (f"{tiles} x {splits} blocks of {256 >> log_tg} row lanes x "
                f"{1 << log_tg} groups of {vec}")

    tool = torch.randn(512 * 56 * 56, 256, device=dev,
                       generator=gen).bfloat16()
    err = _check_bn(tool, 1e-4, 1e-3)
    tool_k, tool_h = _kernel_times(lambda: bn_stats(tool))
    tool_t = _median_ms(lambda: bn_stats_reference(tool))
    print(f"bn_stats {tuple(tool.shape)} bf16 (the tool's shape), "
          f"{blocks(tool)}: kernel {tool_k:.4f} ms on the card "
          f"({tool.numel() * 2 / tool_k / 1e6:.0f} GB/s), {tool_h:.4f} ms on "
          f"the host; twin {tool_t:.4f} ms")
    del tool
    # f32 and inputs that rule out 16-byte loads, against the twin
    for m, c, dtype in ((37632, 256, torch.float32),
                        (192, 2048, torch.float32),
                        (1000, 7, torch.bfloat16), (5000, 24, torch.float32)):
        x = (torch.randn(m, c, device=dev, generator=gen) * 2 + 1).to(dtype)
        err = max(err, _check_bn(x, 1e-4, 1e-3))
    odd = torch.randn(64 * 32 + 1, device=dev, generator=gen)[1:].view(64, 32)
    _check_bn(odd, 1e-4, 1e-3)      # a pointer off the 16-byte grid
    rows = 3 * TRAIN_BATCH
    step_k = step_h = step_t = 0.0
    # the trunk's and the head's BN inputs are all bf16 in the bf16 run
    shapes = [(m, c, n, torch.bfloat16)
              for m, c, n in resnet50_bn_shapes(rows, SIZE)]
    shapes += [(rows, 2048, 1, torch.bfloat16),
               (rows, 1024, 1, torch.bfloat16)]
    for m, c, n, dtype in shapes:
        x = (torch.randn(m, c, device=dev, generator=gen) * 2 + 1).to(dtype)
        err = max(err, _check_bn(x, 1e-4, 1e-3))
        kern, host = _kernel_times(lambda: bn_stats(x))
        twin = _median_ms(lambda: bn_stats_reference(x), runs=20)
        step_k += n * kern
        step_h += n * host
        step_t += n * twin
        floor = m * c * 2 / HBM_BYTES_PER_S * 1e3
        print(f"bn_stats ({m}, {c}) {str(dtype)[6:]} x{n} per forward, "
              f"{blocks(x)}: kernel {kern:.4f} ms on the card (bound "
              f"{floor:.4f}), {host:.4f} ms on the host; twin {twin:.4f} ms")
    count = sum(n for *_, n, _ in shapes)
    print(f"bn_stats, the {count} train-mode BNs of one ResNet-50 SHAM "
          f"forward at {rows} rows ({len(shapes)} shapes), {BACK_TO_BACK} "
          f"calls back to back per shape: kernel {step_k:.3f} ms on the card,"
          f" {step_h:.3f} ms on the host ({1e3 * step_h / count:.1f} us a "
          f"call); twin {step_t:.3f} ms; vs twin and run to run: ok, max "
          f"|err| {err:.3g}")
    torch.cuda.empty_cache()
    # one forward's BN inputs read once (bf16), two f32 vectors written per
    # launch; an add and a fused multiply-add per value
    values = sum(n * m * c for m, c, n, _ in shapes)
    bound = _bound(2 * values + sum(n * 8 * c for _, c, n, _ in shapes),
                   3.0 * values, "f32")
    # the two train-mode BNs of the ViT-B/16 SHAM head, bf16, 3B rows
    from hairci_torch.ssl.sham import _PROJ_DIMS

    vit = [(rows, c) for c in _PROJ_DIMS["vit_b_16"][1:]]
    vit_k = vit_h = vit_t = 0.0
    for m, c in vit:
        x = (torch.randn(m, c, device=dev, generator=gen) * 2
             + 1).bfloat16()
        err = max(err, _check_bn(x, 1e-4, 1e-3))
        kern, host = _kernel_times(lambda: bn_stats(x))
        twin = _median_ms(lambda: bn_stats_reference(x), runs=20)
        vit_k, vit_h, vit_t = vit_k + kern, vit_h + host, vit_t + twin
        print(f"bn_stats ({m}, {c}) bf16, ViT SHAM head, {blocks(x)}: "
              f"kernel {kern:.4f} ms on the card, {host:.4f} ms on the host; "
              f"twin {twin:.4f} ms")
    values = sum(m * c for m, c in vit)
    vit_bound = _bound(2 * values + sum(8 * c for _, c in vit),
                       3.0 * values, "f32")
    print(f"bn_stats, the 2 train-mode BNs of one ViT-B/16 SHAM forward at "
          f"{rows} rows: kernel {vit_k:.4f} ms on the card (bound "
          f"{vit_bound[0]:.5f} by {vit_bound[1]}), {vit_h:.4f} ms on the "
          f"host; twin {vit_t:.4f} ms")
    # the 20 train-mode BNs of one SupCon forward: the CIFAR-stem ResNet-18
    # over both views (2B rows), layer1 at 224 x 224
    sc_rows = 2 * TRAIN_BATCH
    sc = resnet18_cifar_bn_shapes(sc_rows, SIZE)
    sc_k = sc_h = sc_t = 0.0
    for m, c, n in sc:
        x = (torch.randn(m, c, device=dev, generator=gen) * 2
             + 1).bfloat16()
        err = max(err, _check_bn(x, 1e-4, 1e-3))
        kern, host = _kernel_times(lambda: bn_stats(x))
        twin = _median_ms(lambda: bn_stats_reference(x), runs=20)
        sc_k, sc_h, sc_t = sc_k + n * kern, sc_h + n * host, sc_t + n * twin
        floor = m * c * 2 / HBM_BYTES_PER_S * 1e3
        print(f"bn_stats ({m}, {c}) bf16 x{n} per SupCon forward, "
              f"{blocks(x)}: kernel {kern:.4f} ms on the card (bound "
              f"{floor:.4f}, {100 * floor / kern:.1f} %), {host:.4f} ms on the"
              f" host; twin {twin:.4f} ms")
        del x
    count = sum(n for *_, n in sc)
    values = sum(n * m * c for m, c, n in sc)
    sc_bound = _bound(2 * values + sum(n * 8 * c for _, c, n in sc),
                      3.0 * values, "f32")
    print(f"bn_stats, the {count} train-mode BNs of one SupCon forward "
          f"(CIFAR-stem ResNet-18 at {SIZE}, {sc_rows} rows, "
          f"{values * 2 / 1e9:.2f} GB): kernel {sc_k:.3f} ms on the card "
          f"({100 * sc_bound[0] / sc_k:.1f} % of the bound {sc_bound[0]:.3f} "
          f"ms by {sc_bound[1]}), {sc_h:.3f} ms on the host; twin {sc_t:.3f} "
          f"ms; vs twin and run to run: ok")
    torch.cuda.empty_cache()
    # MSN's head: its two train-mode BNs over the anchors (B rows) and over
    # the 10 focal views (10B rows), bf16: 4 launches a step
    msn = [(TRAIN_BATCH, 2048), (10 * TRAIN_BATCH, 2048)]
    msn_k = msn_h = msn_t = 0.0
    for m, c in msn:
        x = (torch.randn(m, c, device=dev, generator=gen) * 2
             + 1).bfloat16()
        err = max(err, _check_bn(x, 1e-4, 1e-3))
        kern, host = _kernel_times(lambda: bn_stats(x))
        twin = _median_ms(lambda: bn_stats_reference(x), runs=20)
        msn_k, msn_h, msn_t = (msn_k + 2 * kern, msn_h + 2 * host,
                               msn_t + 2 * twin)
        print(f"bn_stats ({m}, {c}) bf16 x2 per MSN step, {blocks(x)}: "
              f"kernel {kern:.4f} ms on the card, {host:.4f} ms on the host; "
              f"twin {twin:.4f} ms")
    values = sum(2 * m * c for m, c in msn)
    msn_bound = _bound(2 * values + sum(2 * 8 * c for _, c in msn),
                       3.0 * values, "f32")
    print(f"bn_stats, the 4 train-mode BNs of one MSN step (ViT-B/16 head at "
          f"{TRAIN_BATCH} + {10 * TRAIN_BATCH} rows): kernel {msn_k:.4f} ms "
          f"on the card (bound {msn_bound[0]:.5f} by {msn_bound[1]}), "
          f"{msn_h:.4f} ms on the host; twin {msn_t:.4f} ms")
    # BYOL's heads: the projection and the prediction head's 4096-wide BNs
    # over both views (2B rows), bf16, timed at B=64 and checked at the CLI
    # run's B=48; then the ResNet-50 trunk's BN inputs at the rows the BYOL
    # (2 x 48) and DenseCL (48) CLI runs give them, checked
    byol_k = byol_h = byol_t = 0.0
    for m in (2 * TRAIN_BATCH, 2 * CLI_BATCH):
        x = (torch.randn(m, 4096, device=dev, generator=gen) * 2
             + 1).bfloat16()
        err = max(err, _check_bn(x, 1e-4, 1e-3))
        if m != 2 * TRAIN_BATCH:
            continue
        kern, host = _kernel_times(lambda: bn_stats(x))
        twin = _median_ms(lambda: bn_stats_reference(x), runs=20)
        byol_k, byol_h, byol_t = 2 * kern, 2 * host, 2 * twin
        print(f"bn_stats ({m}, 4096) bf16 x2 per BYOL step, {blocks(x)}: "
              f"kernel {kern:.4f} ms on the card, {host:.4f} ms on the host; "
              f"twin {twin:.4f} ms")
    values = 2 * 2 * TRAIN_BATCH * 4096
    byol_bound = _bound(2 * values + 2 * 8 * 4096, 3.0 * values, "f32")
    print(f"bn_stats, the 2 head BNs of one BYOL step ({2 * TRAIN_BATCH} "
          f"rows): kernel {byol_k:.4f} ms on the card (bound "
          f"{byol_bound[0]:.5f} by {byol_bound[1]}), {byol_h:.4f} ms on the "
          f"host; twin {byol_t:.4f} ms")
    for rows in (2 * CLI_BATCH, CLI_BATCH):
        for m, c, _ in resnet50_bn_shapes(rows, SIZE):
            x = (torch.randn(m, c, device=dev, generator=gen) * 2
                 + 1).bfloat16()
            err = max(err, _check_bn(x, 1e-4, 1e-3))
            del x
    print(f"bn_stats at the ResNet-50 trunk's 14 BN shapes at "
          f"{2 * CLI_BATCH} rows (BYOL's CLI run) and {CLI_BATCH} (DenseCL's)"
          f": vs twin and run to run: ok, max |err| {err:.3g}")
    torch.cuda.empty_cache()
    # SiameseIM's PermuteBNs: f32 (rows, 512) over the batch's tokens, 16
    # launches a step (siameseim_bn_shapes); timed at B=64, checked at the
    # CLI run's B=48
    siam = siameseim_bn_shapes(TRAIN_BATCH)
    siam_k = siam_h = siam_t = siam_l = 0.0
    for m, c, n in siam + siameseim_bn_shapes(CLI_BATCH):
        x = torch.randn(m, c, device=dev, generator=gen) * 2 + 1
        err = max(err, _check_bn(x, 1e-4, 1e-3))
        if (m, c, n) not in siam:
            continue
        kern, host = _kernel_times(lambda: bn_stats(x))
        twin = _median_ms(lambda: bn_stats_reference(x), runs=20)
        lib = _var_mean_ms(x)
        siam_k, siam_h, siam_t, siam_l = (
            siam_k + n * kern, siam_h + n * host, siam_t + n * twin,
            siam_l + n * lib)
        floor = m * c * 4 / HBM_BYTES_PER_S * 1e3
        print(f"bn_stats ({m}, {c}) f32 x{n} per SiameseIM step, "
              f"{blocks(x)}: kernel {kern:.4f} ms on the card (bound "
              f"{floor:.4f}, {100 * floor / kern:.1f} %), {host:.4f} ms on "
              f"the host; twin {twin:.4f} ms; torch.var_mean {lib:.4f} ms "
              "on the card")
    values = sum(n * m * c for m, c, n in siam)
    siam_bound = _bound(4 * values + sum(n * 8 * c for _, c, n in siam),
                        3.0 * values, "f32")
    print(f"bn_stats, the 16 PermuteBNs of one SiameseIM step (B="
          f"{TRAIN_BATCH}, {4 * values / 1e6:.0f} MB of f32): kernel "
          f"{siam_k:.4f} ms on the card (bound {siam_bound[0]:.4f} by "
          f"{siam_bound[1]}), {siam_h:.4f} ms on the host; twin "
          f"{siam_t:.4f} ms; torch.var_mean {siam_l:.4f} ms on the card; at "
          f"B={CLI_BATCH} too: vs twin and run to run: ok")
    torch.cuda.empty_cache()
    # DualViewHair's student: the ResNet-50 trunk's 53 train-mode BN inputs
    # and the head's 3 ((32, 256) x 2, (32, 128)) at the CLI's B=32, all
    # f32: 56 launches a step
    dv = resnet50_bn_shapes(DV_BATCH, SIZE) + [(DV_BATCH, 256, 2),
                                               (DV_BATCH, 128, 1)]
    dv_k = dv_h = dv_t = dv_l = 0.0
    for m, c, n in dv:
        x = torch.randn(m, c, device=dev, generator=gen) * 2 + 1
        err = max(err, _check_bn(x, 1e-4, 1e-3))
        kern, host = _kernel_times(lambda: bn_stats(x))
        twin = _median_ms(lambda: bn_stats_reference(x), runs=20)
        dv_k, dv_h, dv_t = dv_k + n * kern, dv_h + n * host, dv_t + n * twin
        dv_l += n * _var_mean_ms(x)
        del x
    count = sum(n for *_, n in dv)
    values = sum(n * m * c for m, c, n in dv)
    dv_bound = _bound(4 * values + sum(n * 8 * c for _, c, n in dv),
                      3.0 * values, "f32")
    print(f"bn_stats, the {count} train-mode BNs of one DualViewHair student "
          f"forward (ResNet-50 + head at {DV_BATCH} rows, f32, "
          f"{4 * values / 1e9:.2f} GB): kernel {dv_k:.3f} ms on the card "
          f"({100 * dv_bound[0] / dv_k:.1f} % of the bound {dv_bound[0]:.3f} "
          f"ms by {dv_bound[1]}), {dv_h:.3f} ms on the host; twin {dv_t:.3f} "
          f"ms; torch.var_mean {dv_l:.3f} ms on the card; vs twin and run to "
          f"run: ok")
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "step": (step_k, step_t, step_h),
            "dualview_step": (dv_k, dv_t, dv_h), "dualview_bound": dv_bound,
            "siameseim_step": (siam_k, siam_t, siam_h),
            "siameseim_library_ms": siam_l, "dualview_library_ms": dv_l,
            "siameseim_bound": siam_bound,
            "msn_step": (msn_k, msn_t, msn_h), "msn_bound": msn_bound,
            "byol_step": (byol_k, byol_t, byol_h), "byol_bound": byol_bound,
            "tool": (tool_k, tool_t, tool_h), "bound": bound,
            "vit_step": (vit_k, vit_t, vit_h), "vit_bound": vit_bound,
            "supcon_step": (sc_k, sc_t, sc_h), "supcon_bound": sc_bound}


def _conv_inputs(gen, B, H, W, cin, cout, dtype, bias=True):
    """x ~ N(0, 1) channels_last, w ~ 0.05 N(0, 1) (the TPU tool's data) and
    a non-zero bias."""
    import torch

    dev = torch.device("cuda")
    x = torch.randn(B, H, W, cin, device=dev, generator=gen).to(dtype)
    w = 0.05 * torch.randn(cout, cin, 3, 3, device=dev, generator=gen)
    b = 0.1 * torch.randn(cout, device=dev, generator=gen) if bias else None
    return x.permute(0, 3, 1, 2), w, b


def _check_conv(x, w, b, stats) -> dict:
    """Kernel against the twin on one input. f32: |err| <= 1e-5 max|ref|
    (two f32 summation orders over 9 * Cin terms). bf16: each output within
    one bf16 ulp of the twin's (|err| <= 2^-7 |ref| + 1e-6 max|ref|) and at
    least 99.9 % of them bitwise equal (both round one f32 sum; they differ
    only where the two sums straddle a rounding boundary). Sums: rtol 1e-5,
    with atol 1e-5 of the largest channel's."""
    import torch

    from hairci_torch.ops.conv3x3 import conv3x3, conv3x3_reference

    got = conv3x3(x, w, b, stats=stats)
    want = conv3x3_reference(x, w, b, stats=stats)
    torch.cuda.synchronize()
    y, ref = (got[0], want[0]) if stats else (got, want)
    tag = f"{tuple(x.shape)} -> {w.shape[0]} {str(x.dtype)[6:]}"
    if (y.shape != ref.shape or y.dtype != x.dtype or not y.is_contiguous(
            memory_format=torch.channels_last)):
        raise AssertionError(f"conv3x3 output {tuple(y.shape)} {y.dtype} "
                             f"strides {y.stride()} at {tag}")
    diff = (y.float() - ref.float()).abs()
    top = ref.float().abs().max().item()
    err = diff.max().item()
    equal = (y == ref).float().mean().item()
    if x.dtype == torch.float32:
        ok = err <= 1e-5 * top
    else:
        ok = bool((diff <= 2.0 ** -7 * ref.float().abs() + 1e-6 * top).all()
                  ) and equal >= 0.999
    if not ok:
        raise AssertionError(f"conv3x3 differs from its twin at {tag}: max "
                             f"|err| {err:.3g} of {top:.3g}, {100 * equal:.4f}"
                             " % bitwise equal")
    if stats:
        for name, a, r in (("sum", got[1], want[1]), ("sumsq", got[2],
                                                      want[2])):
            if not torch.allclose(a, r, rtol=1e-5,
                                  atol=1e-5 * r.abs().max().item()):
                raise AssertionError(
                    f"conv3x3 {name} differs from its twin at {tag}: "
                    f"{(a - r).abs().max().item():.3g} of "
                    f"{r.abs().max().item():.3g}")
    return {"err": err, "equal": equal}


def _check_conv2d_cache(gen) -> None:
    """A ``Conv2d`` of the kernel's shape keeps its packed weights between
    forwards; after an in-place update of the weight (an EMA teacher's, an
    optimizer's) the next no-grad forward must read the new values."""
    import torch

    from hairci_torch.models.resnet import Conv2d
    from hairci_torch.ops.conv3x3 import conv3x3, conv3x3_reference

    conv = Conv2d(64, 64, 3, 1, 1, dtype=torch.bfloat16).cuda()
    other = Conv2d(64, 64, 3, 1, 1, dtype=torch.bfloat16).cuda()
    x = torch.randn(4, 56, 56, 64, device="cuda",
                    generator=gen).bfloat16().permute(0, 3, 1, 2)
    with torch.no_grad():
        first = conv(x)
        packed = conv.packed_weight()
        if conv.packed_weight() is not packed:
            raise AssertionError("Conv2d packed unchanged weights again")
        torch._foreach_mul_([conv.weight], 0.5)             # an EMA update
        torch._foreach_add_([conv.weight],
                            torch._foreach_mul([other.weight], 0.5))
        before = conv3x3.routes["mma"]
        got = conv(x)
        if conv3x3.routes["mma"] != before + 1:
            raise AssertionError("Conv2d did not take the tensor-core kernel")
        want = conv3x3_reference(x, conv.weight)
        fresh = conv3x3(x, conv.weight)
    torch.cuda.synchronize()
    if conv.packed_weight() is packed or torch.equal(got, first):
        raise AssertionError("Conv2d kept stale packed weights")
    equal = (got == want).float().mean().item()
    diff = (got.float() - want.float()).abs()
    top = want.float().abs().max().item()
    if not (torch.equal(got, fresh) and equal >= 0.999 and bool(
            (diff <= 2.0 ** -7 * want.float().abs() + 1e-6 * top).all())):
        raise AssertionError("Conv2d after an in-place weight update differs "
                             "from the twin on the new weights")
    print(f"Conv2d 64->64 after an in-place EMA update of its weight: packed "
          f"anew, equal to the kernel on the new weights, {100 * equal:.4f} "
          f"% of outputs bitwise equal to the twin's")


def phase_conv3x3() -> dict:
    import torch
    import torch.nn.functional as F

    from hairci_torch.ops.conv3x3 import (
        conv3x3,
        conv3x3_reference,
        kernel_route,
        pack_weights,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    least_equal = 1.0
    took = {}

    def check(x, w, b, stats):
        route = kernel_route(x.shape[1], w.shape[0], x.dtype)
        before = conv3x3.routes[route]
        r = _check_conv(x, w, b, stats)
        if conv3x3.routes[route] != before + 1:
            raise AssertionError(f"conv3x3 did not take the {route} kernel")
        took[f"{tuple(x.shape)}->{w.shape[0]} {str(x.dtype)[6:]}"] = route
        worst[x.dtype] = max(worst[x.dtype], r["err"])
        return r

    # borders and ragged tiles, other channel counts, no bias; the last
    # three are ragged for the tensor-core kernel's 8 x 28 tile
    for B, H, W, cin, cout, bias in ((3, 7, 9, 64, 64, True),
                                     (2, 17, 33, 24, 40, True),
                                     (1, 1, 1, 8, 8, False),
                                     (2, 8, 16, 64, 128, False),
                                     (1, 1, 1, 64, 64, True),
                                     (2, 9, 29, 64, 64, False),
                                     (5, 30, 57, 64, 64, True)):
        for dtype in (torch.float32, torch.bfloat16):
            for stats in (False, True):
                check(*_conv_inputs(gen, B, H, W, cin, cout, dtype, bias),
                      stats)
    _check_conv2d_cache(gen)
    times = {}
    # the TPU tool's shape, BYOL's momentum forward over both views (2B at
    # B=64 and at the CLI run's 48), the full-width embed's batch of layer1,
    # the batch the kNN CLI (and DenseCL's momentum forward) gives the
    # kernel on the main path, and DualViewHair's EMA teacher at the CLI's
    # B=32, f32 (the fma kernel)
    shapes = [(B, dtype, kind)
              for B in (256, 2 * TRAIN_BATCH, 2 * CLI_BATCH, KNN_BATCH,
                        CLI_BATCH)
              for dtype, kind in ((torch.bfloat16, "bf16"),
                                  (torch.float32, "f32"))]
    shapes.append((DV_BATCH, torch.float32, "f32"))
    for B, dtype, kind in shapes:
        x, w, b = _conv_inputs(gen, B, 56, 56, 64, 64, dtype)
        for stats in (False, True):
            r = check(x, w, b, stats)
            if dtype == torch.bfloat16:
                least_equal = min(least_equal, r["equal"])
        # the same result on every run: no atomics in the statistics
        one, two = conv3x3(x, w, b, stats=True), conv3x3(x, w, b,
                                                         stats=True)
        if not all(torch.equal(p, q) for p, q in zip(one, two)):
            raise AssertionError("conv3x3 differs from run to run")
        del one, two
        nbytes = (2 * x.numel() * x.element_size() + 9 * 64 * 64 * 4
                  + 64 * 4)
        bound, by = _bound(nbytes, 2.0 * B * 56 * 56 * 9 * 64 * 64, kind)
        wl, bl = w.to(dtype), b.to(dtype)
        packed = pack_weights(w, dtype)
        with torch.no_grad():
            # weights packed by the caller, as Conv2d hands them over
            ms, host = _kernel_times(
                lambda: conv3x3(x, w, b, packed=packed))
            pack_ms, pack_host = _kernel_times(
                lambda: conv3x3(x, w, b))
            stats_ms, _ = _kernel_times(
                lambda: conv3x3(x, w, b, stats=True, packed=packed))
            # the one PyTorch call that computes the same function
            # (cuDNN); timed here, used nowhere in the port
            lib_ms, lib_host = _kernel_times(
                lambda: F.conv2d(x, wl, bl, padding=1))
            row = {
                "ms": ms, "host_ms": host, "packing_ms": pack_ms,
                "packing_host_ms": pack_host, "stats_ms": stats_ms,
                "plain_ms": _median_ms(lambda: conv3x3_reference(x, w,
                                                                 b)),
                "plain_stats_ms": _median_ms(
                    lambda: conv3x3_reference(x, w, b, stats=True)),
                "library_ms": lib_ms, "library_host_ms": lib_host,
                "bound_ms": bound, "bound_by": by,
                "route": kernel_route(64, 64, dtype)}
        times[(B, kind)] = row
        print(f"conv3x3 ({B}, 56, 56, 64) -> 64 {kind}, the "
              f"{row['route']} kernel, {BACK_TO_BACK} calls back to "
              f"back: {ms:.4f} ms on the card ({100 * bound / ms:.1f} % "
              f"of the bound {bound:.4f} ms, by {by}), {host:.4f} ms on "
              f"the host; packing the weights in the call {pack_ms:.4f} "
              f"/ {pack_host:.4f} ms; with stats {stats_ms:.4f} ms; twin "
              f"{row['plain_ms']:.4f} ms, with stats "
              f"{row['plain_stats_ms']:.4f} ms; F.conv2d {lib_ms:.4f} ms "
              f"on the card ({100 * bound / lib_ms:.1f} % of the bound), "
              f"{lib_host:.4f} ms on the host")
        del x, w, b, wl, bl, packed
    # the CIFAR-stem ResNet-18's layer1 (SupCon's eval forward): 224 x 224,
    # 16x the pixels of ResNet-50's layer1; 47 leaves a ragged last wave
    times224 = {}
    for B in (KNN_BATCH, CLI_BATCH, CLI_BATCH - 1):
        x, w, b = _conv_inputs(gen, B, SIZE, SIZE, 64, 64, torch.bfloat16)
        for stats in (False, True):
            least_equal = min(least_equal, check(x, w, b, stats)["equal"])
        one, two = conv3x3(x, w, b, stats=True), conv3x3(x, w, b, stats=True)
        if not all(torch.equal(p, q) for p, q in zip(one, two)):
            raise AssertionError(f"conv3x3 differs from run to run at "
                                 f"({B}, {SIZE}, {SIZE}, 64)")
        del one, two
        nbytes = 2 * x.numel() * 2 + 9 * 64 * 64 * 4 + 64 * 4
        bound, by = _bound(nbytes, 2.0 * B * SIZE * SIZE * 9 * 64 * 64,
                           "bf16")
        wl, bl = w.bfloat16(), b.bfloat16()
        packed = pack_weights(w, torch.bfloat16)
        with torch.no_grad():
            ms, host = _kernel_times(lambda: conv3x3(x, w, b, packed=packed))
            lib_ms, lib_host = _kernel_times(
                lambda: F.conv2d(x, wl, bl, padding=1))
            plain = _median_ms(lambda: conv3x3_reference(x, w, b), runs=10,
                               warmup=2)
        times224[B] = {"ms": ms, "host_ms": host, "plain_ms": plain,
                       "library_ms": lib_ms, "library_host_ms": lib_host,
                       "bound_ms": bound, "bound_by": by}
        print(f"conv3x3 ({B}, {SIZE}, {SIZE}, 64) -> 64 bf16, the mma "
              f"kernel: {ms:.4f} ms on the card ({100 * bound / ms:.1f} % of "
              f"the bound {bound:.4f} ms, by {by}), {host:.4f} ms on the "
              f"host; twin {plain:.4f} ms; F.conv2d {lib_ms:.4f} ms on the "
              f"card ({100 * bound / lib_ms:.1f} % of the bound), "
              f"{lib_host:.4f} ms on the host")
        del x, w, b, wl, bl, packed
    print("conv3x3 kernel by shape: " + "; ".join(
        f"{k} {v}" for k, v in took.items()))
    print(f"conv3x3 vs twin: ok; max |err| f32 {worst[torch.float32]:.3g} "
          f"bf16 {worst[torch.bfloat16]:.3g}; bf16 outputs bitwise equal at "
          f"56x56x64 and 224x224x64: >= {100 * least_equal:.4f} %")
    torch.cuda.empty_cache()
    return {"max_abs_err": worst[torch.bfloat16], "times": times,
            "times224": times224}


def phase_kernels() -> dict:
    return {"topk": phase_topk(), "rotate": phase_rotate(),
            "bn_stats": phase_bn_stats(), "conv3x3": phase_conv3x3()}


# ---------------------------------------------------------------------------
# phase 3b: the fused BatchNorm apply and its backward
# ---------------------------------------------------------------------------

def resnet50_bn_epilogues(rows: int, size: int) -> list:
    """(M, C, epilogue, count) of the 53 trunk BNs of a ResNet-50 forward
    over ``rows`` images of ``size`` px: the stem's and a block's first two
    take the ReLU ("relu"), a block's last the residual add and the ReLU
    ("residual_relu"), a projection's neither ("none")."""
    out, hw = [(rows * (size // 2) ** 2, 64, "relu")], size // 4
    for i, blocks in enumerate((3, 4, 6, 3)):
        f = 64 * 2 ** i
        for j in range(blocks):
            out.append((rows * hw * hw, f, "relu"))
            if i > 0 and j == 0:
                hw //= 2
            out += [(rows * hw * hw, f, "relu"),
                    (rows * hw * hw, 4 * f, "residual_relu")]
            if j == 0:
                out.append((rows * hw * hw, 4 * f, "none"))
    counts = {}
    for key in out:
        counts[key] = counts.get(key, 0) + 1
    return [(m, c, e, n) for (m, c, e), n in counts.items()]


def _bn_formula(x2, bn, residual, relu):
    """``models/norm.py``'s non-centred BatchNorm as it was written before
    the fused apply (the statistics from the same bn_stats kernel), then the
    block's ``residual + y`` and ReLU, on an (M, C) input, without touching
    ``bn``'s running statistics: what the fused path's bits are held to."""
    import torch

    from hairci_torch.ops.bn_stats import bn_stats

    if bn.training:
        s, sq = bn_stats(x2)
        n = s.new_full((1,), x2.shape[0])
        mean = s / n
        var = sq / n - mean * mean
    else:
        mean, var = bn.running_mean, bn.running_var
    w = torch.reciprocal(torch.sqrt(var + bn.eps)) * bn.weight
    y = (x2.float() * w + (-mean * w + bn.bias)).to(bn.dtype)
    if residual is not None:
        y = residual + y
    return torch.relu(y) if relu else y


def bn_apply_counts() -> dict:
    """The fused BatchNorm kernels' launches: the apply's by BN mode, and
    the backward's two."""
    from hairci_torch.ops import bn_apply

    return {"train": bn_apply.bn_apply.modes["train"],
            "eval": bn_apply.bn_apply.modes["eval"],
            "grad_sums": bn_apply.bn_grad_sums.launches,
            "grad_input": bn_apply.bn_grad_input.launches}


def _bn_apply_shapes(shapes, dtype, gen, problems: list, dev) -> dict:
    """Checks and times of the three kernels at ``shapes`` ((M, C,
    epilogue, count)), summed over the counts: each kernel's card and host
    ms, its bound (the bytes its function must move, once each, at 3.35
    TB/s), the twins' ms and ``F.batch_norm`` + ReLU's (the one-PyTorch-call
    yardstick the port never calls). Mismatches go to ``problems``."""
    import torch
    import torch.nn.functional as F

    from hairci_torch.ops import bn_apply as ba

    elem = torch.empty(0, dtype=dtype).element_size()
    tot = {k: 0.0 for k in ("apply", "apply_host", "apply_bound",
                            "apply_twin", "grad", "grad_host", "grad_bound",
                            "grad_twin", "library")}
    for m, c, epi, n in shapes:
        x = (torch.randn(m, c, device=dev, generator=gen) * 2 + 1).to(dtype)
        w = torch.rand(c, device=dev, generator=gen) + 0.5
        b = torch.randn(c, device=dev, generator=gen) * 0.3
        res = (torch.randn(m, c, device=dev, generator=gen).to(dtype)
               if epi == "residual_relu" else None)
        relu = epi != "none"
        y = ba.bn_apply(x, w, b, res, relu)
        if not torch.equal(y, ba.bn_apply_reference(x, w, b, res, relu)):
            problems.append(f"bn_apply ({m}, {c}) {epi} differs from its twin")
        dy = torch.randn(m, c, device=dev, generator=gen).to(dtype)
        out = y if relu else None
        sums = ba.bn_grad_sums(dy, out, x)
        ref = ba.bn_grad_sums_reference(dy, out, x)
        for got, want in zip(sums, ref):
            scale = float(want.abs().max()) + 1.0
            if float((got - want).abs().max()) > 1e-5 * scale * m ** 0.5:
                problems.append(f"bn_grad_sums ({m}, {c}) {epi}: max |err| "
                                f"{float((got - want).abs().max()):.3g}")
        again = ba.bn_grad_sums(dy, out, x)
        if not all(torch.equal(a, b2) for a, b2 in zip(sums, again)):
            problems.append(f"bn_grad_sums ({m}, {c}) differs run to run")
        g_s = torch.randn(c, device=dev, generator=gen) * 1e-3
        g_sq = torch.randn(c, device=dev, generator=gen) * 1e-3
        dx, dres = ba.bn_grad_input(dy, out, x, w, g_s, g_sq, res is not None)
        rdx, rres = ba.bn_grad_input_reference(dy, out, x, w, g_s, g_sq,
                                               res is not None)
        if not torch.equal(dx, rdx) or (res is not None
                                        and not torch.equal(dres, rres)):
            bad = float((dx.float() - rdx.float()).abs().max())
            problems.append(f"bn_grad_input ({m}, {c}) {epi} differs from its "
                            f"twin: max |err| {bad:.3g}")
        ak, ah = _kernel_times(lambda: ba.bn_apply(x, w, b, res, relu))
        sk, sh = _kernel_times(lambda: ba.bn_grad_sums(dy, out, x))
        ik, ih = _kernel_times(lambda: ba.bn_grad_input(
            dy, out, x, w, g_s, g_sq, res is not None))
        at = _median_ms(lambda: ba.bn_apply_reference(x, w, b, res, relu),
                        runs=10, warmup=2)
        gt = _median_ms(lambda: (ba.bn_grad_sums_reference(dy, out, x),
                                 ba.bn_grad_input_reference(
                                     dy, out, x, w, g_s, g_sq,
                                     res is not None)), runs=10, warmup=2)
        # (1, C, M, 1) in channels_last: the layout the trunk's BNs see
        x4 = x.view(1, m, 1, c).permute(0, 3, 1, 2)
        rm, rv = torch.zeros(c, device=dev), torch.ones(c, device=dev)
        lib = _kernel_times(lambda: F.relu(F.batch_norm(
            x4, rm, rv, w, b, training=True)))[0]
        mc = m * c * elem
        a_bytes = (3 if res is not None else 2) * mc
        # sums: dy, x (and y); input: dy, x (and y) read, dx (and dres)
        g_bytes = ((3 if relu else 2) * mc
                   + (3 if relu else 2) * mc + (2 if res is not None else 1)
                   * mc)
        a_bound = a_bytes / HBM_BYTES_PER_S * 1e3
        g_bound = g_bytes / HBM_BYTES_PER_S * 1e3
        print(f"bn_apply ({m}, {c}) {str(dtype)[6:]} {epi} x{n}: apply "
              f"{ak:.4f} ms on the card (bound {a_bound:.4f}, "
              f"{100 * a_bound / ak:.1f} %), {ah:.4f} on the host; backward "
              f"{sk:.4f} + {ik:.4f} ms (bound {g_bound:.4f}, "
              f"{100 * g_bound / (sk + ik):.1f} %), {sh:.4f} + {ih:.4f} on "
              f"the host; twins {at:.4f} / {gt:.4f}; F.batch_norm + relu "
              f"{lib:.4f}")
        for k, v in (("apply", ak), ("apply_host", ah),
                     ("apply_bound", a_bound), ("apply_twin", at),
                     ("grad", sk + ik), ("grad_host", sh + ih),
                     ("grad_bound", g_bound), ("grad_twin", gt),
                     ("library", lib)):
            tot[k] += n * v
        del x, y, dy, res, dx, dres, rdx, rres, out, x4
        torch.cuda.empty_cache()
    return tot


def phase_bn_apply() -> dict:
    """Phase 3b: the fused BatchNorm (``ops/bn_apply.py``) on the card. The
    module's output and running statistics against the formula it replaced,
    bit for bit, in train and eval mode with each epilogue, bf16 and f32,
    at a step shape and at shapes off the 16-byte path; its backward the
    same bits twice; each kernel against its twin (the apply and the input
    gradient bit for bit) and timed at the 53 trunk BN inputs of one
    ResNet-50 SHAM forward at 3B rows (B = 256, bf16) and of DualViewHair's
    student at 32 rows (f32); then one ResNet-50 SHAM step in each stage at
    B=64, whose launches must be 53 train-mode and 53 eval-mode applies
    (106 in ``mine``) and 53 of each backward kernel."""
    import torch

    from hairci_torch.models.norm import BatchNorm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    problems = []
    # the module against the formula it replaced, and its backward twice
    for m, c, dtype in ((3 * 64 * 28 * 28, 128, torch.bfloat16),
                        (3 * 64 * 7 * 7, 2048, torch.bfloat16),
                        (32 * 14 * 14, 1024, torch.float32),
                        (1000, 7, torch.bfloat16), (999, 24, torch.float32)):
        for epi in ("none", "relu", "residual_relu"):
            for training in (True, False):
                bn = BatchNorm(c, dtype=dtype).to(dev).train(training)
                with torch.no_grad():
                    bn.weight.copy_(torch.rand(c, device=dev, generator=gen)
                                    + 0.5)
                    bn.bias.copy_(torch.randn(c, device=dev, generator=gen))
                    bn.running_mean.normal_(generator=gen)
                    bn.running_var.uniform_(0.5, 1.5, generator=gen)
                x = (torch.randn(m, c, device=dev, generator=gen) * 2
                     + 1).to(dtype)
                res = (torch.randn(m, c, device=dev, generator=gen).to(dtype)
                       if epi == "residual_relu" else None)
                want = _bn_formula(x, bn, res, epi != "none")
                if training:
                    rm = bn.running_mean.clone()
                before = dict(bn_apply_counts())
                y = bn(x, residual=res, relu=epi != "none")
                mode = "train" if training else "eval"
                if bn_apply_counts()[mode] != before[mode] + 1:
                    problems.append(f"BatchNorm {mode} made no apply launch")
                if not torch.equal(y, want):
                    bad = (y.float() - want.float()).abs().max()
                    problems.append(f"BatchNorm ({m}, {c}) {dtype} {epi} "
                                    f"{mode} differs from the old formula: "
                                    f"max |err| {float(bad):.3g}")
                if training:
                    s = x.float().sum(0)
                    if not torch.allclose(bn.running_mean,
                                          0.9 * rm + 0.1 * s / m,
                                          rtol=1e-4, atol=1e-4):
                        problems.append(f"BatchNorm ({m}, {c}) running mean")
                    grads = []
                    for _ in range(2):
                        xg = x.clone().requires_grad_()
                        rg = (None if res is None
                              else res.clone().requires_grad_())
                        bn.zero_grad()
                        bn(xg, residual=rg, relu=epi != "none").backward(
                            torch.ones_like(y) * 1e-2 + y * 1e-3)
                        grads.append([xg.grad, bn.weight.grad.clone(),
                                      bn.bias.grad.clone()]
                                     + ([] if rg is None else [rg.grad]))
                    if not all(torch.equal(a, b) for a, b in zip(*grads)):
                        problems.append(f"BatchNorm ({m}, {c}) {dtype} {epi} "
                                        f"backward differs run to run")
    print(f"BatchNorm against the formula it replaced (5 shapes x 3 "
          f"epilogues x train / eval), and its backward run to run: "
          f"{len(problems)} problems")
    torch.cuda.empty_cache()
    rows = 3 * 256
    step = _bn_apply_shapes(resnet50_bn_epilogues(rows, SIZE),
                            torch.bfloat16, gen, problems, dev)
    print(f"bn_apply, the 53 trunk BNs of one ResNet-50 SHAM forward at "
          f"{rows} rows, bf16, {BACK_TO_BACK} calls back to back per shape: "
          f"apply {step['apply']:.3f} ms on the card (bound "
          f"{step['apply_bound']:.3f}, "
          f"{100 * step['apply_bound'] / step['apply']:.1f} %), "
          f"{step['apply_host']:.3f} on the host, twin "
          f"{step['apply_twin']:.3f}; backward {step['grad']:.3f} ms on the "
          f"card (bound {step['grad_bound']:.3f}, "
          f"{100 * step['grad_bound'] / step['grad']:.1f} %), "
          f"{step['grad_host']:.3f} on the host, twins "
          f"{step['grad_twin']:.3f}; F.batch_norm + relu "
          f"{step['library']:.3f}")
    dv = _bn_apply_shapes(resnet50_bn_epilogues(DV_BATCH, SIZE),
                          torch.float32, gen, problems, dev)
    print(f"bn_apply, the 53 trunk BNs of one DualViewHair student forward "
          f"at {DV_BATCH} rows, f32: apply {dv['apply']:.3f} ms on the card "
          f"(bound {dv['apply_bound']:.3f}), {dv['apply_host']:.3f} on the "
          f"host, twin {dv['apply_twin']:.3f}; backward {dv['grad']:.3f} ms "
          f"(bound {dv['grad_bound']:.3f}), {dv['grad_host']:.3f} on the "
          f"host, twins {dv['grad_twin']:.3f}; F.batch_norm + relu "
          f"{dv['library']:.3f}")
    # the launches of one ResNet-50 SHAM step in each stage
    from hairci_torch.ssl.sham import SHAMRecipe

    rec = SHAMRecipe(backbone="resnet50", img_size=SIZE, num_batches=1,
                     dtype=torch.bfloat16)
    state = rec.create_state(SEED, TRAIN_BATCH, dev)
    images = torch.randint(0, 256, (TRAIN_BATCH, SIZE, SIZE, 3),
                           dtype=torch.uint8, device=dev, generator=gen)
    cpu_gen = torch.Generator().manual_seed(SEED)
    launches = {}
    for stage in ("warmup", "mine", "mined"):
        before = bn_apply_counts()
        rec.train_step(state, images, cpu_gen, stage)
        torch.cuda.synchronize()
        launches[stage] = {k: v - before[k]
                           for k, v in bn_apply_counts().items()}
        want = {"train": 53, "eval": 106 if stage == "mine" else 53,
                "grad_sums": 53, "grad_input": 53}
        print(f"SHAM ResNet-50 {stage} step, B={TRAIN_BATCH}, bf16: fused BN "
              f"launches {launches[stage]}")
        if launches[stage] != want:
            problems.append(f"{stage} step: launches {launches[stage]} != "
                            f"{want}")
    del state, rec, images
    torch.cuda.empty_cache()
    print(json.dumps({"bn_apply": {"step_bf16_768": step,
                                   "dualview_f32_32": dv,
                                   "launches": launches}}))
    if problems:
        raise AssertionError("phase bn_apply: " + "; ".join(problems))
    return {"step": step, "dualview": dv, "launches": launches}


# ---------------------------------------------------------------------------
# phase 4: the serving slice through its entry point
# ---------------------------------------------------------------------------

def _wrappers() -> dict:
    from hairci_torch.ops.bn_stats import bn_stats
    from hairci_torch.ops.conv3x3 import conv3x3
    from hairci_torch.ops.rotate import rotate_shear
    from hairci_torch.ops.topk import topk_gallery_search

    return {"topk_gallery_search": topk_gallery_search,
            "rotate_shear": rotate_shear, "bn_stats": bn_stats,
            "conv3x3": conv3x3}


def _reset_counts() -> None:
    """Every kernel's launch count to 0, just before a path is driven."""
    from hairci_torch.ops import bn_apply

    for fn in _wrappers().values():
        fn.launches = 0
        for route in getattr(fn, "routes", {}):
            fn.routes[route] = 0
    for fn in (bn_apply.bn_apply, bn_apply.bn_grad_sums,
               bn_apply.bn_grad_input):
        fn.launches = 0
    bn_apply.bn_apply.modes.update(train=0, eval=0)


def _counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def _decodes() -> int:
    from hairci_torch.native import imageio

    return imageio.decode_batch.decodes


def _check_decode_route(what: str, decodes: int, loaded: int) -> None:
    """The loaders' default decoder took the C++ decoder for every image
    where it is built, and PIL for every image where it is not."""
    from hairci_torch.native import imageio

    route = "native" if imageio.available() else "pil"
    print(f"{what}: {loaded} images loaded, {decodes} through the C++ "
          f"decoder (route {route})")
    if decodes != (loaded if route == "native" else 0):
        raise AssertionError(f"{what}: {decodes} native decodes of {loaded} "
                             f"images on the {route} route")


def _request(server, path, payload=None):
    url = f"http://127.0.0.1:{server.server_address[1]}{path}"
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        if r.status != 200:
            raise AssertionError(f"{path}: HTTP {r.status}")
        return json.loads(r.read())


def _write_big_gallery(index_dir: str, rows: int) -> list:
    """The real embeddings followed by seeded unit-norm rows, as an index
    directory; returns the real rows' paths."""
    import numpy as np

    real = np.load(os.path.join(index_dir, "embeddings.npy"))
    with open(os.path.join(index_dir, "image_paths.txt")) as f:
        paths = f.read().splitlines()
    extra = np.random.default_rng(SEED).standard_normal(
        (rows - len(real), real.shape[1]), dtype=np.float32)
    extra /= np.linalg.norm(extra, axis=1, keepdims=True)
    np.save(os.path.join(index_dir, "embeddings.npy"),
            np.concatenate([real, extra]))
    with open(os.path.join(index_dir, "image_paths.txt"), "w") as f:
        f.write("\n".join(paths + [f"synthetic/{i:06d}"
                                   for i in range(len(real), rows)]) + "\n")
    return paths


def _serve_requests(server, index_dir: str, width: int, model: str) -> dict:
    """/health, /search by image_path and by four base64 images, /embed on
    the indexed images; then /reload of a 103,945-row gallery, 20 searches
    by a stored embedding (each must find its own row) and one of 256 in one
    request, which the mma route must answer. Returns the paths indexed,
    the searches made, the /search p50 and the batched request's ms."""
    import numpy as np
    import torch

    from hairci_torch.ops.topk import topk_gallery_search

    health = _request(server, "/health")
    n_images = len(server.service.index)
    if health != {"status": "ok", "gallery_size": n_images, "dim": width,
                  "model": model} or n_images != 128:
        raise AssertionError(f"/health: {health}")
    paths = list(server.service.index.paths)
    target = paths[2]
    res = _request(server, "/search", {"image_path": target, "k": 5})
    print(f"/search image_path {os.path.basename(target)}: "
          f"{[os.path.basename(p) for p in res['paths'][0]]} "
          f"{res['scores'][0]}")
    if res["paths"][0][0] != target or res["scores"][0][0] < 0.99:
        raise AssertionError("/search by image_path: rank 1 is not the "
                             "image itself at score >= 0.99")
    four = paths[10:14]
    b64 = [base64.b64encode(open(p, "rb").read()).decode() for p in four]
    res = _request(server, "/search", {"images_b64": b64, "k": 5})
    top1 = [row[0] for row in res["paths"]]
    print(f"/search images_b64 x4: rank-1 scores "
          f"{[row[0] for row in res['scores']]}")
    if top1 != four or np.asarray(res["scores"]).shape != (4, 5):
        raise AssertionError(f"/search images_b64: rank 1 {top1}")
    emb = np.asarray(_request(server, "/embed",
                              {"image_path": paths[5]})["embedding"])
    if emb.shape != (1, width) or abs(np.linalg.norm(emb) - 1) > 1e-4:
        raise AssertionError(f"/embed: shape {emb.shape}")
    searches = 2

    real = _write_big_gallery(index_dir, GALLERY_ROWS)
    t0 = time.perf_counter()
    reloaded = _request(server, "/reload", {})["gallery_size"]
    print(f"/reload: {reloaded} rows in {time.perf_counter() - t0:.2f} s")
    if reloaded != GALLERY_ROWS:
        raise AssertionError(f"/reload: {reloaded} rows")
    stored = server.service.index.embeddings
    latencies = []
    for i in range(20):
        q = stored[i].float().cpu().numpy().tolist()
        t0 = time.perf_counter()
        res = _request(server, "/search", {"embedding": q, "k": 5})
        latencies.append((time.perf_counter() - t0) * 1e3)
        searches += 1
        if res["paths"][0][0] != real[i]:
            raise AssertionError(f"self-retrieval failed for row {i}")
    latencies.sort()
    print(f"/search by embedding, {GALLERY_ROWS} x {width}, k=5: p50 "
          f"{latencies[10]:.3f} ms over 20 requests (HTTP round trip)")
    # one batched search: 256 stored rows, each must find itself
    rows = np.arange(256) * (GALLERY_ROWS // 256)
    batch = stored[torch.from_numpy(rows).to(stored.device)]
    payload = {"embedding": batch.float().cpu().numpy().tolist(), "k": 5}
    before = topk_gallery_search.routes["mma"]
    t0 = time.perf_counter()
    res = _request(server, "/search", payload)
    batched_ms = (time.perf_counter() - t0) * 1e3
    searches += 1
    top1 = [row[0] for row in res["paths"]]
    index_paths = server.service.index.paths
    if top1 != [index_paths[r] for r in rows] or np.asarray(
            res["scores"]).shape != (256, 5):
        raise AssertionError("batched /search: a rank 1 is not the "
                             "query's own row")
    if topk_gallery_search.routes["mma"] != before + 1:
        raise AssertionError("batched /search did not take the mma "
                             "route of the top-k kernel")
    print(f"/search by embedding, 256 x {width} in one request, k=5: "
          f"{batched_ms:.3f} ms HTTP round trip; rank 1 is each row "
          f"itself; served by the mma route")
    return {"paths": paths, "searches": searches, "p50_ms": latencies[10],
            "batched_ms": batched_ms}


def _serve_and_check(encoder, index_dir: str, width: int) -> dict:
    """``serve`` over the repo's images with every kernel count at 0, the
    requests of ``_serve_requests``, then the top-k's launches: one a
    search, 22 on the fma route and 1 on the mma route."""
    from hairci_torch.ops.topk import topk_gallery_search
    from hairci_torch.serve.api import serve

    _reset_counts()
    t0 = time.perf_counter()
    server = serve(encoder, index_dir, port=0, dataset_path=DATASET)
    print(f"serve(): indexed the dataset in {time.perf_counter() - t0:.2f} s")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        served = _serve_requests(server, index_dir, width,
                                 type(encoder).__name__)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    launches = dict(topk_gallery_search.routes)
    print(f"topk kernel launches during the serve run: {launches} for "
          f"{served['searches']} searches")
    if launches != {"fma": served["searches"] - 1, "mma": 1} or \
            _counts()["topk_gallery_search"] != served["searches"]:
        raise AssertionError("/search did not go through both routes of the "
                             "top-k kernel, one launch a search")
    return {**served, "launches": launches}


def phase_serve(workdir: str):
    import torch

    from hairci_torch.retrieval.encoders import HairEncoder

    t0 = time.perf_counter()
    encoder = HairEncoder(None, "vit_base_patch16", device="cuda")
    print(f"HairEncoder vit_base_patch16 bf16 on cuda: "
          f"{time.perf_counter() - t0:.2f} s to build")
    served = _serve_and_check(encoder, os.path.join(workdir, "index"), WIDTH)
    paths, launches = served["paths"], served["launches"]

    batch = encoder._preprocess(
        [paths[i % len(paths)] for i in range(64)])
    x = torch.from_numpy(batch).cuda()
    with torch.no_grad():
        fwd_ms = _median_ms(lambda: encoder._embed_fn(x), runs=20, warmup=3)
    host = []
    for _ in range(10):
        t0 = time.perf_counter()
        encoder.extract_features(batch)
        host.append(time.perf_counter() - t0)
    host.sort()
    print(f"embed batch 64 at 224: forward {fwd_ms:.3f} ms "
          f"({64e3 / fwd_ms:.1f} img/s device), extract_features "
          f"{host[5] * 1e3:.3f} ms ({64 / host[5]:.1f} img/s with copies)")
    return encoder, paths, launches


# ---------------------------------------------------------------------------
# phase 5: the card against the CPU
# ---------------------------------------------------------------------------

def phase_parity(encoder, paths) -> None:
    import numpy as np
    import torch

    from hairci_torch.retrieval.encoders import HairEncoder

    cpu = HairEncoder(None, "vit_base_patch16", device="cpu",
                      dtype=torch.float32)
    images = encoder._preprocess(paths[:4])
    cos = np.sum(cpu.extract_features(images)
                 * encoder.extract_features(images), axis=1)
    print(f"bf16 cuda vs f32 cpu cosine: {cos.tolist()}")
    if not np.all(cos >= 0.99):
        raise AssertionError("card and CPU embeddings disagree")


# ---------------------------------------------------------------------------
# phase 4d: the face encoder behind the API, and the face-retrieval CLI
# ---------------------------------------------------------------------------

FACE_MODELS = ("VIT", "VITs")
FACE_PARITY_IMAGES = 8


def _face_embed_times(encoder, paths: list) -> dict:
    """The face embed at batch 64: CUDA events, median of 10 after 3, and
    the forward's FLOPs by ``FlopCounterMode``."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    batch = encoder._preprocess([paths[i % len(paths)] for i in range(64)])
    x = torch.from_numpy(batch).cuda()
    with torch.no_grad():
        ms = _median_ms(lambda: encoder._embed_fn(x), runs=10, warmup=3)
        with FlopCounterMode(display=False) as counter:
            encoder._embed_fn(x)
    flops = counter.get_total_flops()
    print(f"  face embed batch 64 at 112: {ms:.3f} ms ({64e3 / ms:.1f} "
          f"img/s), {flops / 64 / 1e9:.2f} GFLOP an image, "
          f"{flops / ms / 1e9:.1f} TFLOP/s")
    return {"ms": ms, "img_s": 64e3 / ms, "flops": flops}


def _face_parity(encoder, model_name: str, paths: list) -> float:
    """The same seeded weights in f32 on the CPU against bf16 on the card;
    returns the least cosine of ``FACE_PARITY_IMAGES`` images."""
    import numpy as np
    import torch

    from hairci_torch.retrieval.encoders import FaceEncoder

    cpu = FaceEncoder(None, model_name, device="cpu", dtype=torch.float32)
    images = encoder._preprocess(paths[:FACE_PARITY_IMAGES])
    cos = np.sum(cpu.extract_features(images)
                 * encoder.extract_features(images), axis=1)
    print(f"  {model_name} bf16 cuda vs f32 cpu cosine: min {cos.min():.6f} "
          f"over {len(cos)} images")
    if not np.all(cos >= 0.99):
        raise AssertionError(f"{model_name}: card and CPU embeddings "
                             f"disagree: {cos.tolist()}")
    return float(cos.min())


def phase_serve_face(workdir: str) -> dict:
    """``api.main --encoder face`` wiring for each face model: the API's own
    parser and ``build_encoder``, then ``serve`` and the requests of phase 4
    at the face width; the embed times and the card-vs-CPU cosine; then
    ``python -m hairci_torch.cli.face_retrieval`` once. Returns the numbers
    by model and the last model's encoder."""
    import contextlib
    import io
    import runpy

    from hairci_torch.serve import api

    out = {}
    for model_name in FACE_MODELS:
        index_dir = os.path.join(workdir, f"face_{model_name}")
        args = api.build_parser().parse_args(
            ["--encoder", "face", "--model_name", model_name, "--index_dir",
             index_dir, "--dataset_path", DATASET, "--port", "0"])
        t0 = time.perf_counter()
        encoder = api.build_encoder(args)
        print(f"FaceEncoder {model_name} bf16 on {encoder.device}: "
              f"{time.perf_counter() - t0:.2f} s to build")
        if encoder.device.type != "cuda" or \
                encoder.feature_dim != FACE_WIDTH:
            raise AssertionError(f"FaceEncoder on {encoder.device}, "
                                 f"width {encoder.feature_dim}")
        served = _serve_and_check(encoder, args.index_dir, FACE_WIDTH)
        paths = served["paths"]
        out[model_name] = {
            **served, "embed": _face_embed_times(encoder, paths),
            "cos_min": _face_parity(encoder, model_name, paths)}

    argv = sys.argv
    sys.argv = ["face_retrieval", "--data_path", DATASET, "--embed_save_dir",
                os.path.join(workdir, "face_cli"), "--query_image",
                os.path.join(DATASET, "000003.jpg"), "--top_k", "5"]
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            runpy.run_module("hairci_torch.cli.face_retrieval",
                             run_name="__main__")
    finally:
        sys.argv = argv
    lines = printed.getvalue().strip().splitlines()
    print("python -m hairci_torch.cli.face_retrieval: " + " | ".join(lines))
    if len(lines) != 6 or not lines[1].split()[1].endswith("000003.jpg"):
        raise AssertionError("face_retrieval: the query is not its own "
                             "rank 1")
    return out, encoder


# ---------------------------------------------------------------------------
# phase 4e: a FAISS artifact through the hair CLI, the host flat index, and
# the demo pipeline
# ---------------------------------------------------------------------------

HOST_SEARCH_Q = (1, 256)


def _printed_top(text: str) -> list:
    """[(path, score)] of the retrieval CLI's print."""
    return [(line.split()[1], float(line.split()[3].rstrip(")")))
            for line in text.strip().splitlines()[1:]]


def _same_top(what: str, idx, scores, ref_idx, ref_scores) -> None:
    """Equal indices, except where the reference's neighbouring scores lie
    within 1e-5 (two sums in other orders may swap them); scores within
    1e-5."""
    import numpy as np

    err = float(np.abs(scores - ref_scores).max())
    if err > 1e-5:
        raise AssertionError(f"{what}: scores differ by {err}")
    inf = np.full_like(ref_scores[:, :1], np.inf)
    gaps = ref_scores[:, :-1] - ref_scores[:, 1:]
    clear = np.minimum(np.concatenate([inf, gaps], 1),
                       np.concatenate([gaps, inf], 1)) > 1e-5
    if not np.all((idx == ref_idx) | ~clear):
        raise AssertionError(f"{what}: indices differ")


def phase_faiss_native_demo(workdir: str, face_encoder) -> dict:
    """Phase 4's 103,945 x 768 gallery written as the reference demo's FAISS
    artifact pair; the hair CLI on it with ``--faiss_index --retrieve_only``
    (one top-k launch, ``GalleryIndex.search``'s top-5); the same rows in
    ``NativeFlatIndex`` against the card at Q = 1 and 256; ``DemoPipeline``
    importing the artifact (a face encoder's width refused) and retrieving
    one image through the Otsu mask with one top-k launch."""
    import contextlib
    import io

    import numpy as np
    import torch

    from hairci_torch.cli import retrieval as retrieval_cli
    from hairci_torch.native import METRIC_IP, NativeFlatIndex
    from hairci_torch.ops.topk import topk_gallery_search
    from hairci_torch.retrieval.encoders import HairEncoder
    from hairci_torch.retrieval.faiss_io import (
        load_faiss_flat,
        read_flat_index,
        save_faiss_flat,
    )
    from hairci_torch.retrieval.index import GalleryIndex
    from hairci_torch.serve.demo import FAISS_ARTIFACT, DemoPipeline

    # phase 4's 103,945 x 768 gallery (the repo's images, then seeded rows)
    gallery = GalleryIndex.load(os.path.join(workdir, "index"))
    faiss_dir = os.path.join(workdir, "faiss")
    os.makedirs(faiss_dir)
    artifact = os.path.join(faiss_dir, FAISS_ARTIFACT)
    t0 = time.perf_counter()
    save_faiss_flat(gallery, artifact,
                    os.path.join(faiss_dir, "paths_hair_region.pkl"))
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    imported = load_faiss_flat(artifact)
    import_s = time.perf_counter() - t0
    print(f"FAISS artifact {GALLERY_ROWS} x {WIDTH}: written in {write_s:.3f}"
          f" s, imported onto the card in {import_s:.3f} s "
          f"({os.path.getsize(artifact) / 1e6:.1f} MB)")
    # the importer normalises the rows again: within an f32 rounding
    if imported.paths != gallery.paths or not torch.allclose(
            imported.embeddings, gallery.embeddings, rtol=0, atol=1e-6):
        raise AssertionError("the FAISS artifact did not import its rows")

    query = os.path.join(DATASET, "000007_hair.png")
    argv = ["--data_path", DATASET, "--faiss_index", artifact,
            "--retrieve_only", "--query_image", query, "--top_k", "5",
            "--embed_save_dir", os.path.join(workdir, "unused")]
    _reset_counts()
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        retrieval_cli.run("hair", argv)
    cli_s = time.perf_counter() - t0
    launches = _counts()["topk_gallery_search"]
    top = _printed_top(printed.getvalue())
    print(f"retrieval --faiss_index --retrieve_only: {cli_s:.2f} s, "
          f"{launches} top-k launch; top-5 "
          f"{[(os.path.basename(p), s) for p, s in top]}")
    if launches != 1:
        raise AssertionError(f"--faiss_index search: {launches} top-k "
                             "launches, not 1")
    encoder = HairEncoder(None, "vit_base_patch16", device="cuda")
    feat = encoder.encode_single_image(query)
    ref_s, ref_paths = imported.search_paths(feat[None], 5)
    if [p for p, _ in top] != ref_paths[0] or top[0][0] != query or \
            np.abs(np.array([s for _, s in top]) - ref_s[0]).max() > 1e-4:
        raise AssertionError("--faiss_index top-5 differs from "
                             "GalleryIndex.search on the same rows")

    vectors, _ = read_flat_index(artifact)
    host = NativeFlatIndex(WIDTH, METRIC_IP)
    t0 = time.perf_counter()
    host.add(vectors)
    print(f"NativeFlatIndex: {len(host)} rows added in "
          f"{time.perf_counter() - t0:.3f} s")
    rng = np.random.default_rng(SEED)
    times = {}
    for Q in HOST_SEARCH_Q:
        q = vectors[rng.integers(0, GALLERY_ROWS, Q)] + 0.3 * \
            rng.standard_normal((Q, WIDTH)).astype(np.float32) / WIDTH ** 0.5
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        runs = 5 if Q == 1 else 2
        host_ms = []
        for _ in range(runs):
            t0 = time.perf_counter()
            hs, hi = host.search(q, 5)
            host_ms.append((time.perf_counter() - t0) * 1e3)
        card_ms = []
        for _ in range(10):
            t0 = time.perf_counter()
            cs, ci = imported.search(q, 5, normalized=True)
            card_ms.append((time.perf_counter() - t0) * 1e3)
        _same_top(f"NativeFlatIndex vs the card at Q={Q}", hi, hs, ci, cs)
        times[Q] = (sorted(host_ms)[runs // 2], sorted(card_ms)[5])
        print(f"flat search Q={Q} k=5 over {GALLERY_ROWS} x {WIDTH}: host "
              f"(NativeFlatIndex, {os.cpu_count()} cores) {times[Q][0]:.3f} "
              f"ms, card (GalleryIndex.search, copies included) "
              f"{times[Q][1]:.3f} ms; same top-5")

    # the demo over the artifact's directory, which holds no embeddings.npy
    pipe = DemoPipeline(encoder, faiss_dir)
    if len(pipe.build_index(DATASET)) != GALLERY_ROWS:
        raise AssertionError("the demo did not import the FAISS artifact")
    try:
        DemoPipeline(face_encoder, faiss_dir).build_index(DATASET)
    except ValueError as e:
        print(f"DemoPipeline with the face encoder refuses the artifact: "
              f"{str(e).split('. ')[0]}")
    else:
        raise AssertionError("the demo took a 768-wide gallery for a "
                             "512-wide encoder")
    from PIL import Image

    with Image.open(os.path.join(DATASET, "000011.jpg")) as im:
        image = np.asarray(im.convert("RGB"))
    _reset_counts()
    t0 = time.perf_counter()
    shown, scores, found = pipe.retrieve(image, k=5)
    demo_s = time.perf_counter() - t0
    launches_demo = _counts()["topk_gallery_search"]
    print(f"DemoPipeline.retrieve (Otsu mask, facer absent): {demo_s:.3f} s, "
          f"{launches_demo} top-k launch; "
          f"{[(os.path.basename(p), round(s, 4)) for p, s in zip(found, scores)]}")
    if launches_demo != 1 or len(shown) != 5 or \
            shown[0].shape[-1] != 3:
        raise AssertionError("the demo's retrieval")
    return {"write_s": write_s, "import_s": import_s, "cli_s": cli_s,
            "host_times": times, "demo_s": demo_s, "launches_cli": launches,
            "launches_demo": launches_demo}


# ---------------------------------------------------------------------------
# phase 6: the SHAM training slice through its entry point
# ---------------------------------------------------------------------------

def _write_manifest(workdir: str) -> str:
    """The repo's 64 hair crops, each listed twice: 128 rows, 2 steps of 64
    an epoch."""
    names = sorted(n for n in os.listdir(DATASET) if n.endswith("_hair.png"))
    if len(names) != 64:
        raise AssertionError(f"expected 64 hair crops, found {len(names)}")
    path = os.path.join(workdir, "train.csv")
    with open(path, "w") as f:
        f.write("id,class\n")
        for rep in range(2):
            f.writelines(f"{n},{i}\n" for i, n in enumerate(names))
    return path


def _step_times(recipe, state, images, stage, runs=10, warmup=3):
    """Median host ms per ``train_step`` (each ends in a synchronize)."""
    import torch

    times = []
    for i in range(warmup + runs):
        gen = torch.Generator().manual_seed(1000 + i)
        t0 = time.perf_counter()
        recipe.train_step(state, images, gen, stage=stage, batch_id=0, k=7)
        torch.cuda.synchronize()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def phase_train(workdir: str, kern: dict) -> dict:
    import torch

    from hairci_torch.cli import mainpretrain
    from hairci_torch.ssl import sham

    manifest = _write_manifest(workdir)
    epochs, steps_per_epoch = 3, 128 // TRAIN_BATCH
    argv = ["--mode", "SHAM", "--model", "resnet50", "--size", str(SIZE),
            "--lr", "0.001", "--weight_decay", "1e-4", "--temp", "0.5",
            "--ema", "0.99", "--k", "7", "--seed", "42",
            "--batch_size", str(TRAIN_BATCH), "--epochs", str(epochs),
            "--warm_up_epochs", "2", "--num_workers", "8",
            "--train_annotation", manifest, "--img_dir", DATASET,
            "--save_path", os.path.join(workdir, "out")]
    torch.cuda.reset_peak_memory_stats()
    # the layout of the view the step hands to positive_transform (the rotate
    # kernel gathers at its strides)
    seen, positive_transform = [], sham.positive_transform

    def spy(x, d):
        if not seen:
            seen.append((tuple(x.stride()), x.is_contiguous()))
        return positive_transform(x, d)

    sham.positive_transform = spy
    _reset_counts()
    decodes = _decodes()
    t0 = time.perf_counter()
    try:
        trainer = mainpretrain.main(argv)
        torch.cuda.synchronize()
    finally:
        sham.positive_transform = positive_transform
    seconds = time.perf_counter() - t0
    launches = _counts()
    _check_decode_route("mainpretrain resnet50", _decodes() - decodes,
                        epochs * steps_per_epoch * TRAIN_BATCH)
    print(f"x_pos1 on the SHAM step: strides {seen[0][0]}, contiguous "
          f"{seen[0][1]}")
    steps = epochs * steps_per_epoch
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"mainpretrain SHAM resnet50 {SIZE}px bf16 B={TRAIN_BATCH}: "
          f"{steps} steps over {epochs} epochs in {seconds:.1f} s (model "
          f"build and first-step warmup included); peak memory "
          f"{peak:.2f} GiB; launches {launches}")
    if launches["rotate_shear"] != steps:
        raise AssertionError(f"rotate launches {launches['rotate_shear']} "
                             f"!= {steps} steps")
    if launches["bn_stats"] != 55 * steps:
        raise AssertionError(f"bn_stats launches {launches['bn_stats']} != "
                             f"55 x {steps} steps")
    # forwards that need no gradient go through the conv3x3 kernel: the EMA
    # teacher's, one a step, and one more in each step of the mining epoch
    no_grad_forwards = steps + steps_per_epoch
    if launches["conv3x3"] != 3 * no_grad_forwards:
        raise AssertionError(f"conv3x3 launches {launches['conv3x3']} != 3 x "
                             f"{no_grad_forwards} forwards without gradient")
    # the trunk's 53 BNs: one fused apply each in every forward (train mode
    # in the step's, eval mode in the EMA's), one of each backward kernel a
    # step
    fused = bn_apply_counts()
    want = {"train": 53 * steps, "eval": 53 * no_grad_forwards,
            "grad_sums": 53 * steps, "grad_input": 53 * steps}
    print(f"fused BatchNorm launches {fused}")
    if fused != want:
        raise AssertionError(f"fused BatchNorm launches {fused} != {want}")

    with open(os.path.join(trainer.save_path, "metrics.jsonl")) as f:
        metrics = [json.loads(line) for line in f]
    log = os.path.join(trainer.save_path, "training_log.txt")
    for m in metrics:
        print(f"epoch {m['epoch']}: loss {m['loss']:.6f} contrastive "
              f"{m['contrastive_loss']:.6f} triplet {m['triplet_loss']:.6f} "
              f"mse {m['mse_loss']:.6f} violations {m['margin_violations']} "
              f"{m['images_per_sec']:.1f} img/s (host clock, loader "
              f"included)")
    if [m["epoch"] for m in metrics] != list(range(epochs)) or not all(
            math.isfinite(m[k]) for m in metrics for k in m):
        raise AssertionError(f"metrics.jsonl: {metrics}")
    if not (os.path.isfile(log) and os.path.isfile(os.path.join(
            trainer.save_path, "model_ckpt_latest"))):
        raise AssertionError("training_log.txt or model_ckpt_latest missing")
    state, recipe = trainer.state, trainer.recipe
    # the cache starts as zeros; mine writes one row of indices per batch
    neg = state.neg_indices.cpu()
    if not (neg.shape == (steps_per_epoch, TRAIN_BATCH)
            and bool((neg != 0).any(1).all())
            and bool(((neg >= 0) & (neg < TRAIN_BATCH)).all())):
        raise AssertionError(f"neg_indices were not mined: {neg}")

    images, _ = next(iter(trainer.train_loader))
    images = torch.from_numpy(images).cuda()
    step_ms = {stage: _step_times(recipe, state, images, stage)
               for stage in ("warmup", "mined")}
    for stage, ms in step_ms.items():
        print(f"train_step {stage} B={TRAIN_BATCH}: median {ms:.2f} ms/step "
              f"({TRAIN_BATCH * 1e3 / ms:.1f} img/s), host clock, each step "
              f"synchronised")
    k_ms = kern["rotate"]["times"]["blur"][0] + kern["bn_stats"]["step"][0]
    print(f"the two kernels' share of a mined step: {k_ms:.3f} ms of "
          f"{step_ms['mined']:.2f} ms ({100 * k_ms / step_ms['mined']:.2f} %,"
          f" from the kernels' times at these shapes in phase 3)")
    save_path = trainer.save_path
    del trainer, state, images
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_ms, "peak_gib": peak,
            "save_path": save_path, "manifest": manifest}


# ---------------------------------------------------------------------------
# phase 7: the kNN evaluation slice through its entry point
# ---------------------------------------------------------------------------

def _embed_ms(recipe, state, images, library_conv: bool = False,
              runs: int = 20) -> float:
    """Median device ms of ``recipe.extract_features`` on a uint8 batch.
    ``library_conv`` sends the three 64 -> 64 3x3 convs to F.conv2d (cuDNN)
    instead of the conv3x3 kernel, for this measurement only."""
    from hairci_torch.models.resnet import Conv2d

    convs = [m for m in state.online.modules()
             if isinstance(m, Conv2d) and m.to_kernel]
    if len(convs) != 3:
        raise AssertionError(f"{len(convs)} convs of the kernel's shape in "
                             "ResNet-50, expected 3")
    try:
        for m in convs:
            m.to_kernel = not library_conv
        return _median_ms(lambda: recipe.extract_features(state, images),
                          runs=runs, warmup=3)
    finally:
        for m in convs:
            m.to_kernel = True


def phase_knn(workdir: str, train: dict) -> dict:
    import numpy as np
    import torch

    from hairci_torch.cli import knn_classification
    from hairci_torch.eval.knn import DEFAULT_KS, knn_predict

    batch = CLI_BATCH
    test_csv = os.path.join(workdir, "test.csv")
    with open(train["manifest"]) as f:
        rows = f.read().splitlines()
    with open(test_csv, "w") as f:
        f.write("\n".join(rows[:65]) + "\n")   # the header and 64 images
    out_dir = os.path.join(workdir, "knn_out")
    argv = ["--mode", "SHAM", "--model", "resnet50", "--size", str(SIZE),
            "--dtype", "bfloat16", "--eval_type", "knn",
            "--batch_size", str(batch), "--num_workers", "8",
            "--checkpoint_path", train["save_path"],
            "--train_annotation", train["manifest"],
            "--test_annotation", test_csv, "--img_dir", DATASET,
            "--save_path", out_dir]
    forwards = math.ceil(128 / batch) + math.ceil(64 / batch)
    _reset_counts()
    decodes = _decodes()
    t0 = time.perf_counter()
    clf = knn_classification.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _counts()
    _check_decode_route("knn_classification resnet50", _decodes() - decodes,
                        128 + 64)
    print(f"knn_classification SHAM resnet50 {SIZE}px bf16, batches of "
          f"{batch}: 128 train + 64 test images, {forwards} forwards, in "
          f"{seconds:.2f} s (model build and checkpoint load included); "
          f"launches {launches}")
    if launches["conv3x3"] != 3 * forwards:
        raise AssertionError(f"conv3x3 launches {launches['conv3x3']} != 3 x "
                             f"{forwards} forwards")
    if launches["bn_stats"] != 0:
        raise AssertionError("an eval-mode BatchNorm took batch statistics")
    with open(os.path.join(out_dir, "knn_evaluation_results.txt")) as f:
        text = f.read()
    accuracy = {}
    for k in DEFAULT_KS:
        head = f"Results for k={k}\n" + "-" * 40 + "\nAccuracy: "
        if text.count(head) != 1:
            raise AssertionError(f"knn_evaluation_results.txt: no block for "
                                 f"k={k}")
        accuracy[k] = float(text.split(head)[1].split("\n")[0])
    print(f"knn_evaluation_results.txt: accuracy by k {accuracy}")
    tr_f, tr_l, te_f, te_l = clf.extracting_features()
    if tr_f.shape != (128, 2048) or te_f.shape != (64, 2048) or \
            tr_f.dtype != np.float32:
        raise AssertionError(f"features {tr_f.shape} {te_f.shape}")
    for f in (tr_f, te_f):
        norms = np.linalg.norm(f, axis=1)
        if not (np.isfinite(f).all() and np.abs(norms - 1).max() < 1e-3):
            raise AssertionError("features are not finite and unit-norm")
    # every test image is in the train set: its nearest neighbour is itself
    self_hit = float(np.mean(knn_predict(tr_f, tr_l, te_f, 1) == te_l))
    print(f"self-retrieval at k=1: {100 * self_hit:.1f} %")
    if self_hit != 1.0:
        raise AssertionError("k=1 self-retrieval is not 100 %")

    # the device's share of the embed: the forwards' device time (CUDA
    # events, same batch shape) against the host clock of a second
    # extraction over both loaders
    images, _ = next(iter(clf.train_loader))
    x = torch.from_numpy(images).cuda()
    fwd_ms = _median_ms(lambda: clf.embed_fn(x), runs=10, warmup=2)
    clf._cached = None
    t0 = time.perf_counter()
    clf.extracting_features()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    idle = 1 - forwards * fwd_ms / wall_ms
    print(f"embed through the loader: {192 / wall_ms * 1e3:.1f} img/s over "
          f"192 images in {wall_ms:.1f} ms (PIL decode, 8 threads); forward "
          f"at batch {batch} {fwd_ms:.3f} ms, so the card is idle an "
          f"estimated {100 * idle:.1f} % of the extraction (not from a "
          f"trace)")
    del clf, x
    torch.cuda.empty_cache()
    return {"launches": launches, "idle": idle}


# ---------------------------------------------------------------------------
# phase 7b: SHAM on ViT-B/16 with S2R2 through the training entry point
# ---------------------------------------------------------------------------

REMAT_MODES = (False, True, "selective", "half")
CONFIG_BATCH = 256       # the batch size of configs/pretrain_{sham,simclr,
                         # simclr_supcon}.yaml


def _vit_recipe(remat):
    """The train-vit phase's recipe (bf16, S2R2) with one mined batch."""
    import torch

    from hairci_torch.ssl.sham import SHAMRecipe

    return SHAMRecipe(backbone="vit_b_16", img_size=SIZE, weight_decay=1e-4,
                      num_batches=1, s2r2_weight=1.0, remat=remat,
                      dtype=torch.bfloat16)


def phase_train_vit(workdir: str, train: dict) -> dict:
    import numpy as np
    import torch

    from hairci_torch.cli import mainpretrain

    epochs, steps_per_epoch = 3, 128 // TRAIN_BATCH
    steps = epochs * steps_per_epoch
    argv = ["--mode", "SHAM", "--model", "vit_b_16", "--S2R2",
            "--size", str(SIZE), "--dtype", "bfloat16",
            "--lr", "0.001", "--weight_decay", "1e-4", "--temp", "0.5",
            "--ema", "0.99", "--k", "7", "--seed", "42",
            "--batch_size", str(TRAIN_BATCH), "--epochs", str(epochs),
            "--warm_up_epochs", "2", "--num_workers", "8",
            "--train_annotation", train["manifest"], "--img_dir", DATASET,
            "--save_path", os.path.join(workdir, "out_vit")]
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    decodes = _decodes()
    t0 = time.perf_counter()
    trainer = mainpretrain.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _counts()
    _check_decode_route("mainpretrain vit_b_16", _decodes() - decodes,
                        steps * TRAIN_BATCH)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"mainpretrain SHAM vit_b_16 --S2R2 {SIZE}px bf16 B={TRAIN_BATCH} "
          f"remat=True: {steps} steps over {epochs} epochs in {seconds:.1f} "
          f"s (model build and first-step warmup included); peak memory "
          f"{peak:.2f} GiB; launches {launches}")
    # one rotate a step (positive_transform), the head's two train-mode BNs
    # a step, and no 3x3 conv anywhere in a ViT
    want = {"rotate_shear": steps, "bn_stats": 2 * steps, "conv3x3": 0,
            "topk_gallery_search": 0}
    if launches != want:
        raise AssertionError(f"ViT SHAM launches {launches} != {want}")
    with open(os.path.join(trainer.save_path, "metrics.jsonl")) as f:
        metrics = [json.loads(line) for line in f]
    for m in metrics:
        rest = (m["contrastive_loss"] + 0.5 * m["triplet_loss"]
                + 0.2 * m["mse_loss"])
        print(f"epoch {m['epoch']}: loss {m['loss']:.6f} (S2R2 "
              f"{m['loss'] - rest:.6f}) contrastive "
              f"{m['contrastive_loss']:.6f} triplet {m['triplet_loss']:.6f} "
              f"mse {m['mse_loss']:.6f} violations {m['margin_violations']}"
              f" {m['images_per_sec']:.1f} img/s (host clock, loader "
              f"included)")
        # Smooth-AP is 1 - mean AP, in [0, 1]
        if not -1e-4 <= m["loss"] - rest <= 1 + 1e-4:
            raise AssertionError(f"S2R2 term out of [0, 1]: {m}")
    if [m["epoch"] for m in metrics] != list(range(epochs)) or not all(
            math.isfinite(m[k]) for m in metrics for k in m):
        raise AssertionError(f"metrics.jsonl: {metrics}")
    neg = trainer.state.neg_indices.cpu()
    if not bool((neg != 0).any(1).all()):
        raise AssertionError(f"neg_indices were not mined: {neg}")
    images, _ = next(iter(trainer.train_loader))
    images = torch.from_numpy(images).cuda()
    save_path = trainer.save_path
    del trainer
    torch.cuda.empty_cache()

    # the step at B=64 in each remat mode: median ms of 10 after 3, and the
    # peak memory of the run (model, EMA, optimizer and the step)
    by_mode = {}
    for mode in REMAT_MODES:
        torch.cuda.reset_peak_memory_stats()
        rec = _vit_recipe(mode)
        state = rec.create_state(SEED, TRAIN_BATCH, torch.device("cuda"))
        rec.train_step(state, images, torch.Generator().manual_seed(SEED),
                       stage="mine", batch_id=0, k=7)
        ms = {stage: _step_times(rec, state, images, stage)
              for stage in ("warmup", "mined")}
        peak_mode = torch.cuda.max_memory_allocated() / 2 ** 30
        by_mode[str(mode)] = {"ms": ms, "peak_gib": peak_mode}
        print(f"train_step vit_b_16 S2R2 B={TRAIN_BATCH} remat={mode!r}: "
              f"warmup {ms['warmup']:.2f} ms, mined {ms['mined']:.2f} ms "
              f"({TRAIN_BATCH * 1e3 / ms['mined']:.1f} img/s), host clock, "
              f"each step synchronised; peak memory {peak_mode:.2f} GiB")
        del rec, state
        torch.cuda.empty_cache()

    # the config's batch with block remat, on a seeded uint8 batch
    big = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 256, (CONFIG_BATCH, 256, 256, 3), dtype=np.uint8)).cuda()
    torch.cuda.reset_peak_memory_stats()
    config = {"fits": True}
    try:
        rec = _vit_recipe(True)
        state = rec.create_state(SEED, CONFIG_BATCH, torch.device("cuda"))
        config["ms"] = _step_times(rec, state, big, "warmup", runs=1,
                                   warmup=1)
    except torch.cuda.OutOfMemoryError as e:
        config = {"fits": False, "error": str(e).splitlines()[0]}
    config["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"train_step vit_b_16 S2R2 B={CONFIG_BATCH} remat=True (the "
          f"config's batch): {config}")
    rec = state = big = None
    torch.cuda.empty_cache()
    return {"launches": launches, "save_path": save_path,
            "manifest": train["manifest"], "peak_gib": peak,
            "by_mode": by_mode, "config_batch": config}


# ---------------------------------------------------------------------------
# phase 7c: kNN evaluation of the ViT SHAM checkpoint
# ---------------------------------------------------------------------------

def phase_knn_vit(workdir: str, train_vit: dict, mode: str = "SHAM",
                  self_retrieval: bool = True, width: int = WIDTH,
                  norm_tol: float = 1e-3) -> dict:
    """knn_classification.main on a ViT checkpoint of ``mode`` (SHAM in
    phase 7c, mae and simMIM in phases 7g and 7h, dinov2 (ViT-S/16, 384-d)
    and MSN in phases 7i and 7j, siaMIM in phase 7m); self-retrieval at k=1
    is printed, and asserted where ``self_retrieval``. The features' norms
    must lie within ``norm_tol`` of 1."""
    import numpy as np
    import torch

    from hairci_torch.cli import knn_classification
    from hairci_torch.eval.knn import DEFAULT_KS, knn_predict

    test_csv = os.path.join(workdir, "test.csv")    # phase 7's 64 images
    out_dir = os.path.join(workdir, f"knn_vit_out_{mode}")
    argv = ["--mode", mode, "--model", "vit_b_16", "--size", str(SIZE),
            "--dtype", "bfloat16", "--eval_type", "knn",
            "--batch_size", str(CLI_BATCH), "--num_workers", "8",
            "--checkpoint_path", train_vit["save_path"],
            "--train_annotation", train_vit["manifest"],
            "--test_annotation", test_csv, "--img_dir", DATASET,
            "--save_path", out_dir]
    _reset_counts()
    decodes = _decodes()
    t0 = time.perf_counter()
    clf = knn_classification.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _counts()
    _check_decode_route("knn_classification vit_b_16", _decodes() - decodes,
                        128 + 64)
    print(f"knn_classification {mode} vit_b_16 {SIZE}px bf16, batches of "
          f"{CLI_BATCH}: 128 train + 64 test images in {seconds:.2f} s (model"
          f" build and checkpoint load included); launches {launches}")
    if any(launches.values()):
        raise AssertionError("the ViT eval path launched a kernel: "
                             f"{launches}")
    with open(os.path.join(out_dir, "knn_evaluation_results.txt")) as f:
        text = f.read()
    accuracy = {}
    for k in DEFAULT_KS:
        head = f"Results for k={k}\n" + "-" * 40 + "\nAccuracy: "
        if text.count(head) != 1:
            raise AssertionError(f"knn_evaluation_results.txt: no block for "
                                 f"k={k}")
        accuracy[k] = float(text.split(head)[1].split("\n")[0])
    print(f"knn_evaluation_results.txt ({mode} vit_b_16): accuracy by k "
          f"{accuracy}")
    tr_f, tr_l, te_f, te_l = clf.extracting_features()
    if tr_f.shape != (128, width) or te_f.shape != (64, width):
        raise AssertionError(f"features {tr_f.shape} {te_f.shape}")
    for f in (tr_f, te_f):
        norms = np.linalg.norm(f, axis=1)
        if not (np.isfinite(f).all()
                and np.abs(norms - 1).max() < norm_tol):
            raise AssertionError("features are not finite and unit-norm")
    self_hit = float(np.mean(knn_predict(tr_f, tr_l, te_f, 1) == te_l))
    # how far apart two different images' features lie: the noise of the
    # forward (the same image in another batch) must stay below it
    cos = te_f @ te_f.T
    np.fill_diagonal(cos, -1.0)
    own = np.sum(te_f * tr_f[:64], axis=1)          # rows 0-63: the same
    print(f"self-retrieval at k=1 ({mode} vit_b_16): "
          f"{100 * self_hit:.1f} %; 1 - cosine to the image's own train row: "
          f"max {float(np.max(1 - own)):.3g}; to the nearest other image: min "
          f"{float(np.min(1 - cos.max(1))):.3g}")
    if self_retrieval and self_hit != 1.0:
        raise AssertionError("k=1 self-retrieval is not 100 %")
    del clf
    torch.cuda.empty_cache()
    return {"launches": launches, "seconds": seconds,
            "features": (tr_f, te_f)}


# ---------------------------------------------------------------------------
# phases 7d and 7e: the SimCLR and SupCon baselines through the training CLI
# ---------------------------------------------------------------------------

# mode -> the configuration's model and temperature (configs/
# pretrain_simclr.yaml, configs/pretrain_simclr_supcon.yaml, passed as flags),
# the train-mode BN inputs of one step, and the batches timed
BASELINES = {
    "simclr": {"model": "resnet50", "temp": "0.7", "bn": 55,
               "timed": (TRAIN_BATCH,)},
    "simclr_supcon": {"model": "resnet18", "temp": "0.07", "bn": 20,
                      "timed": (TRAIN_BATCH, 2 * TRAIN_BATCH)},
}
BASELINE_EPOCHS = 2
FIT_GIB = 75.0           # a batch runs only where its extrapolated peak fits


def _baseline_step_times(recipe, state, images, labels, runs=10, warmup=3):
    """Median host ms per ``train_step`` of SimCLR or SupCon (each ends in a
    synchronize)."""
    import torch

    times = []
    for i in range(warmup + runs):
        gen = torch.Generator().manual_seed(1000 + i)
        t0 = time.perf_counter()
        recipe.train_step(state, images, gen, labels=labels)
        torch.cuda.synchronize()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def _timed_batch(recipe, B: int, runs: int = 10, warmup: int = 3) -> dict:
    """A fresh seeded state at batch ``B`` on a seeded uint8 batch (256 px
    for 224, as the loader resizes for the crop) and labels of 64 classes:
    median step ms and the peak memory of state and steps."""
    import numpy as np
    import torch

    raw = max(SIZE, int(SIZE * 256 / 224))
    rng = np.random.default_rng(SEED)
    images = torch.from_numpy(rng.integers(0, 256, (B, raw, raw, 3),
                                           dtype=np.uint8)).cuda()
    labels = torch.from_numpy(rng.integers(0, 64, B)).cuda()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = recipe.create_state(SEED, B, torch.device("cuda"))
    ms = _baseline_step_times(recipe, state, images, labels, runs, warmup)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del state, images, labels
    torch.cuda.empty_cache()
    return {"ms": ms, "peak_gib": peak}


def phase_train_baseline(workdir: str, train: dict, mode: str) -> dict:
    import torch

    from hairci_torch.cli import mainpretrain

    cfg = BASELINES[mode]
    batch = CLI_BATCH
    steps_per_epoch = math.ceil(128 / batch)         # 48 + 48 + 32 padded
    steps = BASELINE_EPOCHS * steps_per_epoch
    argv = ["--mode", mode, "--model", cfg["model"], "--temp", cfg["temp"],
            "--lr", "0.001", "--size", str(SIZE), "--dtype", "bfloat16",
            "--seed", "42", "--batch_size", str(batch), "--epochs",
            str(BASELINE_EPOCHS), "--num_workers", "8",
            "--train_annotation", train["manifest"], "--img_dir", DATASET,
            "--save_path", os.path.join(workdir, f"out_{mode}")]
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    decodes = _decodes()
    t0 = time.perf_counter()
    trainer = mainpretrain.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _counts()
    # the padding repeats decoded rows: every image is decoded once an epoch
    _check_decode_route(f"mainpretrain {mode}", _decodes() - decodes,
                        BASELINE_EPOCHS * 128)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"mainpretrain {mode} {cfg['model']} {SIZE}px bf16 B={batch}: "
          f"{steps} steps over {BASELINE_EPOCHS} epochs in {seconds:.1f} s "
          f"(model build and first-step warmup included); peak memory "
          f"{peak:.2f} GiB; launches {launches}")
    loader = trainer.train_loader
    if not (len(loader) == steps_per_epoch and loader.pad_last
            and not loader.drop_last and trainer.state.step == steps):
        raise AssertionError(f"{mode}: {len(loader)} batches an epoch, "
                             f"pad_last {loader.pad_last}, "
                             f"{trainer.state.step} steps")
    want = {"rotate_shear": 0, "bn_stats": cfg["bn"] * steps, "conv3x3": 0,
            "topk_gallery_search": 0}
    if launches != want:
        raise AssertionError(f"{mode} launches {launches} != {want}")
    with open(os.path.join(trainer.save_path, "metrics.jsonl")) as f:
        metrics = [json.loads(line) for line in f]
    with open(os.path.join(trainer.save_path, "training_log.txt")) as f:
        log = f.read()
    for m in metrics:
        print(f"{mode} epoch {m['epoch']}: loss {m['loss']:.6f} "
              f"{m['images_per_sec']:.1f} img/s (host clock, loader "
              f"included)")
    if [m["epoch"] for m in metrics] != list(range(BASELINE_EPOCHS)) or \
            not all(math.isfinite(m["loss"]) for m in metrics) or \
            log.count(": Loss = ") != BASELINE_EPOCHS:
        raise AssertionError(f"{mode}: metrics {metrics}, log {log!r}")
    ckpt = torch.load(os.path.join(trainer.save_path, "model_ckpt_latest"),
                      map_location="cpu", weights_only=True)
    if set(ckpt) != {"online", "optimizer", "step", "epoch"}:
        raise AssertionError(f"{mode} checkpoint keys {sorted(ckpt)}")
    recipe, save_path = trainer.recipe, trainer.save_path
    del trainer, ckpt
    torch.cuda.empty_cache()

    timed = {}
    for B in cfg["timed"]:
        timed[B] = _timed_batch(recipe, B)
        print(f"train_step {mode} {cfg['model']} bf16 B={B}: median "
              f"{timed[B]['ms']:.2f} ms/step ({B * 1e3 / timed[B]['ms']:.1f} "
              f"img/s), host clock, each step synchronised; peak memory "
              f"{timed[B]['peak_gib']:.2f} GiB")
    # the config's batch, where the largest timed batch's peak, scaled by
    # rows, says that it fits
    last = cfg["timed"][-1]
    extrapolated = timed[last]["peak_gib"] * CONFIG_BATCH / last
    if extrapolated < FIT_GIB:
        config = {"fits": True, **_timed_batch(recipe, CONFIG_BATCH, runs=1,
                                               warmup=1)}
    else:
        config = {"fits": False, "extrapolated_peak_gib": extrapolated}
    print(f"train_step {mode} {cfg['model']} bf16 B={CONFIG_BATCH} (the "
          f"config's batch; {timed[last]['peak_gib']:.2f} GiB at B={last} "
          f"scales to {extrapolated:.1f} GiB): "
          + (f"{config['ms']:.2f} ms, peak memory {config['peak_gib']:.2f} "
             f"GiB" if config["fits"] else "does not fit"))
    return {"launches": launches, "save_path": save_path, "timed": timed,
            "config_batch": config, "peak_gib": peak}


# ---------------------------------------------------------------------------
# phases 7g and 7h: the masked-image recipes through the training CLI
# ---------------------------------------------------------------------------

# mode -> the tokens the encoder sees at 224 px (MAE: the 49 kept of 196 and
# cls; SimMIM: all 196), the decoder built beside it, and whether the kNN
# check holds self-retrieval at k=1. The 64 crops hold near-duplicates: the
# nearest other image lies at 1 - cosine = 3.0e-6 (SHAM ViT) and 3.2e-6
# (MAE) of a barely trained model's cls token, and within rounding of it
# for SimMIM's mean of 196 normed tokens (on the card: 93.8 % self-retrieval
# in bf16, 81.2 % in f32). SimMIM's features are held card against CPU
# instead, after the mean over the images is taken out
MASKED = {"mae": {"tokens": 50, "decoder": (8, 512), "self_retrieval": True},
          "simMIM": {"tokens": 196, "decoder": None, "self_retrieval": False}}
MASKED_EPOCHS = 2


def _masked_step_times(recipe, B: int, images=None, runs: int = 10,
                       warmup: int = 3) -> dict:
    """A fresh seeded state at batch ``B`` (on ``images``, else a seeded
    uint8 batch at 256 px): ``runs`` steps timed after ``warmup`` by
    ``utils.profiling.StepTimer`` (the card synchronised round each step),
    the peak memory of state and steps, and the step's operations an image
    by ``FlopCounterMode`` (one more step, counted, not timed)."""
    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from hairci_torch.utils.profiling import StepTimer

    if images is None:
        images = torch.from_numpy(np.random.default_rng(SEED).integers(
            0, 256, (B, 256, 256, 3), dtype=np.uint8)).cuda()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = recipe.create_state(SEED, B, torch.device("cuda"))
    timer = StepTimer(warmup=warmup, device="cuda")
    for i in range(warmup + runs):
        with timer:
            recipe.train_step(state, images, torch.Generator().manual_seed(
                1000 + i))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counter = FlopCounterMode(display=False)
    with counter:
        recipe.train_step(state, images, torch.Generator().manual_seed(999))
    torch.cuda.synchronize()
    flops = counter.get_total_flops()
    del state
    torch.cuda.empty_cache()
    return {"ms": timer.p50 * 1e3, "mean_ms": timer.mean * 1e3,
            "peak_gib": peak, "gflop_per_image": flops / B / 1e9,
            "tflop_s": flops / timer.p50 / 1e12}


def _features_card_vs_cpu(mode: str, save_path: str, test_csv: str,
                          n: int = 16) -> float:
    """The checkpoint's eval features of the first ``n`` test images (the
    kNN loader's centre crops), f32 on the card (TF32 off) against f32 on
    the CPU, each less the mean over the images: the part that tells two
    images apart must agree (relative error < 1e-2)."""
    import torch

    from hairci_torch.data import DataLoader, load_manifest
    from hairci_torch.ssl import build_recipe
    from hairci_torch.train import checkpoint as ckpt_lib

    loader = DataLoader(load_manifest(test_csv, DATASET), n, size=SIZE,
                        mode="center_crop", shuffle=False, num_workers=8)
    images = torch.from_numpy(next(iter(loader))[0])
    rec = build_recipe(mode, img_size=SIZE, dtype=torch.float32)
    path = ckpt_lib.get_latest_checkpoint(save_path)
    feats = {}
    for dev in ("cuda", "cpu"):
        state = rec.create_state(SEED, n, torch.device(dev))
        ckpt_lib.restore_weights(path, state)
        feats[dev] = rec.extract_features(state, images.to(dev)).cpu().double()
        del state
    centred = {dev: f - f.mean(0) for dev, f in feats.items()}
    rel = float((centred["cuda"] - centred["cpu"]).norm()
                / centred["cpu"].norm())
    spread = float(centred["cpu"].norm(dim=1).mean()
                   / feats["cpu"].norm(dim=1).mean())
    print(f"{mode} eval features, {n} images, f32 card vs f32 CPU: relative "
          f"error {rel:.3g} of the part that differs between images (that "
          f"part is {spread:.3g} of a feature's norm)")
    if not rel < 1e-2:
        raise AssertionError(f"{mode} features: card and CPU differ by {rel}")
    torch.cuda.empty_cache()
    return rel


def phase_train_masked(workdir: str, train: dict, mode: str) -> dict:
    """``configs/pretrain_mae.yaml`` as flags (SimMIM has no config; the
    same flags), B cut from 256 to 64, through mainpretrain.main: the
    ViT-B/16 recipe at full width and depth, no kernel launch, a finite
    ``Loss =`` line each epoch, a checkpoint; then the step timed at B=64
    and at the config's B=256 where the B=64 peak, scaled by rows, fits."""
    import torch

    from hairci_torch.cli import mainpretrain

    steps_per_epoch = 128 // TRAIN_BATCH
    steps = MASKED_EPOCHS * steps_per_epoch
    argv = ["--mode", mode, "--model", "vit_b_16", "--lr", "0.001",
            "--size", str(SIZE), "--dtype", "bfloat16", "--seed", "42",
            "--batch_size", str(TRAIN_BATCH), "--epochs", str(MASKED_EPOCHS),
            "--num_workers", "8", "--train_annotation", train["manifest"],
            "--img_dir", DATASET,
            "--save_path", os.path.join(workdir, f"out_{mode}")]
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    decodes = _decodes()
    t0 = time.perf_counter()
    trainer = mainpretrain.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _counts()
    _check_decode_route(f"mainpretrain {mode}", _decodes() - decodes,
                        MASKED_EPOCHS * 128)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"mainpretrain {mode} vit_b_16 {SIZE}px bf16 B={TRAIN_BATCH}: "
          f"{steps} steps over {MASKED_EPOCHS} epochs in {seconds:.1f} s "
          f"(model build and first-step warmup included); peak memory "
          f"{peak:.2f} GiB; launches {launches}")
    # no BatchNorm, no rotation, no 3x3 conv, no gallery search on this path
    if any(launches.values()):
        raise AssertionError(f"{mode} launched a kernel: {launches}")
    recipe, module = trainer.recipe, trainer.state.online
    encoder = module.encoder if mode == "mae" else module
    width, depth = encoder.embed_dim, len(encoder.blocks)
    decoder = ((len(module.decoder.blocks), module.decoder.embed.out_features)
               if mode == "mae" else None)
    if (recipe.backbone, width, depth, decoder) != (
            "vit_base_patch16", WIDTH, 12, MASKED[mode]["decoder"]):
        raise AssertionError(f"{mode}: {recipe.backbone} {width} x {depth}, "
                             f"decoder {decoder}")
    if trainer.state.step != steps:
        raise AssertionError(f"{mode}: {trainer.state.step} steps")
    with open(os.path.join(trainer.save_path, "metrics.jsonl")) as f:
        metrics = [json.loads(line) for line in f]
    with open(os.path.join(trainer.save_path, "training_log.txt")) as f:
        log = f.read()
    for m in metrics:
        print(f"{mode} epoch {m['epoch']}: loss {m['loss']:.6f} "
              f"{m['images_per_sec']:.1f} img/s (host clock, loader "
              f"included)")
    if [m["epoch"] for m in metrics] != list(range(MASKED_EPOCHS)) or \
            not all(math.isfinite(m["loss"]) for m in metrics) or \
            log.count(": Loss = ") != MASKED_EPOCHS:
        raise AssertionError(f"{mode}: metrics {metrics}, log {log!r}")
    ckpt = torch.load(os.path.join(trainer.save_path, "model_ckpt_latest"),
                      map_location="cpu", weights_only=True)
    if set(ckpt) != {"online", "optimizer", "step", "epoch"}:
        raise AssertionError(f"{mode} checkpoint keys {sorted(ckpt)}")
    images, _ = next(iter(trainer.train_loader))
    images = torch.from_numpy(images).cuda()
    save_path = trainer.save_path
    del trainer, module, encoder, ckpt
    torch.cuda.empty_cache()

    timed = _masked_step_times(recipe, TRAIN_BATCH, images)
    print(f"train_step {mode} vit_b_16 bf16 B={TRAIN_BATCH} (encoder over "
          f"{MASKED[mode]['tokens']} tokens): p50 {timed['ms']:.2f} ms, mean "
          f"{timed['mean_ms']:.2f} ms ({TRAIN_BATCH * 1e3 / timed['ms']:.1f} "
          f"img/s), StepTimer, 10 after 3; {timed['gflop_per_image']:.2f} "
          f"GFLOP an image (FlopCounterMode, forward and backward), "
          f"{timed['tflop_s']:.1f} TFLOP/s; peak memory "
          f"{timed['peak_gib']:.2f} GiB")
    extrapolated = timed["peak_gib"] * CONFIG_BATCH / TRAIN_BATCH
    if extrapolated < FIT_GIB:
        config = {"fits": True, **_masked_step_times(
            recipe, CONFIG_BATCH, runs=1, warmup=1)}
    else:
        config = {"fits": False, "extrapolated_peak_gib": extrapolated}
    print(f"train_step {mode} vit_b_16 bf16 B={CONFIG_BATCH} (the config's "
          f"batch; {timed['peak_gib']:.2f} GiB at B={TRAIN_BATCH} scales to "
          f"{extrapolated:.1f} GiB): "
          + (f"{config['ms']:.2f} ms, peak memory {config['peak_gib']:.2f} "
             f"GiB, {config['tflop_s']:.1f} TFLOP/s" if config["fits"]
             else "does not fit"))
    knn = phase_knn_vit(workdir, {"save_path": save_path,
                                  "manifest": train["manifest"]}, mode,
                        MASKED[mode]["self_retrieval"])
    if not MASKED[mode]["self_retrieval"]:
        _features_card_vs_cpu(mode, save_path,
                              os.path.join(workdir, "test.csv"))
    return {"launches": launches, "knn_launches": knn["launches"],
            "timed": timed, "config_batch": config, "peak_gib": peak,
            "seconds": seconds}


# ---------------------------------------------------------------------------
# phases 7i and 7j: DINOv2 and MSN through the training CLI
# ---------------------------------------------------------------------------

# mode -> the batch of the CLI run (DINOv2: configs/pretrain_dinov2.yaml's
# 128, one step an epoch on the 128-row manifest; MSN has no config: 64),
# the flags of the run (the config's lr, weight decay and seed; MSN the
# CLI's defaults), the backbone and feature width the recipe must build,
# the train-mode BN launches of one step (MSN: the head's two BNs over the
# anchors, then over the focal views; DINOv2 has no BN), and whether the
# kNN check holds self-retrieval at k=1. DINOv2's LayerScale (1e-5 at init,
# about 2e-3 after two Adam steps) leaves its cls tokens within rounding of
# one another: its features are held card against CPU instead
DISTILL = {"dinov2": {"batch": 128, "flags": ["--lr", "0.001",
                                              "--weight_decay", "0.04"],
                      "backbone": "vit_small_patch16", "width": 384,
                      "bn_per_step": 0, "self_retrieval": False},
           "MSN": {"batch": TRAIN_BATCH, "flags": ["--lr", "0.001"],
                   "backbone": "vit_base_patch16", "width": WIDTH,
                   "bn_per_step": 4, "self_retrieval": True}}
DISTILL_EPOCHS = 2


def _distill_recipe(mode: str, B: int, **kw):
    """The recipe of the CLI run (bf16 at 224, its lr and weight decay: the
    config's, or the CLI's default 1e-4 for MSN; the run's schedules) for
    timing at batch ``B``."""
    import torch

    from hairci_torch.ssl import build_recipe

    return build_recipe(mode, img_size=SIZE, learning_rate=1e-3,
                        weight_decay=0.04 if mode == "dinov2" else 1e-4,
                        dtype=torch.bfloat16, epochs=DISTILL_EPOCHS,
                        steps_per_epoch=128 // B, **kw)


def _print_timed(what: str, B: int, t: dict, dtype: str = "bf16") -> None:
    print(f"train_step {what} {dtype} B={B}: p50 {t['ms']:.2f} ms, mean "
          f"{t['mean_ms']:.2f} ms ({B * 1e3 / t['ms']:.1f} img/s), "
          f"StepTimer, 10 after 3; {t['gflop_per_image']:.2f} GFLOP an image "
          f"(FlopCounterMode, forward and backward), {t['tflop_s']:.1f} "
          f"TFLOP/s; peak memory {t['peak_gib']:.2f} GiB")


def _device_breakdown(recipe, B: int, images, workdir: str, what: str,
                      step_ms: float) -> dict:
    """One step of ``recipe`` at batch ``B`` (after two untraced ones) under
    ``utils.profiling.trace``: the card's busy time (its kernels' and
    copies' durations summed; the step runs on one stream), its share of
    ``step_ms`` (the untraced step's p50: the traced step's wall time
    carries the profiler's host cost), and the kernels that took most of
    it."""
    import collections

    import torch

    from hairci_torch.utils.profiling import trace

    state = recipe.create_state(SEED, B, torch.device("cuda"))
    for i in range(3):
        gen = torch.Generator().manual_seed(2000 + i)
        if i < 2:
            recipe.train_step(state, images, gen)
            torch.cuda.synchronize()
            continue
        with trace(os.path.join(workdir, f"trace_{what}")) as prof:
            t0 = time.perf_counter()
            recipe.train_step(state, images, gen)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    by_kernel = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.name] += e.time_range.elapsed_us()
    busy = sum(by_kernel.values())
    print(f"{what} step B={B} under torch.profiler: the card busy "
          f"{busy / 1e3:.2f} ms, {100 * busy / 1e3 / step_ms:.1f} % of the "
          f"untraced step's p50 {step_ms:.2f} ms (traced wall "
          f"{wall_us / 1e3:.2f} ms); {len(by_kernel)} distinct kernels")
    for name, us in by_kernel.most_common(8):
        print(f"  {us / 1e3:9.2f} ms {100 * us / max(busy, 1):5.1f} %  "
              f"{name[:110]}")
    del state
    torch.cuda.empty_cache()
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
            "top": [(n[:110], us / 1e3)
                    for n, us in by_kernel.most_common(8)]}


def phase_train_distill(workdir: str, train: dict, mode: str) -> dict:
    """DINOv2 (``configs/pretrain_dinov2.yaml`` as flags: ViT-S/16 with
    LayerScale, the 65,536-prototype DINO/iBOT head, 2 global + 8 local
    views, B=128) or MSN (ViT-B/16, 1,024 prototypes, 2 + 10 focal views,
    B=64) through mainpretrain.main at 224, bf16, for 2 epochs; the launch
    counts (DINOv2 none, MSN exactly 4 bn_stats a step), a finite ``Loss =``
    line each epoch, the checkpoint's keys (DINOv2's centres); the step
    timed by StepTimer (DINOv2 at B=128 with remat True, and False where the
    peak at B=32 scaled by rows fits; MSN at B=64, then at the largest of
    128 and 256 whose scaled peak fits); one step at the run's batch under
    torch.profiler (the card's busy share, the top kernels); then
    knn_classification.main --mode MODE on the checkpoint (MSN: the target
    branch)."""
    import torch

    from hairci_torch.cli import mainpretrain

    cfg = DISTILL[mode]
    B = cfg["batch"]
    steps = DISTILL_EPOCHS * (128 // B)
    argv = ["--mode", mode, "--model", "vit_b_16", "--size", str(SIZE),
            "--dtype", "bfloat16", "--seed", "42", "--batch_size", str(B),
            "--epochs", str(DISTILL_EPOCHS), "--num_workers", "8",
            "--train_annotation", train["manifest"], "--img_dir", DATASET,
            "--save_path", os.path.join(workdir, f"out_{mode}")] + cfg["flags"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    decodes = _decodes()
    t0 = time.perf_counter()
    trainer = mainpretrain.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _counts()
    _check_decode_route(f"mainpretrain {mode}", _decodes() - decodes,
                        DISTILL_EPOCHS * 128)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    recipe, state = trainer.recipe, trainer.state
    backbone = state.online.backbone
    print(f"mainpretrain {mode} {recipe.backbone} ({backbone.embed_dim} x "
          f"{len(backbone.blocks)}) {SIZE}px bf16 B={B}: {steps} steps over "
          f"{DISTILL_EPOCHS} epochs in {seconds:.1f} s (model build and "
          f"first-step warmup included); peak memory {peak:.2f} GiB; "
          f"launches {launches}")
    want = {name: 0 for name in launches}
    want["bn_stats"] = cfg["bn_per_step"] * steps
    if launches != want:
        raise AssertionError(f"{mode} launches {launches}, expected {want}")
    if (recipe.backbone, backbone.embed_dim, len(backbone.blocks)) != (
            cfg["backbone"], cfg["width"], 12) or state.step != steps:
        raise AssertionError(f"{mode}: {recipe.backbone} "
                             f"{backbone.embed_dim} x {len(backbone.blocks)}"
                             f", {state.step} steps")
    if mode == "dinov2":
        head = state.online.dino_head
        blk = backbone.blocks[0]
        if (head.prototypes.shape, head.fc1.out_features, recipe.n_local,
                recipe.n_masked, blk.layer_scale) != (
                    (65536, 256), 2048, 8, 80, True):
            raise AssertionError(f"dinov2 head {tuple(head.prototypes.shape)}"
                                 f", {recipe.n_local} locals, "
                                 f"{recipe.n_masked} masked")
        print(f"dinov2: LayerScale gamma of block 0 after {steps} steps: "
              f"mean |gamma| {blk.ls1.gamma.abs().mean().item():.3g}; "
              f"teacher temperature {recipe.teacher_temp(0)} -> "
              f"{recipe.teacher_temp(steps - 1)}, momentum "
              f"{recipe.momentum(0)} -> {recipe.momentum(steps - 1):.6f}")
    else:
        if (state.online.prototypes.shape, recipe.n_focal,
                recipe.mask_ratio) != ((1024, 256), 10, 0.15):
            raise AssertionError(f"MSN prototypes "
                                 f"{tuple(state.online.prototypes.shape)}")
    with open(os.path.join(trainer.save_path, "metrics.jsonl")) as f:
        metrics = [json.loads(line) for line in f]
    with open(os.path.join(trainer.save_path, "training_log.txt")) as f:
        log = f.read()
    for m in metrics:
        terms = ", ".join(f"{k} {m[k]:.6f}" for k in ("dino_loss", "ibot_loss",
                                                      "koleo_loss") if k in m)
        print(f"{mode} epoch {m['epoch']}: loss {m['loss']:.6f}"
              + (f" ({terms})" if terms else "")
              + f", {m['images_per_sec']:.1f} img/s (host clock, loader "
              f"included)")
    if [m["epoch"] for m in metrics] != list(range(DISTILL_EPOCHS)) or \
            not all(math.isfinite(m["loss"]) for m in metrics) or \
            log.count(": Loss = ") != DISTILL_EPOCHS:
        raise AssertionError(f"{mode}: metrics {metrics}, log {log!r}")
    ckpt = torch.load(os.path.join(trainer.save_path, "model_ckpt_latest"),
                      map_location="cpu", weights_only=True)
    keys = {"online", "ema", "optimizer", "step", "epoch"}
    if mode == "dinov2":
        keys.add("extra")
        centres = ckpt["extra"]
        if {k: tuple(v.shape) for k, v in centres.items()} != {
                "dino_center": (1, 65536), "ibot_center": (1, 65536)} or \
                not all(torch.isfinite(v).all() and v.abs().sum() > 0
                        for v in centres.values()):
            raise AssertionError(f"dinov2 centres {centres}")
    if set(ckpt) != keys:
        raise AssertionError(f"{mode} checkpoint keys {sorted(ckpt)}")
    images, _ = next(iter(trainer.train_loader))
    images = torch.from_numpy(images).cuda()
    save_path = trainer.save_path
    del trainer, recipe, state, backbone, ckpt
    torch.cuda.empty_cache()

    timed = {}
    if mode == "dinov2":
        timed["remat=True"] = _masked_step_times(_distill_recipe(mode, B),
                                                 B, images)
        _print_timed("dinov2 vit_small_patch16 remat=True", B,
                     timed["remat=True"])
        small = _masked_step_times(_distill_recipe(mode, B, remat=False),
                                   B // 4, images[:B // 4], runs=3)
        _print_timed("dinov2 vit_small_patch16 remat=False", B // 4, small)
        extrapolated = small["peak_gib"] * 4
        if extrapolated < FIT_GIB:
            timed["remat=False"] = _masked_step_times(
                _distill_recipe(mode, B, remat=False), B, images)
            _print_timed("dinov2 vit_small_patch16 remat=False", B,
                         timed["remat=False"])
        else:
            print(f"train_step dinov2 remat=False B={B}: does not fit "
                  f"({small['peak_gib']:.2f} GiB at B={B // 4} scales to "
                  f"{extrapolated:.1f} GiB)")
            timed["remat=False"] = {"fits": False,
                                    "extrapolated_peak_gib": extrapolated}
    else:
        timed[f"B={B}"] = _masked_step_times(_distill_recipe(mode, B), B,
                                             images)
        _print_timed("MSN vit_base_patch16", B, timed[f"B={B}"])
        fits = [b for b in (128, 256)
                if timed[f"B={B}"]["peak_gib"] * b / B < FIT_GIB]
        if fits:
            big = max(fits)
            timed[f"B={big}"] = _masked_step_times(
                _distill_recipe(mode, big), big, runs=3)
            _print_timed("MSN vit_base_patch16", big, timed[f"B={big}"])
        print(f"train_step MSN: the largest batch whose peak at B={B}, "
              f"scaled by rows, stays below {FIT_GIB} GiB: "
              f"{max(fits) if fits else B}")
    profile = _device_breakdown(
        _distill_recipe(mode, B), B, images, workdir, mode,
        timed["remat=True" if mode == "dinov2" else f"B={B}"]["ms"])
    knn = phase_knn_vit(workdir, {"save_path": save_path,
                                  "manifest": train["manifest"]}, mode,
                        cfg["self_retrieval"], cfg["width"])
    if not cfg["self_retrieval"]:
        _features_card_vs_cpu(mode, save_path,
                              os.path.join(workdir, "test.csv"))
    return {"launches": launches, "knn_launches": knn["launches"],
            "timed": timed, "profile": profile, "peak_gib": peak,
            "seconds": seconds}


# ---------------------------------------------------------------------------
# phases 7k and 7l: BYOL and DenseCL through the training CLI
# ---------------------------------------------------------------------------

# mode -> the train-mode BN launches of one step (BYOL: the trunk's 53 over
# the 2B rows of both views and the two 4096-wide head BNs; DenseCL: the
# trunk's 53 over the B query rows), the conv3x3 launches of one step (the
# momentum branch's forward without gradient: ResNet-50's layer1 3x3 convs,
# over 2B rows for BYOL, B for DenseCL), the rows that forward runs at per
# image, and the loss terms each epoch logs beside the loss
MOMENTUM_MODES = {"BYOL": {"bn": 55, "conv": 3, "rows": 2, "terms": ()},
                  "DenseCL": {"bn": 53, "conv": 3, "rows": 1,
                              "terms": ("global_loss", "local_loss")}}
MOMENTUM_EPOCHS = 2


def _momentum_recipe(mode: str, **kw):
    """The recipe of the CLI run (ResNet-50 bf16 at 224, lr 1e-3, the run's
    epochs for the momentum schedule) for timing."""
    import torch

    from hairci_torch.ssl import build_recipe

    return build_recipe(mode, img_size=SIZE, learning_rate=1e-3,
                        dtype=torch.bfloat16, epochs=MOMENTUM_EPOCHS, **kw)


def _momentum_heads(mode: str, state) -> tuple:
    """The widths of the recipe's heads (out, in) and DenseCL's banks."""
    online = state.online
    if mode == "BYOL":
        return tuple(tuple(h.layers[i].weight.shape)
                     for h in (online.projection_head, online.prediction_head)
                     for i in (0, 3))
    return tuple(tuple(h.layers[i].weight.shape)
                 for h in (online.projection_head_global,
                           online.projection_head_local)
                 for i in (0, 2)) + (tuple(state.extra["bank_g"].shape),
                                     tuple(state.extra["bank_l"].shape))


MOMENTUM_HEADS = {"BYOL": ((4096, 2048), (256, 4096), (4096, 256),
                           (256, 4096)),
                  "DenseCL": ((2048, 2048), (512, 2048), (2048, 2048),
                              (512, 2048), (4096, 512), (4096, 512))}


def phase_train_momentum(workdir: str, train: dict, mode: str) -> dict:
    """BYOL (ResNet-50, the 2048 -> 4096 -> 256 projection and 256 -> 4096
    -> 256 prediction heads) or DenseCL (ResNet-50 kept spatial, the 2048 ->
    2048 -> 512 global and local heads, banks of 4096 x 512) through
    mainpretrain.main at 224, bf16, seeded random weights, B=48 for 2
    epochs on phase 6's manifest (48 + 48 + 32 padded): the launch counts
    of every step (BYOL 55 bn_stats + 3 conv3x3, DenseCL 53 + 3; no rotate,
    no top-k), the heads' widths, a finite ``Loss =`` line each epoch (and
    DenseCL's two terms), the checkpoint's keys (DenseCL's banks, their
    pointers at 6 x 48 rows). Then the step timed by StepTimer at B=64 and
    at the config's B=256 where the B=64 peak scaled by rows fits, GFLOP an
    image by FlopCounterMode, one step at B=64 under torch.profiler; for
    DenseCL knn_classification --mode DenseCL --model resnet50 on the
    checkpoint (3 conv3x3 launches a batch) and its features f32 card
    against CPU."""
    import numpy as np
    import torch

    from hairci_torch.cli import mainpretrain

    cfg = MOMENTUM_MODES[mode]
    batch = CLI_BATCH
    steps_per_epoch = math.ceil(128 / batch)         # 48 + 48 + 32 padded
    steps = MOMENTUM_EPOCHS * steps_per_epoch
    argv = ["--mode", mode, "--model", "resnet50", "--lr", "0.001",
            "--size", str(SIZE), "--dtype", "bfloat16", "--seed", "42",
            "--batch_size", str(batch), "--epochs", str(MOMENTUM_EPOCHS),
            "--num_workers", "8", "--train_annotation", train["manifest"],
            "--img_dir", DATASET,
            "--save_path", os.path.join(workdir, f"out_{mode}")]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    decodes = _decodes()
    t0 = time.perf_counter()
    trainer = mainpretrain.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _counts()
    _check_decode_route(f"mainpretrain {mode}", _decodes() - decodes,
                        MOMENTUM_EPOCHS * 128)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    recipe, state = trainer.recipe, trainer.state
    print(f"mainpretrain {mode} {recipe.backbone} {SIZE}px bf16 B={batch}: "
          f"{steps} steps over {MOMENTUM_EPOCHS} epochs in {seconds:.1f} s "
          f"(model build and first-step warmup included); peak memory "
          f"{peak:.2f} GiB; launches {launches}; momentum by epoch "
          f"{[recipe.momentum_for_epoch(e) for e in range(MOMENTUM_EPOCHS)]}")
    loader = trainer.train_loader
    if not (len(loader) == steps_per_epoch and loader.pad_last
            and not loader.drop_last and state.step == steps):
        raise AssertionError(f"{mode}: {len(loader)} batches an epoch, "
                             f"pad_last {loader.pad_last}, {state.step} "
                             f"steps")
    want = {"rotate_shear": 0, "bn_stats": cfg["bn"] * steps,
            "conv3x3": cfg["conv"] * steps, "topk_gallery_search": 0}
    if launches != want:
        raise AssertionError(f"{mode} launches {launches} != {want}")
    heads = _momentum_heads(mode, state)
    if (recipe.backbone, state.online.backbone.num_features, heads) != (
            "resnet50", 2048, MOMENTUM_HEADS[mode]):
        raise AssertionError(f"{mode}: {recipe.backbone}, heads {heads}")
    with open(os.path.join(trainer.save_path, "metrics.jsonl")) as f:
        metrics = [json.loads(line) for line in f]
    with open(os.path.join(trainer.save_path, "training_log.txt")) as f:
        log = f.read()
    for m in metrics:
        terms = ", ".join(f"{k} {m[k]:.6f}" for k in cfg["terms"])
        print(f"{mode} epoch {m['epoch']}: loss {m['loss']:.6f}"
              + (f" ({terms})" if terms else "")
              + f", {m['images_per_sec']:.1f} img/s (host clock, loader "
              f"included)")
    if [m["epoch"] for m in metrics] != list(range(MOMENTUM_EPOCHS)) or \
            not all(math.isfinite(m[k]) for m in metrics
                    for k in ("loss",) + cfg["terms"]) or \
            log.count(": Loss = ") != MOMENTUM_EPOCHS:
        raise AssertionError(f"{mode}: metrics {metrics}, log {log!r}")
    ckpt = torch.load(os.path.join(trainer.save_path, "model_ckpt_latest"),
                      map_location="cpu", weights_only=True)
    keys = {"online", "ema", "optimizer", "step", "epoch"}
    if mode == "DenseCL":
        keys.add("extra")
        extra = ckpt["extra"]
        rows = steps * batch
        filled = int((extra["bank_g"].abs().sum(1) > 0).sum())
        if (int(extra["ptr_g"]), int(extra["ptr_l"]), filled) != (
                rows, rows, rows) or not all(
                    torch.isfinite(extra[k]).all()
                    for k in ("bank_g", "bank_l")):
            raise AssertionError(f"DenseCL banks: pointers "
                                 f"{int(extra['ptr_g'])}, "
                                 f"{int(extra['ptr_l'])}, {filled} rows")
        print(f"DenseCL banks (4096 x 512 f32): {filled} rows filled, both "
              f"pointers at {rows}")
    if set(ckpt) != keys:
        raise AssertionError(f"{mode} checkpoint keys {sorted(ckpt)}")
    save_path = trainer.save_path
    del trainer, recipe, state, ckpt
    torch.cuda.empty_cache()

    timed = {TRAIN_BATCH: _masked_step_times(_momentum_recipe(mode),
                                             TRAIN_BATCH)}
    _print_timed(f"{mode} resnet50", TRAIN_BATCH, timed[TRAIN_BATCH])
    extrapolated = timed[TRAIN_BATCH]["peak_gib"] * CONFIG_BATCH / TRAIN_BATCH
    if extrapolated < FIT_GIB:
        timed[CONFIG_BATCH] = _masked_step_times(_momentum_recipe(mode),
                                                 CONFIG_BATCH, runs=5)
        _print_timed(f"{mode} resnet50", CONFIG_BATCH, timed[CONFIG_BATCH])
    else:
        print(f"train_step {mode} B={CONFIG_BATCH}: does not fit "
              f"({extrapolated:.1f} GiB scaled from B={TRAIN_BATCH})")
    images = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 256, (TRAIN_BATCH, 256, 256, 3), dtype=np.uint8)).cuda()
    profile = _device_breakdown(_momentum_recipe(mode), TRAIN_BATCH, images,
                                workdir, mode, timed[TRAIN_BATCH]["ms"])
    del images
    knn_launches = {name: 0 for name in launches}
    if mode == "DenseCL":
        knn_launches = _eval_densecl(workdir, train, save_path)
    return {"launches": launches, "knn_launches": knn_launches,
            "timed": timed, "profile": profile, "peak_gib": peak,
            "seconds": seconds}


def _eval_densecl(workdir: str, train: dict, save_path: str) -> dict:
    """knn_classification.main --mode DenseCL --model resnet50 on the
    checkpoint, batches of 48: 3 conv3x3 launches a forward and no other;
    unit-norm 2048-d features (the online trunk's unrounded pooled ones;
    self-retrieval printed), then held f32 card against CPU."""
    import numpy as np
    import torch

    from hairci_torch.cli import knn_classification
    from hairci_torch.eval.knn import knn_predict

    test_csv = os.path.join(workdir, "test.csv")    # phase 7's 64 images
    out_dir = os.path.join(workdir, "knn_out_DenseCL")
    argv = ["--mode", "DenseCL", "--model", "resnet50", "--size", str(SIZE),
            "--dtype", "bfloat16", "--eval_type", "knn",
            "--batch_size", str(CLI_BATCH), "--num_workers", "8",
            "--checkpoint_path", save_path,
            "--train_annotation", train["manifest"],
            "--test_annotation", test_csv, "--img_dir", DATASET,
            "--save_path", out_dir]
    forwards = math.ceil(128 / CLI_BATCH) + math.ceil(64 / CLI_BATCH)
    _reset_counts()
    decodes = _decodes()
    t0 = time.perf_counter()
    clf = knn_classification.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _counts()
    _check_decode_route("knn_classification DenseCL", _decodes() - decodes,
                        128 + 64)
    print(f"knn_classification DenseCL resnet50 {SIZE}px bf16, batches of "
          f"{CLI_BATCH}: {forwards} forwards in {seconds:.2f} s; launches "
          f"{launches}")
    want = {"rotate_shear": 0, "bn_stats": 0, "conv3x3": 3 * forwards,
            "topk_gallery_search": 0}
    if launches != want:
        raise AssertionError(f"DenseCL knn launches {launches} != {want}")
    if not os.path.isfile(os.path.join(out_dir,
                                       "knn_evaluation_results.txt")):
        raise AssertionError("DenseCL: no knn_evaluation_results.txt")
    tr_f, tr_l, te_f, te_l = clf.extracting_features()
    if tr_f.shape != (128, 2048) or te_f.shape != (64, 2048):
        raise AssertionError(f"features {tr_f.shape} {te_f.shape}")
    for f in (tr_f, te_f):
        if not (np.isfinite(f).all() and np.abs(
                np.linalg.norm(f, axis=1) - 1).max() < 1e-3):
            raise AssertionError("features are not finite and unit-norm")
    self_hit = float(np.mean(knn_predict(tr_f, tr_l, te_f, 1) == te_l))
    print(f"self-retrieval at k=1 (DenseCL resnet50): {100 * self_hit:.1f} "
          f"% (printed, not held)")
    del clf
    torch.cuda.empty_cache()
    _features_card_vs_cpu("DenseCL", save_path, test_csv)
    return launches


# ---------------------------------------------------------------------------
# phases 7m and 7n: SiameseIM through both CLIs, SHAM v1 through the Trainer
# ---------------------------------------------------------------------------

SIAMESEIM_EPOCHS = 2


def _siameseim_reference_sd(online: dict, ema: dict) -> dict:
    """The port's SiameseIM weights in the reference ``SiameseIMViT``
    layout that ``models.convert.siameseim_state_dict`` reads: the online
    timm encoder at the top level (no encoder mask token, no final norm),
    the decoder-width ``mask_token``, ``decoder_embed``,
    ``projector_decoder_blocks``, ``predictor_decoder_blocks``,
    ``decoder_pred``, ``decoder_pos_mlp``; the momentum encoder, projector
    and mask token under ``mm_`` (``pos_embed`` is shared)."""
    renames = (("projector_blocks.", "projector_decoder_blocks."),
               ("predictor_blocks.", "predictor_decoder_blocks."))
    out = {}
    for prefix, sd in (("", online), ("mm_", ema)):
        for key, value in sd.items():
            if key.startswith("encoder."):
                key = key[len("encoder."):]
                if key == "mask_token" or key.startswith("norm.") or (
                        prefix and key == "pos_embed"):
                    continue
            elif prefix and key.startswith(("predictor_blocks.",
                                            "decoder_pred.",
                                            "decoder_pos_mlp.")):
                continue
            for ours, theirs in renames:
                if key.startswith(ours):
                    key = theirs + key[len(ours):]
            out[prefix + key] = value.cpu()
    return out


def phase_train_siameseim(workdir: str, train: dict) -> dict:
    """SiameseIM (ViT-B/16 without a final norm, the 512-wide decoder of 16
    heads, 2 projector and 4 predictor PermuteBN blocks, mask ratio 0.6
    blockwise) through mainpretrain.main at 224, bf16, seeded random
    weights, B=48 for 2 epochs on phase 6's manifest (48 + 48 + 32
    padded): exactly 16 bn_stats launches a step, all on f32 inputs, and no
    other kernel; a finite ``Loss =`` line each epoch; the momentum
    branch's PermuteBN statistics in the checkpoint. Then the step timed by
    StepTimer at B=64 and at 256 where the B=64 peak scaled by rows fits
    (peak memory, GFLOP an image by FlopCounterMode), one step at B=64
    under torch.profiler; then knn_classification.main --mode siaMIM on the
    checkpoint (no launch, 768-d raw cls features, held f32 card against
    CPU) and on a reference-layout .pth written from the same weights (the
    same features)."""
    import numpy as np
    import torch

    from hairci_torch.cli import mainpretrain
    from hairci_torch.models import norm as norm_module

    batch = CLI_BATCH
    steps = SIAMESEIM_EPOCHS * math.ceil(128 / batch)
    argv = ["--mode", "siameseim", "--model", "vit_b_16", "--lr", "0.001",
            "--size", str(SIZE), "--dtype", "bfloat16", "--seed", "42",
            "--batch_size", str(batch), "--epochs", str(SIAMESEIM_EPOCHS),
            "--num_workers", "8", "--train_annotation", train["manifest"],
            "--img_dir", DATASET,
            "--save_path", os.path.join(workdir, "out_siameseim")]
    # the dtypes the train-mode BatchNorms hand the stats kernel
    dtypes = set()
    stats_fn = norm_module.BNStats

    class Spy:
        @staticmethod
        def apply(x):
            dtypes.add(x.dtype)
            return stats_fn.apply(x)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    decodes = _decodes()
    norm_module.BNStats = Spy
    try:
        t0 = time.perf_counter()
        trainer = mainpretrain.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        norm_module.BNStats = stats_fn
    launches = _counts()
    _check_decode_route("mainpretrain siameseim", _decodes() - decodes,
                        SIAMESEIM_EPOCHS * 128)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    recipe, state = trainer.recipe, trainer.state
    module = state.online
    print(f"mainpretrain siameseim {recipe.backbone} {SIZE}px bf16 B={batch}"
          f": {steps} steps over {SIAMESEIM_EPOCHS} epochs in {seconds:.1f} s"
          f" (model build and first-step warmup included); peak memory "
          f"{peak:.2f} GiB; launches {launches}, bn_stats inputs "
          f"{sorted(str(d) for d in dtypes)}; momentum by epoch "
          f"{[recipe.momentum_for_epoch(e) for e in range(SIAMESEIM_EPOCHS)]}")
    want = {"rotate_shear": 0, "bn_stats": 16 * steps, "conv3x3": 0,
            "topk_gallery_search": 0}
    if launches != want or dtypes != {torch.float32}:
        raise AssertionError(f"siameseim launches {launches} != {want}, "
                             f"bn_stats inputs {dtypes}")
    shape = (recipe.backbone, module.encoder.embed_dim,
             len(module.encoder.blocks), module.encoder.final_norm,
             module.decoder_embed.out_features,
             module.projector_blocks[0].attn.num_heads,
             len(module.projector_blocks), len(module.predictor_blocks),
             recipe.block_norm, recipe.mask_ratio, recipe.with_blockwise_mask,
             recipe.num_keep)
    if shape != ("vit_base_patch16", WIDTH, 12, False, 512, 16, 2, 4,
                 "permute_bn", 0.6, True, int((SIZE // 16) ** 2 * 0.4)):
        raise AssertionError(f"siameseim: {shape}")
    loader = trainer.train_loader
    if not (loader.pad_last and state.step == steps):
        raise AssertionError(f"siameseim: pad_last {loader.pad_last}, "
                             f"{state.step} steps")
    with open(os.path.join(trainer.save_path, "metrics.jsonl")) as f:
        metrics = [json.loads(line) for line in f]
    with open(os.path.join(trainer.save_path, "training_log.txt")) as f:
        log = f.read()
    for m in metrics:
        print(f"siameseim epoch {m['epoch']}: loss {m['loss']:.6f}, "
              f"{m['images_per_sec']:.1f} img/s (host clock, loader "
              f"included)")
    if [m["epoch"] for m in metrics] != list(range(SIAMESEIM_EPOCHS)) or \
            not all(math.isfinite(m["loss"]) for m in metrics) or \
            log.count(": Loss = ") != SIAMESEIM_EPOCHS:
        raise AssertionError(f"siameseim: metrics {metrics}, log {log!r}")
    ckpt = torch.load(os.path.join(trainer.save_path, "model_ckpt_latest"),
                      map_location="cpu", weights_only=True)
    stats = [k for k in ckpt.get("ema", {}) if k.endswith(".running_var")]
    if set(ckpt) != {"online", "ema", "optimizer", "step", "epoch"} or \
            len(stats) != 12 or not all(
                torch.isfinite(ckpt["ema"][k]).all()
                and not torch.equal(ckpt["ema"][k], ckpt["online"][k])
                for k in stats):
        raise AssertionError(f"siameseim checkpoint keys {sorted(ckpt)}, "
                             f"{len(stats)} EMA PermuteBN variances")
    print(f"siameseim checkpoint: the momentum branch's {len(stats)} "
          f"PermuteBN running variances, apart from the online ones")
    pth = os.path.join(workdir, "siameseim_reference.pth")
    torch.save({"model": _siameseim_reference_sd(ckpt["online"],
                                                 ckpt["ema"])}, pth)
    save_path = trainer.save_path
    del trainer, recipe, state, module, ckpt
    torch.cuda.empty_cache()

    timed = {TRAIN_BATCH: _masked_step_times(_momentum_recipe("siameseim"),
                                             TRAIN_BATCH)}
    _print_timed("siameseim vit_base_patch16", TRAIN_BATCH,
                 timed[TRAIN_BATCH])
    extrapolated = timed[TRAIN_BATCH]["peak_gib"] * CONFIG_BATCH / TRAIN_BATCH
    if extrapolated < FIT_GIB:
        timed[CONFIG_BATCH] = _masked_step_times(
            _momentum_recipe("siameseim"), CONFIG_BATCH, runs=3, warmup=1)
        _print_timed("siameseim vit_base_patch16", CONFIG_BATCH,
                     timed[CONFIG_BATCH])
    else:
        print(f"train_step siameseim B={CONFIG_BATCH}: does not fit "
              f"({extrapolated:.1f} GiB scaled from B={TRAIN_BATCH})")
    images = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 256, (TRAIN_BATCH, 256, 256, 3), dtype=np.uint8)).cuda()
    profile = _device_breakdown(_momentum_recipe("siameseim"), TRAIN_BATCH,
                                images, workdir, "siameseim",
                                timed[TRAIN_BATCH]["ms"])
    del images
    # the raw cls token is bf16 in a bf16 run, and the evaluation
    # normalises it in bf16 as JAX's does: unit norm to bf16's rounding
    manifest, bf16_tol = train["manifest"], 2 ** -7
    knn = phase_knn_vit(workdir, {"save_path": save_path,
                                  "manifest": manifest}, "siaMIM", False,
                        WIDTH, bf16_tol)
    _features_card_vs_cpu("siameseim", save_path,
                          os.path.join(workdir, "test.csv"))
    ref = phase_knn_vit(workdir, {"save_path": pth, "manifest": manifest},
                        "siaMIM", False, WIDTH, bf16_tol)
    diff = max(float(np.abs(a - b).max())
               for a, b in zip(knn["features"], ref["features"]))
    print(f"knn_classification siaMIM on the reference-layout .pth of the "
          f"same weights: largest feature difference {diff:.3g}")
    if diff > 1e-6:
        raise AssertionError(f"siaMIM .pth features differ by {diff}")
    knn_launches = {k: knn["launches"][k] + ref["launches"][k]
                    for k in launches}
    return {"launches": launches, "knn_launches": knn_launches,
            "timed": timed, "profile": profile, "peak_gib": peak,
            "seconds": seconds}


SHAM_V1_EPOCHS = 2


def phase_train_sham_v1(workdir: str, train: dict) -> dict:
    """SHAM v1 (ViT-B/16, the 1024 -> 256 global and 1024 local projectors,
    the cross block, mask ratio 0.75; the depth-2 decoder in reconstruction
    mode) through ``build_recipe("SHAM_v1", sham_mode=...)`` and the
    ``Trainer``, as the JAX package reaches it (no CLI mode), in both modes
    at 224, bf16, seeded random weights, B=48 for 2 epochs on phase 6's
    manifest (the last batch padded): no kernel launch; finite global,
    local (and recon) terms each epoch. Each mode's step timed by StepTimer
    at B=64 and at 256 where the B=64 peak scaled by rows fits, with the
    peak memory and GFLOP an image."""
    import types

    import torch

    from hairci_torch.data import DataLoader, load_manifest
    from hairci_torch.ssl import build_recipe
    from hairci_torch.train.engine import Trainer

    batch = CLI_BATCH
    steps = SHAM_V1_EPOCHS * math.ceil(128 / batch)
    launches = {name: 0 for name in _wrappers()}
    timed = {}
    for mode in ("embedding", "reconstruction"):
        recipe = build_recipe("SHAM_v1", img_size=SIZE, sham_mode=mode,
                              learning_rate=1e-3, dtype=torch.bfloat16)
        loader = DataLoader(load_manifest(train["manifest"], DATASET), batch,
                            size=max(SIZE, int(SIZE * 256 / 224)),
                            mode="raw_resize", shuffle=True, drop_last=False,
                            pad_last=True, seed=42, num_workers=8)
        args = types.SimpleNamespace(
            mode="SHAM_v1", model="vit_b_16", epochs=SHAM_V1_EPOCHS,
            batch_size=batch, lr=1e-3, temp=0.5, seed=42,
            save_path=os.path.join(workdir, f"out_sham_v1_{mode}"))
        torch.cuda.empty_cache()
        _reset_counts()
        t0 = time.perf_counter()
        trainer = Trainer(recipe, loader, args, torch.device("cuda"))
        state = trainer.train()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _counts()
        print(f"Trainer SHAM_v1 {mode} {recipe.backbone} {SIZE}px bf16 "
              f"B={batch}: {state.step} steps over {SHAM_V1_EPOCHS} epochs "
              f"in {seconds:.1f} s (model build and first-step warmup "
              f"included); launches {counts}")
        if any(counts.values()) or state.step != steps:
            raise AssertionError(f"SHAM_v1 {mode}: launches {counts}, "
                                 f"{state.step} steps")
        launches = {k: launches[k] + v for k, v in counts.items()}
        terms = ("loss", "global_loss", "local_loss") + (
            ("recon_loss",) if mode == "reconstruction" else ())
        with open(os.path.join(trainer.save_path, "metrics.jsonl")) as f:
            metrics = [json.loads(line) for line in f]
        for m in metrics:
            print(f"SHAM_v1 {mode} epoch {m['epoch']}: "
                  + ", ".join(f"{k} {m[k]:.6f}" for k in terms))
        if [m["epoch"] for m in metrics] != list(range(SHAM_V1_EPOCHS)) or \
                not all(math.isfinite(m[k]) for m in metrics
                        for k in terms):
            raise AssertionError(f"SHAM_v1 {mode}: metrics {metrics}")
        del trainer, state
        torch.cuda.empty_cache()
        t = {TRAIN_BATCH: _masked_step_times(recipe, TRAIN_BATCH)}
        _print_timed(f"SHAM_v1 {mode} vit_base_patch16", TRAIN_BATCH,
                     t[TRAIN_BATCH])
        scaled = t[TRAIN_BATCH]["peak_gib"] * CONFIG_BATCH / TRAIN_BATCH
        if scaled < FIT_GIB:
            t[CONFIG_BATCH] = _masked_step_times(recipe, CONFIG_BATCH,
                                                 runs=3, warmup=1)
            _print_timed(f"SHAM_v1 {mode} vit_base_patch16", CONFIG_BATCH,
                         t[CONFIG_BATCH])
        else:
            print(f"train_step SHAM_v1 {mode} B={CONFIG_BATCH}: does not "
                  f"fit ({scaled:.1f} GiB scaled from B={TRAIN_BATCH})")
        timed[mode] = t
    return {"launches": launches,
            "knn_launches": {k: 0 for k in launches}, "timed": timed}


# ---------------------------------------------------------------------------
# phase 7o: DualViewHair through its train and evaluation CLIs
# ---------------------------------------------------------------------------

DV_RUNS = ((["--epochs", "2"], 56),
           (["--epochs", "1", "--loss", "queue"], 56),
           (["--epochs", "1", "--loss", "asymmetric"], 56),
           (["--epochs", "1", "--encoder", "multiscale", "--loss", "hybrid"],
            53),
           (["--epochs", "1", "--encoder", "partbased"], 53))


class _DualViewSteps:
    """DualViewHair's infonce step in the interface of the timing helpers
    (``create_state(seed, B, device)``, ``train_step(state, images, gen)``):
    the same uint8 batch as the student's and the teacher's images."""

    def __init__(self):
        from hairci_torch.experiments.dualview.models import (
            DualViewHairModel)
        from hairci_torch.experiments.dualview.train import make_train_step

        self.model = DualViewHairModel()
        self.step = make_train_step(self.model, "infonce")

    def create_state(self, seed, B, device):
        return self.model.create_state(seed, device)

    def train_step(self, state, images, gen):
        from hairci_torch.experiments.dualview.train import _student_draw

        B, H, W, _ = images.shape
        return self.step(state, {"full": images, "hair": images},
                         _student_draw(gen, B, H, W))


def phase_train_dualview(workdir: str) -> dict:
    """DualViewHair at ResNet-50 full width, 224, f32, seeded random weights,
    on the repo's 64 (full, hair) pairs through
    ``hairci_torch.experiments.dualview.train.main``: 2 epochs of infonce at
    B=32 with ``--save_path``, then 1 epoch each of queue, asymmetric,
    multiscale + hybrid and partbased; exactly 56 bn_stats launches a step
    for the ResNet encoder and 53 for the other two, all on f32 inputs, 3
    conv3x3 (its f32 fma kernel: the EMA teacher's forward), no rotate, no
    top-k; a finite loss each epoch. The step timed by StepTimer at B=32 and
    at 256 where the scaled peak fits (else 128), GFLOP an image, one step
    under torch.profiler. Then ``quantitative_eval.main --model dualview``
    on the checkpoint for both towers (a benchmark of the 64 stems: Recall@K
    / mAP@K at 10, 20, 50 and the top-100 file; no top-k launch at k = 100,
    3 conv3x3 an embed batch), the same features on the CPU (cosine >=
    0.9999), and ``HairstyleRetrievalModel.retrieve(k=5)`` at Q = 1 and 64
    (one fma and one mma launch, the kernel held against its twin)."""
    import numpy as np
    import torch

    import hairci_torch.models.norm as norm_module
    from hairci_torch.experiments.dualview import quantitative_eval, train
    from hairci_torch.experiments.dualview.data import discover_pairs
    from hairci_torch.ops.conv3x3 import conv3x3

    pairs = discover_pairs(DATASET)
    if len(pairs) != 64:
        raise AssertionError(f"{len(pairs)} (full, hair) pairs in {DATASET}")
    steps_per_epoch = 64 // DV_BATCH
    save_path = os.path.join(workdir, "out_dualview")
    # the dtypes the train-mode BatchNorms hand the stats kernel, counted
    dtypes = {}
    stats_fn = norm_module.BNStats

    class Spy:
        @staticmethod
        def apply(x):
            dtypes[x.dtype] = dtypes.get(x.dtype, 0) + 1
            return stats_fn.apply(x)

    launches, seconds = {name: 0 for name in _wrappers()}, 0.0
    for extra, bn_per_step in DV_RUNS:
        argv = ["--data_root", DATASET, "--batch_size", str(DV_BATCH),
                "--size", str(SIZE)] + extra
        if extra[1] == "2":
            argv += ["--save_path", save_path]
        epochs = int(extra[1])
        steps = epochs * steps_per_epoch
        torch.cuda.empty_cache()
        _reset_counts()
        fma_before = conv3x3.routes["fma"]
        norm_module.BNStats = Spy
        t0 = time.perf_counter()
        try:
            out = train.main(argv)
            torch.cuda.synchronize()
        finally:
            norm_module.BNStats = stats_fn
        seconds += time.perf_counter() - t0
        counts = _counts()
        fma = conv3x3.routes["fma"] - fma_before
        print(f"dualview train {' '.join(extra)}: ResNet-50 {SIZE}px f32 "
              f"B={DV_BATCH}, {out['state'].step} steps in "
              f"{time.perf_counter() - t0:.1f} s (model build and first-step "
              f"warmup included); launches {counts} (conv3x3 fma {fma}); "
              f"loss by epoch {out['history']}")
        want = {"rotate_shear": 0, "bn_stats": bn_per_step * steps,
                "conv3x3": 3 * steps, "topk_gallery_search": 0}
        if counts != want or fma != 3 * steps or out["state"].step != steps:
            raise AssertionError(f"dualview {extra}: launches {counts}, fma "
                                 f"{fma}, {out['state'].step} steps; want "
                                 f"{want}")
        if len(out["history"]) != epochs or not all(
                math.isfinite(v) for v in out["history"]):
            raise AssertionError(f"dualview {extra}: {out['history']}")
        launches = {k: launches[k] + v for k, v in counts.items()}
        del out
    if set(dtypes) != {torch.float32}:
        raise AssertionError(f"dualview bn_stats inputs by dtype {dtypes}")
    print(f"dualview bn_stats inputs: {dtypes[torch.float32]} launches, all "
          f"f32")
    ckpt = os.path.join(save_path, "dualview_latest")
    keys = set(torch.load(ckpt, map_location="cpu", weights_only=True))
    if keys != {"online", "ema", "optimizer", "step", "epoch"}:
        raise AssertionError(f"dualview checkpoint keys {sorted(keys)}")

    steps = _DualViewSteps()
    images = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 256, (256, SIZE, SIZE, 3), dtype=np.uint8)).cuda()
    timed = {DV_BATCH: _masked_step_times(steps, DV_BATCH,
                                          images[:DV_BATCH])}
    _print_timed("dualview resnet50", DV_BATCH, timed[DV_BATCH], "f32")
    for B in (256, 128):
        scaled = timed[DV_BATCH]["peak_gib"] * B / DV_BATCH
        if scaled < FIT_GIB:
            timed[B] = _masked_step_times(steps, B, images[:B], runs=5)
            _print_timed("dualview resnet50", B, timed[B], "f32")
            break
        print(f"train_step dualview B={B}: does not fit ({scaled:.1f} GiB "
              f"scaled from B={DV_BATCH})")
    profile = _device_breakdown(steps, DV_BATCH, images[:DV_BATCH], workdir,
                                "dualview", timed[DV_BATCH]["ms"])
    del images, steps
    torch.cuda.empty_cache()

    # the evaluation CLI on the checkpoint, both towers
    stems = sorted(os.path.basename(f)[:-len(".jpg")] for f, _ in pairs)
    bench = [{"query_image": f"{s}.jpg",
              "ground_truth": [f"{s}.jpg", f"{stems[(i + 1) % 64]}.jpg"]}
             for i, s in enumerate(stems)]
    bench_path = os.path.join(workdir, "dualview_bench.json")
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    eval_launches = {name: 0 for name in _wrappers()}
    results = {}
    for tower in ("student", "teacher"):
        out_json = os.path.join(workdir, f"dualview_top100_{tower}.json")
        _reset_counts()
        t0 = time.perf_counter()
        res = quantitative_eval.main([
            "--db_path", DATASET, "--benchmark", bench_path,
            "--ckpt_path", ckpt, "--model", "dualview", "--tower", tower,
            "--size", str(SIZE), "--out", out_json])
        torch.cuda.synchronize()
        counts = _counts()
        forwards = 1 + len(bench)      # one database batch of 64, 1 a query
        print(f"quantitative_eval --model dualview --tower {tower}: "
              f"{time.perf_counter() - t0:.1f} s; Recall "
              f"{res['Recall']}, mAP {res['mAP']}; launches {counts}")
        want = {"rotate_shear": 0, "bn_stats": 0, "conv3x3": 3 * forwards,
                "topk_gallery_search": 0}
        if counts != want:
            raise AssertionError(f"dualview eval launches {counts} != {want}")
        with open(out_json) as f:
            top = json.load(f)
        if (len(top) != 64 or any(len(r["top100"]) != 64 for r in top)
                or res["total_queries"] != 64 or res["Recall"][10] != 1.0):
            raise AssertionError(f"dualview eval {tower}: {res}")
        eval_launches = {k: eval_launches[k] + v for k, v in counts.items()}
        results[tower] = res

    # the same student features on the CPU
    feats = {}
    paths = [h for _, h in pairs[:16]]
    for dev in ("cuda", "cpu"):
        _, embed = quantitative_eval._dualview_embedder(ckpt, "resnet", SIZE,
                                                        device=dev)
        feats[dev] = np.stack([embed(p) for p in paths]).astype(np.float64)
    a, b = feats["cuda"], feats["cpu"]
    cos = (a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)
    print(f"dualview student embeddings, 16 hair crops, f32 card vs f32 CPU: "
          f"cosine min {cos.min():.7f}")
    if not cos.min() >= 0.9999:
        raise AssertionError(f"dualview features card vs CPU: {cos.min()}")
    retrieve = _dualview_retrieve(ckpt, pairs)
    eval_launches["topk_gallery_search"] += 2
    return {"launches": launches, "knn_launches": eval_launches,
            "timed": timed, "profile": profile, "seconds": seconds,
            "results": results, "cos_min": float(cos.min()),
            "retrieve": retrieve}


def _dualview_retrieve(ckpt: str, pairs: list) -> dict:
    """``HairstyleRetrievalModel`` over the checkpoint's teacher: the 64
    hair crops as the database, then ``retrieve(k=5)`` of one crop (the
    top-k's fma route) and of all 64 (its mma route): one launch each,
    every crop its own first hit, and the kernel held against its twin on
    those queries as phase 3 holds it."""
    import numpy as np
    import torch

    from hairci_torch.aug import ops
    from hairci_torch.data.loader import decode_image
    from hairci_torch.eval.features import l2_normalize
    from hairci_torch.experiments.dualview.models import (
        DualViewHairModel,
        HairstyleRetrievalModel,
    )
    from hairci_torch.ops.topk import topk_gallery_search
    from hairci_torch.train.checkpoint import restore_checkpoint

    model = DualViewHairModel()
    state = model.create_state(0, "cuda")
    restore_checkpoint(ckpt, state)
    paths = [h for _, h in pairs]
    images = ops.normalize(ops.to_float(torch.from_numpy(np.stack(
        [decode_image(p, "raw_resize", SIZE) for p in paths])))).numpy()
    retr = HairstyleRetrievalModel(model, state)
    index = retr.build_database(images, paths)
    out = {}
    for Q, route in ((1, "fma"), (64, "mma")):
        _reset_counts()
        _, got = retr.retrieve(images[:Q], k=5)
        torch.cuda.synchronize()
        routes = dict(topk_gallery_search.routes)
        launched = topk_gallery_search.launches
        print(f"HairstyleRetrievalModel.retrieve Q={Q} k=5 over 64 x "
              f"{DV_WIDTH}: launches {launched}, routes {routes}")
        if (launched != 1 or routes[route] != 1
                or [r[0] for r in got] != paths[:Q]):
            raise AssertionError(f"dualview retrieve Q={Q}: {routes}, "
                                 f"first hits {[r[0] for r in got][:4]}")
        # the kernel against the twin on the same queries: the scores
        # within 1e-5, an index apart only where the twin's neighbouring
        # scores lie within 1e-5 (the barely trained teacher's embeddings
        # of 64 crops lie close together)
        q = l2_normalize(model.get_embeddings(
            state, torch.from_numpy(images[:Q]), use_teacher=True))
        err, _ = _check_topk(q.contiguous(), index.embeddings, 5, 1e-5,
                             route=route)
        print(f"  the kernel vs the twin on those queries: max |score "
              f"err| {err:.3g}; indices equal where the scores part")
        out[Q] = (route, err)
    del state
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 7f: the baselines' checkpoints through every evaluation
# ---------------------------------------------------------------------------

EVAL_FILES = {"knn": "knn_evaluation_results.txt",
              "linear_prob": "linear_probe_results.txt",
              "visualization": "umap_test.npz",
              "inter_intra_distance": "variance_analysis_both.txt"}


def phase_eval_baselines(workdir: str, train: dict, runs: dict) -> dict:
    import numpy as np
    import torch

    from hairci_torch.cli import knn_classification

    test_csv = os.path.join(workdir, "test.csv")    # phase 7's 64 images
    forwards = math.ceil(128 / CLI_BATCH) + math.ceil(64 / CLI_BATCH)
    out = {}
    for mode, convs in (("simclr", 3), ("simclr_supcon", 4)):
        model = BASELINES[mode]["model"]
        total = {"conv3x3": 0, "bn_stats": 0}
        for eval_type, name in EVAL_FILES.items():
            out_dir = os.path.join(workdir, f"eval_{mode}", eval_type)
            argv = ["--mode", mode, "--model", model, "--size", str(SIZE),
                    "--dtype", "bfloat16", "--eval_type", eval_type,
                    "--batch_size", str(CLI_BATCH), "--num_workers", "8",
                    "--checkpoint_path", runs[mode]["save_path"],
                    "--train_annotation", train["manifest"],
                    "--test_annotation", test_csv, "--img_dir", DATASET,
                    "--save_path", out_dir]
            _reset_counts()
            t0 = time.perf_counter()
            clf = knn_classification.main(argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = _counts()
            want = {"rotate_shear": 0, "bn_stats": 0,
                    "conv3x3": convs * forwards, "topk_gallery_search": 0}
            if launches != want:
                raise AssertionError(f"{mode} {eval_type} launches "
                                     f"{launches} != {want}")
            for k in total:
                total[k] += launches[k]
            path = os.path.join(out_dir, name)
            if not os.path.isfile(path):
                raise AssertionError(f"{mode} {eval_type}: no {name}")
            tr_f, _, te_f, _ = clf.extracting_features()
            for f in (tr_f, te_f):
                if not (np.isfinite(f).all() and np.abs(
                        np.linalg.norm(f, axis=1) - 1).max() < 1e-3):
                    raise AssertionError(f"{mode}: features are not finite "
                                         "and unit-norm")
            note = ""
            if eval_type == "linear_prob":
                with open(path) as f:
                    acc = float(f.read().split("Accuracy: ")[1].split()[0])
                if not 0.0 <= acc <= 1.0:
                    raise AssertionError(f"probe accuracy {acc}")
                note = f"; probe accuracy {acc:.4f}"
            elif eval_type == "inter_intra_distance":
                with open(path) as f:
                    ratio = float(f.read().split("variance_ratio: ")[1]
                                  .split()[0])
                if not ratio > 0:
                    raise AssertionError(f"variance ratio {ratio}")
                note = f"; variance ratio {ratio:.6f}"
            elif eval_type == "visualization":
                coords = np.load(path)["coords"]
                if coords.shape != (64, 2) or not np.isfinite(coords).all():
                    raise AssertionError(f"2-D coordinates {coords.shape}")
            print(f"knn_classification {mode} {model} --eval_type "
                  f"{eval_type}: {name} written in {seconds:.2f} s; "
                  f"{tr_f.shape[1]}-d unit-norm features; launches "
                  f"{launches}{note}")
            del clf
        out[mode] = total
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 8: kNN at the gallery size of the README's benchmark
# ---------------------------------------------------------------------------

def phase_knn_full() -> tuple:
    """Returns the seeded features (gallery, its labels, the queries, their
    labels) as numpy arrays, for the probe at full size."""
    import numpy as np
    import torch

    from hairci_torch.eval.knn import (
        DEFAULT_KS,
        knn_predict_multi,
        ordered_neighbours,
        similarities,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    N, D, C, Q, DUP = GALLERY_ROWS, 2048, 61, 4096, 64

    def unit(x):
        return x / x.norm(dim=1, keepdim=True)

    # rows scatter around their class's centre, so votes are decided by the
    # data and not by which of two f32 summation orders ranks a near-tie
    centres = unit(torch.randn(C, D, device=dev, generator=gen))
    labels = torch.randint(0, C, (N,), device=dev, generator=gen)
    gallery = unit(centres[labels]
                   + unit(torch.randn(N, D, device=dev, generator=gen)))
    # exact ties: rows 1000 .. 1063 repeat rows 0 .. 63 under another label
    gallery[1000:1000 + DUP] = gallery[:DUP]
    labels[1000:1000 + DUP] = (labels[:DUP] + 1) % C
    rows = torch.randint(0, N, (Q,), device=dev, generator=gen)
    rows[:DUP] = torch.arange(DUP, device=dev)
    noise = unit(torch.randn(Q, D, device=dev, generator=gen))
    noise[:DUP] = 0     # these queries equal a duplicated row exactly
    queries = unit(gallery[rows] + 0.5 * noise)
    g_np, l_np, q_np = (t.cpu().numpy() for t in (gallery, labels, queries))

    sims = similarities(queries, gallery)
    first = {}
    for method in ("sort", "topk"):
        first[method] = ordered_neighbours(sims, max(DEFAULT_KS), method)
        ms = _median_ms(lambda: ordered_neighbours(sims, max(DEFAULT_KS),
                                                   method), runs=5, warmup=1)
        print(f"ordered_neighbours {Q} x {N}, k={max(DEFAULT_KS)}, {method}: "
              f"{ms:.2f} ms")
    if not torch.equal(first["sort"], first["topk"]):
        raise AssertionError("the two orderings disagree")
    want = torch.arange(DUP, device=dev)
    if not (torch.equal(first["sort"][:DUP, 0], want)
            and torch.equal(first["sort"][:DUP, 1], want + 1000)):
        raise AssertionError("kNN tie order: the lower index must win")
    mm_ms = _median_ms(lambda: similarities(queries, gallery), runs=5,
                       warmup=1)
    print(f"similarities {Q} x {N} x {D} f32: {mm_ms:.2f} ms "
          f"({2.0 * Q * N * D / mm_ms / 1e9:.1f} TFLOP/s)")
    del sims, first
    torch.cuda.empty_cache()

    for _ in range(3):
        t0 = time.perf_counter()
        preds = knn_predict_multi(g_np, l_np, q_np, DEFAULT_KS, C)
        torch.cuda.synchronize()
        print(f"knn_predict_multi, {N} x {D} gallery, {Q} queries, ks "
              f"{DEFAULT_KS}: {time.perf_counter() - t0:.3f} s "
              f"(host clock; the gallery's copy to the card included)")
    t0 = time.perf_counter()
    cpu = knn_predict_multi(g_np, l_np, q_np[:512], DEFAULT_KS, C,
                            device="cpu")
    print(f"the same on the CPU for 512 queries: "
          f"{time.perf_counter() - t0:.1f} s")
    for k in DEFAULT_KS:
        if not np.array_equal(preds[k][:512], cpu[k]):
            raise AssertionError(f"kNN predictions differ at k={k}")
    # with k=1 and 2 the duplicated rows decide: the lower index's label,
    # then a 1:1 vote that goes to the lower class
    small = knn_predict_multi(g_np, l_np, q_np[:DUP], (1, 2), C)
    if not (np.array_equal(small[1], l_np[:DUP]) and np.array_equal(
            small[2], np.minimum(l_np[:DUP], l_np[1000:1000 + DUP]))):
        raise AssertionError("kNN ties: lower index, then lower class")
    acc = float(np.mean(preds[5] == l_np[rows.cpu().numpy()]))
    print(f"kNN at full size: card == CPU on 512 queries at every k; top-k "
          f"with repair == stable sort on {Q} x {N} scores; ties by index "
          f"and class; accuracy at k=5 {acc:.4f}")
    q_labels = l_np[rows.cpu().numpy()]
    del gallery, labels, queries, noise
    torch.cuda.empty_cache()
    return g_np, l_np, q_np, q_labels


# ---------------------------------------------------------------------------
# phase 8b: the linear probe at the gallery size of the README's benchmark
# ---------------------------------------------------------------------------

PROBE_CPU_ROWS = (8192, 1024)   # train and test rows of the CPU comparison


def phase_probe_full(data: tuple) -> dict:
    import numpy as np
    import torch

    from hairci_torch.eval.knn import full_f32_matmul
    from hairci_torch.eval.linear_probe import (
        fit_lbfgs,
        linear_probe_fit_predict,
    )

    X, y, Xq, yq = data
    C = int(y.max()) + 1
    t0 = time.perf_counter()
    preds = linear_probe_fit_predict(X, y, Xq, C, max_iter=500)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    acc = float(np.mean(preds == yq))
    dev = torch.device("cuda")
    Xd = torch.from_numpy(X).to(dev)
    yd = torch.from_numpy(y.astype(np.int64)).to(dev)
    t0 = time.perf_counter()
    W, b, info = fit_lbfgs(Xd, yd, C, 500)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    with full_f32_matmul():
        again = (torch.from_numpy(Xq).to(dev) @ W + b).argmax(1).cpu().numpy()
    print(f"linear_probe_fit_predict {X.shape[0]} x {X.shape[1]} f32, {C} "
          f"classes, {Xq.shape[0]} test rows, max_iter 500, TF32 off: "
          f"{seconds:.3f} s (host clock, the copies to the card included); "
          f"accuracy {acc:.4f}. The fit alone: {fit_s:.3f} s, objective "
          f"{info['objective']:.7f} after {info['iterations']} iterations "
          f"and {info['evaluations']} objective evaluations "
          f"({info['evaluations'] / max(info['iterations'], 1):.2f} an "
          f"iteration); its predictions equal the entry point's on "
          f"{100 * np.mean(again == preds):.2f} % of rows")
    if not (np.isfinite(info["objective"]) and 0.0 <= acc <= 1.0):
        raise AssertionError(f"probe: {info}, accuracy {acc}")
    del Xd, yd, W, b
    torch.cuda.empty_cache()

    # the card against the port on the CPU, on the first rows
    n, nq = PROBE_CPU_ROWS
    fits = {}
    for name in ("cuda", "cpu"):
        d = torch.device(name)
        t0 = time.perf_counter()
        W, b, inf = fit_lbfgs(torch.from_numpy(X[:n]).to(d),
                              torch.from_numpy(y[:n].astype(np.int64)).to(d),
                              C, 500)
        with full_f32_matmul():
            p = (torch.from_numpy(Xq[:nq]).to(d) @ W + b).argmax(1).cpu()
        fits[name] = (p.numpy(), inf, time.perf_counter() - t0)
    agree = float(np.mean(fits["cuda"][0] == fits["cpu"][0]))
    o_card, o_cpu = fits["cuda"][1]["objective"], fits["cpu"][1]["objective"]
    rel = abs(o_card - o_cpu) / abs(o_cpu)
    print(f"linear probe on {n} x {X.shape[1]}, {nq} test rows: card "
          f"{fits['cuda'][2]:.2f} s ({fits['cuda'][1]['iterations']} "
          f"iterations), CPU {fits['cpu'][2]:.2f} s "
          f"({fits['cpu'][1]['iterations']}); predictions agree on "
          f"{100 * agree:.2f} %; objective {o_card:.7f} against "
          f"{o_cpu:.7f} (relative {rel:.3g})")
    if not (agree >= 0.995 and rel <= 1e-4):
        raise AssertionError("the probe on the card and on the CPU disagree")
    return {"seconds": seconds, "fit_seconds": fit_s, "info": info,
            "accuracy": acc, "agree": agree, "objective_rel": rel}


# ---------------------------------------------------------------------------
# phase 8c: hard-negative mining at the gallery size
# ---------------------------------------------------------------------------

MINING_CPU_ROWS, MINING_CPU_K = 8192, 64


def phase_mining_full(data: tuple) -> dict:
    """``train.mining`` on phase 8's seeded clustered 103,945 x 2048
    features on the card: ``estimate_k_by_pca``, ``run_kmeans`` (niter 20)
    and ``mine_hard_negatives``, each timed (host clock, synchronised); no
    anchor its own negative but where JAX's rule leaves one (the anchor is
    the first candidate of its second-nearest centroid, the fallback of a
    self pick). On an 8,192-row subsample (K = 64), Lloyd from
    the same k-means++ indices on the card and on the CPU, then the mining
    with the same centroids and offsets: the same ids."""
    import numpy as np
    import torch

    from hairci_torch.train import mining

    X = torch.from_numpy(data[0]).cuda()
    times = {}
    t0 = time.perf_counter()
    k, m_star = mining.estimate_k_by_pca(X)
    times["pca_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cents, assign = mining.run_kmeans(X, k, niter=20, seed=SEED)
    torch.cuda.synchronize()
    times["kmeans_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hard = mining.mine_hard_negatives(X, cents, seed=SEED)
    torch.cuda.synchronize()
    times["mine_s"] = time.perf_counter() - t0
    sizes = torch.bincount(assign, minlength=k)
    print(f"mining {tuple(X.shape)} f32 on the card: estimate_k_by_pca K={k}"
          f" (m*={m_star}) in {times['pca_s']:.3f} s; run_kmeans niter 20 in "
          f"{times['kmeans_s']:.3f} s ({int((sizes > 0).sum())} of {k} "
          f"clusters filled, largest {int(sizes.max())}); "
          f"mine_hard_negatives in {times['mine_s']:.3f} s")
    # an anchor is its own negative only where the reference's rule leaves
    # it: it is the first candidate of its second-nearest centroid (the
    # fallback of a self pick), as in JAX (ROADMAP.md section 3)
    own = torch.arange(X.shape[0], device=X.device)
    d_ac = mining._sq_dists(X, cents)
    first = mining._stable_smallest(d_ac.T, 5)[
        mining._stable_smallest(d_ac, 2)[:, 1], 0]
    del d_ac
    selfs = hard == own
    print(f"mining: {int(selfs.sum())} anchors their own negative, each the "
          f"first candidate of its second-nearest centroid; "
          f"{int((first == own).sum())} anchors are such a first candidate")
    if hard.shape != own.shape or bool((selfs & (first != own)).any()):
        raise AssertionError("mining: an anchor is its own negative")
    # card against CPU on a subsample, from the same draws
    sub = X[:MINING_CPU_ROWS]
    draws = mining.draw_kmeanspp(torch.Generator().manual_seed(SEED),
                                 MINING_CPU_ROWS, MINING_CPU_K)
    init = mining._kmeanspp_init(sub, draws, MINING_CPU_K)
    c_card, a_card = mining._lloyd(sub, init, MINING_CPU_K, 20)
    t0 = time.perf_counter()
    c_cpu, a_cpu = mining._lloyd(sub.cpu(), init.cpu(), MINING_CPU_K, 20)
    cpu_s = time.perf_counter() - t0
    same = float((a_card.cpu() == a_cpu).float().mean())
    cdiff = float((c_card.cpu() - c_cpu).abs().max())
    offs = mining.draw_mining(torch.Generator().manual_seed(SEED),
                              MINING_CPU_ROWS)
    ids_card = mining._mine(sub, c_card, offs).cpu()
    ids_cpu = mining._mine(sub.cpu(), c_card.cpu(), offs)
    print(f"mining {MINING_CPU_ROWS} rows, K={MINING_CPU_K}, card vs CPU "
          f"(CPU Lloyd {cpu_s:.2f} s): assignments {100 * same:.3f} % equal, "
          f"centroids within {cdiff:.3g}; mined ids from the same centroids "
          f"and offsets: {int((ids_card == ids_cpu).sum())} of "
          f"{MINING_CPU_ROWS} equal")
    if not (same >= 0.999 and torch.equal(ids_card, ids_cpu)):
        raise AssertionError("mining: card and CPU differ")
    del X, sub
    torch.cuda.empty_cache()
    return {"k": k, "m_star": m_star, **times}


# ---------------------------------------------------------------------------
# phase 9: the embed at full width
# ---------------------------------------------------------------------------

def phase_embed(conv: dict) -> None:
    import numpy as np
    import torch

    from hairci_torch.ops.conv3x3 import conv3x3
    from hairci_torch.ssl.sham import SHAMRecipe

    rng = np.random.default_rng(SEED)
    images = torch.from_numpy(
        rng.integers(0, 256, (KNN_BATCH, SIZE, SIZE, 3), dtype=np.uint8))
    rec = SHAMRecipe(backbone="resnet50", img_size=SIZE,
                     dtype=torch.bfloat16)
    state = rec.create_state(SEED, 8, torch.device("cuda"))
    x = images.cuda()
    before = conv3x3.launches
    feats = rec.extract_features(state, x)
    torch.cuda.synchronize()
    if conv3x3.launches - before != 3 or feats.shape != (KNN_BATCH, 2048):
        raise AssertionError("one eval forward must launch conv3x3 3 times")
    ms = {}
    for name, lib in (("kernel", False), ("F.conv2d", True),
                      ("F.conv2d again", True), ("kernel again", False)):
        ms[name] = _embed_ms(rec, state, x, library_conv=lib)
        print(f"ResNet-50 eval forward {SIZE}px bf16 batch {KNN_BATCH}, 3x3 "
              f"64->64 convs by {name}: {ms[name]:.3f} ms "
              f"({KNN_BATCH * 1e3 / ms[name]:.1f} img/s)")
    # does the host keep ahead of the card? its time to enqueue one forward
    # (no synchronize inside the clock), and the batch the CLI is driven at
    enqueue = []
    for _ in range(10):
        t0 = time.perf_counter()
        rec.extract_features(state, x)
        enqueue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    enqueue.sort()
    ms_cli = _embed_ms(rec, state, x[:CLI_BATCH].contiguous())
    print(f"the host enqueues that forward in {enqueue[5]:.3f} ms (median of "
          f"10, host clock); the same forward at batch {CLI_BATCH}: "
          f"{ms_cli:.3f} ms ({CLI_BATCH * 1e3 / ms_cli:.1f} img/s)")
    k_ms = 3 * conv[(KNN_BATCH, "bf16")]["ms"]
    print(f"the conv3x3 kernel's share of that forward: {k_ms:.3f} ms of "
          f"{ms['kernel']:.3f} ms ({100 * k_ms / ms['kernel']:.1f} %, from "
          f"its time at this shape in phase 3)")
    rec32 = SHAMRecipe(backbone="resnet50", img_size=SIZE,
                       dtype=torch.float32)
    cpu = rec32.extract_features(
        rec32.create_state(SEED, 8, torch.device("cpu")), images[:4])
    a, b = feats[:4].float().cpu(), cpu.float()
    cos = torch.nn.functional.cosine_similarity(a, b, dim=1)
    print(f"ResNet-50 features bf16 cuda vs f32 cpu cosine: {cos.tolist()}")
    if not bool((cos >= 0.99).all()):
        raise AssertionError("card and CPU features disagree")
    del state, x
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 10: one training step on the card against the CPU
# ---------------------------------------------------------------------------

def phase_train_parity(backbone: str = "resnet50",
                       s2r2_weight: float = 0.0) -> None:
    import numpy as np
    import torch

    from hairci_torch.ssl.sham import SHAMRecipe

    B = 8
    rng = np.random.default_rng(SEED)
    images = torch.from_numpy(
        rng.integers(0, 256, (B, 256, 256, 3), dtype=np.uint8))
    rec = SHAMRecipe(backbone=backbone, img_size=SIZE, weight_decay=1e-4,
                     num_batches=1, dtype=torch.float32,
                     s2r2_weight=s2r2_weight)
    draws = rec.draw(torch.Generator().manual_seed(SEED), B, 256, 256)
    views = rec.transform.apply(images, draws["views"])
    out = {}
    for dev in ("cuda", "cpu"):
        state = rec.create_state(SEED, B, torch.device(dev))
        t0 = time.perf_counter()
        m = rec.step_on_views(state, *(v.to(dev) for v in views), draws,
                              "warmup")
        loss = float(m["loss"])
        grads = {n: p.grad.detach().cpu()
                 for n, p in state.online.named_parameters()}
        out[dev] = (loss, grads)
        print(f"train parity {dev}: warmup step {backbone} {SIZE}px B={B} "
              f"f32, S2R2 weight {s2r2_weight}: loss {loss:.7f} "
              f"({time.perf_counter() - t0:.1f} s)")
    rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    gmax = max((out["cuda"][1][n] - g).abs().max().item()
               for n, g in out["cpu"][1].items())
    print(f"train parity {backbone}: relative loss difference {rel:.3g}, max "
          f"|grad difference| {gmax:.3g} (clipped gradients)")
    if not rel <= 1e-3:
        raise AssertionError(f"card and CPU losses differ by {rel:.3g}")


def phase_train_parity_baseline(mode: str) -> None:
    """One f32 step of SimCLR (ResNet-50) or SupCon (CIFAR-stem ResNet-18)
    at 224, B=8, on the card and on the CPU from identical weights, views
    and labels."""
    import numpy as np
    import torch

    from hairci_torch.ssl import build_recipe

    B = 8
    rng = np.random.default_rng(SEED)
    images = torch.from_numpy(
        rng.integers(0, 256, (B, 256, 256, 3), dtype=np.uint8))
    labels = torch.tensor([0, 1, 0, 2, 1, 0, 3, 2])
    model = BASELINES[mode]["model"]
    rec = build_recipe(mode, backbone=model, img_size=SIZE,
                       weight_decay=1e-4, dtype=torch.float32)
    draws = rec.draw(torch.Generator().manual_seed(SEED), B, 256, 256)
    views = rec.transform.apply(images, draws["views"])
    loss = {}
    for dev in ("cuda", "cpu"):
        state = rec.create_state(SEED, B, torch.device(dev))
        t0 = time.perf_counter()
        args = [v.to(dev) for v in views]
        if mode == "simclr_supcon":
            args.append(labels.to(dev))
        loss[dev] = float(rec.step_on_views(state, *args)["loss"])
        print(f"train parity {dev}: {mode} step {model} {SIZE}px B={B} f32: "
              f"loss {loss[dev]:.7f} ({time.perf_counter() - t0:.1f} s)")
        del state
    rel = abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"])
    print(f"train parity {mode}: relative loss difference {rel:.3g}")
    if not rel <= 1e-3:
        raise AssertionError(f"card and CPU losses differ by {rel:.3g}")
    torch.cuda.empty_cache()


def phase_train_parity_masked(mode: str) -> None:
    """One f32 step of MAE or SimMIM (ViT-B/16) at 224, B=8, on the card
    and on the CPU from identical weights, view and mask."""
    import numpy as np
    import torch

    from hairci_torch.models.masking import random_token_mask_from_noise
    from hairci_torch.ssl import build_recipe

    B = 8
    rng = np.random.default_rng(SEED)
    images = torch.from_numpy(
        rng.integers(0, 256, (B, 256, 256, 3), dtype=np.uint8))
    rec = build_recipe(mode, img_size=SIZE, weight_decay=1e-4,
                       dtype=torch.float32)
    draws = rec.draw(torch.Generator().manual_seed(SEED), B, 256, 256)
    (view,) = rec.transform.apply(images, draws["views"])
    ids_keep, ids_restore, maskf = random_token_mask_from_noise(
        draws["noise"], rec.mask_ratio)
    out = {}
    for dev in ("cuda", "cpu"):
        state = rec.create_state(SEED, B, torch.device(dev))
        t0 = time.perf_counter()
        if mode == "mae":
            args = (ids_keep.to(dev), ids_restore.to(dev), maskf.to(dev))
        else:
            args = ((maskf > 0.5).to(dev),)
        m = rec.step_on_view(state, view.to(dev), *args)
        grads = {n: p.grad.detach().cpu()
                 for n, p in state.online.named_parameters()}
        out[dev] = (float(m["loss"]), grads)
        print(f"train parity {dev}: {mode} step vit_b_16 {SIZE}px B={B} f32: "
              f"loss {out[dev][0]:.7f} ({time.perf_counter() - t0:.1f} s)")
        del state
    rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    gmax = max((out["cuda"][1][n] - g).abs().max().item()
               for n, g in out["cpu"][1].items())
    print(f"train parity {mode}: relative loss difference {rel:.3g}, max "
          f"|grad difference| {gmax:.3g}")
    if not rel <= 1e-3:
        raise AssertionError(f"card and CPU losses differ by {rel:.3g}")
    torch.cuda.empty_cache()


def phase_train_parity_distill(mode: str) -> None:
    """One f32 step of DINOv2 (ViT-S/16, 65,536 prototypes, 2 + 8 views) or
    MSN (ViT-B/16, 2 + 10 views) at 224, B=8, on the card and on the CPU
    from identical weights, views and mask: every loss term, and DINOv2's
    centres. DINOv2's LayerScale gammas are drawn in [0.2, 1) first: at
    their init of 1e-5 the cls tokens lie within rounding of one another and
    KoLeo's nearest-neighbour distance is rounding noise on either device."""
    import numpy as np
    import torch

    from hairci_torch.aug.ops import to_device
    from hairci_torch.models.masking import (
        random_block_mask_from_scores,
        random_token_mask_from_noise,
    )
    from hairci_torch.ssl import build_recipe

    B = 8
    rng = np.random.default_rng(SEED)
    images = torch.from_numpy(
        rng.integers(0, 256, (B, 256, 256, 3), dtype=np.uint8))
    rec = build_recipe(mode, img_size=SIZE, weight_decay=1e-4,
                       dtype=torch.float32)
    draws = rec.draw(torch.Generator().manual_seed(SEED), B, 256, 256)
    views = rec.transform.apply(images, draws["views"])
    if mode == "dinov2":
        mask = random_block_mask_from_scores(draws["scores"], rec.grid,
                                             rec.mask_ratio)
    else:
        mask = random_token_mask_from_noise(draws["noise"],
                                            rec.mask_ratio)[0]
    out = {}
    for dev in ("cuda", "cpu"):
        state = rec.create_state(SEED, B, torch.device(dev))
        if mode == "dinov2":
            gen = torch.Generator().manual_seed(SEED)
            with torch.no_grad():
                for name, p in state.online.named_parameters():
                    if name.endswith(".gamma"):
                        gamma = torch.rand(p.shape, generator=gen) * 0.8 + 0.2
                        p.copy_(gamma)
                        state.ema.get_parameter(name).copy_(gamma)
        t0 = time.perf_counter()
        args = ([to_device(v, torch.device(dev)) for v in views],
                mask.to(dev))
        if mode == "dinov2":
            args += (0.04, 0.992)
        m = rec.step_on_views(state, *args)
        out[dev] = ({k: float(v) for k, v in m.items()},
                    {k: v.cpu() for k, v in (state.extra or {}).items()})
        print(f"train parity {dev}: {mode} step {rec.backbone} {SIZE}px B={B}"
              f" f32: {out[dev][0]} ({time.perf_counter() - t0:.1f} s)")
        del state
    rel = max(abs(out["cuda"][0][k] - v) / max(abs(v), 1e-6)
              for k, v in out["cpu"][0].items() if v != 0.0)
    centre = max([(out["cuda"][1][k] - v).abs().max().item()
                  / v.abs().max().item() for k, v in out["cpu"][1].items()]
                 or [0.0])
    print(f"train parity {mode}: largest relative loss-term difference "
          f"{rel:.3g}" + (f", centres {centre:.3g} of their largest value"
                          if mode == "dinov2" else ""))
    if not (rel <= 1e-3 and centre <= 1e-3):
        raise AssertionError(f"{mode}: card and CPU differ by {rel:.3g} "
                             f"(losses), {centre:.3g} (centres)")
    torch.cuda.empty_cache()


def phase_train_parity_momentum(mode: str) -> None:
    """One f32 step of BYOL or DenseCL (ResNet-50 at 224, B=8, the full
    heads; DenseCL's banks of 4096 x 512) on the card and on the CPU from
    identical weights and views: the loss (and DenseCL's two terms) within
    rtol 1e-3."""
    import numpy as np
    import torch

    from hairci_torch.ssl import build_recipe

    B = 8
    rng = np.random.default_rng(SEED)
    images = torch.from_numpy(
        rng.integers(0, 256, (B, 256, 256, 3), dtype=np.uint8))
    rec = build_recipe(mode, img_size=SIZE, weight_decay=1e-4,
                       dtype=torch.float32)
    draws = rec.draw(torch.Generator().manual_seed(SEED), B, 256, 256)
    views = rec.transform.apply(images, draws["views"])
    out = {}
    for dev in ("cuda", "cpu"):
        state = rec.create_state(SEED, B, torch.device(dev))
        relu_in = []
        if mode == "BYOL":   # the prediction head's first BN output
            state.online.prediction_head.layers[1].register_forward_hook(
                lambda mod, i, o: relu_in.append(o.detach().cpu()))
        t0 = time.perf_counter()
        m = rec.step_on_views(state, *(v.to(dev) for v in views),
                              momentum=0.996)
        grads = {n: p.grad.detach().cpu()
                 for n, p in state.online.named_parameters()}
        out[dev] = ({k: float(v) for k, v in m.items()}, grads,
                    relu_in[0] if relu_in else None)
        print(f"train parity {dev}: {mode} step resnet50 {SIZE}px B={B} f32:"
              f" {out[dev][0]} ({time.perf_counter() - t0:.1f} s)")
        del state
    rel = max(abs(out["cuda"][0][k] - v) / max(abs(v), 1e-6)
              for k, v in out["cpu"][0].items())
    # relative to the model's largest gradient entry: some gradients are 0
    # in exact arithmetic (BYOL's projection bias, which the predictor's
    # train-mode BN subtracts again) and rounding noise on either device
    top = max(g.abs().max().item() for g in out["cpu"][1].values())
    diff = {n: (out["cuda"][1][n] - g).abs().max().item()
            for n, g in out["cpu"][1].items()}
    worst = max(diff, key=diff.get)
    print(f"train parity {mode}: largest relative loss-term difference "
          f"{rel:.3g}; largest gradient difference {diff[worst] / top:.3g} "
          f"of the largest gradient entry ({worst})")
    if mode == "BYOL":
        # is that difference the step's own sensitivity? The ReLU inputs of
        # the prediction head whose sign the two devices' f32 rounding set
        # apart, then the CPU step again from every weight (online and
        # momentum branch alike) moved by a uniform factor in 1 +- scale
        flips = int(((out["cuda"][2] > 0) != (out["cpu"][2] > 0)).sum())
        near = float(out["cpu"][2].abs().min())
        print(f"train parity {mode}: {flips} ReLU inputs of the prediction "
              f"head take the other sign on the card (the nearest to 0 on "
              f"the CPU: {near:.3g})")
        for scale in (1e-7, 1e-5):
            state = rec.create_state(SEED, B, torch.device("cpu"))
            gen = torch.Generator().manual_seed(SEED + 1)
            with torch.no_grad():
                for p, e in zip(state.online.parameters(),
                                state.ema.parameters()):
                    f = 1 + scale * (2 * torch.rand(p.shape, generator=gen)
                                     - 1)
                    p.mul_(f)
                    e.mul_(f)
            rec.step_on_views(state, *views, momentum=0.996)
            moved = {n: (p.grad - out["cpu"][1][n]).abs().max().item()
                     for n, p in state.online.named_parameters()}
            most = max(moved, key=moved.get)
            print(f"train parity {mode}: weights moved by {scale:g} of "
                  f"themselves move the CPU gradient of {worst} by "
                  f"{moved[worst] / top:.3g} of the largest gradient entry "
                  f"(card vs CPU: {diff[worst] / top:.3g}); the most moved, "
                  f"{most}, by {moved[most] / top:.3g}")
        del state
    if not rel <= 1e-3:
        raise AssertionError(f"{mode}: card and CPU losses differ by "
                             f"{rel:.3g}")
    torch.cuda.empty_cache()


def phase_train_parity_siameseim(block_norm: str) -> None:
    """One f32 SiameseIM step (ViT-B/16, the full decoder) at 224, B=8, on
    the card and on the CPU from identical weights, views, boxes and
    mask."""
    import numpy as np
    import torch

    from hairci_torch.ssl import build_recipe
    from hairci_torch.ssl.siameseim import (
        relative_pos_embed,
        sim_two_view_transform,
    )

    B = 8
    rng = np.random.default_rng(SEED)
    images = torch.from_numpy(
        rng.integers(0, 256, (B, 256, 256, 3), dtype=np.uint8))
    rec = build_recipe("siameseim", img_size=SIZE, weight_decay=1e-4,
                       dtype=torch.float32, block_norm=block_norm)
    draws = rec.draw(torch.Generator().manual_seed(SEED), B, 256, 256)
    v1, v2, b1, b2 = sim_two_view_transform(images, draws["views"], SIZE)
    rel = relative_pos_embed(b1, b2, rec.grid, 2 * rec.decoder_dim)
    ids_keep = rec.ids_keep(draws, torch.device("cpu"))
    loss = {}
    for dev in ("cuda", "cpu"):
        state = rec.create_state(SEED, B, torch.device(dev))
        t0 = time.perf_counter()
        loss[dev] = float(rec.step_on_views(
            state, v1.to(dev), v2.to(dev), ids_keep.to(dev), rel.to(dev),
            momentum=0.996)["loss"])
        print(f"train parity {dev}: siameseim ({block_norm}) step vit_b_16 "
              f"{SIZE}px B={B} f32: loss {loss[dev]:.7f} "
              f"({time.perf_counter() - t0:.1f} s)")
        del state
    rel_diff = abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"])
    print(f"train parity siameseim ({block_norm}): relative loss difference "
          f"{rel_diff:.3g}")
    if not rel_diff <= 1e-3:
        raise AssertionError(f"siameseim: card and CPU losses differ by "
                             f"{rel_diff:.3g}")
    torch.cuda.empty_cache()


def phase_train_parity_sham_v1(mode: str) -> None:
    """One f32 SHAM v1 step (ViT-B/16) in ``mode`` at 224, B=8, on the card
    and on the CPU from identical weights, views and mask: every loss
    term."""
    import numpy as np
    import torch

    from hairci_torch.models.masking import random_token_mask_from_noise
    from hairci_torch.ssl import build_recipe

    B = 8
    rng = np.random.default_rng(SEED)
    images = torch.from_numpy(
        rng.integers(0, 256, (B, 256, 256, 3), dtype=np.uint8))
    rec = build_recipe("SHAM_v1", img_size=SIZE, sham_mode=mode,
                       dtype=torch.float32)
    draws = rec.draw(torch.Generator().manual_seed(SEED), B, 256, 256)
    views = rec.transform.apply(images, draws["views"])
    mask = random_token_mask_from_noise(draws["noise"], rec.mask_ratio)
    out = {}
    for dev in ("cuda", "cpu"):
        state = rec.create_state(SEED, B, torch.device(dev))
        t0 = time.perf_counter()
        m = rec.step_on_views(state, *(t.to(dev) for t in (*views, *mask)))
        out[dev] = {k: float(v) for k, v in m.items()}
        print(f"train parity {dev}: SHAM_v1 {mode} step vit_b_16 {SIZE}px "
              f"B={B} f32: {out[dev]} ({time.perf_counter() - t0:.1f} s)")
        del state
    rel = max(abs(out["cuda"][k] - v) / max(abs(v), 1e-6)
              for k, v in out["cpu"].items())
    print(f"train parity SHAM_v1 {mode}: largest relative loss-term "
          f"difference {rel:.3g}")
    if not rel <= 1e-3:
        raise AssertionError(f"SHAM_v1 {mode}: card and CPU differ by "
                             f"{rel:.3g}")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 10: one f32 DualViewHair step on the card and on the CPU
# ---------------------------------------------------------------------------

DV_PARITY = (("resnet", "infonce"), ("resnet", "queue"),
             ("multiscale", "hybrid"), ("partbased", "infonce"))


def phase_train_parity_dualview(encoder: str, loss: str) -> None:
    """One f32 DualViewHair step (ResNet-50 at 224, B=8; the queue a seeded
    4096 x 128 bank) on the card and on the CPU from identical weights,
    images and draws: every loss term, the queue's new rows, and the EMA
    taken before the step, within rtol 1e-3."""
    import numpy as np
    import torch

    from hairci_torch.experiments.dualview.losses import MomentumQueue
    from hairci_torch.experiments.dualview.models import DualViewHairModel
    from hairci_torch.experiments.dualview.train import (
        _student_draw,
        make_train_step,
    )

    B = 8
    rng = np.random.default_rng(SEED)
    batch = {k: torch.from_numpy(rng.integers(0, 256, (B, SIZE, SIZE, 3),
                                              dtype=np.uint8))
             for k in ("full", "hair")}
    bank0 = torch.from_numpy(rng.normal(size=(4096, 128)).astype(np.float32))
    draws = _student_draw(torch.Generator().manual_seed(SEED), B, SIZE, SIZE)
    model = DualViewHairModel(encoder=encoder)
    queue = MomentumQueue(128) if loss == "queue" else None
    step = make_train_step(model, loss, queue)
    out = {}
    for dev in ("cuda", "cpu"):
        state = model.create_state(SEED, dev)
        b = {k: v.to(dev) for k, v in batch.items()}
        t0 = time.perf_counter()
        if queue:
            m, bank, ptr = step(state, b, draws, bank0.to(dev),
                                torch.tensor(4092, device=dev))
            m["bank_rows"] = bank[[4092, 4093, 4094, 4095, 0, 1, 2, 3]]
        else:
            m = step(state, b, draws)
        ema = torch.cat([v.detach().float().reshape(-1).cpu()
                         for v in state.ema.state_dict().values()])
        out[dev] = ({k: v.detach().cpu().double() for k, v in m.items()},
                    ema, {n: p.grad.detach().cpu()
                          for n, p in state.online.named_parameters()})
        print(f"train parity {dev}: dualview {encoder} {loss} step resnet50 "
              f"{SIZE}px B={B} f32: " + ", ".join(
                  f"{k} {float(v):.7f}" for k, v in m.items()
                  if v.dim() == 0)
              + f" ({time.perf_counter() - t0:.1f} s)")
        del state
    terms = {k: float((out["cuda"][0][k] - v).abs().max()
                      / max(float(v.abs().max()), 1e-6))
             for k, v in out["cpu"][0].items()}
    ema_rel = float((out["cuda"][1] - out["cpu"][1]).abs().max()
                    / out["cpu"][1].abs().max())
    top = max(float(g.abs().max()) for g in out["cpu"][2].values())
    gmax = max(float((out["cuda"][2][n] - g).abs().max())
               for n, g in out["cpu"][2].items()) / top
    print(f"train parity dualview {encoder} {loss}: relative differences "
          f"{terms}; EMA {ema_rel:.3g}; largest gradient difference "
          f"{gmax:.3g} of the largest entry (printed, not held)")
    if not (max(terms.values()) <= 1e-3 and ema_rel <= 1e-3):
        raise AssertionError(f"dualview {encoder} {loss}: card and CPU "
                             f"differ: {terms}, EMA {ema_rel:.3g}")
    torch.cuda.empty_cache()


def kernel_times(root: str) -> int:
    """``python3 chip_smoke.py --kernel-times [DIR]``: the card's and the
    host's time of the bn_stats wrapper over the 55 BN inputs of a SHAM step
    and the 3 f32 PermuteBN shapes of a SiameseIM step (these checked
    against the twin first),
    of a 64 -> 64 ``Conv2d`` forward without gradient (bf16, 56 x 56), of
    ``topk_gallery_search`` at k=5 over a 103,945 x 768 gallery (f32 and
    bf16) for each Q of ``TOPK_SWEEP_Q`` on the route the package picks
    (recorded where the package counts its routes; beside each, under
    ``topk_twin``, the twin's median ms and the route's bound), of
    ``rotate_shear`` on
    the step's (64, 224, 224, 3) f32 batch without and with the blur, and of
    ``positive_transform`` on the step's strided SimCLR view, for the
    ``hairci_torch`` package under DIR (default: this checkout), by this
    script's back-to-back method. For comparing two checkouts on one
    card: run it for each in turn, each in its own process. Prints one JSON
    line; no other phase runs."""
    sys.path.insert(0, os.path.abspath(root))
    phase_device()
    import torch

    import hairci_torch
    from hairci_torch.aug.pipelines import positive_transform
    from hairci_torch.models.resnet import Conv2d
    from hairci_torch.ops.bn_stats import bn_stats
    from hairci_torch.ops.rotate import rotate_shear
    from hairci_torch.ops.topk import (topk_gallery_search,
                                       topk_gallery_search_reference)

    pkg = os.path.dirname(os.path.abspath(hairci_torch.__file__))
    if os.path.dirname(pkg) != os.path.abspath(root):
        raise SystemExit(f"chip_smoke: hairci_torch came from {pkg}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = 3 * TRAIN_BATCH
    shapes = resnet50_bn_shapes(rows, SIZE) + [(rows, 2048, 1),
                                               (rows, 1024, 1)]
    out = {"package": pkg, "calls": BACK_TO_BACK, "bn_stats": {}, "conv": {},
           "topk": {}, "topk_twin": {}, "rotate": {}}
    card = host = 0.0
    for m, c, n in shapes:
        x = (torch.randn(m, c, device="cuda", generator=gen) * 2
             + 1).bfloat16()
        k, h = _kernel_times(lambda: bn_stats(x))
        out["bn_stats"][f"{m}x{c}"] = [n, k, h]
        card += n * k
        host += n * h
    out["bn_stats"]["step"] = [sum(n for *_, n in shapes), card, host]
    for m, c, n in siameseim_bn_shapes(TRAIN_BATCH):
        x = torch.randn(m, c, device="cuda", generator=gen) * 2 + 1
        _check_bn(x, 1e-4, 1e-3)        # against the twin, twice for bits
        out["bn_stats"][f"siameseim {m}x{c} f32"] = [
            n, *_kernel_times(lambda: bn_stats(x))]
    conv = Conv2d(64, 64, 3, 1, 1, dtype=torch.bfloat16).cuda()
    for B in (CLI_BATCH, KNN_BATCH, 256):
        x = _conv_inputs(gen, B, 56, 56, 64, 64, torch.bfloat16)[0]
        with torch.no_grad():
            out["conv"][str(B)] = list(_kernel_times(lambda: conv(x)))
    g32 = torch.randn(GALLERY_ROWS, WIDTH, device="cuda", generator=gen)
    g32 /= g32.norm(dim=1, keepdim=True)
    for name, g in (("f32", g32), ("bf16", g32.bfloat16())):
        for Q in TOPK_SWEEP_Q:
            q = g32[:Q].contiguous()
            before = dict(getattr(topk_gallery_search, "routes", {}))
            times = list(_kernel_times(lambda: topk_gallery_search(q, g, 5)))
            took = [r for r, c in getattr(topk_gallery_search, "routes",
                                          {}).items() if c != before[r]]
            out["topk"][f"{Q} {name}"] = times + took
            out["topk_twin"][f"{Q} {name}"] = [
                _median_ms(lambda: topk_gallery_search_reference(q, g, 5)),
                *_topk_bound(Q, name, took[0] if took else "fma")]
    x = torch.randn(TRAIN_BATCH, SIZE, SIZE, 3, device="cuda", generator=gen)
    theta = torch.linspace(-15, 15, TRAIN_BATCH, device="cuda") * (
        math.pi / 180)
    sigma = torch.rand(TRAIN_BATCH, device="cuda", generator=gen) * 0.4 + 0.1
    xv = _step_view(gen, TRAIN_BATCH)
    d = {"theta": theta, "sigma": sigma}
    out["rotate"] = {
        key: list(_kernel_times(fn)) for key, fn in (
            ("plain", lambda: rotate_shear(x, theta, max_degrees=15.0)),
            ("blur", lambda: rotate_shear(x, theta, max_degrees=15.0,
                                          blur_sigma=sigma)),
            ("positive_transform", lambda: positive_transform(xv, d)))}
    print(json.dumps(out))
    return 0


# ---------------------------------------------------------------------------
# phase 11: data parallelism through the port's process-group code
# ---------------------------------------------------------------------------

DP_STAGES = ("warmup", "mine", "mined")
DP_F32_BATCH = 16        # the f32 step held against the step without a group
DP_GLOBAL_BATCH = 256    # the config's batch, for --ranks N


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dp_images(workdir: str, B: int):
    """B uint8 images as the training loader decodes them: the repo's 64
    hair crops (raw resize to 256), repeated past 64."""
    import torch

    from hairci_torch.data import DataLoader, load_manifest

    path = os.path.join(workdir, "train.csv")
    if not os.path.isfile(path):
        _write_manifest(workdir)
    loader = DataLoader(load_manifest(path, DATASET), batch_size=64,
                        size=256, mode="raw_resize", shuffle=False,
                        num_workers=8)
    images = torch.from_numpy(next(iter(loader))[0])
    return images.repeat((B + 63) // 64, 1, 1, 1)[:B]


def _sham_recipe(dtype):
    from hairci_torch.ssl import build_recipe

    return build_recipe("SHAM", backbone="resnet50", img_size=SIZE,
                        weight_decay=1e-4, num_batches=1, dtype=dtype,
                        ema_momentum=0.99, warm_up_epochs=2)


def _dp_stage_steps(recipe, state, images, tag: str) -> dict:
    """One SHAM step in each stage, each with the kernels' launch counts and
    the collectives issued; then 10 timed warmup and mined steps."""
    import torch

    from hairci_torch.parallel import collectives

    out = {"launches": {}, "calls": {}, "loss": {}, "ms": {}}
    for stage in DP_STAGES:
        _reset_counts()
        collectives.calls.update(all_gather=0, all_reduce=0)
        m = recipe.train_step(state, images,
                              torch.Generator().manual_seed(SEED),
                              stage=stage, batch_id=0, k=7)
        torch.cuda.synchronize()
        out["launches"][stage] = _counts()
        out["calls"][stage] = dict(collectives.calls)
        out["loss"][stage] = float(m["loss"])
        if not math.isfinite(out["loss"][stage]):
            raise AssertionError(f"{tag} {stage}: loss {m['loss']}")
    for stage in ("warmup", "mined"):
        out["ms"][stage] = _step_times(recipe, state, images, stage)
    print(f"dp {tag}: SHAM resnet50 {SIZE}px bf16 B={images.shape[0]} a "
          f"rank: losses {out['loss']}; launches {out['launches']}; "
          f"collectives {out['calls']}; median ms/step (host clock, each "
          f"step synchronised) {out['ms']}")
    return out


def _dp_f32_step(images) -> dict:
    """One f32 warmup step from seeded weights: its metrics, clipped
    gradients and BN running stats."""
    import torch

    rec = _sham_recipe(torch.float32)
    state = rec.create_state(SEED, images.shape[0], images.device)
    m = rec.train_step(state, images, torch.Generator().manual_seed(SEED),
                       stage="warmup")
    out = {"metrics": {k: float(v) for k, v in m.items()},
           "grads": {n: p.grad.detach().clone()
                     for n, p in state.online.named_parameters()},
           "running": {n: b.clone() for n, b in state.online.named_buffers()
                       if "running" in n}}
    del state
    return out


def _near_tie_same(s, i, g, q, k: int) -> float:
    """The top-k scores within 1e-5 of the plain twin's on the whole
    gallery, the indices equal where its neighbouring scores part by more
    than 1e-5; returns the largest score difference."""
    import torch

    from hairci_torch.eval.knn import full_f32_matmul
    from hairci_torch.ops.topk import topk_gallery_search_reference

    with full_f32_matmul():
        rs, ri = topk_gallery_search_reference(q, g, k + 1)
    s, i = torch.as_tensor(s, device=g.device), torch.as_tensor(
        i, device=g.device)
    err = (s - rs[:, :k]).abs().max().item()
    inf = torch.full_like(rs[:, :1], float("inf"))
    gaps = rs[:, :-1] - rs[:, 1:]
    clear = torch.minimum(torch.cat([inf, gaps[:, :-1]], 1), gaps) > 1e-5
    if not (err <= 1e-5 and bool(((i == ri[:, :k]) | ~clear).all())):
        raise AssertionError(f"sharded search differs from the whole "
                             f"gallery's (score error {err})")
    return err


def _dp_gallery():
    """The seeded 103,945 x 768 unit-norm gallery (host f32) and queries
    near its rows, Q = 1 and 256 (host f32)."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    g = rng.standard_normal((GALLERY_ROWS, WIDTH), dtype=np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    rows = rng.integers(0, GALLERY_ROWS, 256)
    q = g[rows] + 0.3 * rng.standard_normal((256, WIDTH), dtype=np.float32) \
        / WIDTH ** 0.5
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return g, {1: q[:1], 256: q}


def _dp_search(index, queries: dict, g, tag: str, check: bool) -> dict:
    """Each query batch through ``index.search`` (k = 5): one top-k launch a
    search, the answer held against the plain twin on the whole gallery,
    the median search ms."""
    import torch

    from hairci_torch.ops.topk import topk_gallery_search

    out = {}
    for Q, q in queries.items():
        _reset_counts()
        s, i = index.search(q, k=5, normalized=True)
        launches = topk_gallery_search.launches
        routes = dict(topk_gallery_search.routes)
        if launches != 1:
            raise AssertionError(f"{tag} Q={Q}: {launches} top-k launches")
        err = (_near_tie_same(s, i, g, torch.as_tensor(q, device=g.device),
                              5) if check else None)
        ms = _median_ms(lambda: index.search(q, k=5, normalized=True),
                        runs=10, warmup=3)
        out[Q] = {"ms": ms, "routes": routes, "max_abs_err": err}
        print(f"dp {tag}: search Q={Q} k=5 over {GALLERY_ROWS} x {WIDTH}: "
              f"{ms:.3f} ms (CUDA events round the call), routes {routes}, "
              f"score error {err}")
    return out


# the recipes whose data-parallel steps came after SHAM's and SimCLR's
# ResNet steps, each at 224 in f32 for the step held with and without a
# group: the kernels one step launches (DINOv2 reaches none; SiameseIM its
# 16 PermuteBNs; SHAM on the ViT one rotation and the head's two BNs;
# SimCLR the ResNet-50's 55 BNs; SupCon the CIFAR-stem ResNet-18's 20; MSN
# the head's 2 BNs in each of its two passes; BYOL the ResNet-50's 53 and
# its heads' 2, DenseCL the 53, each with the 3 conv3x3 of its momentum
# forward; MAE, SimMIM and SHAM v1 none) and the all-gathers it issues
# (SHAM's pos1 views and NT-Xent's pairs, SimCLR's NT-Xent pairs, one more
# for S2R2's keys, DINOv2's KoLeo rows of its two global views, SupCon's
# views and labels, DenseCL's global and local keys for its banks, SHAM
# v1's NT-Xent pairs; SiameseIM, MSN, BYOL, MAE and SimMIM reduce their
# sums and gather nothing)
DP_RECIPES = {
    "dinov2": {"launches": {"bn_stats": 0, "rotate_shear": 0},
               "all_gather": 2},
    "siameseim": {"launches": {"bn_stats": 16, "rotate_shear": 0},
                  "all_gather": 0},
    "SHAM_vit_s2r2": {"launches": {"bn_stats": 2, "rotate_shear": 1},
                      "all_gather": 3},
    "simclr_s2r2": {"launches": {"bn_stats": 55, "rotate_shear": 0},
                    "all_gather": 2},
    "simclr_supcon": {"launches": {"bn_stats": 20, "rotate_shear": 0},
                      "all_gather": 2},
    "MSN": {"launches": {"bn_stats": 4, "rotate_shear": 0}, "all_gather": 0},
    "BYOL": {"launches": {"bn_stats": 55, "rotate_shear": 0, "conv3x3": 3},
             "all_gather": 0},
    "DenseCL": {"launches": {"bn_stats": 53, "rotate_shear": 0,
                             "conv3x3": 3}, "all_gather": 2},
    "mae": {"launches": {"bn_stats": 0, "rotate_shear": 0}, "all_gather": 0},
    "simMIM": {"launches": {"bn_stats": 0, "rotate_shear": 0},
               "all_gather": 0},
    "SHAM_v1": {"launches": {"bn_stats": 0, "rotate_shear": 0},
                "all_gather": 1},
}
# --ranks N: the global batch of each mode, the config's B=256 but for
# DINOv2's config's 128 and the 128 of SupCon's and MSN's one-card timings
# (phases 7e, 7j; SupCon's B=256 does not fit one card)
DP_RANK_BATCH = {"dinov2": 128, "simclr_supcon": 128, "MSN": 128}
DP_RECIPE_BATCH = 8      # the f32 steps of DP_RECIPES
# the modes of --ranks N and the all-gathers one step issues: SHAM's and
# SimCLR's ResNet-50 steps (SHAM in its warmup stage), then DP_RECIPES
DP_RANK_GATHERS = {"SHAM": 2, "simclr": 1,
                   **{name: r["all_gather"] for name, r in DP_RECIPES.items()}}


def _dp_recipe(name: str, dtype):
    from hairci_torch.ssl import build_recipe

    kw = dict(img_size=SIZE, weight_decay=1e-4, dtype=dtype)
    if name == "SHAM":
        return build_recipe("SHAM", backbone="resnet50", num_batches=1, **kw)
    if name == "simclr":
        return build_recipe("simclr", backbone="resnet50", **kw)
    if name == "SHAM_vit_s2r2":
        return build_recipe("SHAM", backbone="vit_b_16", num_batches=1,
                            s2r2_weight=1.0, **kw)
    if name == "simclr_s2r2":
        return build_recipe("simclr", backbone="resnet50", s2r2_weight=1.0,
                            **kw)
    if name == "dinov2":
        return build_recipe("dinov2", epochs=1, steps_per_epoch=1, **kw)
    if name == "SHAM_v1":
        return build_recipe(name, sham_mode="reconstruction", **kw)
    return build_recipe(name, **kw)


def _dp_recipe_state(name: str, rec, B: int, dev):
    """The recipe's seeded state; DINOv2's LayerScale gammas drawn in
    [0.2, 1) in both branches (at their init of 1e-5 KoLeo's nearest
    neighbour is rounding noise, phase 10)."""
    import torch

    state = rec.create_state(SEED, B, dev)
    if name == "dinov2":
        gen = torch.Generator().manual_seed(SEED)
        with torch.no_grad():
            for pname, p in state.online.named_parameters():
                if pname.endswith(".gamma"):
                    gamma = torch.rand(p.shape, generator=gen) * 0.8 + 0.2
                    p.copy_(gamma)
                    state.ema.get_parameter(pname).copy_(gamma)
    return state


def _dp_recipe_step(name: str, rec, state, images, seed: int = SEED):
    import torch

    from hairci_torch.parallel import collectives

    gen = torch.Generator().manual_seed(seed)
    if name == "dinov2":
        return rec.train_step(state, images, gen, teacher_temp=0.04,
                              momentum=0.992)
    if name in ("siameseim", "BYOL", "DenseCL"):
        return rec.train_step(state, images, gen, momentum=0.996)
    if name == "simclr_supcon":
        # seven classes over the global batch, this rank's rows' labels
        lo = collectives.rank() * images.shape[0]
        labels = torch.arange(lo, lo + images.shape[0]) % 7
        return rec.train_step(state, images, gen,
                              labels=labels.to(images.device))
    if name in ("SHAM", "SHAM_vit_s2r2"):
        return rec.train_step(state, images, gen, stage="warmup")
    return rec.train_step(state, images, gen)


def _dp_recipe_f32(name: str, images) -> dict:
    """One f32 step of a DP_RECIPES entry from seeded weights: its metrics,
    the gradients the optimizer took, the BN running statistics, DINOv2's
    centres; the kernels' launches and the collectives of the step."""
    import torch

    from hairci_torch.parallel import collectives

    rec = _dp_recipe(name, torch.float32)
    state = _dp_recipe_state(name, rec, images.shape[0], images.device)
    _reset_counts()
    collectives.calls.update(all_gather=0, all_reduce=0)
    t0 = time.perf_counter()
    m = _dp_recipe_step(name, rec, state, images)
    torch.cuda.synchronize()
    out = {"s": time.perf_counter() - t0, "launches": _counts(),
           "calls": dict(collectives.calls),
           "metrics": {k: float(v) for k, v in m.items()},
           "grads": {n: p.grad.detach().clone()
                     for n, p in state.online.named_parameters()},
           "running": {n: b.clone() for n, b in state.online.named_buffers()
                       if "running" in n},
           "extra": {k: v.clone() for k, v in (state.extra or {}).items()}}
    del state
    torch.cuda.empty_cache()
    return out


def _held(a: dict, b: dict, parts=("metrics", "grads", "running")) -> dict:
    """For each part, the largest |a - b| over (1e-5 |b| + 1e-5 max|b| of
    its tensor): at most 1 where a equals b at rtol 1e-5."""
    import torch

    worst = {}
    for what in parts:
        errs = [0.0]
        for name, want in b[what].items():
            got = torch.as_tensor(a[what][name], dtype=torch.float64)
            want = torch.as_tensor(want, dtype=torch.float64)
            scale = want.abs().max().item()
            tol = 1e-5 * want.abs() + 1e-5 * scale + 1e-12
            errs.append(((got - want).abs() / tol).max().item())
        worst[what] = max(errs)
    return worst


def _dp_recipes_held(plain: dict, dp: dict) -> dict:
    """The one-rank group's f32 step of each DP_RECIPES entry against the
    step without a group: the same launches, the step's all-gathers and
    some all-reduces with the group and no collective without it, every
    metric, gradient, BN statistic and centre at rtol 1e-5."""
    launches = {}
    for name, r in DP_RECIPES.items():
        p, d = plain[name], dp[name]
        want = {"topk_gallery_search": 0, "conv3x3": 0, **r["launches"]}
        if p["launches"] != want or d["launches"] != p["launches"]:
            raise AssertionError(
                f"dp {name}: launches {d['launches']} with the group, "
                f"{p['launches']} without, want {want}")
        if (d["calls"]["all_gather"] != r["all_gather"]
                or not d["calls"]["all_reduce"] or any(p["calls"].values())):
            raise AssertionError(
                f"dp {name}: collectives {d['calls']} with the group (want "
                f"{r['all_gather']} all-gathers), {p['calls']} without")
        worst = _held(d, p, ("metrics", "grads", "running", "extra"))
        print(f"dp f32 step {name} ({SIZE} px, B={DP_RECIPE_BATCH}): the "
              f"one-rank group's against the step without a group, largest "
              f"|difference| over (1e-5 |x| + 1e-5 max|x|): {worst}; loss "
              f"{d['metrics']['loss']:.7f} vs {p['metrics']['loss']:.7f}; "
              f"launches {d['launches']}; collectives {d['calls']}; "
              f"{d['s']:.2f} s with the group, {p['s']:.2f} s without "
              "(first call, host clock)")
        if max(worst.values()) > 1:
            raise AssertionError(f"dp f32 step {name}: off by {worst} of "
                                 "rtol 1e-5")
        launches[name] = d["launches"]
    return launches


def phase_dp(workdir: str) -> dict:
    """Phase 11: SHAM's step and the gallery search without a process group,
    then through a one-rank NCCL group (the data-parallel code that runs at
    W ranks; NCCL takes one rank a card), side by side."""
    import torch
    import torch.distributed as dist

    from hairci_torch.parallel import collectives, create_mesh
    from hairci_torch.retrieval import ShardedGalleryIndex
    from hairci_torch.retrieval.index import GalleryIndex

    dev = torch.device("cuda")
    images = _dp_images(workdir, TRAIN_BATCH).to(dev)
    rec = _sham_recipe(torch.bfloat16)
    g, queries = _dp_gallery()
    paths = [str(i) for i in range(GALLERY_ROWS)]
    g_dev = torch.from_numpy(g).to(dev)

    # without a process group: the one-card path of every earlier phase
    state = rec.create_state(SEED, TRAIN_BATCH, dev)
    plain = _dp_stage_steps(rec, state, images, "without a group")
    del state
    f32_plain = _dp_f32_step(images[:DP_F32_BATCH])
    index = GalleryIndex(g, paths, normalized=True, device=dev)
    plain_search = _dp_search(index, queries, g_dev, "GalleryIndex", True)
    del index
    t_recipes = time.perf_counter()
    recipes_plain = {name: _dp_recipe_f32(name, images[:DP_RECIPE_BATCH])
                     for name in DP_RECIPES}
    t_recipes = time.perf_counter() - t_recipes

    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = create_mesh()
        state = rec.create_state(SEED, TRAIN_BATCH, dev)
        dp = _dp_stage_steps(rec, state, images, "one-rank group")
        del state
        f32_dp = _dp_f32_step(images[:DP_F32_BATCH])
        index = ShardedGalleryIndex(mesh, g, paths, normalized=True,
                                    device=dev)
        dp_search = _dp_search(index, queries, g_dev, "ShardedGalleryIndex",
                               True)
        del index
        t0 = time.perf_counter()
        recipes_dp = {name: _dp_recipe_f32(name, images[:DP_RECIPE_BATCH])
                      for name in DP_RECIPES}
        t_recipes += time.perf_counter() - t0
        tp = _dp_tp(mesh, dev)
    finally:
        collectives.shutdown()

    for stage in DP_STAGES:
        # 55 train-mode BNs over the 3B rows, one rotation, and 3 conv3x3 a
        # forward without gradient (the EMA's; two in the mine stage)
        want = {"topk_gallery_search": 0, "rotate_shear": 1, "bn_stats": 55,
                "conv3x3": 6 if stage == "mine" else 3}
        if plain["launches"][stage] != want:
            raise AssertionError(f"{stage}: launches "
                                 f"{plain['launches'][stage]} != {want}")
        if dp["launches"][stage] != plain["launches"][stage]:
            raise AssertionError(
                f"dp {stage}: launches {dp['launches'][stage]} != "
                f"{plain['launches'][stage]} without a group")
        # the pos1 views and NT-Xent's pairs, and the EMA features to mine
        gathers = 3 if stage == "mine" else 2
        if (dp["calls"][stage]["all_gather"] != gathers
                or not dp["calls"][stage]["all_reduce"]):
            raise AssertionError(f"dp {stage}: collectives "
                                 f"{dp['calls'][stage]}, want {gathers} "
                                 "all-gathers and some all-reduces")
    # the one-rank step is the step: every metric, BN statistic and clipped
    # gradient of the f32 step at rtol 1e-5
    worst = _held(f32_dp, f32_plain)
    if max(worst.values()) > 1:
        raise AssertionError(f"dp f32 step: off by {worst} of rtol 1e-5")
    print(f"dp f32 step (B={DP_F32_BATCH}, warmup): the one-rank group's "
          f"against the step without a group, largest |difference| over "
          f"(1e-5 |x| + 1e-5 max|x|): {worst}; loss "
          f"{f32_dp['metrics']['loss']:.7f} vs "
          f"{f32_plain['metrics']['loss']:.7f}")
    recipe_launches = _dp_recipes_held(recipes_plain, recipes_dp)
    print(f"dp: the {len(DP_RECIPES)} recipes' f32 steps, with and without "
          f"the group, took {t_recipes:.1f} s (host clock, builds included)")
    launches = {name: sum(dp["launches"][s][name] for s in DP_STAGES)
                + sum(r[name] for r in recipe_launches.values())
                for name in dp["launches"]["warmup"]}
    launches["topk_gallery_search"] = len(dp_search)
    torch.cuda.empty_cache()
    return {"launches": launches, "recipe_launches": recipe_launches,
            "tp": tp, "search": {"plain": plain_search, "dp": dp_search}}


def _dp_tp(mesh, dev) -> dict:
    """The dry run's tensor-parallel CosFace head over the mesh's ``model``
    group (one rank here): its loss and step against the unsharded head's,
    and the collectives it called."""
    from hairci_torch.cli.dryrun_multichip import part_tp
    from hairci_torch.parallel import collectives

    collectives.calls.update(all_gather=0, all_reduce=0)
    out = part_tp(mesh, dev, B=16)
    out["calls"] = dict(collectives.calls)
    if out["calls"]["all_gather"] < 1:
        raise AssertionError(f"TP head: collectives {out['calls']}")
    print(f"dp TP CosFace head (64 classes x 32 on the one-rank model "
          f"group, B=16): loss {out['loss']:.6f}, "
          f"|loss - unsharded| {out['loss_err']:.3g}, largest |step - "
          f"unsharded step| {out['step_err']:.3g}; collectives "
          f"{out['calls']}")
    return out


# ---------------------------------------------------------------------------
# --ranks N: phase 11 on N cards, one NCCL rank a card
# ---------------------------------------------------------------------------

DP_PROFILE = ("SHAM", "siameseim")   # the modes --profile traces


def _dp_profile(rec, state, step, x) -> dict:
    """Three steps of ``step`` on ``x`` under torch.profiler, each
    synchronised: per step, the host clock's wall time, the host time of
    the recipe's draws (``rec.draw``, for the global batch under a group),
    the card's busy time (the union of its kernels' and copies' intervals:
    NCCL runs on a stream of its own), the NCCL kernels' time, and the
    card's idle share of the wall time. The traced steps carry the
    profiler's own host cost, and the spans' (``utils.profiling.span``)."""
    import torch

    from hairci_torch.utils import profiling

    draw = rec.draw

    def traced_draw(*args, **kw):
        with profiling.span("dp_draw"):
            return draw(*args, **kw)

    rec.draw = traced_draw
    walls = []
    try:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for i in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(state, x, 20 + i)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
    finally:
        del rec.draw   # the class's method again
        # the program's spans (dp_draw, sham.*) are ranges, not device work
        named = {s["name"] for s in profiling.spans()}
        profiling.clear()
    spans, nccl_us, draw_us = [], 0.0, 0.0
    for e in prof.events():
        if getattr(e, "is_user_annotation", False) or e.name in named:
            if e.device_type == torch.autograd.DeviceType.CPU \
                    and e.name == "dp_draw":
                draw_us += e.time_range.elapsed_us()
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            if "nccl" in e.name.lower():
                nccl_us += e.time_range.elapsed_us()
    busy_us, end = 0.0, -math.inf
    for lo, hi in sorted(spans):
        busy_us += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    wall = sum(walls) / 3
    return {"wall_ms": wall, "draw_ms": draw_us / 3e3,
            "busy_ms": busy_us / 3e3, "nccl_ms": nccl_us / 3e3,
            "idle_share": 1 - busy_us / 3e3 / wall,
            "threads": torch.get_num_threads()}


def _dp_rank(rank: int, n: int, port: int, workdir: str,
             profile: bool = False) -> None:
    """One rank of ``--ranks N``: SHAM and SimCLR (ResNet-50, 224, bf16) and
    the DP_RECIPES (bf16) at the global batch (DP_RANK_BATCH, else 256)
    on N cards (B/N a rank) and on one card (rank 0 alone, through a
    one-rank group, where N x the peak of a rank's step stays below 75
    GiB), each timed; the kernels' launches and the collectives of the
    N-card step; equal parameters on every rank; the sharded search on N
    cards against GalleryIndex on one. With ``profile``, the DP_PROFILE
    modes also trace three N-card steps on every rank, time the N-card step
    again at (host cores / N) intra-op threads a rank, and on rank 0 trace
    a one-card step at the same b rows a rank (``_dp_profile``)."""
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    from hairci_torch.parallel import collectives, create_mesh
    from hairci_torch.retrieval import ShardedGalleryIndex
    from hairci_torch.retrieval.index import GalleryIndex

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if n > 1:
        dev = collectives.init_distributed(f"localhost:{port}", n, rank,
                                           torch.device("cuda"))
    else:   # init_distributed leaves one process alone, as JAX's does
        dev = torch.device("cuda", 0)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"tcp://localhost:{port}",
                                rank=0, world_size=1)
    images = _dp_images(workdir, DP_GLOBAL_BATCH)
    one = dist.new_group([0])
    res = {"ranks": n, "global_batch": DP_GLOBAL_BATCH, "card": _card_line()}
    for mode in DP_RANK_GATHERS:
        B = DP_RANK_BATCH.get(mode, DP_GLOBAL_BATCH)
        b = B // n
        mine = images[rank * b:(rank + 1) * b].to(dev)
        rec = _dp_recipe(mode, torch.bfloat16)

        def step(state, x, i):
            return _dp_recipe_step(mode, rec, state, x, 1000 + i)

        def timed(state, x):
            times = []
            for i in range(13):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(state, x, i)
                torch.cuda.synchronize()
                if i >= 3:
                    times.append((time.perf_counter() - t0) * 1e3)
            return sorted(times)[len(times) // 2]

        torch.cuda.reset_peak_memory_stats()
        state = rec.create_state(SEED, B, dev)
        _reset_counts()
        collectives.calls.update(all_gather=0, all_reduce=0)
        step(state, mine, 0)
        torch.cuda.synchronize()
        row = {"global_batch": B, "launches": _counts(),
               "calls": dict(collectives.calls),
               "ms_n_cards": timed(state, mine)}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if profile and mode in DP_PROFILE:
            row["profile"] = _dp_profile(rec, state, step, mine)
            threads = torch.get_num_threads()
            cut = max(1, len(os.sched_getaffinity(0)) // n)
            torch.set_num_threads(cut)
            row["profile"]["threads_cut"] = cut
            row["profile"]["ms_threads_cut"] = timed(state, mine)
            torch.set_num_threads(threads)
        sums = torch.stack([p.detach().double().sum()
                            for p in state.online.parameters()])
        every = collectives.all_gather(sums[None])
        row["params_equal"] = bool((every == every[0]).all())
        row["peak_gib_a_rank"] = peak
        del state
        torch.cuda.empty_cache()
        if rank == 0 and peak * n < 75:
            collectives.set_group(one)
            state = rec.create_state(SEED, B, dev)
            row["ms_one_card"] = timed(state, images[:B].to(dev))
            collectives.set_group(None)
            del state
            torch.cuda.empty_cache()
        elif rank == 0:
            row["ms_one_card"] = None
        if profile and mode in DP_PROFILE and rank == 0:
            collectives.set_group(one)
            state = rec.create_state(SEED, b, dev)
            x = images[:b].to(dev)
            row["profile_one_card"] = {
                "ms": timed(state, x),
                **_dp_profile(rec, state, step, x)}
            collectives.set_group(None)
            del state, x
            torch.cuda.empty_cache()
        res[mode] = row
        dist.barrier()
    g, queries = _dp_gallery()
    paths = [str(i) for i in range(GALLERY_ROWS)]
    index = ShardedGalleryIndex(create_mesh(), g, paths, normalized=True,
                                device=dev)
    res["search_n_cards"] = _dp_search(index, queries,
                                       torch.from_numpy(g).to(dev),
                                       f"{n} ranks, rank {rank}", rank == 0)
    del index
    if rank == 0:
        index = GalleryIndex(g, paths, normalized=True, device=dev)
        res["search_one_card"] = _dp_search(index, queries,
                                            torch.from_numpy(g).to(dev),
                                            "GalleryIndex", True)
        with open(os.path.join(workdir, "dp_ranks.json"), "w") as f:
            json.dump(res, f)
    dist.barrier()
    collectives.shutdown()


def dp_ranks(n: int, profile: bool = False) -> int:
    """``python3 chip_smoke.py --ranks N [--profile]``: phases 1-2, then
    phase 11 on N cards (``_dp_rank``), one process a card."""
    import torch

    device = phase_device()
    if device["count"] < n:
        raise SystemExit(f"chip_smoke --ranks {n}: {device['count']} cards")
    phase_build()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_",
                                     dir=REPO) as workdir:
        torch.multiprocessing.spawn(_dp_rank,
                                    args=(n, _free_port(), workdir,
                                          profile),
                                    nprocs=n)
        with open(os.path.join(workdir, "dp_ranks.json")) as f:
            res = json.load(f)
    for mode, gathers in DP_RANK_GATHERS.items():
        r = res[mode]
        if not (r["params_equal"] and r["calls"]["all_reduce"]
                and r["calls"]["all_gather"] == gathers):
            raise AssertionError(f"--ranks {n} {mode}: {r}, want {gathers} "
                                 "all-gathers and some all-reduces")
        what = f"{mode} resnet50" if mode in ("SHAM", "simclr") else mode
        print(f"dp {what} {SIZE}px bf16 B={r['global_batch']}: "
              f"{n} cards {r['ms_n_cards']:.2f} ms/step, one card "
              f"{r['ms_one_card']} ms/step (host clock, median of 10 after "
              f"3); launches a rank {r['launches']}; collectives {r['calls']}")
        if "profile" in r:
            b = r["global_batch"] // n
            for what, p in ((f"{n} cards, rank 0", r["profile"]),
                            ("one card", r.get("profile_one_card"))):
                if p is None:
                    continue
                print(f"dp profile {what}: {mode} b={b} a rank, 3 steps "
                      f"under torch.profiler (host clock, synchronised): "
                      f"wall {p['wall_ms']:.2f} ms/step, the draws on the "
                      f"host {p['draw_ms']:.2f}, the card busy "
                      f"{p['busy_ms']:.2f} (NCCL kernels {p['nccl_ms']:.2f}), "
                      f"idle share {p['idle_share']:.3f}; {p['threads']} "
                      "intra-op threads")
            p = r["profile"]
            print(f"dp profile {n} cards: {mode} at {p['threads_cut']} "
                  f"intra-op threads a rank {p['ms_threads_cut']:.2f} "
                  f"ms/step, at {p['threads']} {r['ms_n_cards']:.2f} "
                  f"(host clock, median of 10 after 3)")
    # the dry run's five parts on the N cards and on one
    res["dryrun"] = {}
    for ranks in (n, 1):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "hairci_torch.cli.dryrun_multichip",
             "--ranks", str(ranks)], cwd=REPO, capture_output=True,
            text=True, timeout=600)
        lines = [line for line in proc.stdout.splitlines()
                 if line.startswith("dryrun_multichip(")]
        print("\n".join(lines))
        if proc.returncode != 0 or len(lines) != 5:
            sys.stderr.write(proc.stderr[-4000:])
            raise AssertionError(f"dryrun_multichip --ranks {ranks}: rc "
                                 f"{proc.returncode}, {len(lines)} lines")
        res["dryrun"][ranks] = {"s": time.perf_counter() - t0,
                                "lines": lines}
        print(f"dryrun_multichip --ranks {ranks}: "
              f"{res['dryrun'][ranks]['s']:.1f} s (host clock, the process "
              "and its ranks' start-up included)")
    print(_card_line())
    print(json.dumps({"dp_ranks": res}))
    device["count"] = n
    print(json.dumps({"ok": True, "device": device}))
    return 0


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "hairci_torch")):
        raise SystemExit("chip_smoke: hairci_torch/ not found beside "
                         "chip_smoke.py; run it from a checkout of the repo")
    if sys.argv[1:2] == ["--kernel-times"]:
        return kernel_times(sys.argv[2] if len(sys.argv) > 2 else REPO)
    sys.path.insert(0, REPO)
    if sys.argv[1:2] == ["--ranks"]:
        return dp_ranks(int(sys.argv[2]), "--profile" in sys.argv[3:])
    device = phase_device()
    phase_build()
    if sys.argv[1:2] == ["--bn-apply"]:
        phase_bn_apply()
        print(json.dumps({"ok": True, "device": device}))
        return 0
    kern = phase_kernels()
    phase_bn_apply()
    # the index, manifest and run dir are written inside the checkout and
    # removed afterwards
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_",
                                     dir=REPO) as workdir:
        encoder, paths, launches = phase_serve(workdir)
        phase_parity(encoder, paths)
        del encoder
        face, face_encoder = phase_serve_face(workdir)
        faiss = phase_faiss_native_demo(workdir, face_encoder)
        del face_encoder
        train = phase_train(workdir, kern)
        knn = phase_knn(workdir, train)
        train_vit = phase_train_vit(workdir, train)
        phase_knn_vit(workdir, train_vit)
        runs = {mode: phase_train_baseline(workdir, train, mode)
                for mode in BASELINES}
        evals = phase_eval_baselines(workdir, train, runs)
        masked = {mode: phase_train_masked(workdir, train, mode)
                  for mode in MASKED}
        distill = {mode: phase_train_distill(workdir, train, mode)
                   for mode in DISTILL}
        momentum = {mode: phase_train_momentum(workdir, train, mode)
                    for mode in MOMENTUM_MODES}
        siameseim = phase_train_siameseim(workdir, train)
        sham_v1 = phase_train_sham_v1(workdir, train)
        dualview = phase_train_dualview(workdir)
    vit = train_vit["launches"]
    features = phase_knn_full()
    phase_probe_full(features)
    phase_mining_full(features)
    del features
    phase_embed(kern["conv3x3"]["times"])
    phase_train_parity()
    phase_train_parity("vit_b_16", s2r2_weight=1.0)
    for mode in BASELINES:
        phase_train_parity_baseline(mode)
    for mode in MASKED:
        phase_train_parity_masked(mode)
    for mode in DISTILL:
        phase_train_parity_distill(mode)
    for mode in MOMENTUM_MODES:
        phase_train_parity_momentum(mode)
    for block_norm in ("permute_bn", "ln"):
        phase_train_parity_siameseim(block_norm)
    for mode in ("embedding", "reconstruction"):
        phase_train_parity_sham_v1(mode)
    for encoder, loss in DV_PARITY:
        phase_train_parity_dualview(encoder, loss)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_",
                                     dir=REPO) as workdir:
        dp = phase_dp(workdir)
    rot, bn, topk = kern["rotate"], kern["bn_stats"], kern["topk"]
    conv = kern["conv3x3"]["times"][(CLI_BATCH, "bf16")]
    conv224 = kern["conv3x3"]["times224"][CLI_BATCH]
    conv128 = kern["conv3x3"]["times"][(2 * TRAIN_BATCH, "bf16")]
    conv_dv = kern["conv3x3"]["times"][(DV_BATCH, "f32")]
    # ms (the card's time, calls back to back), host_ms (the wrapper's time
    # on the host), plain_ms, bound_ms and library_ms of a kernel are at one
    # shape: the top-k at Q=1 (its fma route) and, as
    # topk_gallery_search_batched, at Q=256 (its mma route, the batched
    # /search), both on the f32 gallery, each with its own bound, its own
    # route's score error and launches in the serve run; the rotation with blur at the step's
    # batch, the 55 BN inputs of one SHAM forward summed, and the conv at
    # the batch the kNN CLI ran it with (its launches are that run's), bf16,
    # weights packed by the caller as Conv2d does. No single PyTorch call
    # computes the first three (matmul + sort is two, grid_sample is no
    # 3-shear, and var_mean of a bf16 input rounds its statistics to bf16),
    # so their library_ms is null; bn_stats' f32 sets (siameseim_*,
    # dualview_*) carry torch.var_mean's time as their library_ms.
    # launches_vit: the same kernel's launches in the ViT SHAM training
    # run (phase 7b); bn_stats' vit_* numbers are the ViT head's two BN
    # inputs summed. launches_simclr / launches_supcon: bn_stats' launches in
    # the SimCLR and SupCon training runs (phases 7d, 7e), conv3x3's in the
    # four evaluations of each one's checkpoint (phase 7f); bn_stats'
    # supcon_* numbers are the 20 BN inputs of one SupCon forward summed,
    # its msn_* numbers the 4 BN inputs of one MSN step summed, its byol_*
    # numbers the 2 head BN inputs of one BYOL step at B=64, (128, 4096)
    # bf16, summed; conv3x3's *_224 numbers the CIFAR-stem ResNet-18's
    # layer1 conv at the kNN CLI's batch, (48, 224, 224, 64) bf16, its *_128
    # numbers BYOL's momentum forward at B=64, (128, 56, 56, 64) bf16;
    # launches_byol / launches_densecl each run's training and (DenseCL)
    # kNN evaluation, phases 7k, 7l; its siameseim_* numbers the 16 f32
    # PermuteBN inputs of one SiameseIM step at B=64 summed. The top-k's
    # *_d512 numbers
    # are the same at the face encoder's width, 103,945 x 512 f32 (phase 3),
    # launches_face its route's launches in each face model's serve run
    # (phase 4d), launches_faiss the --faiss_index search's and the demo's
    # retrieval's (phase 4e; both single queries, the fma route); its *_d256
    # numbers the same at DualViewHair's width, 103,945 x 256 f32. bn_stats'
    # dualview_* numbers are the 56 f32 BN inputs of one DualViewHair
    # student forward at B=32 summed, conv3x3's *_f32_32 numbers its EMA
    # teacher's layer1 conv at B=32, (32, 56, 56, 64) f32 (the fma kernel);
    # launches_dualview each kernel's launches in phase 7o (its five training
    # runs, both evaluation towers and the two retrievals).
    topk_rows = []
    for name, route, Q in (("topk_gallery_search", "fma", 1),
                           ("topk_gallery_search_batched", "mma", 256)):
        kern_ms, plain_ms, host_ms, bound, took = topk["times"][(Q, "f32")]
        if took != route:
            raise AssertionError(f"topk at Q={Q} took the {took} route")
        d512 = topk["face_times"][(Q, "f32")]
        d256 = topk["d256_times"][Q]
        topk_rows.append(
            {"name": name, "route": "cuda",
             "source": "hairci_torch/ops/csrc/topk.cu",
             "replaces": "hairci/ops/topk_pallas.py:43",
             "launches": launches[route],
             "launches_vit": vit["topk_gallery_search"],
             "launches_face": {m: face[m]["launches"][route]
                               for m in FACE_MODELS},
             "launches_faiss": (faiss["launches_cli"]
                                + faiss["launches_demo"]
                                if route == "fma" else 0),
             "max_abs_err": topk["max_abs_err"][(route, "f32")],
             "ms": kern_ms, "host_ms": host_ms, "plain_ms": plain_ms,
             "bound_ms": bound[0], "bound_by": bound[1],
             "library_ms": None,
             "max_abs_err_d512": topk["face_err"][(route, "f32")],
             "ms_d512": d512[0], "host_ms_d512": d512[2],
             "plain_ms_d512": d512[1], "bound_ms_d512": d512[3][0],
             "bound_by_d512": d512[3][1],
             "max_abs_err_d256": topk["d256_err"][route],
             "ms_d256": d256[0], "host_ms_d256": d256[2],
             "plain_ms_d256": d256[1], "bound_ms_d256": d256[3][0],
             "bound_by_d256": d256[3][1]})
    # the card again, then the serving numbers of phases 4d and 4e, as
    # printed there, in one line: the tail of the output holds both
    print(_card_line())
    print(json.dumps({"serving": {
        "face": {m: {"embed_ms": face[m]["embed"]["ms"],
                     "embed_img_s": face[m]["embed"]["img_s"],
                     "gflop_per_image": face[m]["embed"]["flops"] / 64e9,
                     "search_p50_ms": face[m]["p50_ms"],
                     "search_256_ms": face[m]["batched_ms"],
                     "cos_min": face[m]["cos_min"]} for m in FACE_MODELS},
        "faiss": {"write_s": faiss["write_s"], "import_s": faiss["import_s"],
                  "cli_s": faiss["cli_s"], "demo_s": faiss["demo_s"]},
        "flat_search_ms": {f"Q={q}": {"host": h, "card": c}
                           for q, (h, c) in faiss["host_times"].items()}}}))
    rows = topk_rows + [
        {"name": "rotate_shear", "route": "cuda",
         "source": "hairci_torch/ops/csrc/rotate.cu",
         "replaces": "hairci/ops/rotate_pallas.py:70",
         "launches": train["launches"]["rotate_shear"],
         "launches_vit": vit["rotate_shear"],
         "max_abs_err": rot["max_abs_err"],
         "ms": rot["times"]["blur"][0],
         "host_ms": rot["times"]["blur"][2],
         "plain_ms": rot["times"]["blur"][1],
         "bound_ms": rot["bound"][0], "bound_by": rot["bound"][1],
         "library_ms": None},
        {"name": "bn_stats", "route": "cuda",
         "source": "hairci_torch/ops/csrc/bn_stats.cu",
         "replaces": "tools/bn_stats_bench.py:28",
         "launches": train["launches"]["bn_stats"],
         "launches_vit": vit["bn_stats"],
         "max_abs_err": bn["max_abs_err"],
         "ms": bn["step"][0],
         "host_ms": bn["step"][2],
         "plain_ms": bn["step"][1],
         "bound_ms": bn["bound"][0], "bound_by": bn["bound"][1],
         "library_ms": None,
         "vit_ms": bn["vit_step"][0], "vit_host_ms": bn["vit_step"][2],
         "vit_plain_ms": bn["vit_step"][1],
         "vit_bound_ms": bn["vit_bound"][0],
         "launches_simclr": runs["simclr"]["launches"]["bn_stats"],
         "launches_supcon": runs["simclr_supcon"]["launches"]["bn_stats"],
         "supcon_ms": bn["supcon_step"][0],
         "supcon_host_ms": bn["supcon_step"][2],
         "supcon_plain_ms": bn["supcon_step"][1],
         "supcon_bound_ms": bn["supcon_bound"][0],
         "msn_ms": bn["msn_step"][0], "msn_host_ms": bn["msn_step"][2],
         "msn_plain_ms": bn["msn_step"][1],
         "msn_bound_ms": bn["msn_bound"][0],
         "byol_ms": bn["byol_step"][0], "byol_host_ms": bn["byol_step"][2],
         "byol_plain_ms": bn["byol_step"][1],
         "byol_bound_ms": bn["byol_bound"][0],
         "siameseim_ms": bn["siameseim_step"][0],
         "siameseim_host_ms": bn["siameseim_step"][2],
         "siameseim_plain_ms": bn["siameseim_step"][1],
         "siameseim_bound_ms": bn["siameseim_bound"][0],
         "siameseim_library_ms": bn["siameseim_library_ms"],
         "dualview_ms": bn["dualview_step"][0],
         "dualview_host_ms": bn["dualview_step"][2],
         "dualview_plain_ms": bn["dualview_step"][1],
         "dualview_bound_ms": bn["dualview_bound"][0],
         "dualview_bound_by": bn["dualview_bound"][1],
         "dualview_library_ms": bn["dualview_library_ms"]},
        {"name": "conv3x3", "route": "cuda",
         "source": "hairci_torch/ops/csrc/conv3x3.cu",
         "replaces": "tools/fused_conv_bn_bench.py:47",
         "launches": knn["launches"]["conv3x3"],
         "launches_vit": vit["conv3x3"],
         "max_abs_err": kern["conv3x3"]["max_abs_err"],
         "ms": conv["ms"], "host_ms": conv["host_ms"],
         "plain_ms": conv["plain_ms"],
         "bound_ms": conv["bound_ms"], "bound_by": conv["bound_by"],
         "library_ms": conv["library_ms"],
         "launches_simclr": evals["simclr"]["conv3x3"],
         "launches_supcon": evals["simclr_supcon"]["conv3x3"],
         "ms_224": conv224["ms"], "host_ms_224": conv224["host_ms"],
         "plain_ms_224": conv224["plain_ms"],
         "bound_ms_224": conv224["bound_ms"],
         "library_ms_224": conv224["library_ms"],
         "ms_128": conv128["ms"], "host_ms_128": conv128["host_ms"],
         "plain_ms_128": conv128["plain_ms"],
         "bound_ms_128": conv128["bound_ms"],
         "library_ms_128": conv128["library_ms"],
         "ms_f32_32": conv_dv["ms"], "host_ms_f32_32": conv_dv["host_ms"],
         "plain_ms_f32_32": conv_dv["plain_ms"],
         "bound_ms_f32_32": conv_dv["bound_ms"],
         "bound_by_f32_32": conv_dv["bound_by"],
         "library_ms_f32_32": conv_dv["library_ms"]}]
    # the masked-image runs (phases 7g, 7h) and DINOv2 (7i) launch none of
    # the four, MSN (7j) bn_stats 4 times a step, BYOL (7k) bn_stats 55 and
    # conv3x3 3 times a step, DenseCL (7l) 53 and 3 a step and conv3x3 3
    # times a forward of its kNN, SiameseIM (7m) bn_stats 16 times a step,
    # SHAM v1 (7n, both modes) none, DualViewHair (7o) bn_stats 56 / 53 and
    # conv3x3 3 a step, conv3x3 3 an evaluation forward and the top-k twice
    # (its retrievals): each run's launches, its training and its
    # evaluations together
    runs_by_mode = {**masked, **distill, **momentum,
                    "siameseim": siameseim, "SHAM_v1": sham_v1,
                    "dualview": dualview}
    for row in rows:
        key = ("topk_gallery_search" if row["name"].startswith("topk")
               else row["name"])
        for mode, run in runs_by_mode.items():
            row[f"launches_{mode.lower()}"] = (run["launches"][key]
                                               + run["knn_launches"][key])
        # phase 11: the SHAM steps (warmup, mine, mined), the f32 steps of
        # DP_RECIPES (launches_dp_recipes, each), and the sharded searches
        # (Q = 1: fma, Q = 256: mma), all through a one-rank group
        if key == "topk_gallery_search":
            route = "mma" if row["name"].endswith("batched") else "fma"
            row["launches_dp"] = sum(r["routes"][route]
                                     for r in dp["search"]["dp"].values())
        else:
            row["launches_dp"] = dp["launches"][key]
        row["launches_dp_recipes"] = {
            name: n[key] for name, n in dp["recipe_launches"].items()}
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
