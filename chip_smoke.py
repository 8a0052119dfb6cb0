#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero before the final line):

1. the card (``nvidia-smi`` name and power limit) and the kernel build
   (nvcc, ``sm_90a``, from ``shm_tpu_torch/ops/csrc``, six sources at once);
2. each of the three fused gate kernels (LSTM, minGRU, attention) against
   its plain PyTorch version on the card, random weights from a numpy seed,
   at four shapes (minGRU also at three layers);
3. the main path, once per model family:
   ``HybridScorer.from_artifacts("data/4dof" | "data/4dof_mingru" |
   "data/4dof_attention")`` on cuda scoring the 3,636 committed 4DOF test
   windows, held against the root's ``figures/pipeline_metrics.json`` and
   against the port's plain path on the same card; the launch count of the
   family's kernel must be > 0 (and of the LSTM kernel 0 in the other two);
   then ``reconstruction_mse`` through the family's gate-only kernel mode;
4. timings at bench.py's 5,440-window workload, per family: kernel, plain
   version, the operation/byte bound, a library yardstick (cuDNN ``nn.LSTM``;
   ``torch.matmul`` with a log-depth scan; ``scaled_dot_product_attention``),
   and ``score()`` windows/s end to end; for the LSTM kernel also its
   registers, spills and shared bytes a block at each width, its instances'
   HMMA and FFMA counts (``cuobjdump -sass``), the 3xTF32 tensor-core bound
   of its gate products, and on the real windows the largest relative mse
   difference from the plain version, held to ``LSTM_MSE_RTOL`` (beside the
   tensor-core body's other sums and the float32 FMA body, each timed; the
   one-term instance must fail it); for the minGRU kernel the same, held to
   ``MINGRU_MSE_RTOL``, beside every tile of its variant entry (TC steps x
   MT m-tiles, and the chained and one-term sums), each timed at 5,440 and
   at the 8,192 bucket; for the attention kernel also its
   registers, spills, threads and shared bytes a block, its packed TF32
   weights and its split of activations against ``cvt.rna.tf32.f32`` on the
   card (bit for bit), and the 3xTF32 tensor-core bound of its four weight
   products beside the f32 bound;
5. where one ``score()`` call's time goes (``torch.profiler``), per family:
   device time by kernel and the device's idle share;
6. the four LSTM training kernels (encoder and decoder, forward and backward)
   against autograd of their plain versions: both forwards and every
   gradient, at the 4DOF training shape, a ragged batch, the 1DOF shape, a
   unit mask, a batch of 1,024 (the reverse scan's clusters in waves), one
   window and H=64; every output of both forwards (h_last / recon, the
   final state, and the stash and gate stash they keep for the backward)
   against ``lstm2_scan_stash_reference``, in the training mode and in the
   trainer's validation mode (no gradient, no stash, null mask) at the same
   shapes; and how the card places each forward- and reverse-scan instance
   (clusters at once, shared memory, registers, spills);
7. the training path at full width: ``train-vae`` on the committed normal
   runs into a temporary root, the recipe unchanged but for 8 epochs of 50,
   on the card through the kernels; launch counts, finite and falling losses, the same losses bit for bit
   from a second run, the kernel path's first-batch loss and gradient against
   the plain autograd path, the written checkpoint read back, and
   ``reconstruction_mse`` through the fused gate kernel;
8. timings of the four kernels and of one training step (kernel path, plain
   autograd path, a cuDNN ``nn.LSTM`` yardstick), their bounds, and where a
   step's time goes; with ``--parent DIR`` (another checkout of the
   repository, e.g. the parent commit unpacked), also rows 1-7, 9 and 10
   of that tree on this card (rows 1, 6 and 7 at 5,440 windows and at the
   8,192 bucket; row 9 at 21,760 windows with loop_T 100 and 1; row 10 in
   each product mode at 21, 1 and 34 tiles), in turns with this tree's,
   its gradients against this tree's on the same inputs, its rows 1, 6, 7
   and 9 mse against this tree's, and row 10's outputs: f32 against this
   tree's bit for bit, bf16 and bf16x3 this tree's against the plain
   version, each printed against float64 sums;
9. the probes (``shm_tpu_torch/tools``): each of the three probe kernels
   against its plain version (``matmul_loop`` in every mode at one tile, at
   21 and at 34, bf16x3 also against the float32 loop; ``gate_variant``'s variants
   at N=1000 ragged, its float32 FMA instance A against its plain version
   and its shipping tensor-core instance T against ``fused_vae_gate`` bit
   for bit;
   the minGRU clone at ``loop_T`` T and 1, against its plain version with
   float64 sums), with planted faults
   (float32 for bf16, another LayerNorm eps, bf16 activations added) that
   each tolerance must fail; then the probe path: the three probes' tables
   at the TPU probes' sizes (launch counts reset before, read after), and
   each kernel's time against its bound, its plain version and a library
   yardstick; row 9 with its scratch's bytes bound, blocks an SM, waves
   and its time on whole waves only; row 10 by product mode, with its bound
   at the grid the C
   entry reports and a yardstick each (a loop of ``torch.matmul`` in the
   mode's type; bf16x3: three bf16 calls a step), each loop captured in a
   CUDA graph and timed by its replay;
10. the 4DOF chain on the card through the port's CLI, figures off
   (``--no-plots``): per family, on a temporary copy of its root,
   ``test-pipeline`` with the committed CNN and threshold (gate_stats
   exact, confusion matrix within the family's limit, AP and AUROC within
   1e-4 of the committed files, every file written), then ``threshold``
   through the gate-only kernel (window counts, within 1e-3 of the
   committed threshold and 1e-5 of the plain path on the card); then, on a
   fresh copy of ``data/4dof``, ``train-cnn`` at the full recipe twice from
   one seed (bit-identical losses and variables, the meta's keys,
   ``cnn.msgpack`` read back, one step timed) and ``test-pipeline`` with
   that CNN, whose accuracy must reach ``CNN_ACCURACY_FLOOR`` (the last
   check). Every command runs with the gate counts at 0 just before it and
   must launch its family's kernel and no other; the kernels line's
   launches of rows 1, 6 and 7 add these to phase 3's;
11. the serving surface on the card (``shm_tpu_torch.serve_http``):
   ``make_server`` on ``data/4dof`` with ``data/4dof_mingru`` as its shadow,
   strides 1 and 2, the admin surface behind a token; ``/score`` of the
   3,636 test windows (npz reply) and of 64 as JSON, and ``/score_series``
   of a normal and a faulty run at both strides, each against the scorer
   called directly (mse, gate and ``y_pred`` bit for bit, ``p_struct``
   within ``P_STRUCT_ATOL``), the gate decisions those of phase 3, stride
   3 refused, a ``StreamScorer`` in uneven chunks the same, and no kernel
   built nor device memory reserved by a warmed request; the shadow's
   counters against the agreement computed directly, nothing dropped; a
   concurrent server (``DynamicBatcher``): 8 clients of 680 windows at
   once, each reply against its single-threaded reply, fewer row-1
   launches than requests; ``/recalibrate`` on the threshold command's
   healthy windows against ``percentile_threshold`` (1e-6 relative),
   ``/reload``, 401 without the token, ``/metrics`` counters and drift
   gauges; a server on ``data/4dof_attention``; request times. Every step
   starts with the gate counts at 0; the kernels line's
   ``serve_launches`` of rows 1, 6 and 7 hold them by step.

12. the whole 4DOF stage on the card through the port's CLI, figures off:
   (a) ``gen-normal``, ``gen-faults`` and ``make-splits`` into a temporary
   root, each of the 18 CSVs per channel within ``GEN_RTOL`` of the
   committed ``data/4dof/raw`` run, the 10 spiked samples of ``spikes_x1``
   the committed ones, ``run_splits.json`` the committed one with the root
   rewritten; (b) ``test-pipeline`` with ``data/4dof``'s committed models
   on those runs (gate exact, confusion matrix within 2 windows of the
   committed one); (c) the two legacy roots generated again with
   ``--legacy-faults`` (``run_splits.json`` exactly the committed one) and
   their ``test-pipeline`` held to the JAX package's output on the CPU
   (``LEGACY_ROOTS``); (d) for ``min_gru`` and ``attention``: ``train-vae
   --cell`` at the full recipe, a 2-epoch run twice from one seed
   (bit-identical losses), one training step timed, then ``threshold``,
   ``train-cnn`` and ``test-pipeline``, the gates at 1.0 on both fault
   classes and the accuracy at least ``CELL_ACCURACY_FLOOR``. Each command
   starts with every count at 0: generation launches no kernel, the
   ``min_gru`` / ``attention`` commands their family's gate kernel and no
   other (rows 1-5 0); the kernels line's ``chain_launches`` holds these
   counts beside phase 10's.
13. the 1-DOF stage on the card through the port's CLI, figures off:
   (a) ``gen-seen`` and ``gen-unseen`` into a temporary root, each channel
   within ``STAGE1_GEN_RTOL`` of the committed ``data/1dof/raw`` CSV, the
   time column and the square wave as ``STAGE1_A_SQUARE_RTOL`` says, and
   the square wave equal to the port's CPU path; (b) ``test-seen``,
   ``test-unseen`` and ``compare-rmse`` with the committed model, twice
   (the tables byte for byte), held to the committed tables
   (``STAGE1_TABLE_ATOL``) and to the port's plain path on the CPU (``ATOL``
   / ``RTOL``); (c) ``train-vae`` at the full recipe through the LSTM
   training kernels (rows 2 and 4 2,600 launches, rows 3 and 5 2,300, rows
   1, 6 and 7 none), falling losses, a 2-epoch run twice from one seed (bit
   for bit), the checkpoint read back, one step timed on the kernel and
   plain paths, then the eval commands with that model, its seen mean
   segment RMSE at most ``STAGE1_SEEN_RMSE_CEILING``; (d) ``train-vae
   --cell min_gru`` / ``attention`` (``STAGE1_CELL_EPOCHS`` epochs) and the
   eval commands, which read the cell from ``split.json``. The eval and
   generation commands and (d) launch no kernel; the kernels line's
   ``stage1dof_launches`` holds the counts of rows 1-7 by command.

14. the openLAB stage on the card, figures off: (a) on a copy of
   ``data/openlab``, ``test-hybrid`` (the six confusion matrices and the
   anomaly rate of the committed reports exactly, AUROCs within
   ``OPENLAB_AUROC_ATOL``), ``validate-cnn`` on val and test,
   ``validate-ml`` from the export files, ``featurize`` and ``make-splits``
   (the committed files exactly), then ``validate-vae`` (threshold within
   ``OPENLAB_THRESHOLD_RTOL`` of the committed one and
   ``OPENLAB_THRESHOLD_PLAIN_RTOL`` of the plain path on the card), with no
   pandas, sklearn or joblib imported; (b) ``OpenLabScorer`` with stage 2
   ``cnn``, ``rf`` and ``svm_rbf`` on the 2,042 test windows (``y_pred``,
   mse and gate those of ``test-hybrid``, mse within ``OPENLAB_MSE_RTOL`` of
   the plain path on the card, windows/s at 2,042 and 8,192), row 1 at this
   shape timed beside its plain version and cuDNN with its
   ``kernel_info(200, 64, 1)``, and where a ``score()`` call's device time
   goes (``torch.profiler``, cnn and svm_rbf); (c) the daemon's ``--openlab``: ``/score``
   equal to ``score()`` bit for bit, both timed; (d) ``test-hybrid`` of
   ``data/openlab_attention`` through row 7 at T=200 (its committed
   matrices exactly); rows 1 and 7 each against its plain version on the
   test and val windows, row 6 on the val windows of (e)'s chain (within
   ``OPENLAB_MSE_RTOL``, ``OPENLAB_ATTENTION_MSE_RTOL`` and
   ``OPENLAB_MINGRU_MSE_RTOL``, every gate decision equal, both also read
   against a float64 pass); (e) ``train-vae`` cut to ``OPENLAB_VAE_EPOCHS``
   epochs twice from one seed (bit for bit, one step timed), ``train-vae
   --cell min_gru`` then ``validate-vae`` through row 6, and ``train-cnn``
   at the full recipe twice (bit for bit, the tuned VAL ST-F2 at least
   ``OPENLAB_CNN_F2_FLOOR``). Every command starts with every count at 0;
   the kernels line's ``openlab_launches`` of rows 1, 6 and 7 holds them by
   command.
15. the openLAB extraction, the ``.shmx`` export and the profiling hooks,
   each step timed by ``utils/profiling.py::Timer``: (a) the committed
   windows written back as catman exports (``write_catman_runs``), then the
   port's ``extract`` (``X_raw`` 6,432 / 6,432 and labels bit for bit,
   ``X_clean`` 6,425 / 6,432, the other 7 exactly each run's last window;
   ``window_labels.csv`` byte for byte but the 6 lines of a last window's
   ``u_min``), ``make-splits`` and ``featurize`` (the committed split,
   ``X_feat.npy`` and ``y.npy`` exactly), then ``all --epochs 2 --no-plots``
   where scikit-learn and joblib import, else ``train-vae --epochs 2``,
   ``validate-vae``, ``train-cnn --epochs 2`` and ``validate-cnn``, with
   row 1's launches counted and row 1 held against its plain version on the
   val windows (``OPENLAB_MSE_RTOL``); (b) ``python -m
   shm_tpu_torch.export`` of ``data/4dof``, ``data/4dof_mingru``,
   ``data/4dof_attention`` and ``--openlab data/openlab``, each loaded on
   the card and scoring the committed test windows: gates and ``y_pred``
   equal to the plain path's on the card, mse within ``EXPORT_MSE_RTOL``;
   against the kernel path gates equal and confusion matrices within phase
   3's 2 / 0 / 0 windows (openLAB: 0); no kernel launched; export seconds,
   artifact MB and ``score()`` windows/s at 5,440 beside
   ``HybridScorer.score``'s; (c) the daemon's ``--shmx``: ``/score`` of
   5,440 windows bit for bit the ``ExportedScorer``'s, both timed, and a
   ``.shmx`` ``--shadow`` whose ``/metrics`` counters are those computed
   directly; (d) one ``trace`` of an exported ``score()``, whose Chrome
   trace file must be there. ``openlab_launches`` carries its counts as
   ``phase 15 <command>``.
16. data parallelism (``shm_tpu_torch/parallel``). The machine has one
   card: ``make_mesh()`` must be one device and ``make_mesh(count + 1)``
   raise with "available", and every mesh path also runs on two shards of
   the one card (``Mesh((cuda:0, cuda:0))``): (b) ``HybridScorer(mesh=)``
   of each family at 5,440 windows and the CNN-mode ``OpenLabScorer(mesh=)``
   at the 2,042 openLAB test windows, with ``make_mesh(1)`` and with the
   two shards, against the scorer without a mesh (mse, gate and ``y_pred``
   bit for bit, ``p_struct`` within ``P_STRUCT_ATOL``), the family's kernel
   launched once per shard of each bucket and nothing else, windows/s by the
   host clock; (c) ``train_vae`` at the 4DOF preset, full width, 2 epochs on
   ``MESH_TRAIN_WINDOWS`` of the normal runs' windows, on
   the two shards against one device (plain path both; histories within
   ``MESH_TRAIN_RTOL``, the best epoch equal, parameters within
   ``MESH_PARAM_ATOL``: the JAX test's bounds), ``use_kernel=True`` with a
   mesh raising; (d) ``train_cnn`` of CNN4DOF on the two shards: a
   500-window full-batch step (loss, BatchNorm statistics over the whole
   batch) and 2 epochs; (e) a world of 1 over NCCL against the steps
   without a process group (NCCL starts; a world of 1 runs no collective),
   and two ``dist_worker`` ranks on the card over gloo with CUDA tensors
   (NCCL refuses two ranks on one card) against one process with two
   shards, the losses of two steps each, the second read after the first
   step's gradients were summed across the ranks; (f) ``train-vae --devices 1`` bit for bit the
   run without the flag, ``--devices 2`` exiting non-zero with "available",
   the daemon's ``--devices 2`` refused so. The kernels line's
   ``mesh_launches`` of rows 1, 6 and 7 holds (b)'s counts.
17. bf16 serving, ``sample=True`` and the int8 CNN: (a) each gate kernel's
   bf16 instance against its plain bf16 version at phase 2's shapes (the
   openLAB shape among them), with float32 and with bf16 io, and on the
   3,636 committed windows through each family's root at the io it serves
   (every gate decision equal), held to ``BF16_GATE_TOL`` and, on the
   committed windows, ``BF16_COMMITTED_TOL``, whose mean bars must lie
   below each case's float32 gap (the plain float32 version against the
   plain bf16 one); (b)
   ``HybridScorer.from_artifacts(fused_dtype=bf16, cnn_dtype=bf16)`` of each
   family on the 3,636 windows against the float32 scorer: the bf16
   instance launched and no other gate instance, every gate decision equal
   (a flip prints its margin and the JAX reading of ``BF16_READINGS``),
   y_pred agreement printed, mse within twice the JAX package's own bf16
   against float32 reading and its mean at least ``BF16_SCORER_FLOOR`` of
   it, the confusion matrix within ``BF16_CM_LIMIT``
   of ``pipeline_metrics.json``; (c) ``OpenLabScorer(gate_io_dtype=bf16)``
   on the 2,042 openLAB pairs: gate and y_pred equal to the float32
   scorer's; (d) ``make_hybrid_fn(sample=True)``: one seed twice equal, a
   second seed another; (e) the int8 CNN of the committed ``data/4dof`` CNN
   on phase 3's inputs, 3-class agreement with the folded float network at
   least ``INT8_AGREE_FLOOR``; (f) times at 5,440 windows: each bf16
   instance against the float32 instance, the plain bf16 version and the
   bf16 library composition, score() windows/s in both precisions, and
   the int8 CNN against the float32 and bf16 CNNs. The kernels line ends
   with the three bf16 instances (``launches``: (b)'s).
18. bf16 training: (a) each bf16 instance of rows 2-5 against its plain bf16
   version (``enc_forward_reference`` / ``dec_forward_reference`` and the
   explicit backward ``enc_backward_reference`` / ``dec_backward_reference``
   at ``dtype=bf16``) at phase 6's cases: both forwards (output, stash,
   gate stash, final state), every gradient, and both forwards in the
   validation mode, each held on its (max, mean) relative difference, the
   mean bar a share of the case's float32 gap (``BF16_TRAIN_*``), and on the
   count of elements over one bf16 ulp, a share of the float32 gap's; the
   float32 instances held to the same bars must fail them; (b)
   ``train_vae(kernel_dtype=bf16)`` at full width, the 4DOF recipe cut to
   ``TRAIN_EPOCHS`` epochs on the committed normal runs, every count at 0
   just before: 96 launches of each bf16 instance and 64 of each float32
   forward (validation stays float32), a second run bit for bit, the
   validation totals no farther from the float32 run's than the float32
   run of the next seed is; (c) at B=256 each bf16 instance
   against its float32 instance, its plain bf16 version and cuDNN
   ``nn.LSTM`` in bf16, its bounds at the float32 FMA rate and at 989
   TFLOP/s bf16, one bf16 training step against a float32 one, profiled.
   The kernels line ends with the four bf16 instances (``launches``: (b)'s).
19. row 7's two softmax forms and two bodies: (a) the long body's
   registers, spills, shared bytes and blocks an SM, then each body and
   form against its plain version at ``P19_CASES`` (the 4DOF and openLAB
   shapes in the resident body, windows past each width's resident limit
   in the long body), float32 under phase 2's bar and bf16 with float32
   and bf16 io under phase 17's, every launch moving the counters of its
   instance, form and body alone; at the two resident shapes the long
   body's streaming form against the resident body's bit for bit (float32
   and bf16) and its packed form within phase 2's bar; (b)
   ``OpenLabScorer`` of ``data/openlab_attention`` on the 2,042 test pairs
   in float32 and bf16 io: the streaming form launched and nothing else,
   gates and ``y_pred`` those of the packed form, the CNN row's matrix the
   committed ``cm3_all.npz``'s; (c) ``data/4dof_attention``'s scorer on the
   3,636 windows: the resident packed form alone, its mse bit for bit the
   tree's before the forms existed (``ATTENTION_4DOF_MSE``); (d)
   CUDA-event times of both forms at the openLAB shape and of the long body
   at ``P19_LONG``, each beside its plain version, the SDPA +
   ``torch.matmul`` composition and its float32 bound, then
   ``reconstruction_mse`` at ``P19_LONG`` through the long body. The
   kernels line ends with ``fused_attention_gate/stream`` and
   ``fused_attention_gate/long``.
20. rows 1 and 6's activation forms and row 1's transposed residual: each
   instance's registers and spills; (a) each form of rows 1 and 6
   (``sigmoid_impl`` / ``tanh_impl``) against its plain version at phase
   2's shapes, float32 under phase 2's bar and bf16 with float32 and bf16
   io under phase 17's, every launch moving its row's instance and form
   counters alone, and where a form gap (plain against plain) passes the
   bar, the kernel nearer its own plain form; (b) row 1's transposed
   residual against its NHWC one permuted, and the mse, bit for bit at the
   4DOF and openLAB shapes in every precision; (c) ``make_hybrid_fn(
   fused_layout="transposed")`` on the LSTM root's 3,636 committed windows
   in float32 and bf16: row 1 once in its transposed layout and nothing
   else, gates those of the NHWC path, the confusion matrix within 2
   windows of ``pipeline_metrics.json``; (d) the default forms' float32 mse
   of the LSTM and minGRU roots bit for bit ``GATE_4DOF_MSE`` (made by the
   tree before, ``--root-mse``); (e) CUDA-event times at 5,440 windows: the
   hybrid in each layout, the CNN alone (cuDNN against the transposed
   form, beside its bounds), row 1 in each layout, rows 1 and 6 in each
   form. The kernels line ends with ``fused_vae_gate/forms``,
   ``fused_vae_gate/transposed`` and ``fused_mingru_gate/forms``.
21. row 7's MLP width (``mlp_ratio``) and the plain modules' bf16: (a) row
   7 at M = 256 (H=32), 128 (H=64), 256, 768 and 512 = 4H (H=128), each in
   the resident body (T=100) and the long body (T=512) and each softmax
   form, against its plain version, float32 under phase 2's bar and bf16
   with float32 and bf16 io under phase 17's (the mean bars
   ``P21_BF16_MEAN``, read on the card by ``p21_readings``), every launch
   moving its counters alone (``mlp_launches`` where M is not 4H); (b) the
   4DOF attention root's default float32 mse bit for bit
   ``ATTENTION_4DOF_MSE``; (c) each 4DOF root's VAE at bf16 through
   ``reconstruction_mse(fused=False)`` on the 3,636 windows against its
   float32 plain path, and ``CNNOpenLab(dtype=bf16)`` on the openLAB test
   fault windows, within twice the JAX package's bf16 readings
   (``PLAIN_BF16_READINGS``), gate and label agreement printed; (d)
   CUDA-event times at 5,440 windows of each width beside its plain
   version, the SDPA + ``torch.matmul`` composition and its bounds; (e) a
   ``HybridScorer`` whose attention VAE has a 6H MLP on the 3,636 windows,
   every launch at that width. The kernels line ends with
   ``fused_attention_gate/mlp``.

The gate and training kernels' reach (no phase of its own): phases 2 and 20
(a) add ``REACH_CASES``, the shapes past the kernels' instances (H=48 and 96
padded to the next instance, D and Z to 128, minGRU's largest block at 4
layers), and 20 (b) a transposed residual of 32 feature rows; phase 3 adds
``route_check``, a 3-layer LSTM and an H=48 attention VAE behind the root's
CNN, which ``auto_fused_gate`` (the JAX package's rule) sends to the plain
modules: no gate launch, the plain scorer's outputs; phase 4 times
``REACH_TIMED`` per family (``reach_ms`` in the row); phases 6 and 18 add
``LSTM_REACH_CASES`` (rows 2-5 at H=48, padded around the autograd
Function) and phase 8 times rows 2-5 there (``reach_ms``).

Prints one JSON line of per-kernel numbers, then, as its last line,
``{"ok": true, "device": {...}}``. Exits non-zero without a card, and when
run from a directory that does not hold the repository. Usage:
``python3 chip_smoke.py [--parent DIR]``; ``--child DIR OUT`` is the child
mode ``--parent`` runs (``child``); ``--attention-mse DIR OUT`` writes the
4DOF attention root's mse through the package at DIR, ``--root-mse DIR
ROOT OUT`` that of another root (``root_mse``).
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# the card's peaks and the bound they give: shm_tpu_torch/tools/workload.py
# (PEAK_F32_FLOPS, PEAK_BF16_FLOPS, PEAK_BYTES, bound_ms)

# kernel vs plain, both float32 on the card: the two sum in different orders
# and round differently inside expf/tanhf, and the 2*L*T-step recurrence
# carries those last-bit differences forward; |kernel - plain| must stay
# within ATOL + RTOL * |plain| elementwise
ATOL, RTOL = 1e-4, 1e-4
N_BENCH = 5440                  # bench.py's workload
REPS = 7
# gradients of the LSTM training kernels against autograd of the plain
# versions: each weight-gradient entry sums T*B (25,600 at 4DOF) products in
# another order, and the recurrence carries last-bit differences of
# expf/tanhf through 2*T steps in both directions; |kernel - plain| must stay
# within GRAD_ATOL_REL * max|plain| + RTOL * |plain| elementwise
GRAD_ATOL_REL = 2e-4
# row 1 (the LSTM gate) against its plain version on the 5,440 real windows,
# on the largest relative mse difference: ATOL and RTOL let pass a gate whose
# products keep one TF32 term, so row 1 is also held to LSTM_MSE_RTOL. Over
# the 3,636 test windows the CPU model of the kernel's sums
# (tests/test_torch_vae_gate_tf32.py) reads 7.8e-7 for the shipped sum,
# 9.9e-6 for a sum chained through every mma, 9.7e-5 for one TF32 term; the
# one-term instance must fail the bound on the card (PERF.md §6)
LSTM_MSE_RTOL = 5e-6
# row 6 (the minGRU gate) on the same 5,440 real windows, held the same way.
# Over the 3,636 test windows through data/4dof_mingru the CPU model of the
# kernel's sums (tests/test_torch_mingru_gate_tf32.py) reads 3.5e-7 for the
# shipped sum, 4.7e-7 for a sum chained through every mma (no recurrent
# product carries the truncation here), 2.5e-5 for one TF32 term; on its 256
# windows 2.4e-7 / 6.7e-7 (plain / JAX kernel) and 1.9e-5. The one-term
# instance must fail the bound on the card (PERF.md §6)
MINGRU_MSE_RTOL = 4e-6
TRAIN_EPOCHS = 8


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = REPS, warm: int = 2) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events)."""
    from shm_tpu_torch.tools.workload import timed

    return timed(fn, reps, warm)


def vae_work(N: int, T: int, D: int, H: int, Z: int, L: int,
             with_residual: bool = True):
    """(FLOPs, bytes) one fused VAE gate call must do: matmul FLOPs only
    (elementwise excluded, as in bench.py's count); bytes = x read once,
    resid and mse written once, every weight read once."""
    enc = T * sum(2 * 4 * H * ((D if l == 0 else H) + H) for l in range(L))
    heads = 2 * H * Z + 2 * Z * H
    dec = 2 * 4 * H * H + T * (2 * 4 * H * H
                               + (L - 1) * 2 * 4 * H * 2 * H + 2 * H * D)
    flops = N * (enc + heads + dec)
    n_w = (sum(((D if l == 0 else H) + H + 1) * 4 * H for l in range(L))
           + L * (2 * H + 1) * 4 * H               # decoder layers
           + 2 * H + (H + 1) * Z + (Z + 1) * H + (H + 1) * D)
    nbytes = 4 * (N * T * D * (2 if with_residual else 1) + N + n_w)
    return float(flops), float(nbytes)


def mingru_work(N: int, T: int, D: int, H: int, Z: int, L: int,
                with_residual: bool = True):
    """(FLOPs, bytes) one fused minGRU gate call must do, counted as
    ``vae_work`` counts: a layer is one [in, 2H] product per step, the
    decoder's layer 0 one product in all."""
    enc = T * sum(2 * 2 * H * (D if l == 0 else H) for l in range(L))
    heads = 2 * H * Z + 2 * Z * H
    dec = 2 * 2 * H * H + T * ((L - 1) * 2 * 2 * H * H + 2 * H * D)
    flops = N * (enc + heads + dec)
    n_w = (sum(((D if l == 0 else H) + 1) * 2 * H for l in range(L))
           + L * (H + 1) * 2 * H
           + 2 * H + (H + 1) * Z + (Z + 1) * H + (H + 1) * D)
    nbytes = 4 * (N * T * D * (2 if with_residual else 1) + N + n_w)
    return float(flops), float(nbytes)


def attention_work(N: int, T: int, D: int, H: int, Z: int, L: int,
                   with_residual: bool = True, M: int = None):
    """(FLOPs, bytes) one fused attention gate call must do. A block: QKV
    2*T*H*3H, scores and PV 2*2*T*T*H, output projection 2*T*H*H, MLP
    2*2*T*H*M (M the MLP's width, 4H unless given); the decoder's in_proj
    once a window. Bytes: x, resid, mse, every weight and the [T, H]
    position table once."""
    M = 4 * H if M is None else M
    block = 2 * T * H * 3 * H + 2 * 2 * T * T * H + 2 * T * H * H + 2 * 2 * T * H * M
    flops = N * (2 * T * D * H + 2 * L * block + 2 * H * Z + 2 * Z * H
                 + 2 * H * H + 2 * T * H * D)
    block_w = 4 * H + (3 * H + 1) * H + 3 * H + (H + 1) * H + (M + 1) * H + M + M * H
    stack_w = lambda i: (i + 1) * H + L * block_w + 2 * H
    n_w = (stack_w(D) + stack_w(H) + 2 * H + (H + 1) * Z + (Z + 1) * H
           + (H + 1) * D + T * H)
    nbytes = 4 * (N * T * D * (2 if with_residual else 1) + N + n_w)
    return float(flops), float(nbytes)


def attention_dense_flops(N: int, T: int, H: int, L: int, M: int = None) -> float:
    """The part of ``attention_work`` in the kernel's four weight products
    (QKV, output projection, the MLP's two, M wide: 4H unless given), which
    run in 3xTF32 on the tensor cores."""
    M = 4 * H if M is None else M
    return float(N * 2 * L * (2 * T * H * 3 * H + 2 * T * H * H
                              + 2 * 2 * T * H * M))


def lstm_gate_flops(N: int, T: int, D: int, H: int, L: int) -> float:
    """The part of ``vae_work`` in the LSTM gate products of both stacks
    (each step's x_t W0i, h W_hh and h0 W1i, and the decoder's
    once-per-window input projection), which the kernel runs in 3xTF32 on
    the tensor cores."""
    G = 4 * H
    enc = T * sum(2 * G * ((D if l == 0 else H) + H) for l in range(L))
    dec = 2 * G * H + T * (2 * G * H + (L - 1) * 2 * G * 2 * H)
    return float(N * (enc + dec))


def mingru_gate_flops(N: int, T: int, D: int, H: int, L: int) -> float:
    """The part of ``mingru_work`` in the gate products of both stacks
    (each step's [in, 2H] product of every layer but the decoder's layer 0,
    which runs once a window), which the kernel runs in 3xTF32 on the
    tensor cores."""
    G = 2 * H
    enc = T * sum(2 * G * (D if l == 0 else H) for l in range(L))
    dec = 2 * G * H + T * (L - 1) * 2 * G * H
    return float(N * (enc + dec))


def sass_counts(name: str, marker: str) -> dict:
    """{kernel function of the built library ``name`` whose symbol holds
    ``marker``: (HMMA, FFMA) instruction counts} from ``cuobjdump -sass``."""
    import shutil

    from shm_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    listing = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                             capture_output=True, text=True, timeout=300,
                             check=True).stdout
    counts, fn = {}, None
    for line in listing.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
            if marker in fn:
                counts[fn] = [0, 0]
        elif fn in counts:
            op = line.split("*/")[1].split() if "*/" in line else []
            op = [t for t in op if not t.startswith("@")][:1]
            if op and op[0].startswith("HMMA"):
                counts[fn][0] += 1
            elif op and op[0].startswith("FFMA"):
                counts[fn][1] += 1
    return {k: tuple(v) for k, v in counts.items()}


def phase_lstm_kernel(w, Z, mse_k, mse_p, T: int, D: int, H: int, L: int) -> dict:
    """How the card takes the LSTM gate kernel (registers, spills, threads,
    shared bytes and windows a block, blocks an SM) at every width it takes;
    what its instances run (HMMA and FFMA counts in SASS); the 3xTF32
    tensor-core bound of its gate products; and on the real windows ``Z``,
    the tensor-core body's three sums and the float32 FMA body each against
    the plain version ``mse_p`` (time and largest relative mse difference):
    the kernel's ``mse_k`` must stay within LSTM_MSE_RTOL, which the one-term
    instance must fail."""
    import torch

    from shm_tpu_torch.ops.fused_vae import kernel_info
    from shm_tpu_torch.tools.probe_vpu_bound import (
        A_F32, SHIP_TC, TC_SUMS, gate_variant,
    )
    from shm_tpu_torch.tools.workload import PEAK_F32_FLOPS, PEAK_TF32_FLOPS

    tag = "[lstm]"
    N = Z.shape[0]
    for h_ in (32, 64, 128):
        info = kernel_info(T, h_, L)
        print(f"{tag} kernel at T={T} H={h_} L={L}: {info['registers']} registers "
              f"and {info['spill_bytes']} B of local memory (spills) a thread, "
              f"{info['threads']} threads, {info['windows_per_block']} windows and "
              f"{info['shared_bytes']} B of shared memory a block, "
              f"{info['blocks_per_sm']} block(s) an SM")
        check(info["blocks_per_sm"] >= 1, f"the LSTM gate kernel does not fit "
                                          f"an SM at H={h_}")
    counts = sass_counts("fused_vae", "fused_vae_")
    for fn, (hmma, ffma) in sorted(counts.items()):
        print(f"{tag} SASS {fn}: {hmma} HMMA, {ffma} FFMA")
    # the shipping instances: fused_vae_tc_kernel<H, 2, TC_SPLIT = 1, float,
    # FORMS = false | true>; the bf16 instances: <H, 2, TC_BF16 = 3, float |
    # bf16 bits (t), FORMS>
    ship = [fn for fn in counts if any(
        f"fused_vae_tc_kernelILi{h_}ELi2ELi1EfLb{f}EE" in fn
        for h_ in (32, 64, 128) for f in "01")]
    check(len(ship) == 6 and all(counts[fn][0] > 0 for fn in ship),
          f"the shipping instances run no HMMA: {ship}")
    bf16 = [fn for fn in counts if any(
        f"fused_vae_tc_kernelILi{h_}ELi2ELi3E{io}Lb{f}EE" in fn
        for h_ in (32, 64, 128) for io in "ft" for f in "01")]
    check(len(bf16) == 12 and all(counts[fn][0] > 0 for fn in bf16),
          f"the bf16 instances run no HMMA: {bf16}")
    dense = lstm_gate_flops(N, T, D, H, L)
    tc_ms = 3 * dense / PEAK_TF32_FLOPS * 1e3
    print(f"{tag} gate products at N={N}: {dense / 1e9:.2f} GFLOP -> 3xTF32 "
          f"tensor-core bound {tc_ms:.4f} ms (3 x {PEAK_TF32_FLOPS / 1e12:g} "
          f"TFLOP/s TF32), f32 FMA-pipe bound {dense / PEAK_F32_FLOPS * 1e3:.4f} ms")

    rel = lambda m: float(((m - mse_p).abs() / mse_p.abs()).max())
    got = {}
    for name, kw in [("A (float32 FMA)", A_F32)] + [
            (f"tc={s!r}", dict(A_F32, tc=s)) for s in TC_SUMS]:
        got[name] = gate_variant(w, Z, **kw)
        ms = time_ms(lambda: gate_variant(w, Z, **kw))
        print(f"{tag} probe instance {name} at N={N}: {ms:.4f} ms, largest "
              f"relative mse diff against the plain version {rel(got[name]):.3e}")
    check(torch.equal(got[f"tc={SHIP_TC!r}"], mse_k),
          "the probe's shipping tensor-core instance is not fused_vae_gate")
    r_k, r_1 = rel(mse_k), rel(got["tc='one_term'"])
    print(f"{tag} kernel vs plain, largest relative mse diff {r_k:.3e} (<= "
          f"{LSTM_MSE_RTOL:g}); planted fault, the one-term instance: {r_1:.3e} "
          f"-> {'caught' if r_1 > LSTM_MSE_RTOL else 'MISSED'}")
    check(r_k <= LSTM_MSE_RTOL, f"row 1 is {r_k:.3e} from its plain version "
                                f"(relative mse), past {LSTM_MSE_RTOL:g}")
    check(r_1 > LSTM_MSE_RTOL, f"LSTM_MSE_RTOL {LSTM_MSE_RTOL:g} does not tell the "
                               f"one-term instance ({r_1:.3e})")
    return {"bound_3xtf32_ms": tc_ms}


def phase_mingru_kernel(w, Z, mse_k, mse_p, T: int, D: int, H: int, L: int,
                        ln: bool) -> dict:
    """How the card takes the minGRU gate kernel (registers, spills, threads,
    shared bytes, windows and steps a tile, blocks an SM) at every width;
    what its instances run (HMMA and FFMA counts in SASS); the 3xTF32 bound
    of its gate products; and on the real windows ``Z`` (N=5,440) and tiled
    to the 8,192 bucket, each instance of the variant entry (the shipping sum
    at every tile of TC steps and MT m-tiles, the chained and the one-term
    sum at the shipping tile) timed beside the kernel with its largest
    relative mse difference from the plain version ``mse_p``: the kernel's
    ``mse_k`` must stay within MINGRU_MSE_RTOL, which the one-term instance
    must fail."""
    import torch

    from shm_tpu_torch.ops.fused_mingru import gate_variant, kernel_info
    from shm_tpu_torch.tools.workload import PEAK_F32_FLOPS, PEAK_TF32_FLOPS

    tag = "[min_gru]"
    N = Z.shape[0]
    for h_ in (32, 64, 128):
        info = kernel_info(T, h_, L)
        print(f"{tag} kernel at T={T} H={h_} L={L}: {info['registers']} registers "
              f"and {info['spill_bytes']} B of local memory (spills) a thread, "
              f"{info['threads']} threads, {info['windows_per_block']} windows x "
              f"{info['steps_per_tile']} steps a tile, {info['shared_bytes']} B of "
              f"shared memory a block, {info['blocks_per_sm']} block(s) an SM")
        check(info["blocks_per_sm"] >= 1, f"the minGRU gate kernel does not fit "
                                          f"an SM at H={h_}")
    tc, mt = info["steps_per_tile"], info["windows_per_block"] // 16
    counts = sass_counts("fused_mingru", "fused_mingru_tc_kernel")
    for fn, (hmma, ffma) in sorted(counts.items()):
        print(f"{tag} SASS {fn}: {hmma} HMMA, {ffma} FFMA")
    # the shipping instances: fused_mingru_tc_kernel<H, MT, TC, TC_SPLIT = 1,
    # float, SIG_TANH = false | true>; the bf16 instances: <H, MT, TC,
    # TC_BF16 = 3, float | bf16 bits, SIG_TANH>
    ship = [fn for fn in counts if any(
        f"fused_mingru_tc_kernelILi{h_}ELi{mt}ELi{tc}ELi1EfLb{f}EE" in fn
        for h_ in (32, 64, 128) for f in "01")]
    check(len(ship) == 6 and all(counts[fn][0] > 0 for fn in ship),
          f"the shipping instances run no HMMA: {ship}")
    bf16 = [fn for fn in counts if any(
        f"fused_mingru_tc_kernelILi{h_}ELi{mt}ELi{tc}ELi3E{io}Lb{f}EE" in fn
        for h_ in (32, 64, 128) for io in "ft" for f in "01")]
    check(len(bf16) == 12 and all(counts[fn][0] > 0 for fn in bf16),
          f"the bf16 instances run no HMMA: {bf16}")
    dense = mingru_gate_flops(N, T, D, H, L)
    tc_ms = 3 * dense / PEAK_TF32_FLOPS * 1e3
    dense8 = mingru_gate_flops(8192, T, D, H, L)
    print(f"{tag} gate products at N={N}: {dense / 1e9:.2f} GFLOP -> 3xTF32 "
          f"tensor-core bound {tc_ms:.4f} ms (3 x {PEAK_TF32_FLOPS / 1e12:g} "
          f"TFLOP/s TF32), f32 FMA-pipe bound {dense / PEAK_F32_FLOPS * 1e3:.4f} ms; "
          f"at N=8192: {dense8 / 1e9:.2f} GFLOP -> "
          f"{3 * dense8 / PEAK_TF32_FLOPS * 1e3:.4f} ms")

    Z8 = torch.cat([Z, Z[:8192 - N]]).contiguous()
    kw = dict(num_layers=L, use_layernorm=ln)
    rel = lambda m: float(((m - mse_p).abs() / mse_p.abs()).max())
    variants = [("split", t_, m_) for t_ in (1, 2, 4) for m_ in (1, 2)] + [
        ("chain", tc, mt), ("one_term", tc, mt)]
    got = {}
    for s_, t_, m_ in variants:
        v = dict(tc_sum=s_, tc=t_, mt=m_, **kw)
        got[s_, t_, m_] = gate_variant(w, Z, **v)
        ms = time_ms(lambda: gate_variant(w, Z, **v))
        ms8 = time_ms(lambda: gate_variant(w, Z8, **v))
        print(f"{tag} variant sum={s_!r} TC={t_} MT={m_}: {ms:.4f} ms at N={N}, "
              f"{ms8:.4f} ms at N=8192; largest relative mse diff against the "
              f"plain version {rel(got[s_, t_, m_]):.3e}")
    check(torch.equal(got["split", tc, mt], mse_k),
          "the variant entry's shipping instance is not fused_mingru_gate")
    r_k, r_1 = rel(mse_k), rel(got["one_term", tc, mt])
    print(f"{tag} kernel vs plain, largest relative mse diff {r_k:.3e} (<= "
          f"{MINGRU_MSE_RTOL:g}); planted fault, the one-term instance: {r_1:.3e} "
          f"-> {'caught' if r_1 > MINGRU_MSE_RTOL else 'MISSED'}")
    check(r_k <= MINGRU_MSE_RTOL, f"row 6 is {r_k:.3e} from its plain version "
                                  f"(relative mse), past {MINGRU_MSE_RTOL:g}")
    check(r_1 > MINGRU_MSE_RTOL, f"MINGRU_MSE_RTOL {MINGRU_MSE_RTOL:g} does not "
                                 f"tell the one-term instance ({r_1:.3e})")
    return {"bound_3xtf32_ms": tc_ms}


def phase_attention_kernel(w, N: int, T: int, H: int, L: int) -> dict:
    """How the card takes the attention kernel (registers, spills, threads,
    shared bytes a block, at the trained root's shape and at the longest
    window of each width), the wrapper's packed TF32 weights against the
    kernel's own ``cvt.rna.tf32.f32`` on the trained weights ``w`` (bit for
    bit), and the 3xTF32 tensor-core bound of the dense products."""
    import torch

    from shm_tpu_torch.ops.fused_attention import (
        kernel_info, tf32_round_on_card, unpack_fragments,
    )
    from shm_tpu_torch.tools.workload import PEAK_F32_FLOPS, PEAK_TF32_FLOPS

    tag = "[attention]"
    for t_, h_ in ((T, H), (136, 128), (208, 64), (268, 32)):
        info = kernel_info(t_, h_)
        print(f"{tag} kernel at T={t_} H={h_}: {info['registers']} registers and "
              f"{info['spill_bytes']} B of local memory (spills) a thread, "
              f"{info['threads']} threads and {info['shared_bytes']} B of shared "
              f"memory a block, {info['blocks_per_sm']} block(s) an SM")
        check(info["blocks_per_sm"] >= 1, f"the attention kernel does not fit "
                                          f"an SM at T={t_} H={h_}")
    frags = [k for k in w if k.endswith("_frag")]
    for k in frags:
        src = w[k[:-len("_frag")]]
        big, small = unpack_fragments(w[k])
        same = (torch.equal(big, tf32_round_on_card(src))
                and torch.equal(small, tf32_round_on_card((src - big).contiguous())))
        check(same, f"{k}: packed TF32 parts differ from cvt.rna.tf32.f32 on the card")
    print(f"{tag} packed TF32 big and small parts of {len(frags)} weights equal "
          f"cvt.rna.tf32.f32 on the card, bit for bit")
    # the kernel's own split of its activations (integer rounding) against
    # cvt.rna.tf32.f32, on every weight and on 2^20 wide-ranging values
    xs = [w[k[:-len("_frag")]] for k in frags]
    for x in xs + [torch.randn(1 << 20, device="cuda") * 30.0]:
        check(torch.equal(tf32_round_on_card(x, exact=False), tf32_round_on_card(x)),
              "the kernel's TF32 split differs from cvt.rna.tf32.f32")
    print(f"{tag} the kernel's split of A rounds as cvt.rna.tf32.f32, bit for "
          f"bit, on {len(xs)} weights and 2^20 random values")
    dense = attention_dense_flops(N, T, H, L)
    tc_ms = 3 * dense / PEAK_TF32_FLOPS * 1e3
    print(f"{tag} dense products at N={N}: {dense / 1e9:.2f} GFLOP -> 3xTF32 "
          f"tensor-core bound {tc_ms:.4f} ms (3 x {PEAK_TF32_FLOPS / 1e12:g} "
          f"TFLOP/s TF32), f32 FMA-pipe bound {dense / PEAK_F32_FLOPS * 1e3:.4f} ms")
    return {"bound_3xtf32_ms": tc_ms}


# the three model families the port scores: the committed artifacts, the
# fused gate kernel, the TPU kernel it replaces, and how many windows of the
# root's committed confusion matrix may move on the card. LSTM root: 2,
# because pipeline_metrics.json was made at another matmul precision and the
# JAX package's own float32 CPU path moves the same 2 (logit margins 0.026,
# 0.019). minGRU and attention roots: 0, because the JAX package's float32
# CPU path and the port's reproduce both files exactly on all 3,636 windows
# (tests/test_torch_pipeline_cells.py), and the narrowest logit margin of any
# faulty test window is 0.028 (minGRU) and 0.012 (attention), a thousand
# times a float32 reordering of the sums.
FAMILIES = {
    "lstm": dict(root="data/4dof", kernel="fused_vae_gate",
                 source="shm_tpu_torch/ops/csrc/fused_vae.cu",
                 replaces="shm_tpu/ops/fused_vae.py:125", work=vae_work,
                 library="cuDNN nn.LSTM", cm_limit=2),
    "min_gru": dict(root="data/4dof_mingru", kernel="fused_mingru_gate",
                    source="shm_tpu_torch/ops/csrc/fused_mingru.cu",
                    replaces="shm_tpu/ops/fused_mingru.py:69", work=mingru_work,
                    library="torch.matmul + log-depth scan", cm_limit=0),
    "attention": dict(root="data/4dof_attention", kernel="fused_attention_gate",
                      source="shm_tpu_torch/ops/csrc/fused_attention.cu",
                      replaces="shm_tpu/ops/fused_attention.py:157",
                      work=attention_work,
                      library="scaled_dot_product_attention + torch.matmul",
                      cm_limit=0),
}


def phase_build():
    from shm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    res = _build.build(["fused_vae", "lstm_train", "fused_mingru",
                        "fused_attention", "probe_mingru_gate",
                        "probe_matmul_loop"])
    wall = time.perf_counter() - t0
    for name, (path, secs, log) in res.items():
        print(f"[build] {name}: {path.relative_to(ROOT)} in {secs:.2f} s")
        for line in log.splitlines():
            if "Compiling entry function" in line:
                print(f"[build]   {line.split('Compiling entry function')[1].strip()[:100]}")
            elif "registers" in line or "spill" in line or "smem" in line:
                print(f"[build]     {line.strip()}")
    print(f"[build] total {wall:.2f} s")


def random_vae(seed: int, D, Z, H, L, ln, cell: str = "lstm"):
    from shm_tpu_torch.config import VAEConfig
    from shm_tpu_torch.convert import random_flax_vae_params, vae_from_flax

    cfg = VAEConfig(input_dim=D, latent_dim=Z, hidden_dim=H, num_layers=L,
                    use_layernorm=ln, cell=cell)
    rng = np.random.default_rng(seed)
    return vae_from_flax(random_flax_vae_params(rng, cfg), cfg).cuda(), rng


def compare(name: str, got, ref) -> float:
    """Max |got - ref|; fails past ATOL + RTOL * |ref|."""
    got, ref = got.detach(), ref.detach()
    err = (got - ref).abs()
    worst = float((err - RTOL * ref.abs()).max())
    max_abs = float(err.max())
    ok = worst <= ATOL
    print(f"[kernel]   {name}: max |diff| {max_abs:.3e} "
          f"(tolerance {ATOL:g} + {RTOL:g}*|plain|) {'ok' if ok else 'FAIL'}")
    check(ok, f"{name}: kernel disagrees with its plain version "
              f"(max |diff| {max_abs:.3e})")
    return max_abs


# the shapes past the kernels' instances that phases 2 and 20 add to their
# cases: widths padded to an instance (32, 64, 128), D and Z past the fixed
# tiles' 16 and 32 (the output head's slots past the registers'), to 128;
# name, N, T, D, Z, H, L, LN, with_residual
REACH_CASES = {
    "lstm": [("H=48 D=64 Z=64 (the H=64 instance)", 300, 100, 64, 64, 48, 2, True, True),
             ("H=96 D=20 Z=128 no LN", 300, 60, 20, 128, 96, 2, False, True),
             ("1-layer H=128 D=128 Z=128", 200, 40, 128, 128, 128, 1, True, True)],
    "min_gru": [("H=48 D=64 Z=64 (the H=64 instance)", 300, 100, 64, 64, 48, 2, True, True),
                ("3-layer H=96 D=20 Z=128 no LN", 300, 60, 20, 128, 96, 3, False, True),
                ("4-layer H=128 D=128 Z=128 (the largest block)", 200, 40, 128, 128,
                 128, 4, True, True)],
    "attention": [("Z=64 1-layer H=64", 300, 100, 12, 64, 64, 1, True, True),
                  ("Z=128", 200, 100, 12, 128, 128, 2, True, True)],
}


def phase_kernel_vs_plain(cell: str = "lstm"):
    """A family's gate kernel against its plain version, random weights.
    Returns the max |diff| over the cases."""
    import torch

    from shm_tpu_torch.ops import FUSED_GATES

    weights_fn, gate, reference = FUSED_GATES[cell]
    cases = [  # name, N, T, D, Z, H, L, LN, with_residual
        ("4dof N=1000 (ragged tile)", 1000, 100, 12, 16, 128, 2, True, True),
        ("openLAB 1-layer H=64 T=200 D=3", 300, 200, 3, 8, 64, 1, True, True),
        ("1dof 2-layer H=32 T=80 no LN", 300, 80, 12, 5, 32, 2, False, True),
        ("4dof with_residual=False", 333, 100, 12, 16, 128, 2, True, False),
    ]
    if cell == "min_gru":
        cases.append(("3-layer H=64 T=60", 200, 60, 12, 16, 64, 3, True, True))
    cases += REACH_CASES[cell]
    worst = 0.0
    for i, (name, N, T, D, Zd, H, L, ln, wr) in enumerate(cases):
        vae, rng = random_vae(100 + i, D, Zd, H, L, ln, cell)
        w = weights_fn(vae)
        Z = torch.from_numpy(rng.normal(size=(N, T, D)).astype(np.float32)).cuda()
        kw = dict(num_layers=L, use_layernorm=ln, with_residual=wr)
        mse, resid = gate(w, Z, **kw)
        torch.cuda.synchronize()
        mse_p, resid_p = reference(w, Z, **kw)
        print(f"[kernel] {gate.__name__} {name}: N={N} T={T} D={D} H={H} "
              f"Z={Zd} L={L} LN={ln} with_residual={wr}")
        check(mse.shape == (N,) and bool(torch.isfinite(mse).all()),
              f"{name}: mse not finite / wrong shape")
        worst = max(worst, compare("mse", mse, mse_p))
        if wr:
            check(resid.shape == (N, T, D), f"{name}: resid shape {resid.shape}")
            worst = max(worst, compare("resid", resid, resid_p))
        else:
            check(resid is None, f"{name}: resid returned with_residual=False")
    return worst


def phase_main_path(W, y, cell: str = "lstm"):
    """Score the 3,636 test windows through a family's committed artifacts on
    the card; returns the scorer and its kernel's launch count."""
    import torch

    from shm_tpu_torch.evals import accuracy, confusion_matrix
    from shm_tpu_torch.ops import FUSED_GATES
    from shm_tpu_torch.serve import HybridScorer
    from shm_tpu_torch.train import reconstruction_mse
    from shm_tpu_torch.utils.io import load_json

    fam = FAMILIES[cell]
    root = ROOT / fam["root"]
    gate = FUSED_GATES[cell][1]
    tag0 = f"[main {cell}]"
    ref = load_json(root / "figures" / "pipeline_metrics.json")
    scorer = HybridScorer.from_artifacts(root)
    check(scorer.device.type == "cuda" and scorer.use_fused_vae
          and scorer.vae.cell == cell,
          f"{cell}: scorer did not select the card, the cell and its kernel")

    for _, g, _ in FUSED_GATES.values():
        g.launches = 0
    t0 = time.perf_counter()
    out = scorer.score(W)
    wall = time.perf_counter() - t0
    launches = gate.launches
    others = {g.__name__: g.launches for _, g, _ in FUSED_GATES.values()
              if g is not gate}
    print(f"{tag0} score() of {len(W)} windows in {wall * 1e3:.1f} ms "
          f"(first call, includes the kernel's first load); {gate.__name__} "
          f"launches: {launches}; other gate kernels: {others}")
    check(launches > 0, f"the {cell} main path did not launch {gate.__name__}")
    check(not any(others.values()),
          f"the {cell} main path launched another family's kernel: {others}")
    check(all(np.isfinite(out[k]).all() for k in ("mse", "p_struct"))
          and out["mse"].shape == (len(W),), "non-finite or mis-shaped output")
    PHASE3_GATE[cell] = out["anomalous"].copy()

    tags = {0: "normal/test", 1: "sensor/test", 2: "struct/test"}
    for g, tag in tags.items():
        m = y == g
        anom = int(out["anomalous"][m].sum())
        want = int(ref["gate"]["gate_stats"][tag]["anom"])
        print(f"{tag0} gate {tag}: {anom}/{int(m.sum())} anomalous "
              f"(rate {anom / m.sum():.4f}; reference {want})")
        check(anom == want, f"{cell}: gate decisions differ on {tag}")

    cm = confusion_matrix(y, out["y_pred"], 3)
    cm_ref = np.asarray(ref["confusion_matrix_counts"])
    acc = accuracy(y, out["y_pred"])
    moved = int(np.abs(cm - cm_ref).sum()) // 2
    print(f"{tag0} confusion matrix {cm.tolist()} (reference "
          f"{cm_ref.tolist()}); windows moved: {moved} (limit "
          f"{fam['cm_limit']})")
    print(f"{tag0} accuracy {acc:.6f} (reference {ref['accuracy']:.6f})")
    logits = scorer._dispatch(torch.from_numpy(W)).logits.cpu().numpy()
    margin = np.abs(logits[:, 1] - logits[:, 0])
    print(f"{tag0} narrowest logit margins of faulty windows: "
          f"{np.sort(margin[y > 0])[:3].round(5).tolist()}")
    if moved:
        # the windows in the cells that gained are the flips; show those
        # nearest the CNN's decision boundary with their logit margins
        for t, p in zip(*np.nonzero(cm > cm_ref)):
            idx = np.nonzero((y == t) & (out["y_pred"] == p))[0]
            idx = idx[np.argsort(margin[idx])][: cm[t, p] - cm_ref[t, p]]
            for i in idx:
                print(f"{tag0}   flip: window {i} true {t} -> pred {p}, "
                      f"logit margin {margin[i]:.5f}")
    check(moved <= fam["cm_limit"], f"{cell}: confusion matrix off by {moved} "
                                    f"windows (> {fam['cm_limit']})")

    plain = HybridScorer.from_artifacts(root, use_fused_vae=False)
    outp = plain.score(W)
    gate_diff = int((outp["anomalous"] != out["anomalous"]).sum())
    y_diff = int((outp["y_pred"] != out["y_pred"]).sum())
    mse_rel = float(np.max(np.abs(outp["mse"] - out["mse"])
                           / np.abs(outp["mse"])))
    print(f"{tag0} kernel path vs plain path on the card: gate decisions "
          f"differing {gate_diff}, y_pred differing {y_diff}, max mse rel "
          f"diff {mse_rel:.3e}")
    # the gate's margins are wide, so its decisions must agree exactly; a
    # CNN decision within float32 rounding of its boundary may flip, within
    # the family's limit
    check(gate_diff == 0 and y_diff <= fam["cm_limit"],
          f"{cell}: kernel path and plain path disagree on the card")

    if cell != "lstm":
        # reconstruction_mse through the family's gate-only kernel mode (the
        # LSTM family's runs on freshly trained weights in the training phase)
        from shm_tpu_torch.data.windows import normalize_windows

        Zn = normalize_windows(torch.from_numpy(W).cuda(), scorer.mean,
                               scorer.std).cpu().numpy()
        before = gate.launches
        mse_k = reconstruction_mse(scorer.vae, Zn)
        n_launch = gate.launches - before
        mse_p = reconstruction_mse(scorer.vae, Zn, fused=False)
        check(n_launch == 1 and gate.launches - before == 1,
              f"{cell}: reconstruction_mse launched {gate.__name__} "
              f"{n_launch} times, not once")
        print(f"{tag0} reconstruction_mse of {len(W)} windows through "
              f"{gate.__name__}(with_residual=False): mean {mse_k.mean():.6f}")
        compare(f"{cell} reconstruction_mse vs plain model",
                torch.from_numpy(mse_k), torch.from_numpy(mse_p))
    if cell in ROUTE_MODELS:
        route_check(scorer, W, cell)
    return scorer, launches


# phase 3's models that the JAX package's rule computes on XLA: each family's
# scorer with the root's CNN, statistics and threshold and a VAE of these
# (H, L) from a seed must launch no gate kernel and give the plain path's
# outputs
ROUTE_MODELS = {"lstm": (128, 3), "attention": (48, 1)}


def route_check(scorer, W, cell: str) -> None:
    """``HybridScorer`` with the default fused flag on a model of
    ``ROUTE_MODELS[cell]``: ``auto_fused_gate`` sends it to the plain
    modules, every gate counter stays at 0, and its outputs are the
    ``use_fused_vae=False`` scorer's (mse, gate and y_pred bit for bit,
    p_struct within P_STRUCT_ATOL)."""
    import torch

    from shm_tpu_torch.models import TemporalVAE
    from shm_tpu_torch.serve import HybridScorer

    H, L = ROUTE_MODELS[cell]
    torch.manual_seed(27)
    vae = TemporalVAE(12, 16, H, L, cell=cell)
    make = lambda fused: HybridScorer(
        vae, scorer.cnn, scorer.mean.cpu().numpy(), scorer.std.cpu().numpy(),
        float(scorer.threshold), use_fused_vae=fused)
    routed = make(None)
    check(not routed.use_fused_vae, f"{cell} H={H} L={L}: the default fused "
                                    f"flag chose the kernel")
    bf16_counts(reset=True)
    out = routed.score(W)
    torch.cuda.synchronize()
    counts = bf16_counts()
    ref = make(False).score(W)
    same = all(np.array_equal(out[k], ref[k]) for k in ("mse", "anomalous", "y_pred"))
    dp = float(np.abs(out["p_struct"] - ref["p_struct"]).max())
    print(f"[main {cell}] route: H={H} L={L} (the JAX rule computes it on XLA): "
          f"use_fused_vae {routed.use_fused_vae}, gate launches {counts}; mse, "
          f"gate and y_pred against the plain scorer "
          f"{'bit for bit' if same else 'DIFFERENT'}, max |p_struct diff| {dp:.3e}")
    check(not any(counts.values()), f"{cell} H={H} L={L}: a gate kernel launched")
    check(same and dp <= P_STRUCT_ATOL and np.isfinite(out["mse"]).all(),
          f"{cell} H={H} L={L}: the routed scorer differs from the plain one")


def cudnn_vae_pass(vae, dtype=None):
    """The same VAE pass composed from ``torch.nn.LSTM`` (cuDNN), in float32
    or ``dtype``: a yardstick timed here only; the port never calls it."""
    import torch
    import torch.nn.functional as F
    from torch import nn

    H, L = vae.hidden_dim, vae.num_layers

    def lstm_from(stack, in_dim):
        m = nn.LSTM(in_dim, H, L, batch_first=True).cuda()
        if dtype is not None:
            m = m.to(dtype)
        with torch.no_grad():
            for l, layer in enumerate(stack.layers):
                getattr(m, f"weight_ih_l{l}").copy_(layer.weight_ih)
                getattr(m, f"weight_hh_l{l}").copy_(layer.weight_hh)
                getattr(m, f"bias_ih_l{l}").copy_(layer.bias_ih)
                getattr(m, f"bias_hh_l{l}").copy_(layer.bias_hh)
        m.flatten_parameters()
        return m

    enc = lstm_from(vae.encoder_lstm, vae.input_dim)
    dec = lstm_from(vae.decoder_lstm, H)

    @torch.inference_mode()
    def run(Z):
        N, T, _ = Z.shape
        _, (hn, _) = enc(Z)
        h = hn[-1]
        if vae.layer_norm is not None:
            h = vae.layer_norm(h)
        dec_in = torch.tanh(vae.fc_latent_to_hidden(vae.fc_mu(h)))
        out, _ = dec(dec_in[:, None].expand(N, T, H))
        r = (Z - vae.output_layer(out)) ** 2
        return r.mean(dim=(1, 2)), r

    return run


def scan_mingru_pass(vae):
    """The same minGRU-VAE pass from ``torch.matmul`` projections and the
    log-depth (doubling) form of the linear recurrence, seven passes over
    [T, N, H] instead of T steps: a yardstick timed here only; the port's
    scoring never takes this form."""
    import torch
    import torch.nn.functional as F

    from shm_tpu_torch.models.minrnn import linear_recurrence

    H = vae.hidden_dim

    def stack(layers, inp, T):
        for layer in layers:
            g = F.linear(inp, layer.weight_ih, layer.bias_ih)
            z = torch.sigmoid(g[..., :H])
            a, b = 1.0 - z, z * g[..., H:]
            if g.dim() == 2:                      # constant decoder input
                a, b = a.expand(T, *a.shape), b.expand(T, *b.shape)
            else:
                a, b = a.transpose(0, 1), b.transpose(0, 1)
            inp = linear_recurrence(a, b, impl="associative").transpose(0, 1)
        return inp

    @torch.inference_mode()
    def run(Z):
        T = Z.shape[1]
        h = stack(vae.encoder_lstm.layers, Z, T)[:, -1]
        if vae.layer_norm is not None:
            h = vae.layer_norm(h)
        dec_in = torch.tanh(vae.fc_latent_to_hidden(vae.fc_mu(h)))
        out = stack(vae.decoder_lstm.layers, dec_in, T)
        r = (Z - vae.output_layer(out)) ** 2
        return r.mean(dim=(1, 2)), r

    return run


def sdpa_attention_pass(vae):
    """The same attention-VAE pass composed from
    ``F.scaled_dot_product_attention``, ``F.linear``, ``F.layer_norm`` and
    ``F.gelu``: a yardstick timed here only; the port never calls it."""
    import torch
    import torch.nn.functional as F

    from shm_tpu_torch.models.attention import sinusoidal_positions

    H = vae.hidden_dim

    def ln(x, m, eps=1e-6):
        return F.layer_norm(x, (H,), m.weight, m.bias, eps)

    def stack(st, tok):
        N, T, _ = tok.shape
        heads = st.num_heads
        s = tok + sinusoidal_positions(T, H, tok.device).to(tok.dtype)
        split = lambda t: t.view(N, T, heads, H // heads).transpose(1, 2)
        for b in st.layers:
            h = ln(s, b.attn_norm)
            o = F.scaled_dot_product_attention(
                split(b.query(h)), split(b.key(h)), split(b.value(h)))
            s = s + b.out(o.transpose(1, 2).reshape(N, T, H))
            s = s + b.mlp_out(F.gelu(b.mlp_in(ln(s, b.mlp_norm)),
                                     approximate="tanh"))
        return ln(s, st.final_norm)

    @torch.inference_mode()
    def run(Z):
        N, T, _ = Z.shape
        h = stack(vae.encoder_lstm, vae.encoder_lstm.in_proj(Z)).mean(dim=1)
        if vae.layer_norm is not None:
            h = vae.layer_norm(h)
        h0 = torch.tanh(vae.fc_latent_to_hidden(vae.fc_mu(h)))
        tok0 = vae.decoder_lstm.in_proj(h0)
        out = stack(vae.decoder_lstm, tok0[:, None].expand(N, T, H))
        r = (Z - vae.output_layer(out)) ** 2
        return r.mean(dim=(1, 2)), r

    return run


LIBRARY_PASS = {"lstm": cudnn_vae_pass, "min_gru": scan_mingru_pass,
                "attention": sdpa_attention_pass}


def phase_timing(scorer, W, cell: str = "lstm"):
    import torch

    from shm_tpu_torch.data.windows import normalize_windows
    from shm_tpu_torch.ops import FUSED_GATES
    from shm_tpu_torch.serve import bucket_size
    from shm_tpu_torch.tools.workload import (
        PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_F32_FLOPS, bound_ms,
    )

    fam = FAMILIES[cell]
    weights_fn, gate, reference = FUSED_GATES[cell]
    tag = f"[time {cell}]"
    Wb = np.resize(W, (N_BENCH,) + W.shape[1:]).astype(np.float32)
    vae = scorer.vae
    N, T, D = Wb.shape
    Z = normalize_windows(torch.from_numpy(Wb).cuda(), scorer.mean,
                          scorer.std).contiguous()
    w = weights_fn(vae)
    kw = dict(num_layers=vae.num_layers, use_layernorm=vae.use_layernorm)

    mse_k, resid_k = gate(w, Z, **kw)
    mse_p, resid_p = reference(w, Z, **kw)
    torch.cuda.synchronize()
    print(f"{tag} kernel vs plain at N={N} (trained weights, real windows):")
    err = max(compare("mse", mse_k, mse_p), compare("resid", resid_k, resid_p))
    print(f"{tag} max relative mse diff, kernel vs plain: "
          f"{float(((mse_k - mse_p).abs() / mse_p.abs()).max()):.3e}")
    del resid_p
    extra = {}
    if cell == "attention":
        extra = phase_attention_kernel(w, N, T, vae.hidden_dim, vae.num_layers)
    elif cell == "lstm":
        extra = phase_lstm_kernel(w, Z, mse_k, mse_p, T, D, vae.hidden_dim,
                                  vae.num_layers)
    else:
        extra = phase_mingru_kernel(w, Z, mse_k, mse_p, T, D, vae.hidden_dim,
                                    vae.num_layers, vae.use_layernorm)
    library = LIBRARY_PASS[cell](vae)
    mse_c, _ = library(Z)
    print(f"{tag} {fam['library']} yardstick vs kernel: max |mse diff| "
          f"{float((mse_c - mse_k).abs().max()):.3e}")

    ms = time_ms(lambda: gate(w, Z, **kw))
    plain_ms = time_ms(lambda: reference(w, Z, **kw), reps=5)
    library_ms = time_ms(lambda: library(Z))
    flops, nbytes = fam["work"](N, T, D, vae.hidden_dim, vae.latent_dim,
                                vae.num_layers)
    bound, bound_by = bound_ms(flops, nbytes, PEAK_F32_FLOPS)
    print(f"{tag} {gate.__name__} N={N}: kernel {ms:.4f} ms | plain "
          f"{plain_ms:.4f} ms | {fam['library']} yardstick {library_ms:.4f} ms")
    print(f"{tag} work {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB -> "
          f"bound {bound:.4f} ms ({bound_by}; f32 "
          f"{flops / PEAK_F32_FLOPS * 1e3:.4f} ms, bf16 tensor-core "
          f"{flops / PEAK_BF16_FLOPS * 1e3:.4f} ms, bytes "
          f"{nbytes / PEAK_BYTES * 1e3:.4f} ms); kernel at "
          f"{bound / ms * 100:.1f}% of the f32 bound")

    scorer.score(Wb)                                   # warm the bucket
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        scorer.score(Wb)
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    bucket = bucket_size(N, scorer.min_bucket, scorer.max_batch)
    print(f"{tag} score() end to end, {N} windows: median {wall * 1e3:.2f} ms "
          f"over 5 -> {N / wall:.1f} windows/s (one dispatch padded to "
          f"{bucket} windows)")
    profile_device(lambda: scorer.score(Wb),
                   f"{cell} score() of {len(Wb)} windows")
    reach = reach_timing(cell)
    return {"max_abs_err": max(err, reach.pop("max_abs_err")), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": library_ms, "reach_ms": reach, **extra}


# phase 4's timing of a shape past the kernel's instances, per family, at
# bench.py's N and T, weights from a seed: name, D, Z, H, L, LN
REACH_TIMED = {"lstm": ("H=48 D=64 Z=64", 64, 64, 48, 2, True),
               "min_gru": ("H=96", 12, 16, 96, 2, True),
               "attention": ("Z=64", 12, 64, 128, 2, True)}


def reach_timing(cell: str) -> dict:
    """The family's ``REACH_TIMED`` shape at N_BENCH random windows of 100
    steps: the kernel against its plain version (phase 2's bar), its
    CUDA-event ms, the plain version's and the bound of the model's own
    work. Returns {name: {ms, plain_ms, bound_ms, bound_by}, "max_abs_err"}."""
    import torch

    from shm_tpu_torch.ops import FUSED_GATES
    from shm_tpu_torch.tools.workload import PEAK_F32_FLOPS, bound_ms

    name, D, Zd, H, L, ln = REACH_TIMED[cell]
    weights_fn, gate, reference = FUSED_GATES[cell]
    T = 100
    vae, rng = random_vae(400, D, Zd, H, L, ln, cell)
    w = weights_fn(vae)
    Z = torch.from_numpy(rng.normal(size=(N_BENCH, T, D)).astype(np.float32)).cuda()
    kw = dict(num_layers=L, use_layernorm=ln)
    mse_k, r_k = gate(w, Z, **kw)
    torch.cuda.synchronize()
    mse_p, r_p = reference(w, Z, **kw)
    print(f"[time {cell}] {name} (N={N_BENCH} T={T} D={D} Z={Zd} H={H} L={L}):")
    err = max(compare("mse", mse_k, mse_p), compare("resid", r_k, r_p))
    del r_k, r_p
    ms = time_ms(lambda: gate(w, Z, **kw))
    plain = time_ms(lambda: reference(w, Z, **kw), reps=3, warm=1)
    flops, nbytes = FAMILIES[cell]["work"](N_BENCH, T, D, H, Zd, L)
    bound, bound_by = bound_ms(flops, nbytes, PEAK_F32_FLOPS)
    print(f"[time {cell}] {name}: kernel {ms:.4f} ms | plain {plain:.4f} ms | "
          f"bound {bound:.4f} ms ({bound_by}, {flops / 1e9:.2f} GFLOP of the "
          f"model's own width)")
    return {name: dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=bound_by),
            "max_abs_err": err}


def profile_device(fn, what: str, calls: int = 3, groups=None, rest: str = ""):
    """Where the time of one ``fn()`` goes: device time by kernel from
    ``torch.profiler`` over ``calls`` calls, against their host wall time,
    and the device's idle share. ``groups`` ({label: name fragments}) sums the
    kernels under labels first; ``rest`` labels what no group matched."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    # device-side events only (kernels, copies): the CPU operators that
    # launched them report the same device time again
    rows = sorted(((e.key, e.self_device_time_total / 1e3 / calls)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    if not rows:
        print("[profile] the profiler recorded no device time: not measured")
        return
    busy = sum(ms for _, ms in rows)
    print(f"[profile] {what} under the profiler: wall {wall_ms:.2f} ms/call, "
          f"device busy {busy:.2f} ms/call, device idle share "
          f"{max(1 - busy / wall_ms, 0.0):.3f}")
    if groups:
        left = busy
        for label, keys in groups.items():
            g = sum(ms for n, ms in rows if any(k in n.lower() for k in keys))
            left -= g
            print(f"[profile]   {g:9.3f} ms  {g / busy * 100:5.1f}%  {label}")
        print(f"[profile]   {left:9.3f} ms  {left / busy * 100:5.1f}%  {rest}")
    for name, ms in rows[:10]:
        print(f"[profile]     {ms:9.3f} ms  {ms / busy * 100:5.1f}%  {name[:90]}")


# ---------------------------------------------------------------------------
# the LSTM training kernels (phases 6-8)
# ---------------------------------------------------------------------------

LSTM_KERNELS = {   # name in the kernels line: the TPU kernel it replaces
    "lstm2_enc_fwd": "shm_tpu/ops/lstm_train.py:153",
    "lstm2_enc_bwd": "shm_tpu/ops/lstm_train.py:191",
    "lstm2_dec_fwd": "shm_tpu/ops/lstm_train.py:359",
    "lstm2_dec_bwd": "shm_tpu/ops/lstm_train.py:399",
}
# the gradients of the encoder and the decoder op, in their order
LSTM_GRAD_NAMES = (["x", "w0i", "w0h", "b0", "w1i", "w1h", "b1"],
                   ["dec_in", "w0i", "w0h", "b0", "w1i", "w1h", "b1", "out_w", "out_b"])


def lstm_work(kernel: str, T: int, D: int, H: int, B: int, K: int = 0,
              with_dx: bool = False, mask: bool = True, recompute: bool = False):
    """(FLOPs, bytes) one call of an LSTM training kernel must do. FLOPs are
    matmul FLOPs (elementwise excluded, as in ``vae_work``): the forward's
    gate products; for a backward the transposed products of the dh chain
    and the weight-gradient products. Bytes: each input read once, each
    output written once (the gate gradients that pass between the backward's
    two passes are neither); the forward writes the gate stash [T,2,4H,B]
    and the backward reads it. ``recompute=True`` counts the design before
    the gate stash: no gate stash, and a backward that computes the forward's
    gate products again."""
    G = 4 * H
    n_w = G * (3 * H + 2) + G * (D if kernel.startswith("lstm2_enc") else K)
    gates = 0 if recompute else T * 2 * G * B
    stream = T * H * B * (1 if mask else 0) + T * G * B + G * B + gates
    if kernel == "lstm2_enc_fwd":
        flops = 2 * G * (D + 3 * H) * T * B
        words = T * D * B + stream + H * B + n_w
    elif kernel == "lstm2_enc_bwd":
        flops = ((2 * G * (D + 3 * H) * T * B if recompute else 0)
                 + 2 * G * 3 * H * T * B                # W^T dg for dh0, dh1
                 + 2 * G * (D + 3 * H) * T * B          # weight gradients
                 + (2 * G * D * T * B if with_dx else 0))
        words = (T * D * B + stream + H * B + n_w        # inputs
                 + n_w + (T * D * B if with_dx else 0))  # gradients out
    elif kernel == "lstm2_dec_fwd":
        flops = 2 * G * K * B + T * B * (2 * G * 3 * H + 2 * D * H)
        words = K * B + stream + n_w + (H + 1) * D + T * D * B
    elif kernel == "lstm2_dec_bwd":
        flops = ((2 * G * K * B + T * B * 2 * G * 3 * H if recompute else 0)
                 + T * B * (2 * G * 3 * H + 2 * D * H)   # W^T dg, head^T dr
                 + T * B * (2 * G * 3 * H + 2 * D * H)   # weight + head grads
                 + 2 * 2 * G * K * B)                    # layer-0 fold, d dec_in
        words = (K * B + stream + n_w + (H + 1) * D + T * D * B
                 + K * B + n_w + (H + 1) * D)
    else:
        raise ValueError(kernel)
    return float(flops), 4.0 * words


def lstm_case(seed: int, T, D, H, B, drop):
    """numpy-seeded inputs of one case, on the card, in the ops' layouts."""
    import torch

    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).cuda()
    u = lambda *s: t(rng.uniform(-1, 1, size=s) / np.sqrt(H))
    stack = lambda in_dim: [u(4 * H, in_dim), u(4 * H, H), u(4 * H, 1),
                            u(4 * H, H), u(4 * H, H), u(4 * H, 1)]
    mask = lambda: (t((rng.random((T, H, B)) > drop) / (1.0 - drop))
                    if drop else None)
    return dict(
        xs=t(rng.normal(size=(T, D, B))), dm_enc=mask(), enc_w=stack(D),
        R_enc=t(rng.normal(size=(H, B))),
        din=t(np.tanh(rng.normal(size=(H, B)))), dm_dec=mask(),
        dec_w=stack(H) + [u(D, H), u(D, 1)],
        R_dec=t(rng.normal(size=(T, D, B))))


def compare_grads(tag: str, got, want, names) -> float:
    """Max |got - want| over all gradients; fails past the stated tolerance."""
    worst_abs = 0.0
    for n, g, w in zip(names, got, want):
        err = (g - w).abs()
        atol = GRAD_ATOL_REL * max(float(w.abs().max()), 1e-12)
        over = float((err - RTOL * w.abs()).max())
        worst_abs = max(worst_abs, float(err.max()))
        print(f"[lstm]     {tag} d{n}: max |diff| {float(err.max()):.3e}, max "
              f"|plain| {float(w.abs().max()):.3e} (tolerance {GRAD_ATOL_REL:g}"
              f"*max|plain| + {RTOL:g}*|plain|) {'ok' if over <= atol else 'FAIL'}")
        check(over <= atol, f"{tag}: gradient {n} disagrees with autograd of "
                            f"the plain version (max |diff| {float(err.max()):.3e})")
    return worst_abs


# the cases of phases 6 and 18: name, T, D, H, B, dropout
LSTM_CASES = (
    ("4dof training shape", 100, 12, 128, 256, 0.3),
    ("4dof ragged batch", 100, 12, 128, 200, 0.3),
    ("1dof 2-layer shape", 80, 12, 32, 64, 0.2),
    ("unit mask", 100, 12, 128, 64, 0.0),
    ("4dof batch of 1,024 (clusters in waves)", 100, 12, 128, 1024, 0.3),
    ("one window", 100, 12, 128, 1, 0.3),
    ("H=64", 40, 12, 64, 45, 0.3),
)
# phases 6 and 18 also hold a width that is no kernel instance's, which the
# ops run padded to the next (H=48 at the H=64 instance)
LSTM_REACH_CASES = (("H=48 (the H=64 instance)", 40, 12, 48, 45, 0.3),)


def padded_case(c):
    """An ``lstm_case`` at the width the kernels run it at: its weights,
    masks and ``R_enc`` widened by ``pad_hidden`` to ``instance_width(H)``,
    as the ops widen them around their autograd.Function; ``c`` itself at
    an instance's width."""
    from shm_tpu_torch.ops._gate import instance_width, pad_units
    from shm_tpu_torch.ops.lstm_train import pad_hidden

    H = c["enc_w"][1].shape[1]
    Hp = instance_width(H)
    if Hp == H:
        return c
    dm_e, *enc_w = pad_hidden(H, Hp, c["dm_enc"], *c["enc_w"])
    dm_d, *dec_w = pad_hidden(H, Hp, c["dm_dec"], *c["dec_w"])
    return dict(c, enc_w=enc_w, dm_enc=dm_e, dec_w=dec_w, dm_dec=dm_d,
                R_enc=pad_units(c["R_enc"], H, Hp, dim=0))


def phase_lstm_kernels_vs_plain():
    """Both forwards and every gradient of the four kernels against autograd
    of the plain versions, and both forwards in the validation mode, same
    inputs, on the card. Returns the max |diff| per kernel at the 4DOF
    training shape."""
    import torch

    from shm_tpu_torch.ops import (
        lstm2_dec_head, lstm2_dec_head_reference, lstm2_enc_last,
        lstm2_scan_reference,
    )
    from shm_tpu_torch.ops.lstm_train import bwd_scan_info, fwd_scan_info

    # the forward- and reverse-scan instances as the card places them
    # (cudaFuncGetAttributes, cudaOccupancyMaxActiveClusters); raises where
    # no cluster fits
    for H in (32, 64, 128):
        for dec in (False, True):
            for scan, info in (("forward", fwd_scan_info(H, dec)),
                               ("reverse", bwd_scan_info(H, dec))):
                print(f"[lstm] {scan} scan H={H} {'decoder' if dec else 'encoder'}: "
                      f"{info['max_active_clusters']} clusters of 8 blocks at once, "
                      f"{info['threads']} threads and {info['shared_bytes']} B of "
                      f"shared memory a block, {info['registers']} registers and "
                      f"{info['local_bytes']} B of local memory (spills) a thread")
    errs = {}
    leaf = lambda ts: [a.clone().requires_grad_(True) for a in ts]
    for i, (name, T, D, H, B, drop) in enumerate(LSTM_CASES + LSTM_REACH_CASES):
        c = lstm_case(200 + i, T, D, H, B, drop)
        print(f"[lstm] {name}: T={T} D={D} H={H} B={B} dropout={drop}")

        lv = leaf([c["xs"]] + c["enc_w"])
        out = lstm2_enc_last(lv[0], c["dm_enc"], *lv[1:])
        got = torch.autograd.grad((out * c["R_enc"]).sum(), lv)
        torch.cuda.synchronize()
        lp = leaf([c["xs"]] + c["enc_w"])
        ref = lstm2_scan_reference(lp[0], c["dm_enc"], *lp[1:])[-1]
        want = torch.autograd.grad((ref * c["R_enc"]).sum(), lp)
        check(out.shape == (H, B) and bool(torch.isfinite(out).all()),
              f"{name}: h_last not finite / wrong shape")
        e_fwd = compare("encoder h_last", out, ref)
        e_bwd = compare_grads("encoder", got, want, LSTM_GRAD_NAMES[0])
        if i == 0:
            errs["lstm2_enc_fwd"], errs["lstm2_enc_bwd"] = e_fwd, e_bwd

        lv = leaf([c["din"]] + c["dec_w"])
        out = lstm2_dec_head(lv[0], c["dm_dec"], *lv[1:], T=T)
        got = torch.autograd.grad((out * c["R_dec"]).sum(), lv)
        torch.cuda.synchronize()
        lp = leaf([c["din"]] + c["dec_w"])
        ref = lstm2_dec_head_reference(lp[0], c["dm_dec"], *lp[1:], T)
        want = torch.autograd.grad((ref * c["R_dec"]).sum(), lp)
        check(out.shape == (T, D, B) and bool(torch.isfinite(out).all()),
              f"{name}: recon not finite / wrong shape")
        e_fwd = compare("decoder recon", out, ref)
        e_bwd = compare_grads("decoder", got, want, LSTM_GRAD_NAMES[1])
        if i == 0:
            errs["lstm2_dec_fwd"], errs["lstm2_dec_bwd"] = e_fwd, e_bwd

        # every output of the forwards (what they keep for the backward too)
        # against the plain forward's, in both modes
        e_stash = compare_stash(c, T)
        if i == 0:
            errs["lstm2_enc_fwd"] = max(errs["lstm2_enc_fwd"], e_stash)
            errs["lstm2_dec_fwd"] = max(errs["lstm2_dec_fwd"], e_stash)

        # the trainer's validation mode: no gradient, so no stash is written,
        # and a null mask pointer
        with torch.no_grad():
            e_val = compare(
                "validation-mode lstm2_enc_last",
                lstm2_enc_last(c["xs"], None, *c["enc_w"]),
                lstm2_scan_reference(c["xs"], None, *c["enc_w"])[-1])
            d_val = compare(
                "validation-mode lstm2_dec_head",
                lstm2_dec_head(c["din"], None, *c["dec_w"], T=T),
                lstm2_dec_head_reference(c["din"], None, *c["dec_w"], T))
        if i == 0:
            errs["lstm2_enc_fwd"] = max(errs["lstm2_enc_fwd"], e_val)
            errs["lstm2_dec_fwd"] = max(errs["lstm2_dec_fwd"], d_val)
    return errs


def compare_stash(c, T: int) -> float:
    """Every output of both forward kernels against
    ``lstm2_scan_stash_reference`` on the same inputs, in the training mode
    (the case's masks; stash and gate stash kept) and in the trainer's
    validation mode (null mask, no stash): h_last / recon, the final state,
    and in the training mode the stash and the gate stash; max |diff|. A
    width no kernel instance has runs both sides on ``padded_case``'s
    inputs, the kernels' own width."""
    import torch

    from shm_tpu_torch.ops import lstm2_scan_stash_reference
    from shm_tpu_torch.ops.lstm_train import dec_forward_cuda, enc_forward_cuda

    c = padded_case(c)
    worst = 0.0
    ow, ob = c["dec_w"][6:]
    with torch.no_grad():
        for mode, keep, dm_e, dm_d in (("training", True, c["dm_enc"], c["dm_dec"]),
                                       ("validation-mode", False, None, None)):
            h1s, *enc_ref = lstm2_scan_stash_reference(c["xs"], dm_e, *c["enc_w"])
            h_last, enc_saved = enc_forward_cuda(c["xs"], dm_e, *c["enc_w"],
                                                 keep_stash=keep)
            h1d, *dec_ref = lstm2_scan_stash_reference(c["din"], dm_d, *c["dec_w"][:6], T=T)
            recon, dec_saved = dec_forward_cuda(c["din"], dm_d, *c["dec_w"], T=T,
                                                keep_stash=keep)
            check(keep or enc_saved[3] is None and dec_saved[3] is None,
                  "a forward in validation mode wrote a stash")
            rows = [("encoder h_last", h_last, h1s[-1]),
                    ("decoder recon", recon, ow @ h1d + ob)]
            for tag, saved, ref in (("encoder", enc_saved, enc_ref),
                                    ("decoder", dec_saved, dec_ref)):
                rows.append((f"{tag} final state", saved[5], ref[2]))
                if keep:
                    rows += [(f"{tag} stash", saved[3], ref[0]),
                             (f"{tag} gate stash", saved[4], ref[1])]
            for what, got, want in rows:
                worst = max(worst, compare(f"{mode} {what}", got, want))
    return worst


def lstm_launch_counts(bf16: bool = False):
    """{row name: launches} of the float32 instances of rows 2-5, or of
    their bf16 instances."""
    from shm_tpu_torch.ops import lstm2_dec_head, lstm2_enc_last

    p = "bf16_" if bf16 else ""
    return {"lstm2_enc_fwd": getattr(lstm2_enc_last, f"{p}fwd_launches"),
            "lstm2_enc_bwd": getattr(lstm2_enc_last, f"{p}bwd_launches"),
            "lstm2_dec_fwd": getattr(lstm2_dec_head, f"{p}fwd_launches"),
            "lstm2_dec_bwd": getattr(lstm2_dec_head, f"{p}bwd_launches")}


def reset_lstm_launch_counts():
    """Every instance's counts of rows 2-5 to 0."""
    from shm_tpu_torch.ops import lstm2_dec_head, lstm2_enc_last

    for op in (lstm2_enc_last, lstm2_dec_head):
        op.fwd_launches = op.bwd_launches = 0
        op.bf16_fwd_launches = op.bf16_bwd_launches = 0


def phase_train_path():
    """``train-vae`` at full width on the committed normal runs, the recipe of
    ``Stage4DofConfig`` cut to ``TRAIN_EPOCHS`` epochs, on the card through
    the kernels, into a temporary root."""
    import shutil
    import tempfile

    import torch

    from shm_tpu_torch.cli.stage4dof import Paths, cmd_train_vae
    from shm_tpu_torch.config import Stage4DofConfig, replace
    from shm_tpu_torch.convert import vae_from_flax, vae_state_dict
    from shm_tpu_torch.models.vae import vae_from_config
    from shm_tpu_torch.ops import fused_vae_gate
    from shm_tpu_torch.train import reconstruction_mse, train_vae
    from shm_tpu_torch.train.vae import batch_loss, draw_batch_noise
    from shm_tpu_torch.utils.checkpoint import load_checkpoint
    from shm_tpu_torch.utils.io import load_json

    # the recipe unchanged; only the depth is cut (8 epochs of 50): the KL
    # weight of the cut run still ramps over its first 30%, and the
    # reconstruction loss falls over the 8 epochs under it
    cfg = Stage4DofConfig()
    tcfg = cfg.vae_train
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        paths = Paths(tmp)
        paths.processed.mkdir(parents=True)
        shutil.copy(Paths(str(ROOT / "data" / "4dof")).run_splits,
                    paths.run_splits)

        reset_lstm_launch_counts()
        gate0 = fused_vae_gate.launches
        res = cmd_train_vae(paths, cfg, epochs=TRAIN_EPOCHS, plot=False)
        torch.cuda.synchronize()
        counts = lstm_launch_counts()

        # the windows, as the command built them, for the checks below
        from shm_tpu_torch.cli.stage4dof import (
            _load_stats, build_fraction_windows_multi,
        )
        from shm_tpu_torch.data.windows import normalize_windows

        files = load_json(paths.run_splits)["normal"]["files"]
        Wtr, Wva = build_fraction_windows_multi(
            files, (cfg.train_frac, cfg.val_frac), cfg)
        mean, std = (torch.from_numpy(a).cuda() for a in _load_stats(paths))
        Ztr = normalize_windows(torch.from_numpy(Wtr).cuda(), mean, std)
        Zva = normalize_windows(torch.from_numpy(Wva).cuda(), mean, std)

        steps = TRAIN_EPOCHS * -(-len(Wtr) // tcfg.batch_size)
        vals = TRAIN_EPOCHS * -(-len(Wva) // tcfg.batch_size)
        print(f"[train] {len(Wtr)} train / {len(Wva)} val windows, "
              f"{TRAIN_EPOCHS} epochs = {steps} steps + {vals} validation "
              f"batches in {res.seconds:.2f} s ({res.seconds / TRAIN_EPOCHS:.3f} "
              f"s/epoch); launches {counts}")
        # every step launches each forward and each backward once; every
        # validation batch launches the two forwards (unit mask, no stash)
        check(counts["lstm2_enc_bwd"] == steps and counts["lstm2_dec_bwd"] == steps,
              f"backward launches {counts} != {steps} training steps")
        check(counts["lstm2_enc_fwd"] == steps + vals
              and counts["lstm2_dec_fwd"] == steps + vals,
              f"forward launches {counts} != {steps} steps + {vals} validation batches")
        h = res.history
        check(len(h["epoch"]) == TRAIN_EPOCHS and all(
            np.isfinite(h[k]).all() for k in h), "non-finite loss in the history")
        print(f"[train] train recon by epoch {h['train_recon']}, val total "
              f"{h['val_total']}, best epoch {res.best_epoch}")
        check(h["train_recon"][-1] < h["train_recon"][0],
              "the training reconstruction loss did not fall")

        # the written checkpoint, read back by the port's reader
        tree = load_checkpoint(paths.models / "temporal_vae.msgpack")
        sd = vae_state_dict(tree["params"], cfg.vae.num_layers,
                            cfg.vae.use_layernorm)
        check(sd.keys() == res.params.keys() and all(
            torch.equal(sd[k], res.params[k].cpu()) for k in sd),
            "temporal_vae.msgpack read back differs from the trained params")
        vae = vae_from_flax(tree["params"], cfg.vae).cuda()

        # gate-only scoring of the validation windows through the fused kernel
        mse_k = reconstruction_mse(vae, Zva)
        gate_launches = fused_vae_gate.launches - gate0
        mse_p = reconstruction_mse(vae, Zva, fused=False)
        check(gate_launches == 1, f"reconstruction_mse launched the gate "
                                  f"kernel {gate_launches} times, not once")
        check(mse_k.shape == (len(Wva),) and np.isfinite(mse_k).all(),
              "reconstruction_mse not finite / wrong shape")
        print(f"[train] reconstruction_mse of {len(Wva)} val windows through "
              f"fused_vae_gate(with_residual=False): mean {mse_k.mean():.6f}")
        compare("reconstruction_mse vs plain model",
                torch.from_numpy(mse_k), torch.from_numpy(mse_p))

    # the same run again, now that every kernel of the loop is loaded: the
    # first call above pays the first use of each of them
    again = train_vae(vae_from_config(cfg.vae), Ztr, Zva,
                      replace(tcfg, epochs=TRAIN_EPOCHS))
    print(f"[train] second run of {TRAIN_EPOCHS} epochs: "
          f"{again.seconds / TRAIN_EPOCHS:.3f} s/epoch (first run "
          f"{res.seconds / TRAIN_EPOCHS:.3f} s/epoch)")
    check(again.history["train_total"] == res.history["train_total"],
          "two runs from one seed gave different training losses")

    # first batch, same noise: kernel path against plain autograd path
    model = vae_from_config(cfg.vae).cuda()
    model.init_parameters(torch.Generator().manual_seed(tcfg.seed))
    model.train()
    bs = tcfg.batch_size
    gen = torch.Generator(device="cuda").manual_seed(tcfg.seed)
    xb = Ztr[:bs].contiguous()
    bmask = torch.ones(bs, device="cuda")
    eps, dm_e, dm_d = draw_batch_noise(model, bs, xb.shape[1], gen, xb.device)
    params = list(model.parameters())
    names = [n for n, _ in model.named_parameters()]
    out = {}
    for kernel in (True, False):
        total, _, _ = batch_loss(model, xb, bmask, eps, dm_e, dm_d, 0.5, kernel)
        out[kernel] = (total.detach(), torch.autograd.grad(total, params))
    torch.cuda.synchronize()
    print("[train] first batch, same noise, kernel path vs plain autograd path:")
    compare("loss", out[True][0], out[False][0])
    compare_grads("step", out[True][1], out[False][1], names)
    return counts, dict(model=model, xb=xb, bmask=bmask, noise=(eps, dm_e, dm_d),
                        seconds_per_epoch=again.seconds / TRAIN_EPOCHS)


def cudnn_lstm(in_dim: int, H: int, drop: float):
    from torch import nn

    m = nn.LSTM(in_dim, H, 2, batch_first=True, dropout=drop).cuda().train()
    m.flatten_parameters()
    return m


def time_fwd_bwd(make_loss, leaves, reps: int = REPS):
    """(forward ms, backward ms): the forward alone, and forward + backward
    minus it (a graph is built anew for every backward)."""
    import torch

    fwd = time_ms(make_loss, reps=reps)
    both = time_ms(lambda: torch.autograd.grad(make_loss(), leaves), reps=reps)
    return fwd, max(both - fwd, 0.0)


def lstm_kernel_ms(c, T: int, dtype=None):
    """CUDA-event ms of the four kernels (their instances at ``dtype``; None
    calls the float32 ones as a tree without bf16 instances takes them) on
    the inputs of one ``lstm_case`` (a training step asks for no dx),
    through the wrappers' public calls."""
    from shm_tpu_torch.ops.lstm_train import (
        dec_backward_cuda, dec_forward_cuda, enc_backward_cuda,
        enc_forward_cuda,
    )

    kw = {} if dtype is None else dict(dtype=dtype)
    _, enc_saved = enc_forward_cuda(c["xs"], c["dm_enc"], *c["enc_w"], **kw)
    _, dec_saved = dec_forward_cuda(c["din"], c["dm_dec"], *c["dec_w"], T=T, **kw)
    return {
        "lstm2_enc_fwd": time_ms(lambda: enc_forward_cuda(
            c["xs"], c["dm_enc"], *c["enc_w"], **kw)),
        "lstm2_enc_bwd": time_ms(lambda: enc_backward_cuda(
            enc_saved, c["R_enc"], need_dx=False, **kw)),
        "lstm2_dec_fwd": time_ms(lambda: dec_forward_cuda(
            c["din"], c["dm_dec"], *c["dec_w"], T=T, **kw)),
        "lstm2_dec_bwd": time_ms(lambda: dec_backward_cuda(
            dec_saved, c["R_dec"], **kw)),
    }


def phase_lstm_timing(errs, counts, ctx):
    """CUDA-event times of the four kernels at the 4DOF training shape, of
    their plain versions and of a cuDNN ``nn.LSTM`` yardstick; one training
    step on the three paths; where a kernel-path step's time goes."""
    import torch
    from torch import nn

    from shm_tpu_torch.config import Stage4DofConfig
    from shm_tpu_torch.ops import (
        lstm2_dec_head_reference, lstm2_scan_reference,
    )
    from shm_tpu_torch.tools.workload import PEAK_BYTES, PEAK_F32_FLOPS, bound_ms
    from shm_tpu_torch.train.vae import batch_loss, make_optimizer

    cfg = Stage4DofConfig()
    T, D, H, B, drop = cfg.seq_len, cfg.vae.input_dim, cfg.vae.hidden_dim, \
        cfg.vae_train.batch_size, cfg.vae.dropout
    c = lstm_case(300, T, D, H, B, drop)
    leaf = lambda ts: [a.clone().requires_grad_(True) for a in ts]

    ms = lstm_kernel_ms(c, T)
    # a width no kernel instance has (H=48): the kernels at the H=64
    # instance on the inputs the ops pad for them
    reach_h = LSTM_REACH_CASES[0][3]
    ms_reach = lstm_kernel_ms(padded_case(lstm_case(301, T, D, reach_h, B, drop)), T)
    print(f"[time] rows 2-5 at H={reach_h} (the H=64 instance, padded inputs) "
          f"T={T} B={B}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in ms_reach.items()))
    # --- plain versions under autograd (weights are the leaves, as in training)
    ew, dw = leaf(c["enc_w"]), leaf(c["dec_w"])
    din = c["din"].clone().requires_grad_(True)
    plain = {}
    plain["lstm2_enc_fwd"], plain["lstm2_enc_bwd"] = time_fwd_bwd(
        lambda: (lstm2_scan_reference(c["xs"], c["dm_enc"], *ew)[-1]
                 * c["R_enc"]).sum(), ew, reps=5)
    plain["lstm2_dec_fwd"], plain["lstm2_dec_bwd"] = time_fwd_bwd(
        lambda: (lstm2_dec_head_reference(din, c["dm_dec"], *dw, T)
                 * c["R_dec"]).sum(), [din] + dw, reps=5)
    # --- cuDNN yardstick: nn.LSTM (2 layers, dropout between) computes the
    # same scans, all T outputs included; the decoder adds a Linear head
    enc_l, dec_l = cudnn_lstm(D, H, drop), cudnn_lstm(H, H, drop)
    head = nn.Linear(H, D).cuda()
    x_bt = c["xs"].permute(2, 0, 1).contiguous()
    din_bt = c["din"].t().contiguous().requires_grad_(True)
    R_enc_bt, R_dec_bt = c["R_enc"].t().contiguous(), c["R_dec"].permute(2, 0, 1).contiguous()
    lib = {}
    lib["lstm2_enc_fwd"], lib["lstm2_enc_bwd"] = time_fwd_bwd(
        lambda: (enc_l(x_bt)[1][0][-1] * R_enc_bt).sum(), list(enc_l.parameters()))
    lib["lstm2_dec_fwd"], lib["lstm2_dec_bwd"] = time_fwd_bwd(
        lambda: (head(dec_l(din_bt[:, None].expand(B, T, H))[0]) * R_dec_bt).sum(),
        [din_bt] + list(dec_l.parameters()) + list(head.parameters()))

    rows = []
    for name, replaces in LSTM_KERNELS.items():
        flops, nbytes = lstm_work(name, T, D, H, B, K=H)
        bound, bound_by = bound_ms(flops, nbytes, PEAK_F32_FLOPS)
        old = bound_ms(*lstm_work(name, T, D, H, B, K=H, recompute=True),
                       PEAK_F32_FLOPS)[0]
        print(f"[time] {name} T={T} H={H} B={B}: kernel {ms[name]:.4f} ms | "
              f"plain {plain[name]:.4f} ms | cuDNN nn.LSTM {lib[name]:.4f} ms | "
              f"work {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB -> bound "
              f"{bound:.4f} ms (f32 {flops / PEAK_F32_FLOPS * 1e3:.4f}, bytes "
              f"{nbytes / PEAK_BYTES * 1e3:.4f}; with the backward's gate "
              f"recompute and no gate stash, as before the gate stash: "
              f"{old:.4f}); kernel at {bound / ms[name] * 100:.1f}% of the bound")
        rows.append(dict(
            name=name, route="cuda",
            source="shm_tpu_torch/ops/csrc/lstm_train.cu", replaces=replaces,
            launches=counts[name], max_abs_err=errs[name], ms=ms[name],
            plain_ms=plain[name], bound_ms=bound, bound_by=bound_by,
            library_ms=lib[name],
            reach_ms={f"H={reach_h}": dict(
                ms=ms_reach[name],
                bound_ms=bound_ms(*lstm_work(name, T, D, reach_h, B, K=reach_h),
                                  PEAK_F32_FLOPS)[0])}))

    # --- one training step: kernel path, plain autograd path, cuDNN yardstick
    model, xb, bmask = ctx["model"], ctx["xb"], ctx["bmask"]
    eps, dm_e, dm_d = ctx["noise"]
    opt = make_optimizer(model.parameters(), cfg.vae_train)

    def step(kernel):
        opt.zero_grad()
        total, _, _ = batch_loss(model, xb, bmask, eps, dm_e, dm_d, 0.5, kernel)
        total.backward()
        opt.step()

    others = [model.fc_mu, model.fc_logvar, model.fc_latent_to_hidden,
              model.output_layer] + ([model.layer_norm] if model.layer_norm is not None else [])
    cparams = [p for m in [enc_l, dec_l] + others for p in m.parameters()]
    copt = make_optimizer(cparams, cfg.vae_train)

    def cudnn_step():
        from shm_tpu_torch.models.vae import vae_loss

        copt.zero_grad()
        h = enc_l(xb)[1][0][-1]
        if model.layer_norm is not None:
            h = model.layer_norm(h)
        mu, logvar = model.fc_mu(h), model.fc_logvar(h)
        z = mu + eps * torch.exp(0.5 * logvar)
        d = torch.tanh(model.fc_latent_to_hidden(z))
        recon = model.output_layer(dec_l(d[:, None].expand(B, T, H))[0])
        vae_loss(recon, xb, mu, logvar, 0.5, mask=bmask)[0].backward()
        copt.step()

    step_ms = time_ms(lambda: step(True))
    plain_step_ms = time_ms(lambda: step(False), reps=3, warm=1)
    cudnn_step_ms = time_ms(cudnn_step)
    print(f"[time] one training step (batch {B}, forward + backward + "
          f"optimizer): kernel path {step_ms:.3f} ms | plain autograd path "
          f"{plain_step_ms:.3f} ms | cuDNN nn.LSTM yardstick {cudnn_step_ms:.3f} ms; "
          f"train-vae's loop ran at {ctx['seconds_per_epoch']:.3f} s/epoch")
    kern = sum(ms.values())
    print(f"[time] the four kernels sum to {kern:.3f} ms = "
          f"{kern / step_ms * 100:.1f}% of the kernel-path step")
    profile_device(
        lambda: step(True), "one kernel-path training step",
        groups={"recurrent scans (lstm2_*_kernel)": ("lstm2_",),
                "gradient pass (contract/reduce/sum/wt_dg)":
                    ("contract_partial", "reduce_partial", "sum_t_rowsum", "wt_dg"),
                "optimizer (foreach/Adam kernels)": ("multi_tensor", "foreach", "adam")},
        rest="autograd glue (LayerNorm, heads, loss, transposes, clip)")
    return rows


# the gate rows that --child / --parent time: the trained VAE of this
# checkout's root of the family (the committed test windows of data/4dof,
# tiled), at bench.py's workload and at the 8,192-window bucket that score()
# pads it to
GATE_ROW_NS = (N_BENCH, 8192)


def gate_row_inputs(cell: str, ns):
    """The trained VAE of this checkout's root of ``cell`` (its
    ``HybridScorer`` through the importable tree) and, for each n of ``ns``,
    the 3,636 committed test windows tiled to n, normalized, on the card."""
    import torch

    from shm_tpu_torch.cli.stage4dof import build_fraction_windows
    from shm_tpu_torch.config import Stage4DofConfig
    from shm_tpu_torch.data.windows import normalize_windows
    from shm_tpu_torch.serve import HybridScorer
    from shm_tpu_torch.utils.io import load_json

    cfg = Stage4DofConfig()
    scorer = HybridScorer.from_artifacts(ROOT / FAMILIES[cell]["root"])
    # the runs' paths are relative to this checkout, not to the child tree
    splits = load_json(ROOT / "data" / "4dof" / "processed" / "run_splits.json")
    W = np.concatenate([build_fraction_windows(
        [str(ROOT / f) for f in splits[g]["files"]], cfg.test_frac, cfg)
        for g in ("normal", "sensor_fault", "structural_fault")])
    Zs = {n: normalize_windows(torch.from_numpy(np.resize(
        W, (n,) + W.shape[1:]).astype(np.float32)).cuda(), scorer.mean,
        scorer.std).contiguous() for n in ns}
    return scorer, Zs


def gate_row_call(cell: str, vae, bf16: bool):
    """(weights, keyword arguments) of a gate row's public call: float32, or
    bf16 with the io the JAX ``HybridScorer`` serves the cell at (bf16 for
    attention)."""
    import torch

    from shm_tpu_torch.ops import FUSED_GATES

    weights_fn = FUSED_GATES[cell][0]
    kw = dict(num_layers=vae.num_layers, use_layernorm=vae.use_layernorm)
    if not bf16:
        return weights_fn(vae), kw
    io = torch.bfloat16 if cell == "attention" else None
    return weights_fn(vae, torch.bfloat16), dict(kw, dtype=torch.bfloat16,
                                                 io_dtype=io)


def gate_row(cell: str, bf16: bool = False):
    """A gate row of the importable tree: the trained VAE of this checkout's
    root of ``cell`` through that tree's public calls (``bf16``: its bf16
    instance, ``gate_row_call``), on the 3,636 committed test windows tiled
    to each of ``GATE_ROW_NS``. Returns ({N: kernel ms}, mse at
    ``N_BENCH``)."""
    from shm_tpu_torch.ops import FUSED_GATES

    gate = FUSED_GATES[cell][1]
    scorer, Zs = gate_row_inputs(cell, GATE_ROW_NS)
    w, kw = gate_row_call(cell, scorer.vae, bf16)
    mse = gate(w, Zs[N_BENCH], **kw)[0].cpu()
    return {n: time_ms(lambda: gate(w, Z, **kw)) for n, Z in Zs.items()}, mse


# the gate rows of --child / --parent: (cell, kernel name, row, bf16)
PARENT_GATE_ROWS = (("lstm", "fused_vae_gate", "1", False),
                    ("min_gru", "fused_mingru_gate", "6", False),
                    ("attention", "fused_attention_gate", "7", False),
                    ("attention", "fused_attention_gate/bf16", "7 bf16", True))


def child(root: str, out: str) -> int:
    """Child mode (``--child ROOT OUT``): kernels of the tree at ROOT on this
    card, through its public calls only: the four LSTM kernels (the
    gradients of phase 6's 4DOF case and their ms at the 4DOF training
    shape) and rows 1, 6 and 7 (``gate_row``), saved to OUT with
    ``torch.save``."""
    sys.path.insert(0, root)
    import torch

    import shm_tpu_torch
    from shm_tpu_torch.device import set_full_f32_precision
    from shm_tpu_torch.ops import lstm2_dec_head, lstm2_enc_last

    set_full_f32_precision()
    T = 100
    c = lstm_case(200, T, 12, 128, 256, 0.3)
    leaf = lambda ts: [a.clone().requires_grad_(True) for a in ts]
    lv = leaf([c["xs"]] + c["enc_w"])
    enc = torch.autograd.grad((lstm2_enc_last(lv[0], c["dm_enc"], *lv[1:])
                               * c["R_enc"]).sum(), lv)
    lv = leaf([c["din"]] + c["dec_w"])
    dec = torch.autograd.grad((lstm2_dec_head(lv[0], c["dm_dec"], *lv[1:], T=T)
                               * c["R_dec"]).sum(), lv)
    ms = lstm_kernel_ms(lstm_case(300, T, 12, 128, 256, 0.3), T)
    gate_mse = {}
    for cell, name, _, bf16 in PARENT_GATE_ROWS:
        by_n, gate_mse[name] = gate_row(cell, bf16)
        ms[name] = by_n[N_BENCH]
        for n, v in by_n.items():
            if n != N_BENCH:
                ms[f"{name} N={n}"] = v
    probe_out = probe_row(ms)
    mingru_out = mingru_probe_row(ms)
    package = str(Path(shm_tpu_torch.__file__).parent)
    print(f"[child] {package}: " + ", ".join(f"{n} {v:.4f}" for n, v in ms.items())
          + " ms")
    torch.save(dict(package=package, ms=ms, gate_mse=gate_mse, probe=probe_out,
                    mingru_probe=mingru_out,
                    enc=[g.cpu() for g in enc], dec=[g.cpu() for g in dec]), out)
    return 0


# row 9's calls that --child / --parent time: the TPU probe's workload
# (probe_inputs: N=21,760 windows of 100 steps) with the loops at full T and
# cut to one step
PARENT_MINGRU_LOOPS = (None, 1)


def mingru_probe_name(loop_T, n: int) -> str:
    return f"make_gate({loop_T}) N={n}"


def mingru_probe_row(ms: dict) -> dict:
    """Row 9 of the importable tree through its public calls:
    ``make_gate(loop_T)`` on ``probe_inputs()`` for each of
    ``PARENT_MINGRU_LOOPS``. Adds each call's kernel ms to ``ms``; returns
    the mse, on the CPU."""
    import torch

    from shm_tpu_torch.tools.probe_mingru_recur import make_gate, probe_inputs

    _, w, Z = probe_inputs()
    outs = {}
    for loop_T in PARENT_MINGRU_LOOPS:
        name = mingru_probe_name(loop_T, Z.shape[0])
        gate = make_gate(loop_T)
        outs[name] = gate(w, Z).cpu()
        ms[name] = time_ms(lambda: gate(w, Z), warm=5)
    del Z
    torch.cuda.empty_cache()
    return outs


# row 10's product modes that --child / --parent run, at the TPU probe's 21
# tiles, at one and at 34 (more than one wave of blocks), on the inputs of
# tests/test_torch_cuda.py's case of that size. The f32 output keeps the
# parent's operands and sum order, so it must equal the parent's bit for
# bit; the tensor-core modes sum each k-step pair apart, in another order
PARENT_PROBE_TILES = (21, 1, 34)
PARENT_PROBE_MODES = ("f32", "bf16", "bf16x3")


def probe_row(ms: dict) -> dict:
    """Row 10 of the importable tree through its public calls:
    ``matmul_loop`` in each product mode on ``make_inputs(tiles,
    seed=tiles)``, T=100. Adds each call's kernel ms to ``ms``; returns the
    outputs, on the CPU."""
    import torch

    from shm_tpu_torch.tools.probe_f32_cliff import make_inputs, matmul_loop

    outs = {}
    for tiles in PARENT_PROBE_TILES:
        w, x = make_inputs(tiles, seed=tiles, device="cuda")
        for mode in PARENT_PROBE_MODES:
            name = f"matmul_loop/{mode} {tiles} tile{'s' if tiles > 1 else ''}"
            outs[name] = matmul_loop(w, x, mode).cpu()
            ms[name] = time_ms(lambda: matmul_loop(w, x, mode))
            torch.cuda.synchronize()
    return outs


def phase_parent(parent: str, rows) -> dict:
    """Rows 1-7, 9 and 10 of the tree at ``parent`` (e.g. the parent
    commit, unpacked) and of this tree on this card, one child process each,
    in turns parent, this, this, parent: their kernel ms side by side (rows
    1, 6 and 7 also at the 8,192 bucket; row 9 at full T and with its loops
    cut to one step; row 10 in each product mode at 21, 1 and 34 tiles); the
    LSTM gradients of the two trees on the same inputs (bit for bit, or
    within the stated tolerance), rows 1, 6 and 7's MSE (within the kernel
    tolerance of the parent's), row 9's (within ``PROBE_TOL["gate"]`` of the
    parent's: its sums changed order on purpose); row 10's outputs: f32 the
    parent's bit for bit, bf16 and bf16x3 each within its mode's tolerance
    of the plain version (their sums changed on purpose), each printed
    against float64 sums beside the parent's and this tree's ``tc="chain"``
    instance; this tree's two runs bit for bit. Adds ``parent_ms`` (median
    of the parent's two runs) to those rows; returns every such median by
    name."""
    import tempfile

    import torch

    runs = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parent_") as tmp:
        for k, root in enumerate([parent, str(ROOT), str(ROOT), parent]):
            out = Path(tmp) / f"run{k}.pt"
            r = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                                "--child", str(root), str(out)],
                               capture_output=True, text=True, timeout=900)
            check(r.returncode == 0, f"child run on {root} failed:\n{r.stderr[-3000:]}")
            runs.append(torch.load(out))
            print(f"[parent] run {k}: {runs[-1]['package']}: " + ", ".join(
                f"{n} {v:.4f}" for n, v in runs[-1]["ms"].items()) + " ms")
    parent_ms = {}
    for name in runs[0]["ms"]:
        par = [runs[0]["ms"][name], runs[3]["ms"][name]]
        new = [runs[1]["ms"][name], runs[2]["ms"][name]]
        print(f"[parent] {name}: parent {par[0]:.4f} / {par[1]:.4f} ms, this tree "
              f"{new[0]:.4f} / {new[1]:.4f} ms ({min(new) / min(par):.3f}x of the parent)")
        parent_ms[name] = float(np.median(par))
        for row in rows:
            if row["name"] == name:
                row["parent_ms"] = parent_ms[name]
    for tag, names in zip(("enc", "dec"), LSTM_GRAD_NAMES):
        same = [bool(torch.equal(a, b)) for a, b in zip(runs[0][tag], runs[1][tag])]
        print(f"[parent] {tag} gradients equal to the parent's bit for bit: "
              + ", ".join(f"d{n} {'yes' if s_ else 'no'}" for n, s_ in zip(names, same)))
        compare_grads(f"{tag} this tree vs parent", runs[1][tag], runs[0][tag], names)
        check(all(torch.equal(a, b) for a, b in zip(runs[1][tag], runs[2][tag])),
              f"{tag}: two runs of this tree gave different gradients")
    for cell, name, row, bf16 in PARENT_GATE_ROWS:
        new, par = runs[1]["gate_mse"][name], runs[0]["gate_mse"][name]
        if bf16:
            # a bf16 row may change its sums' order: each tree against this
            # tree's plain bf16 version, this tree within BF16_COMMITTED_TOL
            from shm_tpu_torch.ops import FUSED_GATES

            scorer, Zs = gate_row_inputs(cell, (N_BENCH,))
            w, kw = gate_row_call(cell, scorer.vae, True)
            ref = FUSED_GATES[cell][2](w, Zs[N_BENCH], **kw)[0].cpu().double()
            rel = lambda m: (m.double() - ref).abs() / ref.abs()
            tmax, tmean, _ = BF16_COMMITTED_TOL[cell]
            r_new, r_par = rel(new), rel(par)
            ok = float(r_new.max()) <= tmax and float(r_new.mean()) <= tmean
            print(f"[parent] row {row} mse at N={N_BENCH} against this tree's "
                  f"plain bf16 version, rel max / mean: this tree "
                  f"{float(r_new.max()):.3e} / {float(r_new.mean()):.3e}, parent "
                  f"{float(r_par.max()):.3e} / {float(r_par.mean()):.3e} "
                  f"(tolerance {tmax:g} / {tmean:g}) {'ok' if ok else 'FAIL'}")
            check(ok, f"row {row}: this tree disagrees with the plain bf16 version")
            del Zs
        else:
            print(f"[parent] row {row} mse at N={N_BENCH}, this tree against the "
                  f"parent's:")
            compare(f"{name} mse, this tree vs parent", new, par)
        check(torch.equal(new, runs[2]["gate_mse"][name]),
              f"row {row}: two runs of this tree gave different mse")
        print(f"[parent] row {row} mse of this tree's two runs: equal bit for bit")
    from shm_tpu_torch.tools.probe_mingru_recur import mingru_gate_reference, probe_inputs

    _, w9, Z9 = probe_inputs()
    for loop_T in PARENT_MINGRU_LOOPS:
        name = mingru_probe_name(loop_T, Z9.shape[0])
        new, par = runs[1]["mingru_probe"][name], runs[0]["mingru_probe"][name]
        ref = mingru_gate_reference(w9, Z9, loop_T, sum_dtype=torch.float64).cpu()
        print(f"[parent] row 9 {name} against the plain version with float64 sums "
              "(max_rel, mean_rel): this tree ({:.3e}, {:.3e}), parent ({:.3e}, "
              "{:.3e}); this tree against the parent's (its sums changed order):"
              .format(*rel_errs(new, ref), *rel_errs(par, ref)))
        compare_rel(f"row 9 {name} mse, this tree vs parent", new, par, PROBE_TOL["gate"])
        check(torch.equal(new, runs[2]["mingru_probe"][name]),
              f"row 9 {name}: two runs of this tree gave different mse")
    print("[parent] row 9 mse of this tree's two runs: equal bit for bit")
    del Z9
    torch.cuda.empty_cache()

    from shm_tpu_torch.tools.probe_f32_cliff import (
        make_inputs, matmul_loop, matmul_loop_reference,
    )

    def errs(got, ref):
        return (", ".join(f"{v:.3e}" for v in rel_errs(got, ref))
                + f", {over_one_bf16_ulp(got, ref)} of {ref.numel()} over one bf16 ulp")

    # every row 10 output is printed before any of its checks fails
    failures = []
    for name, par in runs[0]["probe"].items():
        new = runs[1]["probe"][name]
        mode, tiles = name.split("/")[1].split()[0], int(name.split()[1])
        same = bool(torch.equal(new, par))
        w, x = make_inputs(tiles, seed=tiles, device="cuda")
        ref = matmul_loop_reference(w, x, mode).cpu()
        print(f"[parent] row 10 {name}, this tree against the parent's: "
              f"{'equal bit for bit' if same else 'not bit for bit'}; against "
              f"the plain version (max_rel, mean_rel, elements): this tree "
              f"({errs(new, ref)}), parent ({errs(par, ref)})")
        if mode == "f32":
            if not same:
                failures.append(f"row 10 {name}: this tree's output is not the "
                                "parent's bit for bit, though it keeps every sum's order")
        else:
            # witnesses: the plain version's sums in float64, and this tree's
            # chained-sum instance (the body before the split)
            ref64 = matmul_loop_reference(w, x, mode, sum_dtype=torch.float64).cpu()
            chain = matmul_loop(w, x, mode, tc="chain").cpu()
            print(f"[parent] row 10 {name} against the plain version with float64 "
                  f"sums: this tree ({errs(new, ref64)}); parent ({errs(par, ref64)}); "
                  f"this tree's tc='chain' ({errs(chain, ref64)}, "
                  f"{'equal' if torch.equal(chain, par) else 'not equal'} to the "
                  f"parent's bit for bit); the plain version ({errs(ref, ref64)})")
            max_rel, mean_rel = rel_errs(new, ref)
            if mode == "bf16":
                tol = PROBE_TOL["matmul_bf16"]
                ok, what = max_rel <= tol[0] and mean_rel <= tol[1], f"PROBE_TOL {tol}"
            else:             # about float32 accuracy: the float32 tolerance
                ok = float(((new - ref).abs() - RTOL * ref.abs()).max()) <= ATOL
                what = f"{ATOL:g} + {RTOL:g}*|plain|"
            print(f"[parent] row 10 {name}, this tree within {what} of the plain "
                  f"version: {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"row 10 {name}: this tree disagrees with the plain "
                                f"version (max_rel {max_rel:.3e}, mean_rel {mean_rel:.3e})")
        if not torch.equal(new, runs[2]["probe"][name]):
            failures.append(f"row 10 {name}: two runs of this tree gave different outputs")
    check(not failures, "; ".join(failures))
    print("[parent] row 10 outputs of this tree's two runs: equal bit for bit")
    return parent_ms


# ---------------------------------------------------------------------------
# the probes (phase 9)
# ---------------------------------------------------------------------------

PROBES = {   # name in the kernels line: (source, the TPU kernel it replaces)
    "fused_vae_probe": ("shm_tpu_torch/ops/csrc/fused_vae.cu",
                        "tools/probe_vpu_bound.py:76"),
    "probe_mingru_gate": ("shm_tpu_torch/ops/csrc/probe_mingru_gate.cu",
                          "tools/probe_mingru_recur.py:49"),
    "probe_matmul_loop": ("shm_tpu_torch/ops/csrc/probe_matmul_loop.cu",
                          "tools/probe_f32_cliff.py:50"),
}
# The probes' bf16 paths against their plain versions. A stored bf16 value
# whose last bit flips when the two sum in another order moves by one bf16
# ulp and the recurrence carries it forward: that moves a few elements far.
# A kernel that drops or adds a rounding, or takes another LayerNorm eps,
# moves every element a little. So each path is held on (max |diff| /
# max |plain|, mean |diff| / mean |plain|), and the checks show that each
# tolerance fails such a planted fault. Measured on the card (PERF.md §6):
# gate_variant and make_gate, N=1000, T=100: kernel (1.5e-5, 8.8e-7); with
# bf16 activations (6 more roundings a cell, so more flips) (2.3e-5, 2.4e-6);
# the faults move the mean by 7.2e-6 (eps) to 1.4e-4 (float32). make_gate's
# tensor-core sums against the float64-sum plain version: (3.4e-5, 4.4e-7),
# and with loop_T=1, where one window's single flip reaches the max, (7.5e-5,
# 3.5e-7).
# matmul_loop bf16, T=100: kernel (4.8e-3, 4.3e-4); float32 instead of bf16
# moves the mean by 7.3e-3.
PROBE_TOL = {"gate": (1e-4, 2e-6), "gate_act_bf16": (1e-4, 5e-6),
             "matmul_bf16": (1e-2, 1e-3)}
# bf16x3 (three bf16 products) against the float32 loop's plain version at
# T=100: measured at most (1.2e-4, 3.3e-5) over 14 input seeds, where bf16
# alone is (1.4e-2, 6.2e-3) or more away
BF16X3_F32_TOL = (3e-4, 1e-4)
PROBE_REPS = 5


def rel_errs(got, ref):
    """(max |got - ref| / max |ref|, mean |got - ref| / mean |ref|)."""
    d, r = (got - ref).abs().double(), ref.abs().double()
    return float(d.max() / r.max()), float(d.mean() / r.mean())


def over_one_bf16_ulp(got, ref) -> int:
    """Elements of ``got`` more than one bf16 ulp (2^(e - 8) for |ref| in
    [2^(e-1), 2^e)) from ``ref``."""
    import torch

    ulp = torch.ldexp(torch.ones_like(ref), torch.frexp(ref)[1] - 8)
    return int(((got - ref).abs() > ulp).sum())


def compare_rel(name: str, got, ref, tol, tag: str = "[probe]") -> float:
    """Max |got - ref|; fails past either relative tolerance of ``tol``."""
    max_rel, mean_rel = rel_errs(got, ref)
    ok = max_rel <= tol[0] and mean_rel <= tol[1]
    print(f"{tag}   {name}: max_rel {max_rel:.3e} (<= {tol[0]:g}), mean_rel "
          f"{mean_rel:.3e} (<= {tol[1]:g}) {'ok' if ok else 'FAIL'}")
    check(ok, f"{name}: probe kernel disagrees with its plain version "
              f"(max_rel {max_rel:.3e}, mean_rel {mean_rel:.3e})")
    return float((got - ref).abs().max())


def planted_fault(name: str, got, wrong_ref, tol, tag: str = "[probe]") -> None:
    """``tol`` must tell the kernel's output from ``wrong_ref``, the plain
    version with one numerics knob changed."""
    max_rel, mean_rel = rel_errs(got, wrong_ref)
    caught = max_rel > tol[0] or mean_rel > tol[1]
    print(f"{tag}   planted fault, {name}: max_rel {max_rel:.3e}, mean_rel "
          f"{mean_rel:.3e} -> {'caught' if caught else 'MISSED'}")
    check(caught, f"the tolerance {tol} does not tell {name}")


def phase_probes_vs_plain():
    """Each probe kernel against its plain version on the card, random
    inputs from a numpy seed, and the planted faults each tolerance must
    fail. Returns the max |diff| per kernel."""
    import torch

    from shm_tpu_torch.ops import (
        fused_vae_gate, mingru_params_to_kernel_weights,
        vae_params_to_kernel_weights,
    )
    from shm_tpu_torch.tools.probe_f32_cliff import (
        MODES, make_inputs, matmul_loop, matmul_loop_reference,
    )
    from shm_tpu_torch.tools.probe_mingru_recur import (
        make_gate, mingru_gate_reference,
    )
    from shm_tpu_torch.tools.probe_vpu_bound import (
        A_F32, MODEL_LN_EPS, PORT_VARIANTS, SHIP_TC, VARIANTS, gate_variant,
        gate_variant_reference,
    )

    errs = dict.fromkeys(PROBES, 0.0)
    tol = PROBE_TOL["matmul_bf16"]
    for tiles in (1, 21, 34):         # 34: more than one wave of blocks
        w, x = make_inputs(tiles, seed=400 + tiles, device="cuda")
        f32_ref = matmul_loop_reference(w, x, "f32")
        for mode in MODES:
            out = matmul_loop(w, x, mode)
            torch.cuda.synchronize()
            ref = f32_ref if mode == "f32" else matmul_loop_reference(w, x, mode)
            check(out.shape == ref.shape and bool(torch.isfinite(out).all()),
                  f"matmul_loop/{mode}: not finite / wrong shape")
            name = f"matmul_loop/{mode} {tiles} tile(s), T=100"
            if mode == "bf16":
                e = compare_rel(name, out, ref, tol)
                planted_fault(f"{name} held against the float32 loop", out,
                              f32_ref, tol)
            else:
                e = compare(name, out, ref)
            if mode == "bf16x3":
                compare_rel(f"{name} against the float32 loop", out, f32_ref,
                            BF16X3_F32_TOL)
            errs["probe_matmul_loop"] = max(errs["probe_matmul_loop"], e)

    tol = PROBE_TOL["gate"]
    vae, rng = random_vae(410, 12, 16, 128, 2, True)
    w = vae_params_to_kernel_weights(vae)
    Z = torch.from_numpy(rng.normal(size=(1000, 100, 12)).astype(np.float32)).cuda()
    out = {}
    for name, kw in {**PORT_VARIANTS, **VARIANTS}.items():
        out[name] = gate_variant(w, Z, **kw)
        torch.cuda.synchronize()
        check(out[name].shape == (1000,) and bool(torch.isfinite(out[name]).all()),
              f"gate_variant {name}: not finite / wrong shape")
        ref = gate_variant_reference(w, Z, **kw)
        label = f"gate_variant {name} N=1000"
        # float32 operands (bf16 weights at most): the gate's float32 tolerance
        if kw.get("bf16", "all") != "all":
            e = compare(label, out[name], ref)
        else:
            e = compare_rel(label, out[name], ref,
                            PROBE_TOL["gate_act_bf16" if kw.get("act_bf16") else "gate"])
        errs["fused_vae_probe"] = max(errs["fused_vae_probe"], e)
    # A, the float32 FMA instance, against the plain version; T, the
    # tensor-core body at the model's eps, is the shipping kernel bit for bit
    a = gate_variant(w, Z, **A_F32)
    torch.cuda.synchronize()
    errs["fused_vae_probe"] = max(errs["fused_vae_probe"], compare(
        "gate_variant A (float32 FMA) N=1000", a, gate_variant_reference(w, Z, **A_F32)))
    ship = fused_vae_gate(w, Z, num_layers=2, use_layernorm=True,
                          with_residual=False)[0]
    check(torch.equal(out["T_tensor_cores"], ship),
          "gate_variant T (tc, eps 1e-5) is not fused_vae_gate bit for bit")
    print(f"[probe]   gate_variant T (tc={SHIP_TC!r}, bf16='none', eps 1e-5) == "
          "fused_vae_gate, bit for bit")
    planted_fault("gate_variant D held against float32 operands",
                  out["D_probe_baseline"], gate_variant_reference(w, Z, bf16="none"), tol)
    planted_fault("gate_variant D held against LayerNorm eps 1e-5",
                  out["D_probe_baseline"],
                  gate_variant_reference(w, Z, ln_eps=MODEL_LN_EPS), tol)
    planted_fault("gate_variant F held against B (bf16 activations added)",
                  out["F_tanh_bf16_act"],
                  gate_variant_reference(w, Z, sig_via_tanh=True), tol)
    planted_fault("gate_variant B held against F (bf16 activations dropped)",
                  out["B_sig_via_tanh"],
                  gate_variant_reference(w, Z, sig_via_tanh=True, act_bf16=True),
                  PROBE_TOL["gate_act_bf16"])

    # make_gate against its plain version with its sums in float64 (all but
    # exact, rounded to float32): with loop_T=1 one window's mse moves by a
    # single bf16 flip of step 0 as far as the max tolerance, and a float32
    # sum's order decides such flips. On these inputs the float32-sum plain
    # version is itself a flip (1.112e-4) from exact sums at one window,
    # where the kernel's sums agree with exact sums (PERF.md §6), so
    # it is printed as a witness beside the check
    vae, rng = random_vae(420, 12, 16, 128, 2, True, cell="min_gru")
    w = mingru_params_to_kernel_weights(vae)
    Z = torch.from_numpy(rng.normal(size=(1000, 100, 12)).astype(np.float32)).cuda()
    f64 = dict(sum_dtype=torch.float64)
    for loop_T in (100, 1):
        o = make_gate(loop_T)(w, Z)
        torch.cuda.synchronize()
        check(o.shape == (1000,) and bool(torch.isfinite(o).all()),
              f"make_gate({loop_T}): not finite / wrong shape")
        label = f"make_gate(loop_T={loop_T}) N=1000"
        ref, ref32 = (mingru_gate_reference(w, Z, loop_T, **f64),
                      mingru_gate_reference(w, Z, loop_T))
        fmt = lambda got, want: "({:.3e}, {:.3e})".format(*rel_errs(got, want))
        print(f"[probe]   witnesses, {label}, against the plain version with float64 "
              f"sums (max_rel, mean_rel): kernel {fmt(o, ref)}, the float32-sum plain "
              f"version {fmt(ref32, ref)}; kernel against the float32-sum plain "
              f"version {fmt(o, ref32)}")
        e = compare_rel(f"{label} against its plain version with float64 sums", o, ref, tol)
        planted_fault(f"{label} held against float32 scratch and operands", o,
                      mingru_gate_reference(w, Z, loop_T, bf16=False, **f64), tol)
        planted_fault(f"{label} held against LayerNorm eps 1e-5", o,
                      mingru_gate_reference(w, Z, loop_T, ln_eps=MODEL_LN_EPS, **f64), tol)
        errs["probe_mingru_gate"] = max(errs["probe_mingru_gate"], e)
    return errs


def graph_time_ms(fn, reps: int = PROBE_REPS) -> float:
    """Median device time of ``fn`` captured in a CUDA graph, by its replay:
    a loop of small launches timed without the host's dispatch between
    them. ``fn`` runs once on a side stream before the capture, as the
    capture needs (cuBLAS sets up its workspace there)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = time_ms(graph.replay, reps=reps, warm=1)
    del graph
    torch.cuda.empty_cache()
    return ms


def matmul_loop_library(w, x, dtype, T: int = 100):
    """``matmul_loop``'s function as a T-step loop of ``torch.matmul`` in
    ``dtype``: a yardstick timed here only."""
    import torch

    H = w.shape[1]
    wd, h = w.to(dtype), x[:H].clone()
    for _ in range(T):
        g = torch.matmul(wd, h.to(dtype)).float()
        h = torch.tanh(g[:H]) * 0.25 + h * 0.75
    return h


def matmul_loop_library_bf16x3(w, x, T: int = 100):
    """bf16x3's yardstick: a T-step loop of three bf16 ``torch.matmul``
    calls a step (W_hi h_hi, W_hi h_lo, W_lo h_hi), timed here only. Each
    call returns bf16, so it times the products, not bf16x3's accuracy."""
    import torch

    H = w.shape[1]
    w_hi = w.bfloat16()
    w_lo = (w - w_hi.float()).bfloat16()
    h = x[:H].clone()
    for _ in range(T):
        hb = h.bfloat16()
        hl = (h - hb.float()).bfloat16()
        g = (torch.matmul(w_hi, hb).float() + torch.matmul(w_hi, hl).float()
             + torch.matmul(w_lo, hb).float())
        h = torch.tanh(g[:H]) * 0.25 + h * 0.75
    return h


def phase_probe_path(errs, wl):
    """The probe path: the three probes' tables at the TPU probes' sizes on
    the trained 4DOF workload ``wl``, launch counts from 0; then each kernel
    row's plain, library and bound."""
    import torch

    from shm_tpu_torch.ops import vae_params_to_kernel_weights
    from shm_tpu_torch.tools import (
        probe_f32_cliff, probe_mingru_recur, probe_vpu_bound,
    )
    from shm_tpu_torch.tools.workload import (
        PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_F32_FLOPS, bound_ms,
    )

    vae8 = wl.vae.cuda()
    w8 = vae_params_to_kernel_weights(vae8)
    Z8 = torch.from_numpy(probe_vpu_bound.tiled_windows(wl)).cuda()
    vae9, w9, Z9 = probe_mingru_recur.probe_inputs()
    counters = {"fused_vae_probe": probe_vpu_bound.gate_variant,
                "probe_mingru_gate": probe_mingru_recur.make_gate,
                "probe_matmul_loop": probe_f32_cliff.matmul_loop}

    for fn in counters.values():
        fn.launches = 0
    rows8 = probe_vpu_bound.probe_table(w8, Z8, wl.threshold, PROBE_REPS)
    rows9 = probe_mingru_recur.probe_table(w9, Z9, PROBE_REPS)
    rows10 = probe_f32_cliff.probe_table(reps=PROBE_REPS)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    for tag, rows in (("probe_vpu_bound", rows8), ("probe_mingru_recur", rows9),
                      ("probe_f32_cliff", rows10)):
        for row in rows:
            print(f"[{tag}] {json.dumps(row)}")
    print(f"[probe] launches on the probe path: {launches}")
    check(all(launches.values()), f"a probe kernel was not launched: {launches}")
    for row in rows8[1:]:
        check(row["gate_agree"] >= 0.99, f"{row['variant']}: gate decisions "
                                         f"agree on {row['gate_agree']:.4f} < 0.99")

    ms8 = next(r["ms"] for r in rows8 if r["variant"] == "D_probe_baseline")
    ms9 = next(r["ms"] for r in rows9 if r.get("run") == "probe clone (full T)")
    ms10 = next(r["ms"] for r in rows10 if r["probe"] == "matmul_loop/f32")
    w, x = probe_f32_cliff.make_inputs(device="cuda")
    plain = {
        "fused_vae_probe": time_ms(lambda: probe_vpu_bound.gate_variant_reference(
            w8, Z8), reps=2, warm=1),
        "probe_mingru_gate": time_ms(
            lambda: probe_mingru_recur.mingru_gate_reference(w9, Z9), reps=2, warm=1),
        "probe_matmul_loop": time_ms(
            lambda: probe_f32_cliff.matmul_loop_reference(w, x, "f32"), reps=3, warm=1),
    }
    lib8, lib9 = cudnn_vae_pass(vae8), scan_mingru_pass(vae9)
    # row 10's yardsticks: T steps of small calls each, so timed as graphs
    lib10 = {"f32": graph_time_ms(lambda: matmul_loop_library(w, x, torch.float32)),
             "bf16": graph_time_ms(lambda: matmul_loop_library(w, x, torch.bfloat16)),
             "bf16x3": graph_time_ms(lambda: matmul_loop_library_bf16x3(w, x))}
    library = {
        "fused_vae_probe": time_ms(lambda: lib8(Z8), reps=3, warm=1),
        "probe_mingru_gate": time_ms(lambda: lib9(Z9), reps=3, warm=1),
        "probe_matmul_loop": lib10["f32"],
    }
    n = Z8.shape[0]
    work = {
        "fused_vae_probe": vae_work(n, 100, 12, 128, 16, 2, with_residual=False),
        "probe_mingru_gate": mingru_work(n, 100, 12, 128, 16, 2, with_residual=False),
        "probe_matmul_loop": (probe_f32_cliff.matmul_loop_flops(x.shape[1], "f32"),
                              4.0 * (w.numel() + x.numel() + x.shape[1] * 128)),
    }
    ms = {"fused_vae_probe": ms8, "probe_mingru_gate": ms9, "probe_matmul_loop": ms10}
    # rows 8 and 9 (variant D, the clone) multiply bf16 operands, as the TPU
    # probes' `mm` does: their bound is at the bf16 tensor-core rate, though
    # the kernels run the FMA pipes (that figure: bound_fma_ms); row 10 is
    # its f32 mode
    rows = []
    for name, (source, replaces) in PROBES.items():
        flops, nbytes = work[name]
        peak = PEAK_F32_FLOPS if name == "probe_matmul_loop" else PEAK_BF16_FLOPS
        bound, bound_by = bound_ms(flops, nbytes, peak)
        fma_ms = flops / PEAK_F32_FLOPS * 1e3
        print(f"[probe] {name}: kernel {ms[name]:.4f} ms | plain {plain[name]:.4f} "
              f"ms | library {library[name]:.4f} ms | work {flops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB -> bound {bound:.4f} ms ({bound_by}, "
              f"{'f32' if peak == PEAK_F32_FLOPS else 'bf16 tensor-core'} rate; "
              f"f32 FMA pipes {fma_ms:.4f}, bytes {nbytes / PEAK_BYTES * 1e3:.4f}); "
              f"kernel at {bound / ms[name] * 100:.1f}% of the bound, "
              f"{fma_ms / ms[name] * 100:.1f}% of the FMA-pipe figure")
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=errs[name], ms=ms[name],
            plain_ms=plain[name], bound_ms=bound, bound_by=bound_by,
            library_ms=library[name], bound_fma_ms=fma_ms))
    # row 9: the project-then-sweep structure moves its scratch through
    # device memory, a bound of its own beside the function's; how the card
    # takes the kernel (blocks an SM, waves of its grid)
    row9, n9 = rows[1], Z9.shape[0]
    info = probe_mingru_recur.kernel_info()
    blocks = -(-n9 // info["windows_per_block"])
    per_wave = info["blocks_per_sm"] * torch.cuda.get_device_properties(0).multi_processor_count
    waves = blocks / per_wave
    row9.update(windows=n9, info=info, waves=waves, ms_loop_T_1=next(
        r["ms"] for r in rows9 if r.get("run") == "loops truncated to 1"))
    # what the last, partly filled wave costs: the same calls on the first
    # windows that fill whole waves only
    Zw = Z9[:int(waves) * per_wave * info["windows_per_block"]]
    row9["whole_waves"] = {"windows": Zw.shape[0], "waves": int(waves), "ms": time_ms(
        lambda: probe_mingru_recur.make_gate(None)(w9, Zw), reps=PROBE_REPS), "ms_loop_T_1":
        time_ms(lambda: probe_mingru_recur.make_gate(1)(w9, Zw), reps=PROBE_REPS)}
    print(f"[probe] probe_mingru_gate on whole waves only: {row9['whole_waves']}")
    for loop_T, key in ((None, "bound_scratch_ms"), (1, "bound_scratch_ms_loop_T_1")):
        row9[key] = probe_mingru_recur.scratch_bytes_moved(n9, loop_T=loop_T) / PEAK_BYTES * 1e3
    print(f"[probe] probe_mingru_gate: {info}; {blocks} blocks, {waves:.2f} waves | "
          f"full T {row9['ms']:.4f} ms, scratch bytes bound {row9['bound_scratch_ms']:.4f} "
          f"ms ({row9['bound_scratch_ms'] / row9['ms'] * 100:.1f}%) | loop_T=1 "
          f"{row9['ms_loop_T_1']:.4f} ms, scratch bytes bound "
          f"{row9['bound_scratch_ms_loop_T_1']:.4f} ms "
          f"({row9['bound_scratch_ms_loop_T_1'] / row9['ms_loop_T_1'] * 100:.1f}%)")
    # row 10 by mode: the kernel against its bound with one SM a tile (the
    # TPU probe's grid) and at the grid the C entry launches, and its
    # yardstick; the kernels row reports the f32 mode
    by_mode = {}
    for r in rows10:
        if not r["probe"].startswith("matmul_loop/") or r["probe"].endswith("/vpu"):
            continue
        mode = r["probe"].split("/")[1]
        blocks = probe_f32_cliff._library().shm_probe_matmul_loop_blocks(
            x.shape[1], probe_f32_cliff.MODES.index(mode))
        check(blocks == r["blocks"], f"matmul_loop/{mode}: the C entry launches "
                                     f"{blocks} blocks, its Python mirror {r['blocks']}")
        by_mode[mode] = dict(ms=r["ms"], blocks=blocks,
                             bound_ms_grid=r["bound_ms_grid"], library_ms=lib10[mode])
        print(f"[probe] matmul_loop/{mode}: kernel {r['ms']:.4f} ms on {blocks} "
              f"blocks | bound {r['bound_ms']:.4f} ms card, {r['bound_ms_per_sm']:.4f} "
              f"one SM a tile, {r['bound_ms_grid']:.4f} at the launched grid (kernel "
              f"at {r['bound_ms_grid'] / r['ms'] * 100:.1f}% of it) | library "
              f"{lib10[mode]:.4f} ms (kernel {r['ms'] / lib10[mode]:.3f}x of it)")
    rows[-1]["by_mode"] = by_mode
    return rows


# ---------------------------------------------------------------------------
# the serving surface on the card (phase 11)
# ---------------------------------------------------------------------------

# p_struct of one window scored in two batches of other sizes: the gate
# kernels compute each window alone (mse, decisions exact), but cuDNN picks
# the CNN's convolution algorithm per batch shape, so p(structural) may move
# in its last bits between buckets; this bound, and the largest difference
# the card gives (printed), are in PERF.md §5
P_STRUCT_ATOL = 1e-6
SERVE_TOKEN = "chip-smoke-admin"
SERVE_RUNS = ("data/4dof/raw/normal/normal_seed2025.csv",
              "data/4dof/raw/faults/structural_fault/stiff_red_20pct/"
              "stiff_red_20pct.csv")
CONCURRENT_CLIENTS = 8
CONCURRENT_WINDOWS = 680            # a client's request; 5,440 in all
CONCURRENT_ROUNDS = 3               # the first is the dispatcher's first use
SERVE_REPS = 5
_SERVE_KEYS = ("mse", "anomalous", "y_pred", "p_struct")
# phase 3's gate decisions on the 3,636 test windows, by family
PHASE3_GATE = {}


class Client:
    """Requests to one of phase 11's servers; replies as numpy dicts."""

    def __init__(self, srv):
        self.base = f"http://127.0.0.1:{srv.server_address[1]}"

    def request(self, path: str, data=None, headers=None, method=None):
        """``(status, headers, body)``; an HTTP error is returned, not raised."""
        import urllib.error
        import urllib.request

        r = urllib.request.Request(self.base + path, data=data,
                                   headers=headers or {}, method=method)
        try:
            with urllib.request.urlopen(r, timeout=600) as resp:
                return resp.status, resp.headers, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.headers, e.read()

    def json(self, path: str, **kw):
        code, _, body = self.request(path, **kw)
        return code, json.loads(body)

    def score(self, W, path: str = "/score", stride=None, npz: bool = True):
        """Post a window stack (or, to /score_series, a series) as
        octet-stream; the reply, read from its npz."""
        import io

        hdr = {"Content-Type": "application/octet-stream",
               "X-Shape": ",".join(map(str, W.shape))}
        if npz:
            hdr["Accept"] = "application/octet-stream"
        if stride is not None:
            hdr["X-Stride"] = str(stride)
        code, _, body = self.request(path, data=np.ascontiguousarray(
            W, np.float32).tobytes(), headers=hdr, method="POST")
        check(code == 200, f"{path}: HTTP {code}: {body[:300]!r}")
        if not npz:
            return json.loads(body)
        z = np.load(io.BytesIO(body))
        return {k: z[k] for k in z.files}


class DispatchLog:
    """A scorer as the concurrent server's batcher sees it: every
    ``score()`` call's start and end on the host clock, and its windows."""

    def __init__(self, scorer):
        self._scorer = scorer
        self.calls = []

    def __getattr__(self, name):
        return getattr(self._scorer, name)

    def score(self, W):
        t0 = time.perf_counter()
        out = self._scorer.score(W)
        self.calls.append((t0, time.perf_counter(), len(W)))
        return out


def concurrent_round(cc, log, reqs, single, name: str, times: dict) -> float:
    """Every request of ``reqs`` from its own client thread, all released
    at once, to the concurrent server of ``cc``; each reply against its
    single-threaded reply. Records and prints the round's wall time,
    windows/s, p50 and the batcher's dispatches; returns max |p_struct
    diff|."""
    import threading

    replies, errors, secs = {}, {}, {}
    barrier = threading.Barrier(len(reqs) + 1)

    def client(i):
        try:
            barrier.wait(60)
            t1 = time.perf_counter()
            replies[i] = cc.score(reqs[i])
            secs[i] = time.perf_counter() - t1
        except BaseException as e:                  # noqa: BLE001 - reported
            errors[i] = repr(e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    log.calls.clear()
    barrier.wait(60)
    t0 = time.perf_counter()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    check(not errors, f"{name}: clients failed: {errors}")
    worst = max(same_outputs(f"{name}: request {i} vs its single-threaded "
                             "reply", replies[i], single[i])
                for i in range(len(reqs)))
    n = sum(len(W) for W in reqs)
    p50 = float(np.median(list(secs.values())))
    times[name] = dict(wall_s=wall, windows_per_s=n / wall, p50_s=p50,
                       dispatches=[(k, a0 - t0, a1 - a0)
                                   for a0, a1, k in log.calls])
    print(f"[serve] {name}: {len(reqs)} clients x {len(reqs[0])} windows in "
          f"{wall * 1e3:.1f} ms = {n / wall:,.0f} windows/s; p50 per request "
          f"{p50 * 1e3:.1f} ms; dispatches (windows, start after release ms, "
          f"score() ms) {[(k, round(s0 * 1e3, 1), round(d * 1e3, 1)) for k, s0, d in times[name]['dispatches']]}; "
          f"each reply equals its single-threaded reply")
    return worst


def serve_in_thread(srv):
    import threading

    threading.Thread(target=srv.serve_forever, name="chip-smoke-server",
                     daemon=True).start()
    return srv


def stop_server(srv) -> None:
    srv.shutdown()
    srv.server_close()
    for part in (srv.batcher, srv.shadow):
        if part is not None:
            part.close()


def same_outputs(tag: str, got: dict, ref: dict) -> float:
    """mse, anomalous and y_pred bit for bit; p_struct within P_STRUCT_ATOL.
    Returns max |p_struct diff|."""
    for k in ("mse", "anomalous", "y_pred"):
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        check(g.shape == r.shape, f"{tag}: {k} shape {g.shape} != {r.shape}")
        check(np.array_equal(g.astype(r.dtype), r),
              f"{tag}: {k} differs on {int((g.astype(r.dtype) != r).sum())} "
              f"windows (max |diff| "
              f"{float(np.abs(g.astype(np.float64) - r).max()):.3e})")
    d = float(np.abs(np.asarray(got["p_struct"], np.float64)
                     - ref["p_struct"]).max()) if len(ref["mse"]) else 0.0
    check(d <= P_STRUCT_ATOL, f"{tag}: p_struct off by {d:.3e} "
                              f"(> {P_STRUCT_ATOL:g})")
    return d


def drain(shadow, timeout: float = 300.0) -> None:
    """Wait until the shadow has scored everything it admitted."""
    t0 = time.perf_counter()
    while shadow.snapshot()["pending_windows"]:
        check(time.perf_counter() - t0 < timeout, "the shadow did not drain")
        time.sleep(0.01)


def shadow_expected(scorer, shadow_scorer, admitted) -> dict:
    """The agreement counters of the shadow, computed directly: each
    admitted request scored by the candidate, against the primary's reply."""
    want = dict(windows=0, gate_agree=0, pred_agree=0, shadow_anomalous=0)
    for kind, data, stride, ref in admitted:
        out = (shadow_scorer.score_series(data, stride=stride)
               if kind == "series" else shadow_scorer.score(data))
        want["windows"] += len(ref["mse"])
        want["gate_agree"] += int((out["anomalous"] == ref["anomalous"]).sum())
        want["pred_agree"] += int((out["y_pred"] == ref["y_pred"]).sum())
        want["shadow_anomalous"] += int(out["anomalous"].sum())
    return want


def phase_serving(W) -> dict:
    """Phase 11: the port's HTTP daemon on the card (``make_server`` over
    ``HybridScorer.from_artifacts``): /score and /score_series against the
    scorer called directly, a StreamScorer, the concurrent mode's batcher,
    the shadow's counters, the admin surface and drift, the attention root;
    then request times. Returns each gate kernel's launches by step (every
    count at 0 just before its step)."""
    import threading

    import torch

    from shm_tpu_torch.calibrate import percentile_threshold
    from shm_tpu_torch.cli.stage4dof import Paths, build_fraction_windows
    from shm_tpu_torch.config import Stage4DofConfig
    from shm_tpu_torch.data.windows import normalize_windows
    from shm_tpu_torch.ops import _build
    from shm_tpu_torch.serve import HybridScorer, StreamScorer
    from shm_tpu_torch.serve_http import make_server
    from shm_tpu_torch.train import reconstruction_mse
    from shm_tpu_torch.utils.io import load_csv_numeric, load_json

    tag = "[serve]"
    card = gpu_line()
    print(f"{tag} {card}")
    launches, times = {}, {}
    p_worst = 0.0

    def step(name: str) -> None:
        launches[name] = gate_counts(reset=True)

    lstm_gate = FAMILIES["lstm"]["kernel"]
    gate_counts(reset=True)
    t0 = time.perf_counter()
    scorer = HybridScorer.from_artifacts(ROOT / "data" / "4dof")
    shadow_scorer = HybridScorer.from_artifacts(ROOT / "data" / "4dof_mingru")
    check(scorer.expected_anomaly_rate is not None
          and abs(scorer.expected_anomaly_rate - 0.01) < 1e-12
          and scorer.calibration_percentile == 99.0,
          f"manifest fields {scorer.expected_anomaly_rate} "
          f"{scorer.calibration_percentile}")
    srv = serve_in_thread(make_server(
        scorer, port=0, series_strides=(1, 2), admin=True,
        admin_token=SERVE_TOKEN, shadow_scorer=shadow_scorer,
        reload_fn=lambda: HybridScorer.from_artifacts(ROOT / "data" / "4dof")))
    servers = [srv]
    try:
        c = Client(srv)
        check(srv.warm_event.wait(600), "the server's warmup did not end")
        err = srv.RequestHandlerClass.warm_error
        check(err is None, f"warmup failed: {err}")
        while not srv.shadow.snapshot()["warmed"]:
            time.sleep(0.01)
        check(srv.shadow.warm_error is None,
              f"the shadow's warmup failed: {srv.shadow.warm_error}")
        code, health = c.json("/healthz")
        check(code == 200 and health["warm"], f"/healthz {code} {health}")
        print(f"{tag} the server's scorer and its shadow loaded and warmed "
              f"(buckets {list(scorer.buckets())}, strides 1 and 2; the "
              f"shadow after the primary) in {time.perf_counter() - t0:.2f} s")
        step("warmup")
        libs = set(_build._LOADED)
        torch.cuda.synchronize()
        reserved = torch.cuda.memory_reserved()
        admitted = []          # what the shadow was given: (kind, data, stride, reply)

        # --- /score: the 3,636 test windows as octet-stream (npz reply),
        # the first 64 as JSON; against score() called directly
        t1 = time.perf_counter()
        out = c.score(W)
        first_s = time.perf_counter() - t1
        drain(srv.shadow)
        admitted.append(("windows", W, None, out))
        t1 = time.perf_counter()
        again = c.score(W)
        times.update(first_score_s=first_s,
                     second_score_s=time.perf_counter() - t1)
        drain(srv.shadow)
        admitted.append(("windows", W, None, again))
        print(f"{tag} /score of {len(W)} windows: the server thread's first "
              f"request {first_s * 1e3:.1f} ms, the same again "
              f"{times['second_score_s'] * 1e3:.1f} ms")
        direct = scorer.score(W)
        same_outputs("/score npz vs score()", out, direct)
        check(np.array_equal(out["anomalous"], PHASE3_GATE["lstm"]),
              "/score: gate decisions differ from phase 3's")
        js = c.score(W[:64], npz=False)
        drain(srv.shadow)
        js = {k: np.asarray(js[k], np.float32 if k in ("mse", "p_struct")
                            else None) for k in _SERVE_KEYS}
        admitted.append(("windows", W[:64], None, js))
        same_outputs("/score JSON vs score()", js, scorer.score(W[:64]))
        # the same windows in the 256 and the 4,096 bucket
        p_worst = max(p_worst, same_outputs(
            "/score JSON (256 bucket) vs the 4,096 bucket",
            js, {k: v[:64] for k, v in direct.items()}))
        print(f"{tag} /score: {len(W)} windows (npz) and 64 (JSON) equal "
              f"score() called directly; gate decisions those of phase 3 "
              f"({int(out['anomalous'].sum())} anomalous)")
        step("/score")

        # --- /score_series at the warmed strides; stride 3 refused; a
        # StreamScorer in uneven chunks
        for rel in SERVE_RUNS:
            x = load_csv_numeric(ROOT / rel, scorer.num_features)
            for stride in (1, 2):
                got = c.score(x, path="/score_series", stride=stride)
                drain(srv.shadow)
                admitted.append(("series", x, stride, got))
                ref = scorer.score_series(x, stride=stride)
                same_outputs(f"/score_series {Path(rel).name} stride "
                             f"{stride} vs score_series()", got, ref)
                stream = StreamScorer(scorer, stride=stride)
                chunks, i, k = [], 0, 0
                while i < len(x):
                    n = (37, 250, 1, 400, 99)[k % 5]
                    chunks.append(stream.push(x[i:i + n]))
                    i, k = i + n, k + 1
                st = {key: np.concatenate([o[key] for o in chunks])
                      for key in chunks[0]}
                check(np.array_equal(st["window_start"],
                                     stride * np.arange(len(ref["mse"]))),
                      "StreamScorer window_start")
                p_worst = max(p_worst, same_outputs(
                    f"StreamScorer {Path(rel).name} stride {stride} in "
                    f"{len(chunks)} chunks vs score_series()", st, ref))
                print(f"{tag} /score_series {Path(rel).name} stride {stride}: "
                      f"{len(ref['mse'])} windows equal score_series(); "
                      f"StreamScorer in {len(chunks)} uneven chunks the same "
                      f"(drift windows {stream.monitor.snapshot()['windows']})")
        code, body = c.json("/score_series", data=x.tobytes(), headers={
            "Content-Type": "application/octet-stream",
            "X-Shape": f"{x.shape[0]},{x.shape[1]}", "X-Stride": "3"},
            method="POST")
        check(code == 422, f"/score_series stride 3: HTTP {code} {body}")
        torch.cuda.synchronize()
        grown = torch.cuda.memory_reserved() - reserved
        print(f"{tag} after warmup, /score and /score_series loaded "
              f"{sorted(set(_build._LOADED) - libs) or 'no'} new kernel "
              f"library and reserved {grown} more device bytes "
              f"({reserved} reserved)")
        check(set(_build._LOADED) == libs and grown == 0,
              "a warmed request built a kernel or reserved device memory")
        step("/score_series and StreamScorer")

        # --- the shadow's counters against the agreement computed directly
        snap = srv.shadow.snapshot()
        want = shadow_expected(scorer, shadow_scorer, admitted)
        got = {k: snap[k] for k in want}
        print(f"{tag} shadow (data/4dof_mingru): {got}; computed directly "
              f"{want}; dropped {snap['dropped_windows']} windows, errors "
              f"{snap['errors']}, max |mse diff| {snap['mse_absdiff_max']:.4g}")
        check(got == want and snap["dropped_windows"] == 0
              and snap["errors"] == 0 and snap["requests_scored"]
              == len(admitted), "the shadow's counters are wrong")
        _, _, text = c.request("/metrics")
        text = text.decode()
        for k in ("windows", "gate_agree", "pred_agree"):
            check(f"shm_shadow_{k}_total {want[k]}\n" in text,
                  f"shm_shadow_{k}_total is not {want[k]} on /metrics")
        launches["shadow (direct check)"] = gate_counts(reset=True)

        # --- concurrent mode: 8 clients of 680 windows at once, each reply
        # against the single-threaded server's reply to the same request
        reqs = [np.ascontiguousarray(
            np.resize(W, (N_BENCH,) + W.shape[1:])[i::CONCURRENT_CLIENTS])
            for i in range(CONCURRENT_CLIENTS)]
        single, single_s = [], []
        for Wi in reqs:
            t1 = time.perf_counter()
            single.append(c.score(Wi))
            single_s.append(time.perf_counter() - t1)
            drain(srv.shadow)
            admitted.append(("windows", Wi, None, single[-1]))
        # a fresh host thread's first scoring call against its second and
        # the main thread's (PyTorch makes its cuBLAS and cuDNN handles per
        # thread, at the thread's first use)
        fresh = []

        def twice():
            for _ in range(2):
                t1 = time.perf_counter()
                scorer.score(reqs[0])
                fresh.append(time.perf_counter() - t1)

        th = threading.Thread(target=twice)
        th.start()
        th.join(600)
        t1 = time.perf_counter()
        scorer.score(reqs[0])
        main_s = time.perf_counter() - t1
        times.update(fresh_thread_first_s=fresh[0], fresh_thread_second_s=fresh[1],
                     main_thread_s=main_s)
        print(f"{tag} score() of {CONCURRENT_WINDOWS} windows: a fresh "
              f"thread's first call {fresh[0] * 1e3:.1f} ms, its second "
              f"{fresh[1] * 1e3:.1f} ms; the main thread {main_s * 1e3:.1f} ms")
        log = DispatchLog(scorer)
        conc = serve_in_thread(make_server(log, port=0, warmup=False,
                                           concurrent=True))
        servers.append(conc)
        cc = Client(conc)
        step("single-threaded requests")
        for rnd in range(1, CONCURRENT_ROUNDS + 1):
            name = f"concurrent round {rnd}"
            p_worst = max(p_worst, concurrent_round(
                cc, log, reqs, single, name, times))
            step(name)
            n_round = launches[name][lstm_gate]
            print(f"{tag}   {lstm_gate} launches {n_round} ({card})")
            check(0 < n_round < CONCURRENT_CLIENTS,
                  f"{name} launched {lstm_gate} {n_round} times for "
                  f"{CONCURRENT_CLIENTS} requests: not coalesced")
        # the same rounds with the listen backlog at socketserver's default
        # of 5, which the daemon raises (serve_http._Server): a connection
        # past it is retried by the client's TCP stack after a second
        conc.socket.listen(5)
        for rnd in range(1, CONCURRENT_ROUNDS + 1):
            name = f"concurrent round {rnd}, backlog 5"
            p_worst = max(p_worst, concurrent_round(
                cc, log, reqs, single, name, times))
            step(name)
        times["single_p50_s"] = float(np.median(single_s))
        print(f"{tag} single-threaded server, one {CONCURRENT_WINDOWS}-window "
              f"request at a time: p50 {times['single_p50_s'] * 1e3:.1f} ms")

        # --- request times at bench.py's workload, the shadow drained
        # between requests so that it never drops
        Wb = np.ascontiguousarray(np.resize(W, (N_BENCH,) + W.shape[1:]))
        ts, td, timed = [], [], []
        for _ in range(SERVE_REPS):
            t1 = time.perf_counter()
            timed.append(c.score(Wb))
            ts.append(time.perf_counter() - t1)
            drain(srv.shadow)
            t1 = time.perf_counter()
            scorer.score(Wb)
            td.append(time.perf_counter() - t1)
        times.update(score_http_ms=float(np.median(ts)) * 1e3,
                     score_direct_ms=float(np.median(td)) * 1e3)
        print(f"{tag} /score of {N_BENCH} windows through the socket: median "
              f"of {SERVE_REPS} {times['score_http_ms']:.2f} ms; score() "
              f"called directly {times['score_direct_ms']:.2f} ms ({card})")
        step("timing")

        # --- the shadow, once more with the timing's requests
        snap = srv.shadow.snapshot()
        times["shadow_dropped_windows"] = snap["dropped_windows"]
        check(snap["dropped_windows"] == 0 and snap["errors"] == 0,
              f"the shadow dropped {snap['dropped_windows']} windows")

        # --- admin: /recalibrate on the threshold command's healthy windows
        # at the manifest's percentile; /reload; a request without the token
        cfg = Stage4DofConfig()
        paths = Paths(str(ROOT / "data" / "4dof"))
        Wn = build_fraction_windows(load_json(paths.run_splits)["normal"]["files"],
                                    cfg.val_frac, cfg)
        # (refused before the body is read, as the JAX daemon does: the
        # request carries none)
        code, _ = c.json("/recalibrate", data=b"", method="POST")
        check(code == 401, f"/recalibrate without the token: HTTP {code}")
        tok = {"X-Admin-Token": SERVE_TOKEN}
        code, rec = c.json("/recalibrate", data=Wn.tobytes(), headers={
            **tok, "Content-Type": "application/octet-stream",
            "X-Shape": ",".join(map(str, Wn.shape))}, method="POST")
        check(code == 200, f"/recalibrate: HTTP {code} {rec}")
        Z = normalize_windows(torch.from_numpy(Wn).cuda(), scorer.mean,
                              scorer.std)
        want_thr = percentile_threshold(reconstruction_mse(scorer.vae, Z),
                                        cfg.threshold_percentile)
        rel = abs(rec["threshold"] / want_thr - 1)
        committed = load_json(paths.processed / "vae_threshold.json")["threshold"]
        print(f"{tag} /recalibrate on {len(Wn)} healthy windows at p"
              f"{rec['percentile']:g}: threshold {rec['threshold']:.7f}; "
              f"percentile_threshold of reconstruction_mse {want_thr:.7f} "
              f"(rel {rel:.2e}); the committed file's {committed:.7f}")
        check(rec["n_windows"] == len(Wn) and rec["percentile"] == 99.0
              and rel <= 1e-6, "/recalibrate's threshold is off")
        drain(srv.shadow)
        code, body = c.json("/reload", data=b"", headers=tok, method="POST")
        check(code == 202, f"/reload: HTTP {code} {body}")
        while True:
            _, state = c.json("/reload", headers=tok)
            if state["state"] in ("done", "failed"):
                break
            time.sleep(0.05)
        check(state["state"] == "done" and state["generation"] == 1,
              f"/reload ended {state}")
        new_scorer = srv.RequestHandlerClass.engine[0]
        check(new_scorer is not scorer
              and float(new_scorer.threshold) == float(committed),
              "/reload did not restore the committed threshold")
        out2 = c.score(W)
        drain(srv.shadow)
        check(np.array_equal(out2["anomalous"], PHASE3_GATE["lstm"]),
              "after /reload: gate decisions differ from phase 3's")
        code, m = c.json("/metrics", headers={"Accept": "application/json"})
        _, _, text = c.request("/metrics")
        text = text.decode()
        # every reply this server gave /score and /score_series
        served = [a[3] for a in admitted] + timed + [out2]
        n_scored = sum(len(r["mse"]) for r in served)
        n_flagged = sum(int(np.sum(r["anomalous"])) for r in served)
        classes = np.bincount(np.concatenate([np.asarray(r["y_pred"], int)
                                              for r in served]), minlength=3)
        d = m["drift"]
        print(f"{tag} /metrics: {m['windows_scored']} windows scored, "
              f"{m['windows_anomalous']} flagged, classes "
              f"{m['pred_class_counts']}; drift after /reload: "
              f"{d['windows']} windows, {d['anomalous']} anomalous, expected "
              f"rate {d['expected_rate']:g}, EWMA {d['ewma_rate']:.4f}, "
              f"alert high {d['alert_high']}")
        check(m["windows_scored"] == n_scored
              and m["windows_anomalous"] == n_flagged
              and list(m["pred_class_counts"].values()) == classes.tolist(),
              f"/metrics counts {m['windows_scored']} / "
              f"{m['windows_anomalous']} / {m['pred_class_counts']} differ "
              f"from the replies' {n_scored} / {n_flagged} / "
              f"{classes.tolist()}")
        check(d["expected_rate"] == scorer.expected_anomaly_rate
              and d["windows"] == len(W)
              and d["anomalous"] == int(PHASE3_GATE["lstm"].sum()),
              "drift gauges do not follow the traffic after /reload")
        check("shm_drift_expected_rate 0.01" in text
              and f"shm_windows_scored_total {n_scored}" in text,
              "Prometheus text lacks the drift or window counters")
        step("admin")

        # --- the attention root through its own server
        att = serve_in_thread(make_server(
            HybridScorer.from_artifacts(ROOT / "data" / "4dof_attention"),
            port=0))
        servers.append(att)
        check(att.warm_event.wait(600)
              and att.RequestHandlerClass.warm_error is None,
              "the attention server did not warm")
        gate_counts(reset=True)
        outa = Client(att).score(W)
        check(np.array_equal(outa["anomalous"], PHASE3_GATE["attention"]),
              "attention /score: gate decisions differ from phase 3's")
        step("attention /score")
        print(f"{tag} attention root /score of {len(W)} windows: gate "
              f"decisions those of phase 3; "
              f"{launches['attention /score']}")
    finally:
        for s in servers:
            stop_server(s)
    times["p_struct_max_abs_diff"] = p_worst
    print(f"{tag} p_struct, one window in two batches of other sizes: max "
          f"|diff| {p_worst:.3e} (bound {P_STRUCT_ATOL:g}); mse, gate and "
          f"y_pred bit for bit")
    print(f"{tag} launches by step: {launches}")
    print(f"{tag} times {json.dumps(times)}")
    for name, want_kernel in (("/score", "fused_vae_gate"),
                              ("/score", "fused_mingru_gate"),
                              ("attention /score", "fused_attention_gate")):
        check(launches[name][want_kernel] > 0,
              f"phase 11 step {name} did not launch {want_kernel}")
    out = {}
    for name, counts in launches.items():
        for k, n in counts.items():
            if n:
                out.setdefault(k, {})[name] = n
    return out


# ---------------------------------------------------------------------------
# the 4DOF chain on the card (phase 10)
# ---------------------------------------------------------------------------

# threshold on the card against the committed file, made by the TPU's bf16
# gate: THRESHOLD_RTOL_4DOF of tests/test_calibrate_dtype.py (the JAX
# package's float32 CPU path sits 1.6e-4 / 9.5e-5 / 2.3e-5 from it); and
# against the plain path on the same card (both float32; row 1's own mse
# bound is 5e-6)
THRESHOLD_RTOL = 1e-3
THRESHOLD_PLAIN_RTOL = 1e-5
# AP and AUROC of test-pipeline against the committed files
PIPELINE_ATOL = 1e-4
# test-pipeline accuracy of a CNN that train-cnn trained on the card (full
# recipe, seed 42). Set before the card's first run, from the JAX trainer
# on the CPU (float32, full recipe) over seeds 42, 43, 44: 0.993674,
# 0.988999, 0.991199; their mean less 3 standard deviations, 0.98427,
# rounded down (PERF.md §6; tests/cnn_seed_spread.py jax 42 43 44)
CNN_ACCURACY_FLOOR = 0.984
CHAIN_FILES = ("figures/pipeline_metrics.json",
               "figures/vae_gate_binary_metrics.json",
               "figures/hybrid_struct_vs_rest_metrics.json",
               "figures/pipeline_classification_report.txt")


def chain_root(dest: Path, cell: str) -> Path:
    """A copy of the family's committed root (processed/, models/); the
    other families' runs are byte-identical copies of data/4dof/raw that are
    not committed, so their run_splits.json is rewritten to name it."""
    import shutil

    src = ROOT / FAMILIES[cell]["root"]
    for sub in ("processed", "models"):
        shutil.copytree(src / sub, dest / sub)
    splits = dest / "processed" / "run_splits.json"
    splits.write_text(splits.read_text().replace(
        f"{FAMILIES[cell]['root']}/raw/", "data/4dof/raw/"))
    return dest


def gate_counts(reset: bool = False) -> dict:
    from shm_tpu_torch.ops import FUSED_GATES

    out = {}
    for _, g, _ in FUSED_GATES.values():
        out[g.__name__] = g.launches
        if reset:
            g.launches = 0
    return out


def run_command(cell: str, argv, what: str) -> int:
    """``main(argv)`` of the port's CLI with every gate count at 0 just
    before (its seconds printed); the family's kernel launches. Fails if
    another family's kernel launched."""
    import torch

    from shm_tpu_torch.cli.stage4dof import main as cli_main

    kernel = FAMILIES[cell]["kernel"]
    gate_counts(reset=True)
    t0 = time.perf_counter()
    cli_main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = gate_counts()
    others = {k: v for k, v in counts.items() if k != kernel}
    print(f"[chain {cell}] {what}: {secs:.2f} s; {kernel} launches "
          f"{counts[kernel]}, other gate kernels {others}")
    check(counts[kernel] > 0, f"{cell} {what} did not launch {kernel}")
    check(not any(others.values()),
          f"{cell} {what} launched another family's kernel: {others}")
    return counts[kernel]


def check_pipeline(cell: str, root: Path, committed: Path, tag: str,
                   committed_cnn: bool = True) -> dict:
    """test-pipeline's outputs under ``root`` against the committed files:
    every file written, the split files the metrics' sections, gate_stats
    exact, each class's window count; with the committed CNN also the
    confusion matrix within the family's limit and AP and AUROC within
    PIPELINE_ATOL. Returns the metrics."""
    from shm_tpu_torch.utils.io import load_json

    for rel in CHAIN_FILES:
        check((root / rel).is_file(), f"{cell} {tag}: {rel} not written")
    got = load_json(root / "figures" / "pipeline_metrics.json")
    want = load_json(committed / "figures" / "pipeline_metrics.json")
    check(load_json(root / "figures" / "vae_gate_binary_metrics.json") == got["gate"]
          and load_json(root / "figures" / "hybrid_struct_vs_rest_metrics.json")
          == got["hybrid_struct_vs_rest"], f"{cell} {tag}: split files differ")
    check(got["gate"]["gate_stats"] == want["gate"]["gate_stats"],
          f"{cell} {tag}: gate_stats {got['gate']['gate_stats']} differ from "
          "the committed file")
    cm = np.asarray(got["confusion_matrix_counts"])
    cm_ref = np.asarray(want["confusion_matrix_counts"])
    check((cm.sum(axis=1) == cm_ref.sum(axis=1)).all(),
          f"{cell} {tag}: windows by class {cm.sum(axis=1).tolist()}")
    moved = int(np.abs(cm - cm_ref).sum()) // 2
    tp = got["throughput"]
    print(f"[chain {cell}] {tag}: accuracy {got['accuracy']:.6f}, confusion "
          f"matrix {cm.tolist()} (committed {cm_ref.tolist()}, windows moved "
          f"{moved}); {tp['n_windows']} windows in {tp['seconds'] * 1e3:.1f} ms "
          f"= {tp['windows_per_sec']:,.0f} windows/s")
    if not committed_cnn:
        return got
    check(moved <= FAMILIES[cell]["cm_limit"], f"{cell} {tag}: confusion "
          f"matrix off by {moved} windows (> {FAMILIES[cell]['cm_limit']})")
    for sec, k in (("gate", "average_precision"), ("gate", "gate_auroc"),
                   ("gate", "hybrid_auroc"),
                   ("hybrid_struct_vs_rest", "average_precision")):
        d = abs(got[sec][k] - want[sec][k])
        print(f"[chain {cell}]   {sec}.{k} {got[sec][k]:.8f} (committed "
              f"{want[sec][k]:.8f}, |diff| {d:.2e})")
        check(d <= PIPELINE_ATOL, f"{cell} {tag}: {sec}.{k} "
              f"off by {d:.2e} (> {PIPELINE_ATOL:g})")
    return got


def chain_scoring(cell: str, root: Path) -> dict:
    """``test-pipeline`` (committed CNN and threshold) and then ``threshold``
    through the port's CLI on the card, on ``root``, a copy of the family's
    root; the family kernel's launches by command."""
    import torch

    from shm_tpu_torch.calibrate import percentile_threshold
    from shm_tpu_torch.cli.stage4dof import (
        Paths, _load_stats, _load_vae, build_fraction_windows,
    )
    from shm_tpu_torch.config import Stage4DofConfig
    from shm_tpu_torch.data.windows import normalize_windows
    from shm_tpu_torch.train import reconstruction_mse
    from shm_tpu_torch.utils.io import load_json

    fam = FAMILIES[cell]
    committed = ROOT / fam["root"]
    cfg = Stage4DofConfig()
    paths = Paths(str(root))
    argv = ["--root", str(root), "--no-plots"]
    launches = {}

    launches["test-pipeline"] = run_command(cell, ["test-pipeline"] + argv,
                                            "test-pipeline")
    check_pipeline(cell, root, committed, "test-pipeline")

    # threshold through the gate-only kernel, against the committed file
    # and against the plain path on the same card
    launches["threshold"] = run_command(cell, ["threshold"] + argv, "threshold")
    thr = load_json(paths.processed / "vae_threshold.json")
    want = load_json(committed / "processed" / "vae_threshold.json")
    groups = ("normal", "sensor", "structural")
    counts = [thr[f"n_val_windows_{g}"] for g in groups]
    check(counts == [want[f"n_val_windows_{g}"] for g in groups] == [2010, 804, 804],
          f"{cell} threshold: window counts {counts}")
    splits = load_json(paths.run_splits)
    W = np.concatenate([build_fraction_windows(splits[g]["files"], cfg.val_frac, cfg)
                        for g in ("normal", "sensor_fault", "structural_fault")])
    mean, std = (torch.from_numpy(a).cuda() for a in _load_stats(paths))
    Z = normalize_windows(torch.from_numpy(W).cuda(), mean, std)
    plain = percentile_threshold(
        reconstruction_mse(_load_vae(paths, cfg), Z, fused=False)[:counts[0]],
        cfg.threshold_percentile)
    rel_c = thr["threshold"] / want["threshold"] - 1
    rel_p = thr["threshold"] / plain - 1
    print(f"[chain {cell}] threshold {thr['threshold']:.7f}: committed "
          f"{want['threshold']:.7f} (rel {rel_c:+.2e}, limit "
          f"{THRESHOLD_RTOL:g}); plain path on the card {plain:.7f} (rel "
          f"{rel_p:+.2e}, limit {THRESHOLD_PLAIN_RTOL:g})")
    check(abs(rel_c) <= THRESHOLD_RTOL, f"{cell}: threshold off the committed one")
    check(abs(rel_p) <= THRESHOLD_PLAIN_RTOL, f"{cell}: threshold off the plain path's")
    return launches


def chain_training(root: Path) -> dict:
    """``train-cnn`` at the full recipe on ``root`` (a copy of data/4dof)
    twice from one seed, one step timed, then ``test-pipeline`` with its CNN
    (the committed threshold), held to CNN_ACCURACY_FLOOR last; the LSTM
    kernel's launches by command."""
    import torch

    from shm_tpu_torch.cli.stage4dof import Paths, _load_cnn, cmd_train_cnn
    from shm_tpu_torch.config import Stage4DofConfig
    from shm_tpu_torch.utils.io import load_json

    cell = "lstm"
    fam = FAMILIES[cell]
    committed = ROOT / fam["root"]
    cfg = Stage4DofConfig()
    paths = Paths(str(root))
    runs, launches = [], {}
    for i in range(2):
        gate_counts(reset=True)
        res = cmd_train_cnn(paths, cfg, plot=False)
        torch.cuda.synchronize()
        n = gate_counts()[fam["kernel"]]
        launches[f"train-cnn run {i + 1}"] = n
        runs.append(res)
        ep = len(res.history["epoch"])
        print(f"[chain {cell}] train-cnn run {i + 1}: {ep} epochs in "
              f"{res.seconds:.2f} s ({res.seconds / ep:.3f} s/epoch), best "
              f"epoch {res.best_epoch}, stopped at {res.stopped_epoch}, val CE "
              f"{res.best_val:.6f}; {fam['kernel']} launches {n} (the CNN's inputs)")
        check(n > 0, f"{cell} train-cnn did not launch {fam['kernel']}")
    h = runs[0].history
    check(all(np.isfinite(h[k]).all() for k in ("train_loss", "val_loss")),
          "train-cnn: non-finite loss")
    check(runs[1].history == h and all(
        torch.equal(runs[0].variables[k], v) for k, v in runs[1].variables.items()),
        "train-cnn: two runs from one seed differ")
    print(f"[chain {cell}] train-cnn: the second run's losses and variables "
          f"equal the first's bit for bit; train / val loss by epoch "
          f"{[round(v, 6) for v in h['train_loss']]} / "
          f"{[round(v, 6) for v in h['val_loss']]}")
    meta = load_json(paths.processed / "stage2_cnn_train_meta.json")
    want_meta = load_json(committed / "processed" / "stage2_cnn_train_meta.json")
    check(meta.keys() == want_meta.keys(),
          f"train-cnn meta keys {sorted(meta)} != {sorted(want_meta)}")
    cnn = _load_cnn(paths, cfg)
    check(all(torch.equal(v, runs[1].variables[k].cpu())
              for k, v in cnn.state_dict().items()
              if not k.endswith("num_batches_tracked")),
          "cnn.msgpack read back differs from the trained variables")
    cnn_step_ms(cfg, runs[1])

    launches["test-pipeline, trained CNN"] = run_command(
        cell, ["test-pipeline", "--root", str(root), "--no-plots"],
        "test-pipeline, trained CNN")
    got = check_pipeline(cell, root, committed, "test-pipeline, trained CNN",
                         committed_cnn=False)
    print(f"[chain {cell}] the trained CNN's accuracy {got['accuracy']:.6f}; "
          f"floor {CNN_ACCURACY_FLOOR} (set before the first card run)")
    check(got["accuracy"] >= CNN_ACCURACY_FLOOR,
          f"{cell}: the trained CNN's accuracy {got['accuracy']:.6f} "
          f"< the floor {CNN_ACCURACY_FLOOR}")
    return launches


def cnn_step_ms(cfg, res) -> float:
    """CUDA-event ms of one CNN training step at the recipe's batch (forward,
    backward, Adam), on the trained variables and random inputs."""
    import torch

    from shm_tpu_torch.models.cnn import CNN4DOF
    from shm_tpu_torch.train.cnn import batch_loss, cross_entropy_loss
    from shm_tpu_torch.train.vae import make_optimizer

    tcfg = cfg.cnn_train
    bs = tcfg.batch_size
    model = CNN4DOF().cuda()
    model.load_state_dict(res.variables)
    model.train()
    opt = make_optimizer(model.parameters(), tcfg)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(bs, cfg.seq_len, cfg.num_features, 2))
                         .astype(np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, 2, bs)).cuda()
    mask = torch.ones(bs, device=x.device)
    keep = torch.rand(bs, 128, device=x.device) < 0.5

    def step():
        opt.zero_grad()
        batch_loss(model, x, y, mask, keep, cross_entropy_loss).backward()
        opt.step()

    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        ms = time_ms(step, reps=21, warm=5)
    print(f"[chain] one CNN training step (batch {bs}, forward + backward + "
          f"Adam, cuDNN deterministic): {ms:.3f} ms (CUDA events, median of 21)")
    return ms


def phase_chains() -> dict:
    """Phase 10: per family, ``test-pipeline`` and ``threshold`` on a copy of
    its root; then ``train-cnn`` and its CNN's ``test-pipeline`` on a fresh
    copy of data/4dof, the accuracy floor the last check. Returns each
    family kernel's launches by command (each count set to 0 just before its
    command), by kernel name."""
    import tempfile

    print(f"[chain] {gpu_line()}")
    print("[chain] figures off (--no-plots / plot=False): a CUDA host "
          "may lack matplotlib, and no JSON depends on a figure")
    out = {}
    for cell, fam in FAMILIES.items():
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix=f"chip_smoke_chain_{cell}_") as tmp:
            launches = chain_scoring(cell, chain_root(Path(tmp), cell))
        out[fam["kernel"]] = launches
        print(f"[chain {cell}] {time.perf_counter() - t0:.2f} s; "
              f"{fam['kernel']} launches by command {launches}")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_chain_train_") as tmp:
        launches = chain_training(chain_root(Path(tmp), "lstm"))
    out[FAMILIES["lstm"]["kernel"]].update(launches)
    print(f"[chain lstm] train-cnn phase {time.perf_counter() - t0:.2f} s; "
          f"fused_vae_gate launches by command {launches}")
    return out


# ---------------------------------------------------------------------------
# the whole 4DOF stage on the card (phase 12)
# ---------------------------------------------------------------------------

# gen-normal / gen-faults on the card against the committed data/4dof/raw
# CSVs (made on a TPU), per channel: max |diff| / max |committed|. Set before
# the first card run: the JAX package on the CPU reads <= 1.03e-4, the port
# on the CPU <= 1.11e-4 (stiff_red_30pct); float32 Newmark runs of 1,001
# steps whose products and eigenvalues sum in another order on the card
GEN_RTOL = 5e-4
# test-pipeline of the legacy roots' committed models on runs regenerated
# with --legacy-faults: the JAX package's own output on the CPU (the committed
# pipeline_metrics.json of these roots is not reproduced by the JAX package
# either; PERF.md §6). Gates exact, confusion matrix within 2 windows
LEGACY_ROOTS = {
    "data/4dof_legacy": dict(cell="lstm", accuracy=0.9935643564356436,
                             cm=[[2020, 0, 0], [0, 782, 26], [0, 0, 1212]]),
    "data/4dof_legacy_attention": dict(
        cell="attention", accuracy=0.994059405940594,
        cm=[[2020, 0, 0], [0, 784, 24], [0, 0, 1212]]),
}
LEGACY_ANOM = {"normal/test": (0, 2020), "sensor/test": (808, 808),
               "struct/test": (1212, 1212)}
STAGE_CM_LIMIT = 2
# test-pipeline accuracy of the chain train-vae --cell -> threshold ->
# train-cnn -> test-pipeline (full recipes, seed 42) on the regenerated runs.
# Set before the first card run from the JAX package's own chain on the CPU
# (`python -m shm_tpu.cli.stage4dof all --cell ... --seed S`, float32, full
# recipes), as phase 10's floor: the seeds' mean less 3 standard deviations,
# rounded down. min_gru, seeds 42, 43, 44: 0.995050, 0.992299, 0.992024
# (0.98811); attention, seeds 42, 43: 0.994774, 0.984598 (0.96810). Every
# seed's gate read 0 / 1 / 1 (PERF.md §6)
CELL_ACCURACY_FLOOR = {"min_gru": 0.988, "attention": 0.968}


def all_kernel_counts(reset: bool = False) -> dict:
    """Launch counts of the gate kernels (rows 1, 6, 7) and the LSTM
    training kernels (rows 2-5), by name."""
    counts = gate_counts(reset)
    counts.update(lstm_launch_counts())
    if reset:
        reset_lstm_launch_counts()
    return counts


def stage_command(argv, what: str, kernel=None) -> dict:
    """``main(argv)`` of the port's CLI with every count at 0 just before;
    its seconds printed. ``kernel`` must launch and nothing else may (with
    None, nothing may). Returns the counts and the seconds."""
    import torch

    from shm_tpu_torch.cli.stage4dof import main as cli_main

    all_kernel_counts(reset=True)
    t0 = time.perf_counter()
    cli_main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = all_kernel_counts()
    others = {k: v for k, v in counts.items() if k != kernel and v}
    print(f"[stage] {what}: {secs:.2f} s; launches "
          f"{ {k: v for k, v in counts.items() if v} or 'none'}")
    if kernel is not None:
        check(counts[kernel] > 0, f"{what} did not launch {kernel}")
    check(not others, f"{what} launched {others}")
    return dict(counts, seconds=secs)


def compare_runs(root: Path, committed: Path) -> float:
    """Every CSV under ``root/raw`` against ``committed/raw``, per channel;
    the worst max |diff| / max |committed|."""
    rels = sorted(p.relative_to(committed).as_posix()
                  for p in (committed / "raw").rglob("*.csv"))
    got_rels = sorted(p.relative_to(root).as_posix()
                      for p in (root / "raw").rglob("*.csv"))
    check(got_rels == rels, f"generated runs {got_rels} != committed {rels}")
    worst, worst_rel = 0.0, ""
    header = (committed / rels[0]).read_text().splitlines()[0]
    for rel in rels:
        check((root / rel).read_text().splitlines()[0] == header,
              f"{rel}: header differs from the committed one")
        got = np.loadtxt(root / rel, delimiter=",", skiprows=1)
        ref = np.loadtxt(committed / rel, delimiter=",", skiprows=1)
        check(got.shape == ref.shape, f"{rel}: shape {got.shape} != {ref.shape}")
        r = float((np.abs(got - ref).max(0) / np.abs(ref).max(0)).max())
        if r > worst:
            worst, worst_rel = r, rel
    print(f"[stage] {len(rels)} CSVs against {committed.relative_to(ROOT)}/raw: "
          f"worst channel max |diff| / max |committed| {worst:.3e} ({worst_rel}); "
          f"limit {GEN_RTOL:g}")
    check(worst <= GEN_RTOL, f"generated runs off the committed ones by "
                             f"{worst:.3e} ({worst_rel})")
    return worst


def spike_positions(root: Path) -> None:
    """spikes_x1's spiked samples on x1, v1, a1 (where the run leaves the
    nominal run, simulated here on the card) against the committed run's."""
    from shm_tpu_torch.config import Stage4DofConfig
    from shm_tpu_torch.sim import simulate_runs, smoothed_gaussian_force_np

    cfg = Stage4DofConfig()
    f = cfg.faults
    force = smoothed_gaussian_force_np(cfg.system.t_total, cfg.system.dt, 4,
                                       f.force_rms, f.force_seed)
    nominal = simulate_runs(np.array(cfg.system.mass)[None],
                            np.array(cfg.system.stiffness)[None],
                            np.full(1, cfg.system.damping_ratio), force[None],
                            cfg.system)[0].cpu().numpy().astype(np.float64)
    rel = "raw/faults/sensor_fault/spikes_x1/spikes_x1.csv"
    got = np.loadtxt(root / rel, delimiter=",", skiprows=1)
    ref = np.loadtxt(ROOT / "data/4dof" / rel, delimiter=",", skiprows=1)
    for c in (0, 4, 8):
        tol = 1e-3 * np.abs(nominal[:, c]).max()
        hit = np.nonzero(np.abs(got[:, c] - nominal[:, c]) > tol)[0]
        hit_c = np.nonzero(np.abs(ref[:, c] - nominal[:, c]) > tol)[0]
        check(len(hit) == 10 and np.array_equal(hit, hit_c),
              f"spikes_x1 column {c}: spikes at {hit.tolist()}, committed "
              f"{hit_c.tolist()}")
    print(f"[stage] spikes_x1: the 10 spiked samples {hit.tolist()} on x1, v1 "
          "and a1 are the committed run's")


def check_stage_pipeline(root: Path, what: str, want_cm, want_anom,
                         limit: int = STAGE_CM_LIMIT) -> dict:
    """test-pipeline's metrics under ``root``: gate counts exact, the
    confusion matrix within ``limit`` windows of ``want_cm``."""
    from shm_tpu_torch.utils.io import load_json

    got = load_json(root / "figures" / "pipeline_metrics.json")
    anom = {tag: (int(s["anom"]), int(s["total"]))
            for tag, s in got["gate"]["gate_stats"].items()}
    cm = np.asarray(got["confusion_matrix_counts"])
    ref = np.asarray(want_cm)
    moved = int(np.abs(cm - ref).sum()) // 2
    print(f"[stage] {what}: accuracy {got['accuracy']:.6f}, gate {anom}, "
          f"confusion matrix {cm.tolist()} (held to {ref.tolist()}: windows "
          f"moved {moved}, limit {limit})")
    check(anom == want_anom, f"{what}: gate {anom} != {want_anom}")
    check((cm.sum(1) == ref.sum(1)).all() and moved <= limit,
          f"{what}: confusion matrix off by {moved} windows")
    return got


def stage_generate(root: Path, root_arg: str, legacy: bool, tag: str) -> dict:
    """gen-normal, gen-faults and make-splits into ``root_arg`` on the card;
    their seconds by command."""
    secs = {}
    base = ["--root", root_arg, "--no-plots"]
    for cmd in ("gen-normal", "gen-faults", "make-splits"):
        argv = [cmd] + base + (["--legacy-faults"] if legacy and cmd == "gen-faults"
                               else [])
        secs[f"{tag} {cmd}"] = stage_command(argv, f"{tag} {cmd}")["seconds"]
    return secs


def vae_step_ms(cell: str, Ztr, scan_impl: str = "sequential",
                profile: bool = False, vcfg=None, tcfg=None,
                use_kernel: bool = False) -> float:
    """CUDA-event ms of one training step of the cell's VAE at the recipe's
    batch (noise drawn, forward, backward, clip, Adam): plain autograd, or
    with ``use_kernel`` the LSTM training kernels; ``scan_impl`` is the
    minGRU recurrence's form. ``vcfg`` / ``tcfg``: the VAE and the recipe
    (default the 4DOF stage's). ``profile`` also prints where a step's
    device time goes, and the device's idle share."""
    import torch

    from shm_tpu_torch.config import Stage4DofConfig
    from shm_tpu_torch.models.vae import TemporalVAE
    from shm_tpu_torch.train.vae import batch_loss, draw_batch_noise, make_optimizer

    v = vcfg or Stage4DofConfig().vae
    tcfg = tcfg or Stage4DofConfig().vae_train
    model = TemporalVAE(v.input_dim, v.latent_dim, v.hidden_dim, v.num_layers,
                        v.use_layernorm, v.dropout, cell, scan_impl).cuda()
    model.init_parameters(torch.Generator().manual_seed(0))
    model.train()
    opt = make_optimizer(model.parameters(), tcfg)
    bs = tcfg.batch_size
    xb = Ztr[:bs].contiguous()
    bmask = torch.ones(bs, device=xb.device)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def step():
        eps, dm_e, dm_d = draw_batch_noise(model, bs, xb.shape[1], gen, xb.device)
        opt.zero_grad()
        total, _, _ = batch_loss(model, xb, bmask, eps, dm_e, dm_d, 0.5,
                                 use_kernel, generator=gen)
        total.backward()
        opt.step()

    ms = time_ms(step, reps=11, warm=3)
    if profile:
        profile_device(step, f"{cell} training step ({scan_impl}"
                             f"{', kernels' if use_kernel else ''})")
    return ms


def stage_cell_chain(cell: str, runs: Path, tmp: Path) -> dict:
    """train-vae --cell at the full recipe on the regenerated runs, a
    2-epoch run twice from one seed, one step timed, then threshold,
    train-cnn and test-pipeline; the gate kernel's launches by command."""
    import shutil

    import torch

    from shm_tpu_torch.cli.stage4dof import (
        Paths, _load_stats, build_fraction_windows_multi,
    )
    from shm_tpu_torch.config import Stage4DofConfig, replace
    from shm_tpu_torch.data.windows import normalize_windows
    from shm_tpu_torch.models.vae import vae_from_config
    from shm_tpu_torch.train import train_vae
    from shm_tpu_torch.utils.io import load_json

    kernel = FAMILIES[cell]["kernel"]
    root = tmp / f"chain_{cell}"
    paths = Paths(str(root))
    paths.processed.mkdir(parents=True)
    shutil.copy(Paths(str(runs)).run_splits, paths.run_splits)
    base = ["--root", str(root), "--no-plots"]
    out = {}

    r = stage_command(["train-vae", "--cell", cell] + base,
                      f"{cell} train-vae (full recipe)")
    meta = load_json(paths.processed / "stage1_vae_train_meta.json")
    cfg = replace(Stage4DofConfig(), vae=replace(Stage4DofConfig().vae, cell=cell))
    tcfg = cfg.vae_train
    check(meta["cell"] == cell and meta["epochs"] == tcfg.epochs
          and meta["batch_size"] == tcfg.batch_size, f"{cell} train-vae meta {meta}")
    ep = tcfg.epochs
    print(f"[stage] {cell} train-vae: {ep} epochs in {meta['train_seconds']:.2f} s "
          f"({meta['train_seconds'] / ep:.3f} s/epoch; command {r['seconds']:.2f} s), "
          f"best epoch {meta['best_epoch']}, val {meta['best_val_total']:.6f}; "
          f"{gpu_line()}")

    # the losses of a run from one seed, twice, on the command's windows
    files = load_json(paths.run_splits)["normal"]["files"]
    Wtr, Wva = build_fraction_windows_multi(files, (cfg.train_frac, cfg.val_frac), cfg)
    mean, std = (torch.from_numpy(a).cuda() for a in _load_stats(paths))
    Ztr = normalize_windows(torch.from_numpy(Wtr).cuda(), mean, std)
    Zva = normalize_windows(torch.from_numpy(Wva).cuda(), mean, std)
    runs2 = [train_vae(vae_from_config(cfg.vae), Ztr, Zva, replace(tcfg, epochs=2))
             for _ in range(2)]
    h = runs2[0].history
    print(f"[stage] {cell} 2-epoch runs from seed {tcfg.seed}: train total "
          f"{h['train_total']} / {runs2[1].history['train_total']}; "
          f"{runs2[1].seconds / 2:.3f} s/epoch")
    check(runs2[1].history == h, f"{cell}: two runs from one seed differ")
    check(all(np.isfinite(v).all() for v in h.values()), f"{cell}: non-finite loss")
    step = vae_step_ms(cell, Ztr, profile=True)
    print(f"[stage] {cell} one training step (batch {tcfg.batch_size}, plain "
          f"autograd, forward + backward + clip + Adam): {step:.3f} ms "
          f"(CUDA events, median of 11); {gpu_line()}")
    out.update(train_s_per_epoch=meta["train_seconds"] / ep, step_ms=step,
               train_vae_seconds=r["seconds"])
    if cell == "min_gru":
        # the recurrence's log-depth form, an option of the model (not the
        # trainer's default), timed beside it
        out["step_ms_associative"] = vae_step_ms(cell, Ztr, "associative")
        print(f"[stage] min_gru one training step with the associative "
              f"recurrence (log2 T doubling passes): "
              f"{out['step_ms_associative']:.3f} ms")

    launches = {}
    for cmd in ("threshold", "train-cnn", "test-pipeline"):
        res = stage_command([cmd] + base, f"{cell} {cmd}", kernel=kernel)
        launches[f"stage {cell} {cmd}"] = res[kernel]
        out[f"{cmd}_seconds"] = res["seconds"]
    got = load_json(paths.figures / "pipeline_metrics.json")
    rates = {k: v["anom_rate"] for k, v in got["gate"]["gate_stats"].items()}
    floor = CELL_ACCURACY_FLOOR[cell]
    print(f"[stage] {cell} chain: accuracy {got['accuracy']:.6f} (floor {floor}, "
          f"set before the first card run), gate rates {rates}, confusion "
          f"matrix {got['confusion_matrix_counts']}")
    check(rates["sensor/test"] == 1.0 and rates["struct/test"] == 1.0,
          f"{cell} chain: gate rates {rates}")
    check(got["accuracy"] >= floor, f"{cell} chain: accuracy "
          f"{got['accuracy']:.6f} < the floor {floor}")
    out["accuracy"] = got["accuracy"]
    return launches, out


def stage_data(tmp: Path, launches: dict) -> dict:
    """Phase 12 (a)-(c) under ``tmp``: data/4dof's runs and splits
    generated again and tested with its committed models, then the two
    legacy roots. Adds the gate kernels' launches by command to
    ``launches``; returns the generation seconds by command and (a)'s
    root."""
    import os
    import shutil

    from shm_tpu_torch.utils.io import load_json

    secs = {}
    # (a) data/4dof's runs and splits, root given absolute
    a = tmp / "r4dof"
    secs.update(stage_generate(a, str(a), False, "data/4dof"))
    compare_runs(a, ROOT / "data/4dof")
    spike_positions(a)
    got = load_json(a / "processed" / "run_splits.json")
    want = (ROOT / "data/4dof/processed/run_splits.json").read_text()
    check(got == json.loads(want.replace("data/4dof/", a.as_posix() + "/")),
          "make-splits: run_splits.json differs from the committed one")
    print("[stage] run_splits.json: the committed one, root prefix rewritten")

    # (b) the committed data/4dof models on those runs
    for p in (ROOT / "data/4dof/processed").iterdir():
        if p.name != "run_splits.json":
            shutil.copy(p, a / "processed" / p.name)
    shutil.copytree(ROOT / "data/4dof/models", a / "models")
    want = load_json(ROOT / "data/4dof/figures/pipeline_metrics.json")
    what = "data/4dof test-pipeline, regenerated runs"
    r = stage_command(["test-pipeline", "--root", str(a), "--no-plots"], what,
                      kernel="fused_vae_gate")
    launches["fused_vae_gate"][f"stage {what}"] = r["fused_vae_gate"]
    check_stage_pipeline(a, what, want["confusion_matrix_counts"],
                         {k: (int(v["anom"]), int(v["total"]))
                          for k, v in want["gate"]["gate_stats"].items()})

    # (c) the legacy roots, generated again with --legacy-faults under a
    # relative root from a working directory of their own
    here = os.getcwd()
    for name, leg in LEGACY_ROOTS.items():
        wd = tmp / ("wd_" + Path(name).name)
        for sub in ("processed", "models"):
            shutil.copytree(ROOT / name / sub, wd / name / sub)
        os.chdir(wd)
        try:
            secs.update(stage_generate(wd / name, name, True, name))
            check(load_json(wd / name / "processed" / "run_splits.json")
                  == load_json(ROOT / name / "processed" / "run_splits.json"),
                  f"{name}: make-splits differs from the committed run_splits.json")
            print(f"[stage] {name}: run_splits.json equal to the committed one")
            kernel = FAMILIES[leg["cell"]]["kernel"]
            r = stage_command(["test-pipeline", "--root", name, "--no-plots"],
                              f"{name} test-pipeline", kernel=kernel)
            launches[kernel][f"stage {name} test-pipeline"] = r[kernel]
            check_stage_pipeline(wd / name, f"{name} test-pipeline",
                                 leg["cm"], LEGACY_ANOM)
        finally:
            os.chdir(here)
    print(f"[stage] generation seconds by command {secs}")
    return a


def phase_stage() -> dict:
    """Phase 12: the whole 4DOF stage on the card. (a) the runs and splits
    of data/4dof generated again; (b) its committed models' test-pipeline on
    them; (c) the two legacy roots generated again (--legacy-faults) and
    tested; (d) the min_gru and attention chains trained on (a)'s runs.
    Returns the gate kernels' launches by command, by kernel name."""
    import tempfile

    print(f"[stage] {gpu_line()}")
    t_phase = time.perf_counter()
    launches = {fam["kernel"]: {} for fam in FAMILIES.values()}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_stage_") as tmp_s:
        tmp = Path(tmp_s)
        a = stage_data(tmp, launches)
        # (d) the two other families trained on (a)'s runs
        for cell in ("min_gru", "attention"):
            t0 = time.perf_counter()
            got, nums = stage_cell_chain(cell, a, tmp)
            launches[FAMILIES[cell]["kernel"]].update(got)
            print(f"[stage] {cell} chain {time.perf_counter() - t0:.2f} s: {nums}")
    print(f"[stage] phase 12 {time.perf_counter() - t_phase:.2f} s; gate kernel "
          f"launches by command {launches}")
    return launches


# ---------------------------------------------------------------------------
# the 1-DOF stage on the card (phase 13)
# ---------------------------------------------------------------------------

STAGE1_ROOT = "data/1dof"
# gen-seen / gen-unseen on the card against the committed data/1dof/raw CSVs,
# per channel: max |diff| / max |committed|. Set before the first card run.
# Seen: the committed series come from a float64 Newmark run, and a float32
# run of 3,000 steps drifts from it in phase: the JAX package on the CPU
# reads <= 1.013e-2, the port on the CPU <= 1.016e-2. Unseen: the float32
# sin / arcsin's last bits, magnified by the two differences: the JAX
# package on the CPU reads <= 2.13e-4, the port <= 1.86e-4 (a_envelope;
# both sets: tests/stage1dof_readings.py distances)
STAGE1_GEN_RTOL = {"seen": 1.5e-2, "unseen": 5e-4}
# the square wave: x_square and v_square equal the committed values. The
# committed a_square holds 79 of its +-50 / +-25 samples one float32 ulp
# further from 0 (its division rounded otherwise); the JAX package and the
# port on the CPU read the same 79, so a_square is held to 1e-7 relative
# with its zeros where the committed ones are
STAGE1_A_SQUARE_RTOL = 1e-7
# test-seen / test-unseen with the committed model against the committed
# tables (made on a TPU), max |diff| of (series, segment RMSE). Set before
# the first card run, about twice what the JAX package on the CPU reads:
# series 1.84e-4 / 4.29e-4, segment RMSE 7.4e-6 / 2.4e-5 (the port on the
# CPU reads the same within 1e-6; tests/stage1dof_readings.py distances)
STAGE1_TABLE_ATOL = {"seen": (4e-4, 2e-5), "unseen": (1e-3, 5e-5)}
STAGE1_TABLES = ("tables/reconstruction_seen/reconstruction_series.csv",
                 "tables/reconstruction_seen/segment_rmse.csv",
                 "tables/reconstruction_unseen/reconstruction_series.csv",
                 "tables/reconstruction_unseen/segment_rmse.csv",
                 "figures/rmse_comparison/rmse_summary_stats.csv")
# the seen mean segment RMSE of the model that train-vae trains on the card
# (full recipe, seed 42). Set before the first card run from the JAX
# package's own train-vae -> test-seen on the CPU (float32, full recipe;
# tests/stage1dof_readings.py seeds jax 42 43 44 45 46 47): 0.0246753,
# 0.0246618, 0.0237990, 0.0244936, 0.0246799, 0.0249608; their mean plus 3
# standard deviations, 0.025731, rounded up
# (seeds 42-44 alone: 0.025885). The committed model reads 0.0251603, the
# port on the CPU (seeds 42 / 43) 0.0250529 / 0.0198310 (PERF.md §6)
STAGE1_SEEN_RMSE_CEILING = 0.0258
# train-vae --cell min_gru / attention: plain autograd, host-bound (PR 16:
# 1.0 / 0.36 s an epoch of 12 steps at the 4DOF shape), so cut to this many
# epochs of the recipe's 100
STAGE1_CELL_EPOCHS = 5


def stage1_command(fn, what: str, want=None):
    """``fn()`` (a command of the port's 1DOF CLI) with every count at 0
    just before; its seconds printed. The launches of rows 1-7 must be
    ``want`` (a kernel it does not name: 0). Returns (fn's result, the
    counts and the seconds)."""
    import torch

    all_kernel_counts(reset=True)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = all_kernel_counts()
    want = {k: (want or {}).get(k, 0) for k in counts}
    print(f"[1dof] {what}: {secs:.2f} s; launches "
          f"{ {k: v for k, v in counts.items() if v} or 'none'}")
    check(counts == want, f"1dof {what}: launches {counts}, expected {want}")
    return out, dict(counts, seconds=secs)


def stage1_cli(argv, what: str, want=None) -> dict:
    """``main(argv)`` of the port's 1DOF CLI through :func:`stage1_command`."""
    from shm_tpu_torch.cli.stage1dof import main as cli_main

    return stage1_command(lambda: cli_main(argv), what, want)[1]


def load_f32_csv(path: Path):
    """(header names, the rows as float32): the port writes every float32
    value as the shortest text that reads back to it."""
    from shm_tpu_torch.utils.io import load_csv_columns

    cols = load_csv_columns(path)
    return list(cols), np.stack(list(cols.values()), 1).astype(np.float32)


def stage1_generation(root: Path, cpu_root: Path) -> dict:
    """gen-seen / gen-unseen's CSVs under ``root`` against the committed ones
    (STAGE1_GEN_RTOL per channel, the time column equal, the square wave as
    STAGE1_A_SQUARE_RTOL says) and against the port's CPU path under
    ``cpu_root`` (the square wave equal); the worst channel of each set."""
    out = {}
    for kind in ("seen", "unseen"):
        rel = f"raw/1dof_{kind}_variants.csv"
        names, got = load_f32_csv(root / rel)
        ref_names, ref = load_f32_csv(ROOT / STAGE1_ROOT / rel)
        _, cpu = load_f32_csv(cpu_root / rel)
        check(names == ref_names, f"{rel}: header {names}")
        check(got.shape == ref.shape == cpu.shape == (3001, 13), f"{rel}: {got.shape}")
        check(np.array_equal(got[:, 0], ref[:, 0]), f"{rel}: the time column differs")
        r = np.abs(got[:, 1:] - ref[:, 1:]).max(0) / np.abs(ref[:, 1:]).max(0)
        r_cpu = np.abs(got[:, 1:] - cpu[:, 1:]).max(0) / np.abs(cpu[:, 1:]).max(0)
        j = int(r.argmax())
        print(f"[1dof] {rel}: worst channel max |diff| / max |committed| "
              f"{r[j]:.3e} ({names[j + 1]}; limit {STAGE1_GEN_RTOL[kind]:g}); "
              f"against the port on the CPU {r_cpu.max():.3e} "
              f"({names[int(r_cpu.argmax()) + 1]})")
        check(r.max() <= STAGE1_GEN_RTOL[kind], f"{rel}: {names[j + 1]} off the "
              f"committed run by {r[j]:.3e}")
        out[kind] = float(r.max())
        if kind == "unseen":
            for c in ("x_square", "v_square", "a_square"):
                k = names.index(c)
                check(np.array_equal(got[:, k], cpu[:, k]),
                      f"{c} differs from the port's CPU path")
                if c != "a_square":
                    check(np.array_equal(got[:, k], ref[:, k]),
                          f"{c} differs from the committed one")
            k = names.index("a_square")
            d = np.abs(got[:, k] - ref[:, k])
            check(np.array_equal(got[:, k] == 0, ref[:, k] == 0)
                  and (d <= STAGE1_A_SQUARE_RTOL * np.abs(ref[:, k])).all(),
                  "a_square off the committed one")
            print(f"[1dof] square wave: x_square and v_square equal to the "
                  f"committed ones, all three to the port's CPU path; a_square "
                  f"{int((d > 0).sum())} samples one ulp from the committed ones "
                  f"(max rel {float((d / np.maximum(np.abs(ref[:, k]), 1e-30)).max()):.2e})")
    return out


def stage1_tables(root: Path, ref_root: Path, what: str, tol=None) -> None:
    """The eval tables under ``root`` against ``ref_root``'s: headers and
    shapes equal; with ``tol`` (STAGE1_TABLE_ATOL) max |diff| within it,
    else elementwise within ATOL + RTOL * |ref| (the card against the port's
    plain path on the CPU)."""
    for rel in STAGE1_TABLES[:4]:
        names, got = load_f32_csv(root / rel)
        ref_names, ref = load_f32_csv(ref_root / rel)
        check(names == ref_names and got.shape == ref.shape,
              f"{what} {rel}: {names} {got.shape}, expected {ref.shape}")
        check(np.isfinite(got).all(), f"{what} {rel}: non-finite values")
        d = np.abs(got[:, 1:] - ref[:, 1:])
        if tol is None:
            bad = d > ATOL + RTOL * np.abs(ref[:, 1:])
            limit = f"ATOL {ATOL:g} + RTOL {RTOL:g} |ref|"
        else:
            a = tol["seen" if "_seen" in rel else "unseen"][0 if "series" in rel else 1]
            bad = d > a
            limit = f"{a:g}"
        print(f"[1dof] {what} {rel.split('/', 1)[1]}: max |diff| {d.max():.3e} "
              f"(limit {limit})")
        check(not bad.any(), f"{what} {rel}: {int(bad.sum())} values off")
    got = (root / STAGE1_TABLES[4]).read_text().splitlines()
    check(got[0] == (ref_root / STAGE1_TABLES[4]).read_text().splitlines()[0]
          and [l.split(",")[0] for l in got[1:]] == ["Seen", "Unseen"],
          f"{what}: rmse_summary_stats.csv {got}")


def stage1_eval(root: Path, what: str) -> dict:
    """test-seen, test-unseen and compare-rmse on ``root`` through the CLI,
    no kernel launched; their counts by command."""
    base = ["--root", str(root), "--no-plots"]
    return {f"{c}, {what}": stage1_cli([c] + base, f"{c} ({what})")
            for c in ("test-seen", "test-unseen", "compare-rmse")}


def stage1_mean_rmse(root: Path, tag: str) -> float:
    return float(np.loadtxt(root / f"tables/reconstruction_{tag}/segment_rmse.csv",
                            delimiter=",", skiprows=1)[:, 1].mean())


def stage1_train(root: Path) -> dict:
    """(c): train-vae at the full recipe on ``root``'s generated seen series,
    rows 2-5 at the counts the recipe gives; its losses, a 2-epoch run twice
    from one seed, the checkpoint read back, one step timed on the kernel
    and plain paths, then the eval commands with that model held to the
    ceiling. Returns the counts by command and the readings."""
    import torch

    from shm_tpu_torch.cli import stage1dof as s1
    from shm_tpu_torch.config import Stage1DofConfig, replace
    from shm_tpu_torch.data.windows import num_windows
    from shm_tpu_torch.models.vae import vae_from_config
    from shm_tpu_torch.train import train_vae

    cfg = Stage1DofConfig()
    tcfg = cfg.train
    paths = s1.Paths(str(root))
    # the windows of the seen series' first half, the first tenth of them the
    # validation set, every batch of the recipe's size
    n = num_windows(int(cfg.train_frac * 3001), cfg.seq_len, cfg.stride)
    nb, nvb = -(-n // tcfg.batch_size), -(-max(n // 10, 1) // tcfg.batch_size)
    want = {"lstm2_enc_fwd": tcfg.epochs * (nb + nvb), "lstm2_dec_fwd": tcfg.epochs * (nb + nvb),
            "lstm2_enc_bwd": tcfg.epochs * nb, "lstm2_dec_bwd": tcfg.epochs * nb}
    check((n, nb, nvb, want["lstm2_enc_fwd"], want["lstm2_enc_bwd"]) == (1421, 23, 3, 2600, 2300),
          f"1dof train-vae plan {n} windows, {nb} + {nvb} batches, {want}")
    res, counts = stage1_command(lambda: s1.cmd_train_vae(paths, cfg, plot=False),
                                 "train-vae (full recipe)", want)
    launches = {"train-vae": counts}
    h = res.history
    ep = len(h["epoch"])
    print(f"[1dof] train-vae: {ep} epochs in {res.seconds:.2f} s "
          f"({res.seconds / ep:.4f} s/epoch; command {counts['seconds']:.2f} s); "
          f"train total {h['train_total'][0]:.6f} -> {h['train_total'][-1]:.6f}; "
          f"{gpu_line()}")
    check(ep == tcfg.epochs and all(np.isfinite(h[k]).all() for k in h),
          "1dof train-vae: history not finite or cut")
    check(h["train_total"][-1] < h["train_total"][0]
          and h["train_recon"][-1] < h["train_recon"][0],
          "1dof train-vae: the losses did not fall")
    loaded = s1._load_model(paths, cfg).state_dict()
    check(loaded.keys() == res.last_params.keys() and all(
        torch.equal(v, res.last_params[k].cpu()) for k, v in loaded.items()),
        "1dof temporal_vae.msgpack read back differs from the last parameters")
    print("[1dof] train-vae: temporal_vae.msgpack reads back the last epoch's "
          "parameters bit for bit")

    W, _, _, _, _ = s1.train_windows(paths, cfg, "cuda")
    runs = [train_vae(vae_from_config(cfg.vae), W, W[:max(len(W) // 10, 1)],
                      replace(tcfg, epochs=2)) for _ in range(2)]
    h2 = runs[0].history
    print(f"[1dof] 2-epoch runs from seed {tcfg.seed}: train total "
          f"{h2['train_total']} / {runs[1].history['train_total']}")
    check(runs[1].history == h2, "1dof: two runs from one seed differ")
    steps = {k: vae_step_ms("lstm", W, profile=k, vcfg=cfg.vae, tcfg=tcfg,
                            use_kernel=k) for k in (True, False)}
    print(f"[1dof] one training step (batch {tcfg.batch_size}, T={cfg.seq_len}, "
          f"H={cfg.vae.hidden_dim}; forward + backward + Adam): kernels "
          f"{steps[True]:.3f} ms, plain autograd {steps[False]:.3f} ms (CUDA "
          f"events, median of 11); {gpu_line()}")

    launches.update(stage1_eval(root, "trained model"))
    seen, unseen = stage1_mean_rmse(root, "seen"), stage1_mean_rmse(root, "unseen")
    print(f"[1dof] trained model: seen mean segment RMSE {seen:.7f} (ceiling "
          f"{STAGE1_SEEN_RMSE_CEILING}, set before the first card run), unseen "
          f"{unseen:.7f}")
    check(seen <= STAGE1_SEEN_RMSE_CEILING, f"1dof: seen mean RMSE {seen:.7f} "
          f"above the ceiling {STAGE1_SEEN_RMSE_CEILING}")
    check(unseen > seen, "1dof: the unseen mean RMSE is not above the seen one")
    return launches, dict(train_s_per_epoch=res.seconds / ep,
                          step_ms_kernel=steps[True], step_ms_plain=steps[False],
                          seen_mean_rmse=seen, unseen_mean_rmse=unseen)


def stage1_cells(gen: Path, tmp: Path) -> dict:
    """(d): train-vae --cell min_gru / attention (STAGE1_CELL_EPOCHS epochs)
    and the eval commands, which read the cell from split.json; no kernel
    launches. Returns the counts by command."""
    import shutil

    from shm_tpu_torch.cli import stage1dof as s1
    from shm_tpu_torch.config import Stage1DofConfig
    from shm_tpu_torch.utils.io import load_json

    launches = {}
    for cell in ("min_gru", "attention"):
        root = tmp / f"cell_{cell}"
        shutil.copytree(gen / "raw", root / "raw")
        base = ["--root", str(root), "--no-plots"]
        r = stage1_cli(["train-vae", "--cell", cell, "--epochs",
                        str(STAGE1_CELL_EPOCHS)] + base,
                       f"train-vae --cell {cell} ({STAGE1_CELL_EPOCHS} epochs)")
        launches[f"train-vae --cell {cell}"] = r
        paths = s1.Paths(str(root))
        check(load_json(paths.processed / "split.json")["cell"] == cell
              and s1._load_model(paths, Stage1DofConfig()).cell == cell,
              f"1dof {cell}: split.json does not carry the cell")
        losses = np.loadtxt(paths.tables / "training" / "training_losses.csv",
                            delimiter=",", skiprows=1)
        check(losses.shape == (STAGE1_CELL_EPOCHS, 5) and np.isfinite(losses).all(),
              f"1dof {cell}: training_losses.csv {losses.shape}")
        launches.update(stage1_eval(root, f"{cell} model"))
        for rel in STAGE1_TABLES[:4]:
            check(np.isfinite(load_f32_csv(root / rel)[1]).all(),
                  f"1dof {cell} {rel}: non-finite values")
        print(f"[1dof] {cell}: {STAGE1_CELL_EPOCHS} epochs in {r['seconds']:.2f} s "
              f"({r['seconds'] / STAGE1_CELL_EPOCHS:.3f} s/epoch with the "
              f"command's loading); train total {losses[0, 1]:.6f} -> "
              f"{losses[-1, 1]:.6f}; the eval commands read the cell from "
              f"split.json; seen / unseen mean segment RMSE "
              f"{stage1_mean_rmse(root, 'seen'):.6f} / {stage1_mean_rmse(root, 'unseen'):.6f}")
    return launches


def phase_stage1dof() -> dict:
    """Phase 13: the 1-DOF stage on the card through the port's CLI, figures
    off. (a) gen-seen / gen-unseen against the committed CSVs; (b) the eval
    commands with the committed model against the committed tables and the
    port's CPU path, twice (bit for bit); (c) train-vae at the full recipe
    through the LSTM training kernels and the eval commands with its model;
    (d) the min_gru and attention cells. Returns the counts of rows 1-7 by
    command."""
    import shutil
    import tempfile

    from shm_tpu_torch.cli import stage1dof as s1

    print(f"[1dof] {gpu_line()}")
    t_phase = time.perf_counter()
    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_1dof_") as tmp_s:
        tmp = Path(tmp_s)
        # (a) the variants, on the card and on the CPU
        gen, cpu = tmp / "gen", tmp / "cpu"
        for c in ("gen-seen", "gen-unseen"):
            launches[c] = stage1_cli([c, "--root", str(gen), "--no-plots"], c)
            s1.main([c, "--root", str(cpu), "--no-plots", "--device", "cpu"])
        stage1_generation(gen, cpu)

        # (b) the committed model, twice on the card and once on the CPU
        runs = []
        for name in ("committed_1", "committed_2", "committed_cpu"):
            r = tmp / name
            for sub in ("raw", "processed", "models"):
                shutil.copytree(ROOT / STAGE1_ROOT / sub, r / sub)
            runs.append(r)
        for i, r in enumerate(runs[:2]):
            launches.update(stage1_eval(r, f"committed model, run {i + 1}"))
        for c in ("test-seen", "test-unseen", "compare-rmse"):
            s1.main([c, "--root", str(runs[2]), "--no-plots", "--device", "cpu"])
        stage1_tables(runs[0], ROOT / STAGE1_ROOT, "committed model", STAGE1_TABLE_ATOL)
        stage1_tables(runs[0], runs[2], "committed model, card against the CPU")
        check(all((runs[0] / rel).read_bytes() == (runs[1] / rel).read_bytes()
                  for rel in STAGE1_TABLES), "1dof: two runs' tables differ")
        print("[1dof] committed model: a second run's five tables equal the "
              f"first's byte for byte; seen / unseen mean segment RMSE "
              f"{stage1_mean_rmse(runs[0], 'seen'):.7f} / "
              f"{stage1_mean_rmse(runs[0], 'unseen'):.7f} (committed "
              f"{stage1_mean_rmse(ROOT / STAGE1_ROOT, 'seen'):.7f} / "
              f"{stage1_mean_rmse(ROOT / STAGE1_ROOT, 'unseen'):.7f})")

        # (c) the LSTM trained through rows 2-5, (d) the other two cells
        got, nums = stage1_train(gen)
        launches.update(got)
        launches.update(stage1_cells(gen, tmp))
    print(f"[1dof] phase 13 {time.perf_counter() - t_phase:.2f} s: {nums}")
    return {k: {n: v for n, v in c.items() if n != "seconds"}
            for k, c in launches.items()}


# ---------------------------------------------------------------------------
# the openLAB stage on the card (phase 14)
# ---------------------------------------------------------------------------

OPENLAB_ROOT = "data/openlab"
OPENLAB_ATTENTION_ROOT = "data/openlab_attention"
# validate-vae's threshold against the committed one, which the TPU's bf16
# gate made: the JAX package's float32 CPU path reads 1.94e-3 (2.177894
# against 2.182128); and against the port's plain path on the same card
# (both float32; row 1's own mse bound is OPENLAB_MSE_RTOL)
OPENLAB_THRESHOLD_RTOL = 4e-3
OPENLAB_THRESHOLD_PLAIN_RTOL = 1e-5
# AUROCs of validate-cnn, validate-ml and test-hybrid against the committed
# files (made on a TPU): the JAX package's CPU run reads at most 1.47e-4
# (test-hybrid's SVM_RBF)
OPENLAB_AUROC_ATOL = 2e-4
# test-hybrid of data/openlab_attention: its matrices exactly; its AUROCs
# within this of the committed file: the JAX package's CPU run reads 2.04e-4
# for SVM_RBF (9.1e-5 for the CNN; tests/openlab_readings.py attention)
OPENLAB_ATTENTION_AUROC_ATOL = 4e-4
# validate-cnn --split val's AUROC: the committed value (0.5491869) is 7.49e-4
# from every float32 evaluation (the JAX package on the CPU and the port
# read 0.5484376330353342 to the last digit), so the card is held to that
# float32 reading within OPENLAB_AUROC_ATOL (tests/openlab_readings.py)
OPENLAB_CNN_VAL_AUROC_F32 = 0.5484376330353342
# train-cnn at the full recipe (seed 42): its tuned VAL ST-F2 must reach this
# floor, set before the first card run from the JAX package's train-cnn on
# the CPU (float32, full recipe; tests/openlab_readings.py cnn-seeds jax
# 42 43 44 45 46 47): 0.687233, 0.690608, 0.687653, 0.691032, 0.688073,
# 0.688494; their mean less 3 standard deviations, 0.684081, rounded down.
# The port on the CPU (seed 42): 0.691032
OPENLAB_CNN_F2_FLOOR = 0.684
# train-vae on plain autograd (the 1-layer LSTM, T=200: no training kernel
# takes it; host-bound, ~6 s an epoch), cut to this many epochs of the
# recipe's 100; the --cell min_gru chain to OPENLAB_CELL_EPOCHS. Two epochs
# keep every check of (e): the KL warm-up is max(1, int(0.3 n)) = 1 epoch
# for any n of 2-6, so two epochs run as the first two of a longer run,
# bit for bit from one seed, and the loss falls (on the CPU 0.860 -> 0.627
# over epochs 1-2)
OPENLAB_VAE_EPOCHS = 2
OPENLAB_CELL_EPOCHS = 2
OPENLAB_REPS = 5
# row 1 against its plain version on the card at the openLAB shape (T=200,
# D=3, H=64, L=1), on the largest relative mse difference over the 2,042
# test windows. LSTM_MSE_RTOL (set at T=100, L=2) does not carry: the card
# read 5.13e-6 here (measured on one H100). The CPU model of the
# kernel's sums (tests/test_torch_vae_gate_tf32.py::emulated_gate, all 2,042
# windows) reads 3.40e-6 for the shipped pair-wise sum, 1.33e-5 for a sum
# chained through every mma and 2.16e-3 for one TF32 term; the port's plain
# path against the JAX package's float32 path on the CPU 3.43e-6. So the
# bound passes the shipped sum twice over and fails the other two. Against
# a float64 pass on the card the kernel read 3.44e-6 there and the plain
# path 4.99e-6: the 5.13e-6 is mostly the plain path's own float32 error
# (the val windows: 2.69e-6 between them; PERF.md §6)
OPENLAB_MSE_RTOL = 1e-5
# rows 6 and 7 against their plain versions on the card at the openLAB shape
# (T=200, D=3, H=64, L=1), on the largest relative mse difference over the
# test and val windows (row 6 on the val windows of the min_gru chain's
# own weights). The CPU models of their sums (tests/openlab_readings.py
# gate-sums; tests/test_torch_openlab_gate_tf32.py) read, row 6 on a minGRU
# VAE trained there by the same chain: 1.89e-6 / 7.7e-7 (test / val) for the
# shipped pair-wise sum, 3.9e-4 / 2.7e-4 for one TF32 term; row 7 on
# data/openlab_attention's VAE: 6.63e-6 / 8.54e-6 for its chained sum,
# 8.55e-4 / 8.58e-4 for one TF32 term. Each plain float32 path is itself
# 0.7e-6-3.6e-6 from a float64 pass, so kernel and plain may differ by the
# sum of the two: the bounds pass that with room and fail one TF32 term by
# 27x (row 6) and 43x (row 7)
OPENLAB_MINGRU_MSE_RTOL = 1e-5
OPENLAB_ATTENTION_MSE_RTOL = 2e-5
# modules the device path must not need (the card's machine has none)
OPENLAB_HOST_ONLY = ("pandas", "sklearn", "joblib")
# the kernels line's rows that carry phase 14's counts
OPENLAB_ROWS = ("fused_vae_gate", "fused_mingru_gate", "fused_attention_gate")


def openlab_command(fn, what: str, want=None):
    """``fn()`` (a command of the port's openLAB CLI) with every count at 0
    just before; the launches of rows 1-7 must be ``want`` (a kernel it does
    not name: 0). Returns (fn's result, the counts and the seconds)."""
    import torch

    all_kernel_counts(reset=True)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = all_kernel_counts()
    want = {k: (want or {}).get(k, 0) for k in counts}
    print(f"[openlab] {what}: {secs:.2f} s; launches "
          f"{ {k: v for k, v in counts.items() if v} or 'none'}")
    check(counts == want, f"openlab {what}: launches {counts}, expected {want}")
    return out, dict(counts, seconds=secs)


def openlab_json(root: Path, rel: str):
    return json.loads((root / rel).read_text())


def openlab_gate_vs_plain(tag: str, vae, Z: np.ndarray, thr: float,
                          bound: float) -> dict:
    """The gate kernel of ``vae``'s cell against its plain version on the
    card, on the windows ``Z`` at the openLAB shape: the largest relative
    mse difference must stay within ``bound`` and every decision at ``thr``
    must be equal. Both are also read against a float64 pass of the model on
    the card, which tells the kernel's own error from the plain path's."""
    import copy

    import torch

    from shm_tpu_torch.train import reconstruction_mse

    mse_k = reconstruction_mse(vae, Z, device="cuda")
    mse_p = reconstruction_mse(vae, Z, fused=False, device="cuda")
    m64 = copy.deepcopy(vae).double().eval()
    with torch.no_grad():
        exact = torch.cat([((z - m64(z)[0]) ** 2).mean(dim=(1, 2)) for z in
                           torch.from_numpy(Z).cuda().double().split(2048)]).cpu().numpy()
    rel = lambda a, b: float(np.max(np.abs(a.astype(np.float64) - b) / np.abs(b)))
    got = dict(windows=len(Z), vs_plain=rel(mse_k, mse_p), kernel_vs_f64=rel(mse_k, exact),
               plain_vs_f64=rel(mse_p, exact),
               gates_differing=int(((mse_k > thr) != (mse_p > thr)).sum()),
               above=int((mse_k > thr).sum()))
    print(f"[openlab] {tag} kernel against its plain version on the card, "
          f"{len(Z)} windows: largest relative mse difference {got['vs_plain']:.3e} "
          f"(limit {bound:g}); against a float64 pass: kernel "
          f"{got['kernel_vs_f64']:.3e}, plain {got['plain_vs_f64']:.3e}; gate "
          f"decisions at {thr:.7f} differing {got['gates_differing']} "
          f"({got['above']} above)")
    check(got["vs_plain"] <= bound and got["gates_differing"] == 0,
          f"{tag}: the kernel and its plain version disagree: {got}")
    return got


def openlab_same_hybrid(root: Path, src: Path, tag: str,
                        auroc_atol: float = OPENLAB_AUROC_ATOL) -> None:
    """test-hybrid's reports under ``root`` against ``src``'s committed ones:
    the six matrices and the anomaly rate exactly, each AUROC within
    ``auroc_atol``."""
    rep = "output/Hybrid_Pipeline/reports/"
    got, want = np.load(root / rep / "cm3_all.npz"), np.load(src / rep / "cm3_all.npz")
    check(sorted(got.files) == sorted(want.files) and all(
        np.array_equal(got[k], want[k]) for k in want.files),
        f"{tag}: confusion matrices differ from the committed cm3_all.npz")
    a = openlab_json(root, rep + "comparison_summary.json")
    b = openlab_json(src, rep + "comparison_summary.json")
    check(a["anomaly_rate"] == b["anomaly_rate"],
          f"{tag}: anomaly rate {a['anomaly_rate']} != {b['anomaly_rate']}")
    worst = 0.0
    for m, n in zip(a["models"], b["models"]):
        check(m["confusion_matrix_counts_3class"] == n["confusion_matrix_counts_3class"],
              f"{tag} {m['name']}: comparison_summary matrix differs")
        d = abs(m["stage2_metrics_on_routed_anomalies"]["auroc_ST"]
                - n["stage2_metrics_on_routed_anomalies"]["auroc_ST"])
        worst = max(worst, d)
        check(d <= auroc_atol, f"{tag} {m['name']}: AUROC off by {d:.3e}")
    print(f"[openlab] {tag}: the six confusion matrices and the anomaly rate "
          f"{a['anomaly_rate']:.6f} equal the committed reports; largest AUROC "
          f"difference {worst:.3e} (limit {auroc_atol:g})")


def openlab_eval(root: Path, src: Path, launches: dict, nums: dict):
    """(a): the eval commands on a copy of the committed root, against its
    committed files, and row 1 against its plain version on the val
    windows; returns test-hybrid's per-window outputs."""
    import torch

    from shm_tpu_torch.cli import openlab as ol
    from shm_tpu_torch.config import OpenLabConfig
    from shm_tpu_torch.ops import fused_vae_gate
    from shm_tpu_torch.train import reconstruction_mse

    cfg = OpenLabConfig()
    paths = ol.Paths(str(root))
    row1 = {fused_vae_gate.__name__: 1}
    (summary, per), launches["test-hybrid"] = openlab_command(
        lambda: ol.cmd_test_hybrid(paths, cfg, device="cuda"), "test-hybrid", row1)
    openlab_same_hybrid(root, src, "test-hybrid")
    for split in ("val", "test"):
        got, launches[f"validate-cnn --split {split}"] = openlab_command(
            lambda: ol.cmd_validate_cnn(paths, cfg, split, device="cuda", plot=False),
            f"validate-cnn --split {split}")
        want = openlab_json(src, f"output/CNN_Validation/artifacts/cnn_{split}_summary.json")
        check(got["confusion_matrix"] == want["confusion_matrix"]
              and got["threshold"] == want["threshold"],
              f"validate-cnn {split}: matrix or threshold differs")
        ref = OPENLAB_CNN_VAL_AUROC_F32 if split == "val" else want["auroc_st"]
        d = abs(got["auroc_st"] - ref)
        print(f"[openlab] validate-cnn {split}: matrix {got['confusion_matrix']} "
              f"and threshold {got['threshold']} the committed ones; AUROC "
              f"{got['auroc_st']:.7f} ({'float32 reading' if split == 'val' else 'committed'} "
              f"{ref:.7f}, committed {want['auroc_st']:.7f})")
        check(d <= OPENLAB_AUROC_ATOL, f"validate-cnn {split}: AUROC off by {d:.3e}")
    got, launches["validate-ml"] = openlab_command(
        lambda: ol.cmd_validate_ml(paths, cfg, device="cuda", plot=False), "validate-ml")
    want = openlab_json(src, "output/ML_Baselines/validation_val/ml_val_summary.json")
    check(got.keys() == want.keys(), f"validate-ml models {list(got)}")
    for name in want:
        d = abs(got[name]["auroc_st"] - want[name]["auroc_st"])
        check(got[name]["confusion_matrix"] == want[name]["confusion_matrix"]
              and got[name]["threshold"] == want[name]["threshold"]
              and d <= OPENLAB_AUROC_ATOL, f"validate-ml {name}: {got[name]}")
        print(f"[openlab] validate-ml {name}: matrix and threshold the committed "
              f"ones, AUROC off by {d:.3e}")
    _, launches["featurize"] = openlab_command(
        lambda: ol.cmd_featurize(paths, cfg), "featurize")
    for rel in ("features/X_feat.npy", "features/y.npy", "features/meta_used.csv"):
        check((root / rel).read_bytes() == (src / rel).read_bytes()
              if rel.endswith(".csv") else
              np.load(root / rel).tobytes() == np.load(src / rel).tobytes(),
              f"featurize: {rel} differs from the committed file")
    _, launches["make-splits"] = openlab_command(
        lambda: ol.cmd_make_splits(paths, cfg), "make-splits")
    check(openlab_json(root, "extracted/run_split.json")
          == openlab_json(src, "extracted/run_split.json"), "make-splits: split differs")
    print("[openlab] featurize: X_feat.npy, y.npy and meta_used.csv equal the "
          "committed files byte for byte; make-splits the committed run_split.json")

    thr_rel = "output/VAE_Validation_and_Thresholding/artifacts/vae_threshold.json"
    committed = openlab_json(src, thr_rel)
    got, launches["validate-vae"] = openlab_command(
        lambda: ol.cmd_validate_vae(paths, cfg, device="cuda", plot=False),
        "validate-vae", row1)
    vae, mu, sd, man = ol._load_openlab_vae(paths, cfg)
    Xc, _, meta = ol._load_extracted(paths)
    vmask = ol._in_runs(meta, got["val_runs"])
    Zv = ol.standardize_clip(Xc[vmask][:, :, man["channels_idx"]], mu, sd,
                             cfg.standardize_clip)
    mse_p = reconstruction_mse(vae, Zv, fused=False, device="cuda")
    normal = ol._labels(meta)[vmask] == ol.LABEL_NORMAL
    from shm_tpu_torch.calibrate import percentile_threshold

    thr_p = percentile_threshold(mse_p[normal], cfg.threshold_percentile)
    nums["row1_val"] = openlab_gate_vs_plain("row 1 (val windows)", vae, Zv,
                                             got["threshold"], OPENLAB_MSE_RTOL)
    rel_c = abs(got["threshold"] - committed["threshold"]) / committed["threshold"]
    rel_p = abs(got["threshold"] - thr_p) / thr_p
    print(f"[openlab] validate-vae: threshold {got['threshold']:.7f} (committed "
          f"{committed['threshold']:.7f}, relative {rel_c:.3e}, limit "
          f"{OPENLAB_THRESHOLD_RTOL:g}; the plain path on the card "
          f"{thr_p:.7f}, relative {rel_p:.3e}, limit {OPENLAB_THRESHOLD_PLAIN_RTOL:g})")
    check(rel_c <= OPENLAB_THRESHOLD_RTOL and rel_p <= OPENLAB_THRESHOLD_PLAIN_RTOL,
          "validate-vae: threshold off")
    for k in ("n_val_windows", "n_val_normal", "n_val_struct", "n_val_sensor",
              "val_runs", "percentile"):
        check(got[k] == committed[k], f"validate-vae: {k} {got[k]} != {committed[k]}")
    loaded = sorted(m for m in OPENLAB_HOST_ONLY if m in sys.modules)
    check(not loaded, f"the openLAB commands imported {loaded}")
    print(f"[openlab] no module of {OPENLAB_HOST_ONLY} imported by the commands")
    return per


def openlab_scoring(src: Path, per: dict, launches: dict) -> dict:
    """(b) and (c): OpenLabScorer on the test windows (cnn, rf, svm_rbf)
    against test-hybrid and the plain path on the card, timed; row 1 at this
    shape timed beside its plain version and cuDNN; the daemon's /score
    against score()."""
    import io
    import threading
    import urllib.request

    import torch

    from shm_tpu_torch.cli import openlab as ol
    from shm_tpu_torch.ops import fused_vae_gate, fused_vae_gate_reference
    from shm_tpu_torch.ops.fused_vae import kernel_info, vae_params_to_kernel_weights
    from shm_tpu_torch.serve_http import _load_scorer, _parse_args, make_server
    from shm_tpu_torch.serve_openlab import OpenLabScorer

    paths = ol.Paths(str(src))
    Xc, Xr, meta = ol._load_extracted(paths)
    split = openlab_json(src, "extracted/run_split.json")
    m = ol._in_runs(meta, split["test_runs"])
    X = np.stack([Xc[m], Xr[m]], axis=-1)
    F = np.load(src / "features/X_feat.npy").astype(np.float32)[m]
    N = len(X)
    X8 = np.concatenate([X] * (-(-8192 // N)))[:8192]
    F8 = np.concatenate([F] * (-(-8192 // N)))[:8192]
    nums = {}
    row1 = fused_vae_gate.__name__
    for stage2, name in (("cnn", "CNN"), ("rf", "RF"), ("svm_rbf", "SVM_RBF")):
        sc = OpenLabScorer.from_artifacts(src, stage2=stage2)
        check(sc.device.type == "cuda" and sc.use_fused_gate, f"{stage2}: not on the kernel")
        feats = None if stage2 == "cnn" else F
        out, c = openlab_command(lambda: sc.score(X, features=feats),
                                 f"OpenLabScorer({stage2}).score of {N} windows",
                                 {row1: 1})
        launches[f"OpenLabScorer {stage2} score"] = c
        check(np.array_equal(out["y_pred"], per["y_pred"][name]),
              f"OpenLabScorer {stage2}: y_pred differs from test-hybrid's")
        check(np.array_equal(out["mse"], per["mse"])
              and np.array_equal(out["anomalous"], per["anomalous"]),
              f"OpenLabScorer {stage2}: mse or gate differs from test-hybrid's")
        thr2 = sc.stage2_threshold
        anom = out["anomalous"].astype(bool)
        margin = float(np.abs(out["p_struct"][anom].astype(np.float64) - thr2).min())
        plain = OpenLabScorer.from_artifacts(src, stage2=stage2, use_fused_gate=False)
        outp = plain.score(X, features=feats)
        rel = float(np.max(np.abs(out["mse"] - outp["mse"]) / np.abs(outp["mse"])))
        check(rel <= OPENLAB_MSE_RTOL and np.array_equal(outp["anomalous"], out["anomalous"])
              and np.array_equal(outp["y_pred"], out["y_pred"]),
              f"OpenLabScorer {stage2}: kernel and plain paths disagree ({rel:.3e})")
        rates = []
        for XX, FF in ((X, feats), (X8, None if stage2 == "cnn" else F8)):
            ts = []
            for _ in range(OPENLAB_REPS):
                t0 = time.perf_counter()
                sc.score(XX, features=FF)
                ts.append(time.perf_counter() - t0)
            rates.append(len(XX) / float(np.median(ts)))
        nums[stage2] = dict(wps=rates[0], wps_8192=rates[1], mse_rel=rel,
                            margin=margin)
        if stage2 != "rf":
            profile_device(lambda: sc.score(X, features=feats),
                           f"OpenLabScorer({stage2}).score of {N} windows")
        print(f"[openlab] OpenLabScorer({stage2}): y_pred, mse and gate those of "
              f"test-hybrid ({int(anom.sum())} of {N} anomalous); kernel against "
              f"the plain path on the card: max mse rel {rel:.3e} (limit "
              f"{OPENLAB_MSE_RTOL:g}), decisions equal; nearest p_st to its "
              f"threshold {thr2:.6g}: {margin:.3e}; score() {rates[0]:,.0f} "
              f"windows/s at {N}, {rates[1]:,.0f} at 8,192 (median of "
              f"{OPENLAB_REPS}); {gpu_line()}")

    # row 1 at the openLAB shape: gate-only, the test windows and 8,192
    sc = OpenLabScorer.from_artifacts(src)
    w = vae_params_to_kernel_weights(sc.vae)
    Zg = ol.standardize_clip(X[..., 0][:, :, list(sc.ch_idx)],
                             sc.gate_mu.cpu().numpy(), sc.gate_sd.cpu().numpy(),
                             sc.clip_z)
    nums["row1_test"] = openlab_gate_vs_plain(
        "row 1 (test windows)", sc.vae, Zg, float(sc.threshold), OPENLAB_MSE_RTOL)
    info = kernel_info(200, 64, 1)
    lib = cudnn_vae_pass(sc.vae)
    for n in (N, 8192):
        Z = torch.from_numpy(np.ascontiguousarray(
            np.concatenate([Zg] * (-(-n // N)))[:n])).cuda()
        kw = dict(num_layers=1, use_layernorm=True, with_residual=False)
        k_ms = time_ms(lambda: fused_vae_gate(w, Z, **kw))
        p_ms = time_ms(lambda: fused_vae_gate_reference(w, Z, **kw))
        l_ms = time_ms(lambda: lib(Z))
        nums[f"row1_{n}"] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms)
        print(f"[openlab] row 1 gate-only at N={n}, T=200, D=3, H=64, Z=8, L=1: "
              f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, cuDNN nn.LSTM "
              f"{l_ms:.3f} ms (CUDA events, median of {REPS})")
    print(f"[openlab] kernel_info(200, 64, 1): {info}")
    nums["kernel_info"] = info

    # (c) the daemon: --openlab, /score of the test windows against score()
    args, strides = _parse_args(["--openlab", str(src)])
    daemon = _load_scorer(args)
    srv = make_server(daemon, port=0, series_strides=strides, quiet=True)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        check(srv.warm_event.wait(timeout=300) and
              srv.RequestHandlerClass.warm_error is None, "openLAB daemon warmup")
        url = f"http://127.0.0.1:{srv.server_address[1]}/score"
        body = np.ascontiguousarray(X, np.float32).tobytes()
        hdr = {"Content-Type": "application/octet-stream",
               "X-Shape": ",".join(map(str, X.shape)),
               "Accept": "application/octet-stream"}

        def post():
            rq = urllib.request.Request(url, data=body, headers=hdr)
            with urllib.request.urlopen(rq, timeout=120) as r:
                with np.load(io.BytesIO(r.read())) as z:
                    return {k: z[k] for k in z.files}

        all_kernel_counts(reset=True)
        got = post()
        c = all_kernel_counts()
        ref = daemon.score(X)
        check(np.array_equal(got["mse"], ref["mse"])
              and np.array_equal(got["anomalous"], ref["anomalous"])
              and np.array_equal(got["y_pred"], ref["y_pred"]),
              "openLAB /score differs from score() called directly")
        check(c[row1] == 1, f"openLAB /score launched {c}")
        launches["daemon /score"] = c
        t_http, t_direct = [], []
        for _ in range(OPENLAB_REPS):
            t0 = time.perf_counter()
            post()
            t_http.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            daemon.score(X)
            t_direct.append(time.perf_counter() - t0)
        nums["daemon"] = dict(http_ms=1e3 * float(np.median(t_http)),
                              direct_ms=1e3 * float(np.median(t_direct)))
        print(f"[openlab] daemon --openlab: /score of {N} windows equals score() "
              f"(mse, gate, y_pred bit for bit); {nums['daemon']['http_ms']:.2f} ms "
              f"through the socket against {nums['daemon']['direct_ms']:.2f} ms "
              f"for score() (median of {OPENLAB_REPS})")
    finally:
        srv.shutdown()
        srv.server_close()
    return nums


def openlab_attention(tmp: Path, launches: dict) -> dict:
    """(d): test-hybrid of data/openlab_attention (its extracted/ and
    features/ copied from data/openlab) through row 7 at T=200, and row 7
    against its plain version on the test and val windows."""
    import shutil

    from shm_tpu_torch.cli import openlab as ol
    from shm_tpu_torch.config import OpenLabConfig
    from shm_tpu_torch.ops import fused_attention_gate

    src = ROOT / OPENLAB_ATTENTION_ROOT
    root = tmp / "openlab_attention"
    for sub in ("extracted", "features"):
        shutil.copytree(ROOT / OPENLAB_ROOT / sub, root / sub)
    shutil.copytree(src / "output", root / "output")
    _, launches["test-hybrid (attention)"] = openlab_command(
        lambda: ol.cmd_test_hybrid(ol.Paths(str(root)), OpenLabConfig(), device="cuda"),
        "test-hybrid (data/openlab_attention)", {fused_attention_gate.__name__: 1})
    openlab_same_hybrid(root, src, "test-hybrid (data/openlab_attention)",
                        OPENLAB_ATTENTION_AUROC_ATOL)
    paths, cfg = ol.Paths(str(root)), OpenLabConfig()
    vae, mu, sd, man = ol._load_openlab_vae(paths, cfg)
    thr = openlab_json(src, "output/VAE_Validation_and_Thresholding/artifacts/"
                            "vae_threshold.json")["threshold"]
    Xc, _, meta = ol._load_extracted(paths)
    split = openlab_json(root, "extracted/run_split.json")
    nums = {}
    for s in ("test", "val"):
        m = ol._in_runs(meta, split[f"{s}_runs"])
        Z = ol.standardize_clip(Xc[m][:, :, man["channels_idx"]], mu, sd,
                                cfg.standardize_clip)
        nums[f"row7_{s}"] = openlab_gate_vs_plain(
            f"row 7 ({s} windows)", vae, Z, thr, OPENLAB_ATTENTION_MSE_RTOL)
    return nums


def openlab_training(tmp: Path, launches: dict) -> dict:
    """(e): train-vae (OPENLAB_VAE_EPOCHS epochs) twice from one seed,
    --cell min_gru then validate-vae through row 6, and train-cnn at the
    full recipe twice from one seed, held to OPENLAB_CNN_F2_FLOOR."""
    import shutil

    import torch

    from shm_tpu_torch.cli import openlab as ol
    from shm_tpu_torch.config import OpenLabConfig, replace
    from shm_tpu_torch.ops import fused_mingru_gate

    cfg = OpenLabConfig()
    nums = {}
    roots = []
    for i in range(2):
        r = tmp / f"train_{i}"
        for sub in ("extracted", "features"):
            shutil.copytree(ROOT / OPENLAB_ROOT / sub, r / sub)
        roots.append(r)
    vres = []
    for i, r in enumerate(roots):
        res, launches[f"train-vae run {i + 1}"] = openlab_command(
            lambda: ol.cmd_train_vae(ol.Paths(str(r)), cfg, OPENLAB_VAE_EPOCHS,
                                     device="cuda", plot=False),
            f"train-vae ({OPENLAB_VAE_EPOCHS} epochs, run {i + 1})")
        vres.append(res)
    h = vres[0].history
    check(vres[1].history == h and all(
        torch.equal(vres[0].last_params[k], vres[1].last_params[k])
        for k in vres[0].last_params), "train-vae: two runs from one seed differ")
    check(h["train_total"][-1] < h["train_total"][0], "train-vae: loss did not fall")
    Xc, _, meta = ol._load_extracted(ol.Paths(str(roots[0])))
    split = openlab_json(roots[0], "extracted/run_split.json")
    mask = ol._in_runs(meta, split["train_runs"]) & (ol._labels(meta) == ol.LABEL_NORMAL)
    art = roots[0] / "output/VAE_Training/artifacts"
    Ztr = torch.from_numpy(ol.standardize_clip(
        Xc[mask][:, :, ol.CHANNELS_IDX], np.load(art / "vae_clean_mean.npy"),
        np.load(art / "vae_clean_std.npy"), cfg.standardize_clip)).cuda()
    step = vae_step_ms("lstm", Ztr, vcfg=cfg.vae, tcfg=cfg.vae_train)
    nums["train_vae"] = dict(s_per_epoch=vres[0].seconds / OPENLAB_VAE_EPOCHS,
                             step_ms=step)
    print(f"[openlab] train-vae: {OPENLAB_VAE_EPOCHS} epochs in {vres[0].seconds:.2f} / "
          f"{vres[1].seconds:.2f} s ({nums['train_vae']['s_per_epoch']:.3f} s/epoch, "
          f"16 steps of 64 and 2 validation batches); the two runs bit for bit; "
          f"total {h['train_total'][0]:.6f} -> {h['train_total'][-1]:.6f}; one "
          f"step {step:.3f} ms (plain autograd, CUDA events); {gpu_line()}")

    # the min_gru chain: train-vae --cell, then validate-vae through row 6
    mg = tmp / "train_min_gru"
    for sub in ("extracted", "features"):
        shutil.copytree(ROOT / OPENLAB_ROOT / sub, mg / sub)
    _, launches["train-vae --cell min_gru"] = openlab_command(
        lambda: ol.main(["train-vae", "--root", str(mg), "--cell", "min_gru",
                         "--epochs", str(OPENLAB_CELL_EPOCHS), "--no-plots"]),
        f"train-vae --cell min_gru ({OPENLAB_CELL_EPOCHS} epochs)")
    got, launches["validate-vae (min_gru)"] = openlab_command(
        lambda: ol.cmd_validate_vae(ol.Paths(str(mg)), cfg, device="cuda", plot=False),
        "validate-vae (min_gru)", {fused_mingru_gate.__name__: 1})
    check(np.isfinite(got["threshold"]) and got["n_val_normal"] == 256,
          f"min_gru validate-vae: {got}")
    vae, mu, sd, man = ol._load_openlab_vae(ol.Paths(str(mg)), cfg)
    Xc, _, meta = ol._load_extracted(ol.Paths(str(mg)))
    vm = ol._in_runs(meta, got["val_runs"])
    Zv = ol.standardize_clip(Xc[vm][:, :, man["channels_idx"]], mu, sd,
                             cfg.standardize_clip)
    nums["row6_val"] = openlab_gate_vs_plain("row 6 (val windows)", vae, Zv,
                                             got["threshold"], OPENLAB_MINGRU_MSE_RTOL)

    # train-cnn at the full recipe, twice from one seed
    cres = []
    for i, r in enumerate(roots):
        res, launches[f"train-cnn run {i + 1}"] = openlab_command(
            lambda: ol.cmd_train_cnn(ol.Paths(str(r)), cfg, device="cuda", plot=False),
            f"train-cnn (full recipe, run {i + 1})")
        cres.append(res)
    check(cres[0].history == cres[1].history and all(
        torch.equal(cres[0].variables[k], cres[1].variables[k])
        for k in cres[0].variables), "train-cnn: two runs from one seed differ")
    info = openlab_json(roots[0], "output/CNN_Training/artifacts/cnn_training_info.json")
    f2 = info["val"]["f2_st"]
    ep = len(cres[0].history["epoch"])
    nums["train_cnn"] = dict(s_per_epoch=cres[0].seconds / ep, epochs=ep,
                             best_epoch=cres[0].best_epoch, tuned_val_f2_st=f2)
    print(f"[openlab] train-cnn: {ep} epochs (best {cres[0].best_epoch}) in "
          f"{cres[0].seconds:.2f} s ({cres[0].seconds / ep:.3f} s/epoch of 17 steps "
          f"of 128); two runs bit for bit; tuned VAL ST-F2 {f2:.6f} (floor "
          f"{OPENLAB_CNN_F2_FLOOR}, set before the first card run)")
    check(f2 >= OPENLAB_CNN_F2_FLOOR, f"train-cnn: tuned VAL ST-F2 {f2:.6f} "
          f"below the floor {OPENLAB_CNN_F2_FLOOR}")
    return nums


def phase_openlab() -> dict:
    """Phase 14: the openLAB stage on the card through the port's CLI,
    ``OpenLabScorer`` and the daemon's ``--openlab``, figures off. (a) the
    eval commands on a copy of data/openlab against its committed files;
    (b) OpenLabScorer on the test windows; (c) the daemon; (d) the
    attention root's test-hybrid through row 7; (e) training. Returns the
    counts of rows 1-7 by command."""
    import shutil
    import tempfile

    print(f"[openlab] {gpu_line()}")
    t_phase = time.perf_counter()
    launches = {}
    src = ROOT / OPENLAB_ROOT
    with tempfile.TemporaryDirectory(prefix="chip_smoke_openlab_") as tmp_s:
        tmp = Path(tmp_s)
        root = tmp / "openlab"
        shutil.copytree(src, root, symlinks=True)
        nums = {}
        per = openlab_eval(root, src, launches, nums)
        nums.update(openlab_scoring(src, per, launches))
        nums.update(openlab_attention(tmp, launches))
        nums.update(openlab_training(tmp, launches))
    print(f"[openlab] phase 14 {time.perf_counter() - t_phase:.2f} s: {nums}")
    return {k: {n: v for n, v in c.items() if n != "seconds"}
            for k, c in launches.items()}


# ---------------------------------------------------------------------------
# the openLAB extraction, the .shmx export and the profiling hooks (phase 15)
# ---------------------------------------------------------------------------

# catman exports: 36 header lines, T0 on line 12, a column row, then one
# tab-separated decimal-comma row a sample; a NaN raw sample is written as
# this sentinel, which the extraction reads as an obstruction (<= -1e5)
CATMAN_SENTINEL = -1e6
CATMAN_HEADER_LINES = 36
CATMAN_T0_LINE = 12
CATMAN_NAMES = ("Time_1", "DMS_1", "Time_2", "Force_N", "Force_A", "IWA",
                "Temp_Bridge", "Temp_Ambient", "Time_3", "LWA_1", "LWA_2",
                "LWA_3", "Time_4", "LWA_4", "LWA_5", "NMA_5", "F_total",
                "Comment")
CATMAN_STRIDE = 20
CATMAN_SEQ_LEN = 200


def _catman_value(v: float) -> str:
    """A float32 sample as decimal-comma text that reads back to the same
    float32 through float64 (the float64 repr of its exact value)."""
    return repr(float(v)).replace(".", ",")


def write_catman_runs(src: Path, dest: Path, windows: int | None = None) -> list:
    """Write each run of ``src``'s committed ``extracted/`` windows as a
    catman ``MD_<run>.txt`` under ``dest``: the raw windows (stride 20,
    length 200, overlapping) stitched back into one series a run, NaN as
    ``CATMAN_SENTINEL``, the other 14 channels filler. ``windows``: only
    each run's first that many windows. Returns the run ids written. Writing
    catman files is no feature of the program: this helper makes inputs for
    its extraction from what the repository commits."""
    from shm_tpu_torch.utils.io import load_csv_table

    meta = load_csv_table(src / "extracted" / "window_labels.csv")
    Xr = np.load(src / "extracted" / "X_raw.npy", mmap_mode="r")
    dest.mkdir(parents=True, exist_ok=True)
    runs = list(dict.fromkeys(meta["run_id"].astype(str).tolist()))
    for run in runs:
        idx = np.flatnonzero(meta["run_id"].astype(str) == run)
        if windows is not None:
            idx = idx[:windows]
        starts = meta["win_start_idx"][idx]
        n = int(starts[-1]) + CATMAN_SEQ_LEN
        series = np.full((n, 4), np.nan, np.float32)
        for i, s in zip(idx, starts):
            series[s:s + CATMAN_SEQ_LEN] = Xr[i]
        if np.isnan(series[:, 0]).any():
            raise ValueError(f"{run}: the stitched series has a gap")
        series = np.where(np.isnan(series), np.float32(CATMAN_SENTINEL), series)
        stamp = run[3:].split("_")          # MD_yyyy_mm_dd_HH_MM_SS
        header = [f"catman export {run}"] * CATMAN_HEADER_LINES
        header[CATMAN_T0_LINE] = (f"T0 = {stamp[2]}.{stamp[1]}.{stamp[0]} "
                                  f"{stamp[3]}:{stamp[4]}:{stamp[5]}")
        cols = {"Time_1": np.arange(n) * 0.02, "DMS_1": series[:, 0],
                "LWA_2": series[:, 1], "LWA_3": series[:, 2], "LWA_4": series[:, 3]}
        text = {k: [_catman_value(v) for v in c] for k, c in cols.items()}
        zero = ["0"] * n
        rows = zip(*[text.get(c, zero) if c != "Comment" else [""] * n
                     for c in CATMAN_NAMES])
        body = "\n".join("\t".join(r) for r in rows)
        (dest / f"{run}.txt").write_text(
            "\n".join(header + ["\t".join(CATMAN_NAMES), body]) + "\n",
            encoding="cp1252")
    return runs


# the exported program (the plain path) against the port's plain path on the
# card: the same operations in the same order, so expected bit for bit
EXPORT_MSE_RTOL = 1e-6
EXPORT_ROOTS = (("data/4dof", "lstm"), ("data/4dof_mingru", "min_gru"),
                ("data/4dof_attention", "attention"))
EXPORT_EPOCHS = 2


def windows_differing(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Indices of the windows of two stacks that differ in any bit."""
    return np.flatnonzero([x.tobytes() != y.tobytes() for x, y in zip(a, b)])


def extraction_checks(root: Path, src: Path) -> None:
    """``extract`` under ``root`` against ``src``'s committed files: X_raw
    and labels bit for bit; X_clean but exactly each run's last window (its
    centred moving average is zero-padded where the written series ends);
    window_labels.csv byte for byte but those windows' u_min."""
    from shm_tpu_torch.utils.io import load_csv_table

    got, want = root / "extracted", src / "extracted"
    raw = windows_differing(np.load(got / "X_raw.npy"), np.load(want / "X_raw.npy"))
    clean = windows_differing(np.load(got / "X_clean.npy"), np.load(want / "X_clean.npy"))
    meta = load_csv_table(want / "window_labels.csv")
    run = meta["run_id"]
    last = np.flatnonzero(np.append(run[1:] != run[:-1], True))
    labels = int((load_csv_table(got / "window_labels.csv")["label"] == meta["label"]).sum())
    a = (got / "window_labels.csv").read_text().splitlines()
    b = (want / "window_labels.csv").read_text().splitlines()
    check(len(a) == len(b), "extract: window_labels.csv has another row count")
    lines = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
    cols = {j for i in lines for j, (u, v) in enumerate(
        zip(a[i].split(","), b[i].split(","))) if u != v}
    n = len(run)
    print(f"[phase15] extract: X_raw {n - len(raw)} / {n} windows bit for bit, "
          f"X_clean {n - len(clean)} / {n} (differing {clean.tolist()}, the runs' "
          f"last windows {last.tolist()}), labels {labels} / {n}; window_labels.csv "
          f"{len(a) - len(lines)} / {len(a)} lines byte for byte, the others "
          f"differing in columns {sorted(b[0].split(',')[j] for j in cols)}")
    check(len(raw) == 0 and labels == n and np.array_equal(clean, last),
          "extract: windows or labels differ from the committed files")
    check(cols <= {b[0].split(",").index("u_min")}
          and {i - 1 for i in lines} <= set(last.tolist()),
          "extract: window_labels.csv differs beyond the last windows' u_min")


def phase15_extraction(tmp: Path, launches: dict, nums: dict, timer) -> None:
    """(a): the committed windows as catman files, then the port's
    extract, make-splits and featurize against the committed files, then
    the stage's training and validation (``all`` where sklearn and joblib
    import), row 1 held against its plain version on the val windows."""
    import importlib.util

    from shm_tpu_torch.cli import openlab as ol
    from shm_tpu_torch.config import OpenLabConfig
    from shm_tpu_torch.ops import fused_vae_gate

    src = ROOT / OPENLAB_ROOT
    raw, root = tmp / "raw", tmp / "openlab"
    with timer.span("write catman files"):
        runs = write_catman_runs(src, raw)
    mb = sum(p.stat().st_size for p in raw.iterdir()) / 2 ** 20
    print(f"[phase15] {len(runs)} runs written as catman exports, {mb:.1f} MiB")
    cli = lambda *a: ol.main([*a, "--root", str(root), "--raw-dir", str(raw),
                              "--no-plots"])
    for cmd in ("extract", "make-splits", "featurize"):
        with timer.span(cmd):
            _, launches[cmd] = openlab_command(lambda: cli(cmd), cmd)
    extraction_checks(root, src)
    check(openlab_json(root, "extracted/run_split.json")
          == openlab_json(src, "extracted/run_split.json"), "make-splits: split differs")
    for rel in ("features/X_feat.npy", "features/y.npy"):
        check(np.load(root / rel).tobytes() == np.load(src / rel).tobytes(),
              f"featurize: {rel} differs from the committed file")
    print("[phase15] make-splits: the committed run_split.json; featurize: "
          "X_feat.npy and y.npy the committed files bit for bit")

    row1 = fused_vae_gate.__name__
    epochs = str(EXPORT_EPOCHS)
    have_ml = all(importlib.util.find_spec(m) for m in ("sklearn", "joblib"))
    nums["phase15_ran"] = "all" if have_ml else "train-vae, validate-vae, train-cnn, validate-cnn"
    print(f"[phase15] scikit-learn and joblib {'import' if have_ml else 'do not import'} "
          f"here: running {nums['phase15_ran']}")
    if have_ml:
        with timer.span("all"):
            _, launches["all"] = openlab_command(
                lambda: cli("all", "--epochs", epochs), f"all --epochs {epochs}",
                {row1: 2})
    else:
        for cmd, want in (("train-vae", None), ("validate-vae", {row1: 1}),
                          ("train-cnn", None), ("validate-cnn", None)):
            extra = ("--epochs", epochs) if cmd.startswith("train") else ()
            with timer.span(cmd):
                _, launches[cmd] = openlab_command(lambda: cli(cmd, *extra),
                                                   f"{cmd} {' '.join(extra)}", want)
    cfg, paths = OpenLabConfig(), ol.Paths(str(root))
    thr = openlab_json(root, "output/VAE_Validation_and_Thresholding/artifacts/"
                             "vae_threshold.json")
    check(np.isfinite(thr["threshold"]) and thr["n_val_normal"] == 256,
          f"validate-vae after extract: {thr}")
    vae, mu, sd, man = ol._load_openlab_vae(paths, cfg)
    Xc, _, meta = ol._load_extracted(paths)
    vm = ol._in_runs(meta, thr["val_runs"])
    Zv = ol.standardize_clip(Xc[vm][:, :, man["channels_idx"]], mu, sd,
                             cfg.standardize_clip)
    nums["row1_extracted_val"] = openlab_gate_vs_plain(
        "row 1 (phase 15, val windows of the extracted root)", vae, Zv,
        thr["threshold"], OPENLAB_MSE_RTOL)
    summary = openlab_json(root, "output/CNN_Validation/artifacts/cnn_val_summary.json")
    print(f"[phase15] validate-vae threshold {thr['threshold']:.7f}; validate-cnn "
          f"val accuracy {summary['accuracy']:.4f}, matrix {summary['confusion_matrix']}")


def score_ms(fn, X, reps: int = SERVE_REPS) -> float:
    """Median host-clock ms of ``fn(X)`` (numpy out, so the device is done)."""
    fn(X)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(X)
        ts.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(ts))


def phase15_export(tmp: Path, W, y, nums: dict, timer) -> dict:
    """(b): each root exported by ``python -m shm_tpu_torch.export``,
    loaded on the card and held to the plain and the kernel paths on the
    committed test windows; returns (the artifact's path, its loaded
    scorer) by root."""
    from shm_tpu_torch import export as ex
    from shm_tpu_torch.cli import openlab as ol
    from shm_tpu_torch.evals import confusion_matrix
    from shm_tpu_torch.serve import HybridScorer
    from shm_tpu_torch.serve_openlab import OpenLabScorer

    src = ROOT / OPENLAB_ROOT
    Xc, Xr, meta = ol._load_extracted(ol.Paths(str(src)))
    m = ol._in_runs(meta, openlab_json(src, "extracted/run_split.json")["test_runs"])
    X = np.stack([Xc[m], Xr[m]], axis=-1)
    lbl = {l: i for i, l in enumerate(ol.LABELS_3)}
    yo = np.array([lbl[v] for v in ol._labels(meta)[m]])
    W5 = np.concatenate([W, W])[:N_BENCH]
    cases = [(root, ["--root", str(ROOT / root)], cell, W, y, FAMILIES[cell]["cm_limit"])
             for root, cell in EXPORT_ROOTS]
    cases.append((OPENLAB_ROOT, ["--openlab", str(src)], "openlab", X, yo, 0))
    paths = {}
    for root, flag, cell, R, yr, cm_limit in cases:
        out = tmp / f"{Path(root).name}.shmx"
        t0 = time.perf_counter()
        with timer.span(f"export {root}"):
            ex.main([*flag, "--out", str(out)])
        secs = time.perf_counter() - t0
        with timer.span(f"load {root}"):
            loaded = ex.load_exported_scorer(out)
        check(loaded.device.type == "cuda", f"{root}: the export did not load on the card")
        if cell == "openlab":
            plain = OpenLabScorer.from_artifacts(src, use_fused_gate=False)
            kernel = OpenLabScorer.from_artifacts(src)
        else:
            plain = HybridScorer.from_artifacts(ROOT / root, use_fused_vae=False)
            kernel = HybridScorer.from_artifacts(ROOT / root)
        check(kernel.use_fused_vae and not plain.use_fused_vae,
              f"{root}: the reference scorers' paths")
        all_kernel_counts(reset=True)
        with timer.span(f"exported score {root}") as s:
            got = loaded.score(R)
            s.result = got["mse"]
        counts = all_kernel_counts()
        check(not any(counts.values()), f"{root}: the exported program launched {counts}")
        ref, kout = plain.score(R), kernel.score(R)
        rel = float(np.max(np.abs(got["mse"].astype(np.float64) - ref["mse"])
                           / np.abs(ref["mse"])))
        check(np.array_equal(got["anomalous"], ref["anomalous"])
              and np.array_equal(got["y_pred"], ref["y_pred"])
              and rel <= EXPORT_MSE_RTOL,
              f"{root}: the exported program differs from the plain path "
              f"(max relative mse {rel:.3e})")
        moved = int(np.abs(confusion_matrix(yr, got["y_pred"], 3)
                           - confusion_matrix(yr, kout["y_pred"], 3)).sum()) // 2
        check(np.array_equal(got["anomalous"], kout["anomalous"]) and moved <= cm_limit,
              f"{root}: the exported program against the kernel path: gates or "
              f"{moved} windows moved (limit {cm_limit})")
        rate = {}
        R5 = W5 if cell != "openlab" else R
        rate["exported"] = len(R5) / score_ms(loaded.score, R5) * 1e3
        rate["kernel"] = len(R5) / score_ms(kernel.score, R5) * 1e3
        mb = out.stat().st_size / 2 ** 20
        nums[f"export {root}"] = dict(
            export_s=secs, artifact_mb=mb, max_mse_rel_vs_plain=rel,
            cm_moved_vs_kernel=moved, windows=len(R5),
            exported_windows_per_s=rate["exported"],
            kernel_windows_per_s=rate["kernel"],
            bit_for_bit=bool(rel == 0.0))
        print(f"[phase15] export {root} ({cell}): {secs:.2f} s, {mb:.2f} MiB; on the "
              f"card, {len(R)} test windows: gates and y_pred = the plain path's, "
              f"max relative mse {rel:.3e} (limit {EXPORT_MSE_RTOL:g}); against the "
              f"kernel path gates equal, {moved} windows moved (limit {cm_limit}); "
              f"score() at {len(R5)}: exported {rate['exported']:,.0f} windows/s, "
              f"{'OpenLabScorer' if cell == 'openlab' else 'HybridScorer'} (kernel) "
              f"{rate['kernel']:,.0f}; no kernel launched; {gpu_line()}")
        paths[root] = out, loaded
        del plain, kernel
    return paths


def phase15_daemon(paths: dict, W, nums: dict, timer) -> None:
    """(c): the daemon's --shmx against ExportedScorer.score, and a .shmx
    shadow's counters against the two scorers called directly."""
    from shm_tpu_torch.serve_http import (
        _load_scorer, _load_shadow_scorer, _parse_args, make_server,
    )

    W5 = np.concatenate([W, W])[:N_BENCH]
    art, direct = paths["data/4dof"]
    args, strides = _parse_args(["--shmx", str(art)])
    with timer.span("daemon --shmx startup"):
        srv = serve_in_thread(make_server(_load_scorer(args), port=0,
                                          series_strides=strides))
        check(srv.warm_event.wait(600) and srv.RequestHandlerClass.warm_error is None,
              "--shmx daemon: warmup failed")
    try:
        c = Client(srv)
        code, info = c.json("/info")
        check(code == 200 and info["exported"] is True and info["device"] == "cuda",
              f"--shmx /info: {info}")
        same_outputs("--shmx /score of 5,440 windows vs ExportedScorer.score",
                     c.score(W5), direct.score(W5))
        with timer.span("daemon --shmx /score"):
            sock = score_ms(c.score, W5)
        dir_ms = score_ms(direct.score, W5)
        nums["shmx_daemon"] = dict(score_ms=sock, direct_ms=dir_ms)
        print(f"[phase15] daemon --shmx: /score of {len(W5)} windows {sock:.2f} ms "
              f"against ExportedScorer.score {dir_ms:.2f} ms; bit for bit")
    finally:
        stop_server(srv)

    args, strides = _parse_args(["--root", str(ROOT / "data/4dof"), "--shadow",
                                 str(paths["data/4dof_mingru"][0])])
    primary, shadow = _load_scorer(args), _load_shadow_scorer(args)
    check(shadow.exported, "--shadow F.shmx did not load the export")
    srv = serve_in_thread(make_server(primary, port=0, series_strides=strides,
                                      shadow_scorer=shadow))
    try:
        check(srv.warm_event.wait(600) and srv.RequestHandlerClass.warm_error is None,
              ".shmx shadow daemon: warmup failed")
        c = Client(srv)
        admitted = []
        for R in (W[: len(W) // 3], W[len(W) // 3:]):
            admitted.append(("score", R, None, c.score(R)))
        drain(srv.shadow)
        code, snap = c.json("/metrics", headers={"Accept": "application/json"})
        want = shadow_expected(primary, shadow, admitted)
        got = {k: snap["shadow"][k] for k in want}
        print(f"[phase15] .shmx shadow (data/4dof_mingru's export beside data/4dof): "
              f"/metrics {got}, computed directly {want}")
        check(code == 200 and got == want and snap["shadow"]["dropped_windows"] == 0,
              ".shmx shadow: its counters differ from the direct computation")
    finally:
        stop_server(srv)


def phase_extract_export(W, y) -> dict:
    """Phase 15: the openLAB extraction and the stage after it, the
    ``.shmx`` export of every family and the openLAB CNN mode, the daemon's
    ``--shmx`` and a ``.shmx`` shadow, and a trace, each step timed by
    ``utils/profiling.py::Timer``. Returns the counts of rows 1-7 by
    command."""
    import tempfile

    from shm_tpu_torch.utils.profiling import Timer, trace

    print(f"[phase15] {gpu_line()}")
    t_phase = time.perf_counter()
    timer, launches, nums = Timer(), {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_p15_") as tmp_s:
        tmp = Path(tmp_s)
        phase15_extraction(tmp, launches, nums, timer)
        paths = phase15_export(tmp, W, y, nums, timer)
        phase15_daemon(paths, W, nums, timer)

        loaded = paths["data/4dof"][1]
        with trace(str(tmp / "trace")) as path:
            loaded.score(W)
        events = json.loads(path.read_text())["traceEvents"]
        gpu = [e for e in events if e.get("cat") == "kernel"]
        print(f"[phase15] trace of one exported score(): {path.name}, "
              f"{path.stat().st_size} bytes, {len(events)} events, {len(gpu)} "
              f"device kernels")
        check(path.is_file() and events, "trace: no trace file written")
    for name, r in timer.report().items():
        print(f"[phase15] span {name}: {r['seconds']:.2f} s over {r['calls']} call(s)")
    print(f"[phase15] phase 15 {time.perf_counter() - t_phase:.2f} s: {nums}")
    return {k: {n: v for n, v in c.items() if n != "seconds"}
            for k, c in launches.items()}


MESH_TRAIN_EPOCHS = 2
# (c) trains on the first this many of the 4DOF normal runs' 3,010 train /
# 2,010 val windows (plain autograd, host-bound: ~28 s for all of them on
# one device and on the two shards). Both counts leave a ragged last batch
# of 256, as the whole split does, so the shards still split one
MESH_TRAIN_WINDOWS = (1210, 810)
MESH_TRAIN_RTOL, MESH_PARAM_ATOL = 1e-5, 1e-6     # tests/test_parallel.py
MESH_CNN_STEP_RTOL, MESH_CNN_EPOCHS_RTOL = 1e-5, 1e-2
MESH_BN_RTOL, MESH_BN_ATOL = 1e-4, 1e-6
MESH_DIST_RTOL = 1e-6                             # tests/test_distributed.py
MESH_DIST_TIMEOUT = 180
MESH_REPS = 3


def mesh_scoring(mesh2, W, launches: dict, nums: dict) -> None:
    """(b) the mesh scorers: every family's HybridScorer and the openLAB
    CNN-mode OpenLabScorer with ``make_mesh(1)`` and with two shards on the
    card, against the scorer without a mesh (mse, gate and y_pred bit for
    bit, p_struct within P_STRUCT_ATOL); the family's kernel launched once
    a shard of each bucket and nothing else; windows/s by the host clock."""
    import torch

    from shm_tpu_torch.cli import openlab as ol
    from shm_tpu_torch.ops import fused_vae_gate
    from shm_tpu_torch.parallel import make_mesh
    from shm_tpu_torch.serve import HybridScorer
    from shm_tpu_torch.serve_openlab import OpenLabScorer

    src = ROOT / OPENLAB_ROOT
    Xc, Xr, meta = ol._load_extracted(ol.Paths(str(src)))
    test = ol._in_runs(meta, openlab_json(src, "extracted/run_split.json")
                       ["test_runs"])
    cases = [(cell, fam["kernel"], HybridScorer, ROOT / fam["root"],
              np.resize(W, (N_BENCH,) + W.shape[1:]).astype(np.float32))
             for cell, fam in FAMILIES.items()]
    cases.append(("openlab", fused_vae_gate.__name__, OpenLabScorer, src,
                  np.stack([Xc[test], Xr[test]], axis=-1)))
    for cell, kernel, cls, root, X in cases:
        ref = cls.from_artifacts(root).score(X)
        for tag, mesh in (("make_mesh(1)", make_mesh(1)),
                          ("2 shards on cuda:0", mesh2)):
            sc = cls.from_artifacts(root, mesh=mesh)
            check(sc.mesh is mesh and sc.device.type == "cuda",
                  f"{cell} {tag}: not a mesh scorer on the card")
            buckets = -(-len(X) // sc.max_batch)
            what = f"{cell} {cls.__name__}(mesh={tag}).score of {len(X)}"
            out, c = openlab_command(lambda: sc.score(X), what,
                                     {kernel: buckets * len(mesh.devices)})
            launches[f"{cell} {tag}"] = c
            d = same_outputs(f"phase16 {what}", out, ref)
            walls = []
            for _ in range(MESH_REPS):
                t0 = time.perf_counter()
                sc.score(X)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            rate = len(X) / float(np.median(walls))
            nums[f"{cell} {tag} windows/s"] = rate
            print(f"[phase16] {what}: the scorer without a mesh's outputs "
                  f"(max |p_struct diff| {d:.3e}); {kernel} {c[kernel]} "
                  f"launches ({buckets} bucket(s) x {len(mesh.devices)} "
                  f"shards); {rate:.1f} windows/s (host clock, median of "
                  f"{MESH_REPS})")
            del sc
        torch.cuda.empty_cache()


def mesh_training(mesh2, nums: dict) -> None:
    """(c) train_vae at the 4DOF preset, full width, on the two shards
    against one device (plain path both); the kernel refused under a mesh.
    (d) train_cnn of CNN4DOF on the two shards: one full-batch step (loss,
    BatchNorm statistics) and two epochs."""
    import torch

    from shm_tpu_torch.cli.stage4dof import build_fraction_windows_multi
    from shm_tpu_torch.config import Stage4DofConfig, TrainConfig, replace
    from shm_tpu_torch.data.windows import (
        compute_mean_std_from_windows, normalize_windows,
    )
    from shm_tpu_torch.models.cnn import CNN4DOF
    from shm_tpu_torch.models.vae import vae_from_config
    from shm_tpu_torch.train import train_cnn, train_vae
    from shm_tpu_torch.utils.io import load_json

    cfg = Stage4DofConfig()
    files = load_json(ROOT / "data/4dof/processed/run_splits.json")["normal"]["files"]
    Wtr, Wva = build_fraction_windows_multi(files, (cfg.train_frac, cfg.val_frac), cfg)
    Wtr, Wva = Wtr[:MESH_TRAIN_WINDOWS[0]], Wva[:MESH_TRAIN_WINDOWS[1]]
    Wtr_t = torch.from_numpy(Wtr).cuda()
    mean, std = compute_mean_std_from_windows(Wtr_t)
    Ztr = normalize_windows(Wtr_t, mean, std)
    Zva = normalize_windows(torch.from_numpy(Wva).cuda(), mean, std)
    tcfg = replace(cfg.vae_train, epochs=MESH_TRAIN_EPOCHS)
    runs = {}
    for tag, mesh in (("one device", None), ("2 shards", mesh2)):
        t0 = time.perf_counter()
        runs[tag] = train_vae(vae_from_config(cfg.vae), Ztr, Zva, tcfg,
                              use_kernel=False, mesh=mesh)
        torch.cuda.synchronize()
        nums[f"train_vae {tag} s"] = time.perf_counter() - t0
    ref, got = runs["one device"], runs["2 shards"]
    hist = max(float(np.max(np.abs(np.array(got.history[k])
                                   / np.array(ref.history[k]) - 1)))
               for k in ("train_total", "val_total"))
    par = max(float((got.params[k] - ref.params[k]).abs().max())
              for k in ref.params)
    print(f"[phase16] train_vae {len(Wtr)} / {len(Wva)} windows, H="
          f"{cfg.vae.hidden_dim}, batch {tcfg.batch_size}, {tcfg.epochs} "
          f"epochs, plain path: one device {nums['train_vae one device s']:.2f} "
          f"s, 2 shards {nums['train_vae 2 shards s']:.2f} s; histories max "
          f"rel diff {hist:.3e} (rtol {MESH_TRAIN_RTOL:g}), best epoch "
          f"{got.best_epoch} / {ref.best_epoch}, params max |diff| {par:.3e} "
          f"(atol {MESH_PARAM_ATOL:g})")
    check(hist <= MESH_TRAIN_RTOL and got.best_epoch == ref.best_epoch
          and par <= MESH_PARAM_ATOL, "train_vae on the mesh is not one device's")
    try:
        train_vae(vae_from_config(cfg.vae), Ztr[:256], Zva[:256],
                  replace(tcfg, epochs=1), use_kernel=True, mesh=mesh2)
        check(False, "train_vae(use_kernel=True, mesh=) did not raise")
    except ValueError as e:
        check("mesh" in str(e), f"train_vae kernel refusal: {e}")
        print(f"[phase16] train_vae(use_kernel=True, mesh=) raises: {e}")

    rng = np.random.default_rng(0)
    X = rng.normal(size=(500, cfg.seq_len, cfg.num_features, 2)).astype(np.float32) * 0.3
    y = rng.integers(0, 2, len(X)).astype(np.int32)
    X[y == 1, :, :, 1] += 1.5
    ccfg = replace(cfg.cnn_train, early_stop_patience=0, grad_clip=0.0)
    for epochs, bs in ((1, len(X)), (2, ccfg.batch_size)):
        c = replace(ccfg, epochs=epochs, batch_size=bs)
        r = [train_cnn(CNN4DOF(dropout=cfg.cnn.dropout), X, y, X[:100],
                       y[:100], c, mesh=m) for m in (None, mesh2)]
        d = max(float(np.max(np.abs(np.array(r[1].history[k])
                                    / np.array(r[0].history[k]) - 1)))
                for k in ("train_loss", "val_loss")
                if epochs == 2 or k == "train_loss")
        tol = MESH_CNN_STEP_RTOL if epochs == 1 else MESH_CNN_EPOCHS_RTOL
        msg = f"{epochs} epoch(s) at batch {bs}: losses max rel diff {d:.3e} (rtol {tol:g})"
        check(d <= tol, f"train_cnn on the mesh, {msg}")
        if epochs == 1:
            bn = max(float(((r[1].variables[k] - r[0].variables[k]).abs()
                            - MESH_BN_RTOL * r[0].variables[k].abs()).max())
                     for k in r[0].variables if "running" in k)
            msg += (f"; BatchNorm statistics within rtol {MESH_BN_RTOL:g} "
                    f"atol {MESH_BN_ATOL:g} (worst excess {bn:.3e})")
            check(bn <= MESH_BN_ATOL, f"train_cnn on the mesh, {msg}")
        print(f"[phase16] train_cnn CNN4DOF on 2 shards, {msg}")


def mesh_distributed(tmp: Path, nums: dict) -> None:
    """(e) a world of 1 over NCCL against the steps without a process
    group (a world of 1 sums nothing across processes, so this runs no
    collective: it shows only that NCCL starts on the card); two processes
    of one shard each on the card, over gloo with CUDA tensors (NCCL takes
    one rank a card), against one process with two shards. Each run takes
    two steps: the second step's loss is read on the parameters the first
    step's gradients, summed across the processes, moved."""
    import socket

    import torch

    from shm_tpu_torch.parallel import Mesh, make_mesh
    from shm_tpu_torch.tools.dist_worker import step_losses

    def port() -> int:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            return s.getsockname()[1]

    def workers(n: int, *flags: str):
        p = port()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "shm_tpu_torch.tools.dist_worker", str(r),
             str(n), str(p), *flags], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(n)]
        outs = []
        try:
            for pr in procs:
                out, err = pr.communicate(timeout=MESH_DIST_TIMEOUT)
                check(pr.returncode == 0, f"dist_worker {flags} exited "
                      f"{pr.returncode}: {err[-2000:]}")
                outs.append(out)
        finally:
            for pr in procs:
                if pr.poll() is None:
                    pr.kill()
                    pr.wait(timeout=30)
        lines = [[l for l in o.splitlines() if l.startswith(("LOSS", "BACKEND"))]
                 for o in outs]
        print(f"[phase16] dist_worker x{n} {' '.join(flags)}: {lines}")
        got = [{l.split()[0]: float(l.split()[1]) for l in ls
                if l.startswith("LOSS")} for ls in lines]
        for g in got:
            check(set(g) == {"LOSS", "LOSS2"},
                  f"dist_worker printed {sorted(g)}, not LOSS and LOSS2")
        return [(g["LOSS"], g["LOSS2"]) for g in got]

    t0 = time.perf_counter()
    single = step_losses(make_mesh(1))
    two = step_losses(Mesh((torch.device("cuda", 0),) * 2))
    [nccl] = workers(1)
    check(nccl == tuple(float(f"{v:.9f}") for v in single),
          f"a world of 1 over NCCL: {nccl} != {single}")
    ranks = workers(2, "--backend", "gloo")
    check(ranks[0] == ranks[1], f"the two ranks disagree: {ranks}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(ranks[0], two))
    check(rel <= MESH_DIST_RTOL, f"2 gloo ranks {ranks[0]} vs one process "
          f"with 2 shards {two}: rel {rel:.3e}")
    nums["distributed s"] = time.perf_counter() - t0
    print(f"[phase16] world of 1 over NCCL (no collective runs in a world "
          f"of 1): {nccl} = the steps without a process group; 2 gloo ranks "
          f"on the card, losses of steps 1 and 2 {ranks[0]} vs one process "
          f"with 2 shards {two} (worst rel {rel:.3e}, rtol "
          f"{MESH_DIST_RTOL:g})")


def mesh_commands(tmp: Path) -> None:
    """(f) ``train-vae --devices 1`` is the run without the flag;
    ``--devices 2`` on a one-card host exits non-zero with 'available', and
    the daemon's ``--devices 2`` is refused so too."""
    import shutil

    from shm_tpu_torch.cli.stage4dof import main as cli_main
    from shm_tpu_torch.serve_http import main as serve_main
    from shm_tpu_torch.utils.checkpoint import load_checkpoint

    roots = []
    for flags in ([], ["--devices", "1"]):
        root = tmp / f"devices{len(flags)}"
        (root / "processed").mkdir(parents=True)
        shutil.copy(ROOT / "data/4dof/processed/run_splits.json",
                    root / "processed")
        cli_main(["train-vae", "--root", str(root), "--epochs", "2",
                  "--no-plots"] + flags)
        roots.append(root)
    ck = [load_checkpoint(r / "models/temporal_vae.msgpack") for r in roots]
    flat = lambda t: {k: v for k, v in _flatten_ckpt(t)}
    a, b = flat(ck[0]), flat(ck[1])
    check(a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a),
          "train-vae --devices 1 differs from the run without the flag")
    print("[phase16] train-vae --devices 1: the checkpoint of the run "
          "without the flag, bit for bit")
    r = subprocess.run(
        [sys.executable, "-m", "shm_tpu_torch.cli.stage4dof", "train-vae",
         "--root", str(roots[0]), "--epochs", "1", "--no-plots", "--devices",
         "2"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    check(r.returncode != 0 and "available" in r.stderr,
          f"train-vae --devices 2 on one card: rc {r.returncode}, "
          f"{r.stderr[-500:]}")
    print(f"[phase16] train-vae --devices 2 on one card: exit {r.returncode}, "
          f"{r.stderr.strip().splitlines()[-1]}")
    try:
        serve_main(["--root", str(ROOT / "data/4dof"), "--devices", "2",
                    "--port", "0", "--no-warmup"])
        check(False, "the daemon with --devices 2 started on one card")
    except ValueError as e:
        check("available" in str(e), f"daemon --devices 2: {e}")
        print(f"[phase16] the daemon with --devices 2 on one card: {e}")


def _flatten_ckpt(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten_ckpt(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def phase_mesh(W) -> dict:
    """Phase 16: data parallelism (``shm_tpu_torch/parallel``) on the
    card. The card's machine holds one card, so beside ``make_mesh(1)``
    every mesh path also runs on two shards of the one card
    (``Mesh((cuda:0, cuda:0))``): the split, the per-shard launches, the
    gradient sums and the global BatchNorm on CUDA tensors. Returns the
    launches of rows 1, 6 and 7 by step."""
    import tempfile

    import torch

    from shm_tpu_torch.parallel import Mesh, make_mesh

    print(f"[phase16] {gpu_line()}")
    t_phase = time.perf_counter()
    mesh1 = make_mesh()
    check(mesh1.size == torch.cuda.device_count() == 1,
          f"make_mesh() on the card: {mesh1}")
    try:
        make_mesh(torch.cuda.device_count() + 1)
        check(False, "make_mesh(device_count + 1) did not raise")
    except ValueError as e:
        check("available" in str(e), f"make_mesh over-request: {e}")
        print(f"[phase16] make_mesh() = {mesh1.devices}; make_mesh("
              f"{torch.cuda.device_count() + 1}) raises: {e}")
    mesh2 = Mesh((torch.device("cuda", 0),) * 2)
    print(f"[phase16] the 2-shard mesh, built from the device list: "
          f"{mesh2.devices} (two shards on the one card)")
    launches, nums = {}, {}
    mesh_scoring(mesh2, W, launches, nums)
    mesh_training(mesh2, nums)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_p16_") as tmp_s:
        mesh_distributed(Path(tmp_s), nums)
        mesh_commands(Path(tmp_s))
    print(f"[phase16] phase 16 {time.perf_counter() - t_phase:.2f} s: {nums}")
    return {k: {n: v for n, v in c.items() if n != "seconds"}
            for k, c in launches.items()}


# ---------------------------------------------------------------------------
# Phase 17: bf16 serving, make_hybrid_fn(sample=True) and the int8 CNN
# ---------------------------------------------------------------------------

# The bf16 instance of each gate kernel against its plain bf16 version on
# the same card: (largest, mean) relative mse difference and the largest
# difference of the reconstructions |x - y| (the residuals' square roots).
# ``tests/bf16_readings.py model`` models each instance's sums in its own
# order (rows 1 and 6 chain the bias, then the products, through the mma's
# truncating sum; row 7's resident body sums every product in k-steps of
# 16, a pair of k-steps from zero at a time, the bias after) and prints the
# gap a float32 instance would show, the plain float32 version against the
# plain bf16 one (PERF.md §6). The mean bars sit between the two, and
# bf16_kernel_vs_plain checks that the mean bar is below the float32 gap of
# every case it holds, so that an instance that skipped the bf16 rounding
# fails. The largest difference cannot separate them (a few windows follow
# any change of sum order by up to half the whole bf16 gap, PERF.md §7):
# its bars catch a gross fault. At phase 2's shapes, worst case of the
# model / of the least float32 gap, (max, mean): row 1 1.9e-5 / 2.2e-5,
# 2.4e-6 / 5.1e-6; row 6 1.7e-5 / 8.2e-5, 2.6e-7 / 1.9e-5; row 7 5.2e-4 /
# 7.2e-4, 8.6e-5 / 2.3e-4.
BF16_GATE_TOL = {"lstm": (1e-4, 3.5e-6, 3e-2), "min_gru": (1e-4, 2e-6, 3e-2),
                 "attention": (1.5e-3, 1.5e-4, 5e-2)}
# The same on the 3,636 committed windows, model / float32 gap: row 1
# 4.97e-4 / 9.52e-4, 7.47e-6 / 5.75e-5, |x - y| 3.8e-3; row 6 1.14e-4 /
# 6.43e-4, 6.37e-7 / 6.37e-5, 7.8e-3; row 7 8.03e-4 / 7.39e-4, 4.14e-5 /
# 8.32e-5, 0.124.
BF16_COMMITTED_TOL = {"lstm": (2e-3, 1.5e-5, 1.5e-2),
                      "min_gru": (3e-4, 1.5e-6, 2e-2),
                      "attention": (1.5e-3, 6.5e-5, 0.25)}
# the JAX package's bf16-against-float32 gate readings on the 3,636 test
# windows (tests/bf16_readings.py jax); the bf16 scorer's mse is held to
# twice them against the float32 scorer's, and its mean to at least
# BF16_SCORER_FLOOR of the JAX mean, so that a float32 gate fails
BF16_READINGS = "tests/bf16_readings.npz"
BF16_SCORER_FLOOR = 0.5
BF16_CM_LIMIT = 2               # windows of pipeline_metrics.json's matrix
INT8_AGREE_FLOOR = 0.999        # the JAX package's int8 bar (BENCHMARKS.md)
P17_REPS = 7


def bf16_kernel_vs_plain(tag: str, cell: str, w, Z, kw: dict, io,
                         tol=None) -> float:
    """The bf16 instance of ``cell``'s gate against its plain bf16 version on
    ``Z``, held to ``tol`` (default ``BF16_GATE_TOL[cell]``), whose mean
    bar must be below the float32 gap on ``Z`` (the plain float32 version
    on the window as read against the plain bf16 one); ``w`` packed for
    bf16. Returns the largest |mse diff|."""
    import torch

    from shm_tpu_torch.ops import FUSED_GATES

    _, gate, reference = FUSED_GATES[cell]
    kw = dict(kw, dtype=torch.bfloat16, io_dtype=io)
    mse_k, r_k = gate(w, Z, **kw)
    torch.cuda.synchronize()
    mse_p, r_p = reference(w, Z, **kw)
    mse_32, _ = reference(w, Z.to(io or torch.float32).float(),
                          **dict(kw, dtype=torch.float32, io_dtype=None))
    check(bool(torch.isfinite(mse_k).all()) and mse_k.shape == mse_p.shape,
          f"{tag}: mse not finite / wrong shape")
    rel = (mse_k.double() - mse_p.double()).abs() / mse_p.double().abs()
    gap = (mse_32.double() - mse_p.double()).abs() / mse_p.double().abs()
    dy = 0.0
    if kw.get("with_residual", True):
        want = io or torch.float32
        shape = r_p.shape if kw.get("residual_layout") == "transposed" else Z.shape
        check(r_k.dtype == r_p.dtype == want and r_k.shape == shape,
              f"{tag}: residual {r_k.dtype} {tuple(r_k.shape)}, want {want}")
        dy = float((r_k.double().sqrt() - r_p.double().sqrt()).abs().max())
    else:
        check(r_k is None, f"{tag}: a residual with with_residual=False")
    tmax, tmean, tdy = tol or BF16_GATE_TOL[cell]
    ok = float(rel.max()) <= tmax and float(rel.mean()) <= tmean and dy <= tdy
    print(f"[bf16]   {tag}: mse rel max {float(rel.max()):.3e} mean "
          f"{float(rel.mean()):.3e} (tolerance {tmax:g} / {tmean:g}); |x - y| "
          f"max diff {dy:.3e} (tolerance {tdy:g}) {'ok' if ok else 'FAIL'}; "
          f"float32 gap max {float(gap.max()):.3e} mean "
          f"{float(gap.mean()):.3e}")
    check(ok, f"{tag}: bf16 kernel disagrees with its plain bf16 version")
    check(tmean < float(gap.mean()), f"{tag}: the mean bar {tmean:g} does not "
                                     f"separate bf16 from float32 here")
    return float((mse_k - mse_p).abs().max())


def bf16_counts(reset: bool = False) -> dict:
    """{name: launches} of every instance of the three gate kernels."""
    from shm_tpu_torch.ops import FUSED_GATES

    out = {}
    for _, g, _ in FUSED_GATES.values():
        for attr in ("launches", "bf16_launches"):
            if reset:
                setattr(g, attr, 0)
            out[f"{g.__name__}{'/bf16' if attr[0] == 'b' else ''}"] = getattr(g, attr)
    return out


def phase17_kernels(W) -> dict:
    """(1) each bf16 instance against its plain bf16 version: random weights
    at phase 2's shapes (the openLAB shape among them), float32 and bf16 io;
    then the 3,636 committed windows through each family's root at the io
    it serves, every gate decision equal. Returns {cell: max |mse diff|}."""
    import torch

    from shm_tpu_torch.data.windows import normalize_windows
    from shm_tpu_torch.ops import FUSED_GATES
    from shm_tpu_torch.serve import HybridScorer
    from shm_tpu_torch.utils.io import load_json

    cases = [  # name, N, T, D, Z, H, L, LN, with_residual (phase 2's)
        ("4dof N=1000 (ragged tile)", 1000, 100, 12, 16, 128, 2, True, True),
        ("openLAB 1-layer H=64 T=200 D=3", 300, 200, 3, 8, 64, 1, True, True),
        ("1dof 2-layer H=32 T=80 no LN", 300, 80, 12, 5, 32, 2, False, True),
        ("4dof with_residual=False", 333, 100, 12, 16, 128, 2, True, False),
    ]
    errs = {}
    for cell in FAMILIES:
        weights_fn = FUSED_GATES[cell][0]
        cs = cases + ([("3-layer H=64 T=60", 200, 60, 12, 16, 64, 3, True,
                        True)] if cell == "min_gru" else [])
        worst = 0.0
        for i, (name, N, T, D, Zd, H, L, ln, wr) in enumerate(cs):
            vae, rng = random_vae(100 + i, D, Zd, H, L, ln, cell)
            w = weights_fn(vae, torch.bfloat16)
            Z = torch.from_numpy(rng.normal(size=(N, T, D)).astype(
                np.float32)).cuda()
            for io in (None, torch.bfloat16):
                worst = max(worst, bf16_kernel_vs_plain(
                    f"{cell} {name} io={'bf16' if io else 'f32'}", cell, w, Z,
                    dict(num_layers=L, use_layernorm=ln, with_residual=wr), io))
        root = ROOT / FAMILIES[cell]["root"]
        sc = HybridScorer.from_artifacts(root)
        Z = normalize_windows(torch.from_numpy(W).cuda(), sc.mean,
                              sc.std).contiguous()
        w = weights_fn(sc.vae, torch.bfloat16)
        io = torch.bfloat16 if cell == "attention" else None
        kw = dict(num_layers=sc.vae.num_layers,
                  use_layernorm=sc.vae.use_layernorm)
        worst = max(worst, bf16_kernel_vs_plain(
            f"{cell} committed {len(W)} windows", cell, w, Z, kw, io,
            BF16_COMMITTED_TOL[cell]))
        thr = float(load_json(root / "processed" / "vae_threshold.json")
                    ["threshold"])
        gate = FUSED_GATES[cell][1]
        mk, _ = gate(w, Z, dtype=torch.bfloat16, io_dtype=io, **kw)
        mp, _ = FUSED_GATES[cell][2](w, Z, dtype=torch.bfloat16, io_dtype=io,
                                     **kw)
        flips = int(((mk > thr) != (mp > thr)).sum())
        print(f"[bf16]   {cell} committed windows: gate decisions of the bf16 "
              f"instance against its plain version differing: {flips}")
        check(flips == 0, f"{cell}: bf16 kernel flips {flips} gate decisions")
        errs[cell] = worst
        del sc
    return errs


def phase17_scoring(W, y, cell: str) -> tuple:
    """(2) ``HybridScorer.from_artifacts(fused_dtype=bf16, cnn_dtype=bf16)``
    of a family on the 3,636 windows against the float32 scorer; returns
    (the bf16 instance's launches, the two scorers)."""
    import torch

    from shm_tpu_torch.evals import confusion_matrix
    from shm_tpu_torch.serve import HybridScorer
    from shm_tpu_torch.utils.io import load_json

    fam = FAMILIES[cell]
    root = ROOT / fam["root"]
    tag = f"[bf16 {cell}]"
    f32 = HybridScorer.from_artifacts(root)
    ref = f32.score(W)
    sc = HybridScorer.from_artifacts(root, fused_dtype=torch.bfloat16,
                                     cnn_dtype=torch.bfloat16)
    check(sc.use_fused_vae and sc.cnn.dtype == torch.bfloat16,
          f"{cell}: the bf16 scorer is not on the kernel with a bf16 CNN")
    bf16_counts(reset=True)
    out = sc.score(W)
    counts = bf16_counts()
    name = f"{fam['kernel']}/bf16"
    launches = counts.pop(name)
    print(f"{tag} score() of {len(W)} windows: {name} launches {launches}; "
          f"every other gate instance: {counts}")
    check(launches > 0 and not any(counts.values()),
          f"{cell}: the bf16 scorer did not run the bf16 instance alone")
    check(all(np.isfinite(out[k]).all() for k in ("mse", "p_struct")),
          f"{cell}: non-finite bf16 outputs")
    thr = float(sc.threshold)
    gate_diff = np.flatnonzero(out["anomalous"] != ref["anomalous"])
    y_diff = np.flatnonzero(out["y_pred"] != ref["y_pred"])
    print(f"{tag} against the float32 scorer: gate agreement "
          f"{1 - len(gate_diff) / len(W):.6f}, y_pred agreement "
          f"{1 - len(y_diff) / len(W):.6f} (parity standard 1.000000)")
    jx = np.load(ROOT / BF16_READINGS)
    for i in gate_diff:
        print(f"{tag}   gate flip: window {i} bf16 mse {out['mse'][i]:.6f} "
              f"float32 {ref['mse'][i]:.6f} threshold {thr:.6f} (margin "
              f"{(ref['mse'][i] - thr) / thr:+.3e}); JAX bf16 "
              f"{jx[f'{cell}_bf16'][i]:.6f} float32 {jx[f'{cell}_f32'][i]:.6f}")
    if len(y_diff):
        logits = f32._dispatch(torch.from_numpy(W[y_diff])).logits.cpu().numpy()
        for i, lg in zip(y_diff, logits):
            print(f"{tag}   y_pred flip: window {i} {ref['y_pred'][i]} -> "
                  f"{out['y_pred'][i]}, float32 logit margin "
                  f"{abs(lg[1] - lg[0]):.5f}")
    check(len(gate_diff) == 0, f"{cell}: {len(gate_diff)} gate decisions flip "
                               f"in bf16")
    rel = np.abs(out["mse"].astype(np.float64) - ref["mse"]) / ref["mse"]
    jrel = np.abs(jx[f"{cell}_bf16"] - jx[f"{cell}_f32"]) / jx[f"{cell}_f32"]
    print(f"{tag} mse against the float32 kernel: rel max {rel.max():.3e} "
          f"mean {rel.mean():.3e}; the JAX package's bf16 against float32 "
          f"on the same windows: max {jrel.max():.3e} mean {jrel.mean():.3e} "
          f"(bar: twice these, and a mean of at least {BF16_SCORER_FLOOR} "
          f"of it)")
    check(rel.max() <= 2 * jrel.max() and rel.mean() <= 2 * jrel.mean(),
          f"{cell}: bf16 mse farther from float32 than twice the JAX reading")
    check(rel.mean() >= BF16_SCORER_FLOOR * jrel.mean(),
          f"{cell}: bf16 mse nearer float32 than {BF16_SCORER_FLOOR} of the "
          f"JAX reading: the gate does not run in bf16")
    cm = confusion_matrix(y, out["y_pred"], 3)
    cm_ref = np.asarray(load_json(root / "figures" / "pipeline_metrics.json")
                        ["confusion_matrix_counts"])
    moved = int(np.abs(cm - cm_ref).sum()) // 2
    print(f"{tag} confusion matrix {cm.tolist()} (pipeline_metrics.json "
          f"{cm_ref.tolist()}); windows moved {moved} (limit {BF16_CM_LIMIT})")
    check(moved <= BF16_CM_LIMIT, f"{cell}: bf16 confusion matrix off by "
                                  f"{moved} windows")
    return launches, sc, f32


def phase17_openlab() -> None:
    """(3) OpenLabScorer(gate_io_dtype=bf16) on the 2,042 test pairs: gate
    and y_pred equal to the float32 scorer's, row 1's bf16 instance
    launched and nothing else."""
    import torch

    from shm_tpu_torch.cli import openlab as ol
    from shm_tpu_torch.serve_openlab import OpenLabScorer

    src = ROOT / OPENLAB_ROOT
    Xc, Xr, meta = ol._load_extracted(ol.Paths(str(src)))
    test = ol._in_runs(meta, openlab_json(src, "extracted/run_split.json")
                       ["test_runs"])
    X = np.stack([Xc[test], Xr[test]], axis=-1)
    ref = OpenLabScorer.from_artifacts(src).score(X)
    sc = OpenLabScorer.from_artifacts(src, gate_io_dtype=torch.bfloat16)
    bf16_counts(reset=True)
    out = sc.score(X)
    counts = bf16_counts()
    n = counts.pop("fused_vae_gate/bf16")
    gate_diff = int((out["anomalous"] != ref["anomalous"]).sum())
    y_diff = int((out["y_pred"] != ref["y_pred"]).sum())
    rel = np.abs(out["mse"].astype(np.float64) - ref["mse"]) / ref["mse"]
    print(f"[bf16 openlab] OpenLabScorer(gate_io_dtype=bf16) on {len(X)} "
          f"pairs: fused_vae_gate/bf16 launches {n}, others {counts}; gate "
          f"decisions differing {gate_diff}, y_pred differing {y_diff}; mse "
          f"rel to float32 max {rel.max():.3e} mean {rel.mean():.3e}")
    check(n > 0 and not any(counts.values()),
          "openLAB: the bf16 scorer did not run row 1's bf16 instance alone")
    check(gate_diff == 0 and y_diff == 0,
          "openLAB: bf16 gate or y_pred differ from the float32 scorer")


def phase17_sample(sc, W) -> None:
    """(4) make_hybrid_fn(sample=True) on a scorer's models and windows
    ``W``: one seed twice gives the same output, a second seed another; the
    fused kernel refuses sample=True."""
    import torch

    from shm_tpu_torch.pipeline import make_hybrid_fn

    fn = make_hybrid_fn(sc.vae, sc.cnn, sample=True)
    Wb = torch.from_numpy(W).cuda()
    run = lambda seed: fn(Wb, sc.mean, sc.std, sc.threshold, generator=
                          torch.Generator(device="cuda").manual_seed(seed))
    a, b, c = run(0), run(0), run(1)
    same = all(torch.equal(getattr(a, k), getattr(b, k))
               for k in ("mse", "y_pred", "p_struct", "logits"))
    differ = not torch.equal(a.mse, c.mse)
    det = make_hybrid_fn(sc.vae, sc.cnn)(Wb, sc.mean, sc.std, sc.threshold)
    print(f"[sample] make_hybrid_fn(sample=True) on {len(Wb)} windows: seed 0 "
          f"twice equal {same}; seed 1 differs {differ} (mse max diff "
          f"{float((a.mse - c.mse).abs().max()):.3e}); deterministic pass "
          f"mse max diff from seed 0 {float((a.mse - det.mse).abs().max()):.3e}")
    check(same and differ, "sample=True is not reproducible by its seed")
    try:
        make_hybrid_fn(sc.vae, sc.cnn, sample=True, use_fused_vae=True)
        check(False, "sample=True with use_fused_vae=True did not raise")
    except ValueError as e:
        print(f"[sample] sample=True with use_fused_vae=True raises: {e}")


def phase17_int8(sc, W, y) -> dict:
    """(5) the int8 CNN of the committed data/4dof CNN on phase 3's inputs
    (the float32 kernel's [Z, residual] of the 3,636 windows, its gate):
    3-class y_pred agreement with the folded float network at least
    INT8_AGREE_FLOOR. Returns its times against the float32 and bf16 CNNs."""
    import copy

    import torch

    from shm_tpu_torch.data.windows import normalize_windows
    from shm_tpu_torch.models import cnn_int8
    from shm_tpu_torch.pipeline import make_vae_pass

    Z = normalize_windows(torch.from_numpy(W).cuda(), sc.mean, sc.std)
    with torch.inference_mode():
        mse, xin = make_vae_pass(sc.vae, use_fused_vae=True)(Z)
    anom = (mse > sc.threshold).cpu().numpy()
    q = cnn_int8.quantize_cnn4dof(sc.cnn).to("cuda")
    got = cnn_int8.cnn4dof_int8_apply(q, xin)
    ref = cnn_int8.cnn4dof_folded_apply(sc.cnn, xin)
    y3 = lambda lg: np.where(anom, lg.argmax(1).cpu().numpy() + 1, 0)
    agree = float((y3(got) == y3(ref)).mean())
    acc = float((y3(got) == y).mean())
    print(f"[int8] int8 CNN (conv1 bf16; conv2, fc1, fc2 through "
          f"torch._int_mm) on {len(W)} phase-3 inputs: 3-class agreement "
          f"with the folded float network {agree:.6f} (floor "
          f"{INT8_AGREE_FLOOR}); accuracy {acc:.6f}")
    check(agree >= INT8_AGREE_FLOOR, f"int8 agreement {agree} < "
                                     f"{INT8_AGREE_FLOOR}")
    X = np.resize(xin.cpu().numpy(), (N_BENCH,) + tuple(xin.shape[1:]))
    X = torch.from_numpy(X).cuda()
    bf = copy.deepcopy(sc.cnn)
    bf.dtype = torch.bfloat16
    with torch.inference_mode():
        ms = {"int8": time_ms(lambda: cnn_int8.cnn4dof_int8_apply(q, X),
                              P17_REPS),
              "f32": time_ms(lambda: sc.cnn(X), P17_REPS),
              "bf16": time_ms(lambda: bf(X), P17_REPS)}
    print(f"[int8] CNN at N={N_BENCH}: int8 {ms['int8']:.4f} ms | float32 "
          f"{ms['f32']:.4f} ms | bf16 {ms['bf16']:.4f} ms")
    return ms


def bf16_library_pass(cell: str, vae):
    """The family's library yardstick (``LIBRARY_PASS``) on a bf16 copy of
    the VAE, fed bf16 windows: timed here only."""
    import copy

    import torch

    v = copy.deepcopy(vae).to(torch.bfloat16)
    if cell == "lstm":
        return cudnn_vae_pass(v, torch.bfloat16)
    return LIBRARY_PASS[cell](v)


def phase17_timing(W, cell: str, sc, f32) -> dict:
    """(6) at N=5,440: the bf16 instance against the float32 instance, the
    plain bf16 version and the bf16 library composition; score() windows/s
    of the bf16 and the float32 scorers. Returns the kernels-line numbers."""
    import torch

    from shm_tpu_torch.data.windows import normalize_windows
    from shm_tpu_torch.ops import FUSED_GATES
    from shm_tpu_torch.tools.workload import (
        PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_TF32_FLOPS, bound_ms,
    )

    fam = FAMILIES[cell]
    weights_fn, gate, reference = FUSED_GATES[cell]
    tag = f"[bf16 time {cell}]"
    Wb = np.resize(W, (N_BENCH,) + W.shape[1:]).astype(np.float32)
    vae = sc.vae
    N, T, D = Wb.shape
    Z = normalize_windows(torch.from_numpy(Wb).cuda(), sc.mean,
                          sc.std).contiguous()
    w, wb = weights_fn(vae), weights_fn(vae, torch.bfloat16)
    io = torch.bfloat16 if cell == "attention" else None
    kw = dict(num_layers=vae.num_layers, use_layernorm=vae.use_layernorm)
    bkw = dict(kw, dtype=torch.bfloat16, io_dtype=io)
    lib = bf16_library_pass(cell, vae)
    Zb = Z.to(torch.bfloat16)
    mse_l, _ = lib(Zb)
    mse_k, _ = gate(wb, Z, **bkw)
    print(f"{tag} bf16 {fam['library']} yardstick vs the bf16 instance: mse "
          f"rel max {float(((mse_l.float() - mse_k) / mse_k).abs().max()):.3e}")
    ms = time_ms(lambda: gate(wb, Z, **bkw), P17_REPS)
    ms32 = time_ms(lambda: gate(w, Z, **kw), P17_REPS)
    plain_ms = time_ms(lambda: reference(wb, Z, **bkw), reps=3)
    library_ms = time_ms(lambda: lib(Zb), P17_REPS)
    flops, nbytes = fam["work"](N, T, D, vae.hidden_dim, vae.latent_dim,
                                vae.num_layers)
    if io is not None:                   # x and resid in 2 bytes, not 4
        nbytes -= 2 * N * T * D * 2
    bound, bound_by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
    print(f"{tag} {gate.__name__}/bf16 N={N}: kernel {ms:.4f} ms | float32 "
          f"instance {ms32:.4f} ms | plain bf16 {plain_ms:.4f} ms | bf16 "
          f"{fam['library']} {library_ms:.4f} ms")
    if cell == "attention":
        from shm_tpu_torch.ops.fused_attention import kernel_info

        info = kernel_info(T, vae.hidden_dim, dtype=torch.bfloat16)
        print(f"{tag} the bf16 resident body at T={T}, H={vae.hidden_dim}: "
              f"{info['registers']} registers and {info['spill_bytes']} B of "
              f"local memory (spills) a thread, {info['shared_bytes']} B of "
              f"shared memory a block, {info['blocks_per_sm']} block(s) an SM "
              f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
    print(f"{tag} work {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB -> "
          f"bound {bound:.4f} ms ({bound_by}; bf16 tensor cores "
          f"{flops / PEAK_BF16_FLOPS * 1e3:.4f} ms, one TF32 term "
          f"{flops / PEAK_TF32_FLOPS * 1e3:.4f} ms, bytes "
          f"{nbytes / PEAK_BYTES * 1e3:.4f} ms); kernel at "
          f"{bound / ms * 100:.1f}% of the bf16 bound")
    rates = {}
    for name, s in (("bf16", sc), ("float32", f32)):
        s.score(Wb)                                    # warm the bucket
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            s.score(Wb)
            walls.append(time.perf_counter() - t0)
        rates[name] = N / float(np.median(walls))
    print(f"{tag} score() of {N} windows: bf16 {rates['bf16']:.1f} windows/s, "
          f"float32 {rates['float32']:.1f} windows/s (median of 5)")
    return {"ms": ms, "f32_ms": ms32, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": library_ms,
            "score_windows_per_s": rates}


def phase_bf16(W, y) -> list:
    """Phase 17: bf16 serving (the bf16 instances of rows 1, 6 and 7, the
    bf16 CNN, fused_dtype / cnn_dtype / gate_io_dtype), sample=True and the
    int8 CNN. Returns the bf16 instances' rows of the kernels line."""
    import torch

    print(f"[phase17] {gpu_line()}")
    t_phase = time.perf_counter()
    errs = phase17_kernels(W)
    rows = []
    for cell, fam in FAMILIES.items():
        launches, sc, f32 = phase17_scoring(W, y, cell)
        nums = phase17_timing(W, cell, sc, f32)
        if cell == "lstm":
            phase17_sample(f32, W[np.linspace(0, len(W) - 1, 64).astype(int)])
            nums["int8_cnn_ms"] = phase17_int8(f32, W, y)
        rows.append(dict(name=f"{fam['kernel']}/bf16", route="cuda",
                         source=fam["source"], replaces=fam["replaces"],
                         launches=launches, max_abs_err=errs[cell], **nums))
        del sc, f32
        torch.cuda.empty_cache()
    phase17_openlab()
    print(f"[phase17] phase 17 {time.perf_counter() - t_phase:.2f} s")
    return rows


# ---------------------------------------------------------------------------
# Phase 18: bf16 training (the bf16 instances of rows 2-5, train_vae(kernel_dtype=))
# ---------------------------------------------------------------------------

# Each bf16 instance of rows 2-5 against its plain bf16 version on the card
# (``enc_forward_reference`` / ``dec_forward_reference`` and the explicit
# backward ``enc_backward_reference`` / ``dec_backward_reference`` at
# dtype=bf16), every output and gradient held on (max |diff| / max |plain|,
# mean |diff| / mean |plain|) and on the share of elements more than one
# bf16 ulp off. Two sum orders of one bf16 computation differ where a float32
# difference flips a bf16 rounding, which the recurrence carries on; a
# missing or extra rounding moves every element. The CPU reading
# (``tests/lstm_train_bf16_readings.py ops``: the JAX ops at dtype=bf16
# against the port's plain bf16 versions, phase 6's 1-DOF and H=64 shapes)
# is at most 8.66e-4 on the max, 1.81e-4 on the mean and 4.01% of the
# elements over one ulp, and the mean at most 0.056 of the output's float32
# gap (the plain float32 version against the plain bf16 one, 7.1e-4 to
# 5.2e-3 in the mean on every output that passes through a product). Bars,
# set before the first card run at about four times those: the max
# BF16_TRAIN_MAX_REL, the mean BF16_TRAIN_GAP_FRAC of the case's own float32
# gap (BF16_TRAIN_MEAN_FLOOR where the output passes through no product:
# the output bias's gradient is a float32 sum in both). The share over one
# ulp was set at 16% of the elements too, and the card's first run read
# 16.3% on the encoder's dx (PERF.md §6): dx sums 512 products in
# one chain, and where they cancel, any change of float32 sum order moves
# it past one ulp of its small value. So the share is held, as the mean, to
# a part of the float32 gap's own share over one ulp: BF16_TRAIN_ULP_FRAC
# (the card read at most 0.30 of it, on dx). The float32 instances held to
# the same bars must fail them (the planted fault).
BF16_TRAIN_MAX_REL = 4e-3
BF16_TRAIN_GAP_FRAC = 0.25
BF16_TRAIN_MEAN_FLOOR = 1e-5
BF16_TRAIN_ULP_FRAC = 0.5
# train_vae(kernel_dtype=bf16) against the float32 run from the same seed:
# the largest relative difference of an epoch's validation total must not
# pass that of the float32 run from the next seed (bf16 moves training less
# than a change of seed does). A fixed 3e-3 was set before the first card
# run from the CPU's H=32 seed spread (tests/lstm_train_bf16_readings.py
# train: 2.89e-3; bf16 2.52e-5 there); at full width the card read 4.26e-3
# at epoch 8 (PERF.md §6)


def bf16_train_compare(tag: str, got, ref, gap_ref, tols=None) -> float:
    """One output of a bf16 instance ``got`` against its plain bf16 version
    ``ref``, its bars from the float32 gap (``gap_ref``, the plain float32
    version, against ``ref``); the (max, mean) bar is appended to ``tols``.
    Returns the max |diff|."""
    gap = rel_errs(gap_ref, ref)[1]
    tol = (BF16_TRAIN_MAX_REL, max(BF16_TRAIN_GAP_FRAC * gap, BF16_TRAIN_MEAN_FLOOR))
    over, gap_over = over_one_bf16_ulp(got, ref), over_one_bf16_ulp(gap_ref, ref)
    print(f"[bf16 train]   {tag}: {over} of {ref.numel()} over one bf16 ulp "
          f"(allowed {BF16_TRAIN_ULP_FRAC:g} of the float32 gap's {gap_over}); "
          f"float32 gap mean {gap:.3e}")
    check(over <= BF16_TRAIN_ULP_FRAC * gap_over,
          f"{tag}: {over} of {ref.numel()} elements over one bf16 ulp")
    if tols is not None:
        tols.append(tol)
    return compare_rel(tag, got, ref, tol, "[bf16 train]")


def bf16_train_plain(c, T: int, dtype):
    """The plain versions at ``dtype`` on one case: ((h_last, enc grads,
    enc saved), (recon, dec grads, dec saved))."""
    from shm_tpu_torch.ops.lstm_train import (
        dec_backward_reference, dec_forward_reference, enc_backward_reference,
        enc_forward_reference,
    )

    h, es = enc_forward_reference(c["xs"], c["dm_enc"], *c["enc_w"], dtype=dtype)
    eg = enc_backward_reference(es, c["R_enc"], dtype=dtype)
    r, ds = dec_forward_reference(c["din"], c["dm_dec"], *c["dec_w"], T=T,
                                  dtype=dtype)
    dg = dec_backward_reference(ds, c["R_dec"], dtype=dtype)
    cp = padded_case(c)
    if cp is not c:     # the stash at the kernels' width (padded_case)
        es = enc_forward_reference(cp["xs"], cp["dm_enc"], *cp["enc_w"], dtype=dtype)[1]
        ds = dec_forward_reference(cp["din"], cp["dm_dec"], *cp["dec_w"], T=T,
                                   dtype=dtype)[1]
    return (h, eg, es), (r, dg, ds)


def bf16_train_kernels(c, T: int, dtype):
    """The wrappers at ``dtype`` on one case, as :func:`bf16_train_plain`
    (the gradients through autograd, the stash from the forward alone)."""
    import torch

    from shm_tpu_torch.ops import lstm2_dec_head, lstm2_enc_last
    from shm_tpu_torch.ops.lstm_train import dec_forward_cuda, enc_forward_cuda

    leaf = lambda ts: [a.clone().requires_grad_(True) for a in ts]
    lv = leaf([c["xs"]] + c["enc_w"])
    h = lstm2_enc_last(lv[0], c["dm_enc"], *lv[1:], dtype=dtype)
    eg = torch.autograd.grad((h * c["R_enc"]).sum(), lv)
    lv = leaf([c["din"]] + c["dec_w"])
    r = lstm2_dec_head(lv[0], c["dm_dec"], *lv[1:], T=T, dtype=dtype)
    dg = torch.autograd.grad((r * c["R_dec"]).sum(), lv)
    cp = padded_case(c)
    with torch.no_grad():
        _, es = enc_forward_cuda(cp["xs"], cp["dm_enc"], *cp["enc_w"], dtype=dtype)
        _, ds = dec_forward_cuda(cp["din"], cp["dm_dec"], *cp["dec_w"], T=T,
                                 dtype=dtype)
    torch.cuda.synchronize()
    return (h.detach(), eg, es), (r.detach(), dg, ds)


def bf16_train_outputs(side, stack: int):
    """(name, tensor) of every output of one stack of one side: the
    forward's output, every gradient, the stash, gate stash and final
    state."""
    out, grads, saved = side[stack]
    names = LSTM_GRAD_NAMES[stack]
    rows = [("h_last" if stack == 0 else "recon", out)]
    rows += [(f"d{n}", g) for n, g in zip(names, grads) if g is not None]
    rows += [("stash", saved[3]), ("gate stash", saved[4]), ("final state", saved[5])]
    return rows


def phase18_kernels() -> dict:
    """(1) each bf16 instance of rows 2-5 against its plain bf16 version at
    phase 6's cases: both forwards (output, stash, gate stash, final state),
    every gradient, and both forwards in the validation mode (null mask, no
    stash); the float32 instances held to the same bars must fail them.
    Returns {row: max |diff|} at the 4DOF training shape."""
    import torch

    from shm_tpu_torch.ops import lstm2_dec_head, lstm2_enc_last
    from shm_tpu_torch.ops.lstm_train import (
        bwd_scan_info, dec_forward_reference, enc_forward_reference,
        fwd_scan_info,
    )

    bf16 = torch.bfloat16
    for H in (32, 64, 128):
        for dec in (False, True):
            for scan, info in (("forward", fwd_scan_info(H, dec, True)),
                               ("reverse", bwd_scan_info(H, dec, True))):
                print(f"[bf16 train] {scan} scan H={H} "
                      f"{'decoder' if dec else 'encoder'} bf16 instance: "
                      f"{info['max_active_clusters']} clusters at once, "
                      f"{info['registers']} registers and "
                      f"{info['local_bytes']} B of local memory a thread")
    errs = {}
    for i, (name, T, D, H, B, drop) in enumerate(LSTM_CASES + LSTM_REACH_CASES):
        c = lstm_case(200 + i, T, D, H, B, drop)
        print(f"[bf16 train] {name}: T={T} D={D} H={H} B={B} dropout={drop}")
        with torch.no_grad():
            plain = bf16_train_plain(c, T, bf16)
            gap = bf16_train_plain(c, T, torch.float32)
        kern = bf16_train_kernels(c, T, bf16)
        # the planted fault: the float32 instances held to the bf16 bars
        f32 = bf16_train_kernels(c, T, torch.float32) if i == 0 else None
        for stack, (row_f, row_b) in enumerate((("lstm2_enc_fwd", "lstm2_enc_bwd"),
                                                ("lstm2_dec_fwd", "lstm2_dec_bwd"))):
            tag = "encoder" if stack == 0 else "decoder"
            tols = []
            for (what, got), (_, ref), (_, g32) in zip(
                    bf16_train_outputs(kern, stack), bf16_train_outputs(plain, stack),
                    bf16_train_outputs(gap, stack)):
                e = bf16_train_compare(f"{tag} {what}", got, ref, g32, tols)
                row = row_b if what.startswith("d") else row_f
                if i == 0:
                    errs[row] = max(errs.get(row, 0.0), e)
            if f32 is not None:
                for (what, got), (_, ref), tol in zip(
                        bf16_train_outputs(f32, stack),
                        bf16_train_outputs(plain, stack), tols):
                    if tol[1] > BF16_TRAIN_MEAN_FLOOR:
                        planted_fault(f"the float32 instance's {tag} {what} "
                                      f"held as bf16", got, ref, tol, "[bf16 train]")
        # the trainer's validation mode at bf16: no gradient, null mask
        with torch.no_grad():
            h = lstm2_enc_last(c["xs"], None, *c["enc_w"], dtype=bf16)
            r = lstm2_dec_head(c["din"], None, *c["dec_w"], T=T, dtype=bf16)
            for tag, got, fwd, args in (
                    ("encoder", h, enc_forward_reference, (c["xs"], None, *c["enc_w"])),
                    ("decoder", r, dec_forward_reference, (c["din"], None, *c["dec_w"]))):
                kw = dict(T=T) if tag == "decoder" else {}
                ref = fwd(*args, keep_stash=False, dtype=bf16, **kw)[0]
                g32 = fwd(*args, keep_stash=False, **kw)[0]
                e = bf16_train_compare(f"validation-mode {tag}", got, ref, g32)
                if i == 0:
                    row = "lstm2_enc_fwd" if tag == "encoder" else "lstm2_dec_fwd"
                    errs[row] = max(errs[row], e)
        del c, plain, gap, kern, f32
        torch.cuda.empty_cache()
    return errs


def phase18_train() -> tuple:
    """(2) ``train_vae(kernel_dtype=torch.bfloat16)`` at full width: the
    4DOF recipe cut to ``TRAIN_EPOCHS`` epochs on the committed normal runs,
    with every count at 0 just before; twice (bit for bit), and against the
    float32 run from the same seed. Returns (the bf16 instances' launches,
    the data, the bf16 run's seconds per epoch)."""
    import torch

    from shm_tpu_torch.cli.stage4dof import Paths, build_fraction_windows_multi
    from shm_tpu_torch.config import Stage4DofConfig, replace
    from shm_tpu_torch.data.windows import (
        compute_mean_std_from_windows, normalize_windows,
    )
    from shm_tpu_torch.models.vae import vae_from_config
    from shm_tpu_torch.train import train_vae
    from shm_tpu_torch.utils.io import load_json

    cfg = Stage4DofConfig()
    tcfg = replace(cfg.vae_train, epochs=TRAIN_EPOCHS)
    files = load_json(Paths(str(ROOT / "data" / "4dof")).run_splits)["normal"]["files"]
    Wtr, Wva = build_fraction_windows_multi(files, (cfg.train_frac, cfg.val_frac), cfg)
    Wtr_t = torch.from_numpy(Wtr).cuda()
    mean, std = compute_mean_std_from_windows(Wtr_t)
    Ztr = normalize_windows(Wtr_t, mean, std)
    Zva = normalize_windows(torch.from_numpy(Wva).cuda(), mean, std)
    steps = TRAIN_EPOCHS * -(-len(Wtr) // tcfg.batch_size)
    vals = TRAIN_EPOCHS * -(-len(Wva) // tcfg.batch_size)
    run = lambda dtype: train_vae(vae_from_config(cfg.vae), Ztr, Zva, tcfg,
                                  kernel_dtype=dtype)

    reset_lstm_launch_counts()
    res = run(torch.bfloat16)
    torch.cuda.synchronize()
    bf16, f32 = lstm_launch_counts(True), lstm_launch_counts()
    print(f"[bf16 train] train_vae(kernel_dtype=bf16), {len(Wtr)} train / "
          f"{len(Wva)} val windows, {TRAIN_EPOCHS} epochs = {steps} steps + "
          f"{vals} validation batches in {res.seconds:.2f} s; bf16 launches "
          f"{bf16}, float32 launches {f32}")
    check(all(n == steps for n in bf16.values()),
          f"bf16 launches {bf16} != {steps} training steps of each row")
    check(f32["lstm2_enc_fwd"] == vals and f32["lstm2_dec_fwd"] == vals
          and f32["lstm2_enc_bwd"] == 0 and f32["lstm2_dec_bwd"] == 0,
          f"float32 launches {f32} != {vals} validation forwards and no backward")
    h = res.history
    check(all(np.isfinite(h[k]).all() for k in h), "non-finite bf16 history")
    check(h["train_recon"][-1] < h["train_recon"][0],
          "the bf16 training reconstruction loss did not fall")
    again = run(torch.bfloat16)
    check(again.history == h, "two bf16 runs from one seed differ")
    ref = run(torch.float32).history
    seed = train_vae(vae_from_config(cfg.vae), Ztr, Zva,
                     replace(tcfg, seed=tcfg.seed + 1)).history
    vt = lambda a, b: [abs(x - y) / abs(y) for x, y in zip(a["val_total"], b["val_total"])]
    rel, spread = vt(h, ref), vt(seed, ref)
    print(f"[bf16 train] val total by epoch, bf16 {h['val_total']}, float32 "
          f"{ref['val_total']}, float32 seed {tcfg.seed + 1} "
          f"{seed['val_total']}; bf16 from float32 {['%.3e' % r for r in rel]}, "
          f"seed {tcfg.seed + 1} from seed {tcfg.seed} "
          f"{['%.3e' % r for r in spread]}; second bf16 run bit for bit, "
          f"{again.seconds / TRAIN_EPOCHS:.3f} s/epoch")
    check(max(rel) <= max(spread), f"bf16 moves the validation totals by up "
                                   f"to {max(rel):.3e}, a change of seed by "
                                   f"{max(spread):.3e}")
    return bf16, dict(Ztr=Ztr), again.seconds / TRAIN_EPOCHS


def phase18_timing(ctx) -> dict:
    """(3) at the 4DOF training shape (B=256): each bf16 instance against
    its float32 instance, its plain bf16 version and cuDNN ``nn.LSTM`` in
    bf16 (forward; forward and backward, as phase 8); its bounds at the
    float32 FMA rate of the body it runs and at the bf16 tensor-core rate;
    one bf16 training step against a float32 one, and where its time goes.
    Returns {row: numbers}."""
    import torch
    from torch import nn

    from shm_tpu_torch.config import Stage4DofConfig
    from shm_tpu_torch.models.vae import vae_from_config
    from shm_tpu_torch.ops.lstm_train import (
        dec_backward_reference, dec_forward_reference, enc_backward_reference,
        enc_forward_reference,
    )
    from shm_tpu_torch.tools.workload import (
        PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_F32_FLOPS, bound_ms,
    )
    from shm_tpu_torch.train.vae import batch_loss, draw_batch_noise, make_optimizer

    bf16 = torch.bfloat16
    cfg = Stage4DofConfig()
    T, D, H, B, drop = cfg.seq_len, cfg.vae.input_dim, cfg.vae.hidden_dim, \
        cfg.vae_train.batch_size, cfg.vae.dropout
    c = lstm_case(300, T, D, H, B, drop)
    ms = lstm_kernel_ms(c, T, bf16)
    ms32 = lstm_kernel_ms(c, T, torch.float32)
    # plain bf16 versions: the forward alone, then the explicit backward on
    # its stash
    with torch.no_grad():
        _, es = enc_forward_reference(c["xs"], c["dm_enc"], *c["enc_w"], dtype=bf16)
        _, ds = dec_forward_reference(c["din"], c["dm_dec"], *c["dec_w"], T=T,
                                      dtype=bf16)
        plain = {
            "lstm2_enc_fwd": time_ms(lambda: enc_forward_reference(
                c["xs"], c["dm_enc"], *c["enc_w"], dtype=bf16), reps=3, warm=1),
            "lstm2_enc_bwd": time_ms(lambda: enc_backward_reference(
                es, c["R_enc"], need_dx=False, dtype=bf16), reps=3, warm=1),
            "lstm2_dec_fwd": time_ms(lambda: dec_forward_reference(
                c["din"], c["dm_dec"], *c["dec_w"], T=T, dtype=bf16), reps=3, warm=1),
            "lstm2_dec_bwd": time_ms(lambda: dec_backward_reference(
                ds, c["R_dec"], dtype=bf16), reps=3, warm=1),
        }
    # cuDNN nn.LSTM in bf16 (2 layers, dropout between; the decoder with a
    # Linear head), timed as phase 8 times the float32 column
    enc_l = cudnn_lstm(D, H, drop).to(bf16)
    dec_l = cudnn_lstm(H, H, drop).to(bf16)
    enc_l.flatten_parameters()
    dec_l.flatten_parameters()
    head = nn.Linear(H, D).cuda().to(bf16)
    x_bt = c["xs"].permute(2, 0, 1).contiguous().to(bf16)
    din_bt = c["din"].t().contiguous().to(bf16).requires_grad_(True)
    R_enc_bt = c["R_enc"].t().contiguous().to(bf16)
    R_dec_bt = c["R_dec"].permute(2, 0, 1).contiguous().to(bf16)
    lib = {}
    lib["lstm2_enc_fwd"], lib["lstm2_enc_bwd"] = time_fwd_bwd(
        lambda: (enc_l(x_bt)[1][0][-1] * R_enc_bt).sum(), list(enc_l.parameters()))
    lib["lstm2_dec_fwd"], lib["lstm2_dec_bwd"] = time_fwd_bwd(
        lambda: (head(dec_l(din_bt[:, None].expand(B, T, H))[0]) * R_dec_bt).sum(),
        [din_bt] + list(dec_l.parameters()) + list(head.parameters()))

    out = {}
    for name in LSTM_KERNELS:
        flops, nbytes = lstm_work(name, T, D, H, B, K=H)
        bound, bound_by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
        fma, _ = bound_ms(flops, nbytes, PEAK_F32_FLOPS)
        print(f"[bf16 time] {name}/bf16 T={T} H={H} B={B}: kernel {ms[name]:.4f} "
              f"ms | float32 instance {ms32[name]:.4f} ms | plain bf16 "
              f"{plain[name]:.4f} ms | cuDNN nn.LSTM bf16 {lib[name]:.4f} ms | "
              f"work {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB -> bound "
              f"{bound:.4f} ms at 989 TFLOP/s bf16 ({bound_by}; bytes "
              f"{nbytes / PEAK_BYTES * 1e3:.4f}), {fma:.4f} ms at the 67 "
              f"TFLOP/s float32 FMA rate of the body it runs; kernel at "
              f"{fma / ms[name] * 100:.1f}% of the FMA bound")
        out[name] = dict(ms=ms[name], f32_ms=ms32[name], plain_ms=plain[name],
                         bound_ms=bound, bound_by=bound_by, bound_fma_ms=fma,
                         library_ms=lib[name])

    # one training step, bf16 against float32, same model, batch and noise
    model = vae_from_config(cfg.vae).cuda()
    model.init_parameters(torch.Generator().manual_seed(cfg.vae_train.seed))
    model.train()
    xb = ctx["Ztr"][:B].contiguous()
    gen = torch.Generator(device=xb.device).manual_seed(cfg.vae_train.seed)
    bmask = torch.ones(B, device=xb.device)
    noise = draw_batch_noise(model, B, T, gen, xb.device)
    opt = make_optimizer(model.parameters(), cfg.vae_train)

    def step(dtype):
        opt.zero_grad()
        total, _, _ = batch_loss(model, xb, bmask, *noise, 0.5, True,
                                 kernel_dtype=dtype)
        total.backward()
        opt.step()

    step_ms = time_ms(lambda: step(bf16))
    step32_ms = time_ms(lambda: step(torch.float32))
    kern = sum(ms.values())
    print(f"[bf16 time] one training step (batch {B}, forward + backward + "
          f"optimizer): bf16 instances {step_ms:.3f} ms | float32 instances "
          f"{step32_ms:.3f} ms; the four bf16 kernels sum to {kern:.3f} ms = "
          f"{kern / step_ms * 100:.1f}% of the step; train_vae's bf16 loop "
          f"{ctx['seconds_per_epoch']:.3f} s/epoch")
    profile_device(
        lambda: step(bf16), "one bf16 training step",
        groups={"recurrent scans (lstm2_*_kernel)": ("lstm2_",),
                "gradient pass (contract/reduce/sum/wt_dg)":
                    ("contract_partial", "reduce_partial", "sum_t_rowsum", "wt_dg"),
                "optimizer (foreach/Adam kernels)": ("multi_tensor", "foreach", "adam")},
        rest="autograd glue (LayerNorm, heads, loss, transposes, clip)")
    out["step"] = dict(bf16_ms=step_ms, f32_ms=step32_ms)
    return out


def phase_bf16_training() -> list:
    """Phase 18: bf16 training (the bf16 instances of rows 2-5,
    ``train_vae(kernel_dtype=)``). Returns the bf16 instances' rows of the
    kernels line, ``launches`` the bf16 training run's."""
    import torch

    print(f"[phase18] {gpu_line()}")
    t_phase = time.perf_counter()
    errs = phase18_kernels()
    launches, data, spe = phase18_train()
    nums = phase18_timing(dict(data, seconds_per_epoch=spe))
    rows = []
    for name, replaces in LSTM_KERNELS.items():
        rows.append(dict(name=f"{name}/bf16", route="cuda",
                         source="shm_tpu_torch/ops/csrc/lstm_train.cu",
                         replaces=replaces, launches=launches[name],
                         max_abs_err=errs[name], **nums[name]))
    rows[0]["step_ms"] = nums["step"]
    torch.cuda.empty_cache()
    print(f"[phase18] phase 18 {time.perf_counter() - t_phase:.2f} s")
    return rows


# ---------------------------------------------------------------- phase 19
# Row 7's two softmax forms (the streaming form, `stream=True`, the JAX
# kernel's default past 128 steps) and its two bodies (the long body takes a
# window whose buffers pass a block's shared memory).

P19_CASES = (  # name, N, T, D, Z, H, L, LN, with_residual
    ("4dof T=100 H=128 L=2", 256, 100, 12, 16, 128, 2, True, True),
    ("openLAB T=200 H=64 L=1", 256, 200, 3, 8, 64, 1, True, True),
    # N past the long body's grid (one block an SM): blocks run two windows
    ("long T=137 H=128 L=2", 300, 137, 12, 16, 128, 2, True, True),
    ("long T=200 H=128 L=2 gate-only", 128, 200, 12, 16, 128, 2, True, False),
    ("long T=512 H=128 L=2", 160, 512, 12, 16, 128, 2, True, True),
    ("long T=209 H=64 L=1", 128, 209, 3, 8, 64, 1, True, True),
    ("long T=400 H=64 L=1", 128, 400, 3, 8, 64, 1, True, True),
    ("long T=269 H=32 L=2 no LN", 128, 269, 12, 5, 32, 2, False, True),
)
# phase 17's bf16 bars (max rel mse 1.5e-3, |x - y| 5e-2) with a mean bar
# for each case between the card's reading of either form against its plain
# version (first) and the form gap, the mean relative mse of the plain
# packed form against the plain streaming form on the case's inputs (second;
# set from the CPU's gaps, then read on the card, NVIDIA H100 80GB HBM3):
# (1.303e-4, 1.468e-4), (1.757e-5, 1.397e-4), (1.266e-4, 1.449e-4),
# (1.047e-4, 1.238e-4), (6.516e-5, 7.636e-5), (1.698e-5, 1.156e-4),
# (2.183e-5, 7.695e-5), (1.345e-5, 6.802e-5). At H=128 a kernel running the
# other form reads as close as 0.93 of the gap (1.371e-4 at T=100), inside
# the bar: ``p19_form_control``'s nearer-form check is what catches it.
P19_BF16_MEAN = (1.42e-4, 5e-5, 1.33e-4, 1.12e-4, 6.9e-5, 4.5e-5, 4.2e-5, 3e-5)
P19_BF16_TOL = {c[0]: (1.5e-3, m, 5e-2) for c, m in zip(P19_CASES, P19_BF16_MEAN)}
P19_LONG = (1024, 512, 12, 128, 16, 2)     # (d)'s long body: N, T, D, H, Z, L
P19_REPS = 5
# the float32 mse of the 3,636 committed 4DOF test windows through
# data/4dof_attention's HybridScorer on the card (NVIDIA H100 80GB HBM3),
# made by the tree before the softmax forms and the long body existed
# (commit 0c39835; its resident kernel at T=100, which the packed form
# keeps): ``git archive 0c39835 shm_tpu_torch | tar -x -C DIR``, then
# ``python3 chip_smoke.py --attention-mse DIR OUT``. The kernel sums in a
# fixed order, so the same source gives the same bits on the same card.
ATTENTION_4DOF_MSE = "tests/attention_4dof_packed_mse.npy"


def attention_counts(reset: bool = False) -> dict:
    """Row 7's launch counters: by instance (float32, bf16), and of those
    the streaming form's and the long body's."""
    from shm_tpu_torch.ops import fused_attention_gate as g

    names = ("launches", "bf16_launches", "stream_launches", "long_launches")
    out = {n: getattr(g, n) for n in names}
    if reset:
        for n in names:
            setattr(g, n, 0)
    return out


def p19_launch(call, bf16: bool, stream: bool, long: bool):
    """``call()``, which launches row 7 once: the counters must move for that
    instance, form and body alone."""
    before = attention_counts()
    out = call()
    got = {k: v - before[k] for k, v in attention_counts().items()}
    want = dict(launches=int(not bf16), bf16_launches=int(bf16),
                stream_launches=int(stream), long_launches=int(long))
    check(got == want, f"row 7's counters moved {got}, want {want}")
    return out


def p19_form_control(tag: str, w, Z, kw: dict, io, tmean: float,
                     long: bool) -> None:
    """(a)'s control of the form a bf16 launch ran (the counters follow the
    wrapper's flag, not the kernel): the form gap, the mean relative mse of
    the plain other form from the plain form asked for, must lie above the
    mean bar ``tmean``; and the kernel run in each form must be nearer, in
    the mean, to that form's plain version than to the other's, so that a
    kernel running the other form fails."""
    import torch

    from shm_tpu_torch.ops import fused_attention_gate, fused_attention_gate_reference

    stream = kw["stream"]
    kw = dict(kw, dtype=torch.bfloat16, io_dtype=io)
    mean = lambda a, b: float(((a.double() - b.double()).abs() / b.double().abs()).mean())
    k, plain = {}, {}
    for form in (stream, not stream):
        f = dict(kw, stream=form)
        k[form] = p19_launch(lambda: fused_attention_gate(w, Z, **f)[0], True, form, long)
        torch.cuda.synchronize()
        plain[form] = fused_attention_gate_reference(w, Z, **f)[0]
    gap = mean(plain[not stream], plain[stream])
    d = {(a, b): mean(k[a], plain[b]) for a in k for b in plain}
    print(f"[phase19]   {tag}: form gap {gap:.3e} (mean bar {tmean:g}); the "
          f"kernel {d[stream, stream]:.3e} from the form asked for, "
          f"{d[stream, not stream]:.3e} from the other; run in the other form "
          f"{d[not stream, stream]:.3e} from the form asked for, "
          f"{d[not stream, not stream]:.3e} from its own")
    check(tmean < gap, f"{tag}: the mean bar {tmean:g} does not lie below the "
                       f"form gap {gap:.3e}")
    for a in (stream, not stream):
        check(d[a, a] < d[a, not a], f"{tag}: the kernel run in the "
              f"{'streaming' if a else 'packed'} form is nearer the other form")


def phase19_kernels() -> dict:
    """(a) each body and form against its plain version at P19_CASES,
    float32 (phase 2's bar) and bf16 with float32 and bf16 io (phase 17's,
    with the mean bar of P19_BF16_TOL and ``p19_form_control``); at the two
    resident shapes the long body's streaming form against the resident
    body's, bit for bit in float32 and within phase 17's bars in bf16 (the
    bf16 resident body sums its scores and P.V on the tensor cores), its
    packed form within phase 2's bar. Returns the
    largest |mse diff| of the streaming form and of the long body, by
    precision."""
    import torch

    from shm_tpu_torch.ops import (
        attention_params_to_kernel_weights, fused_attention_gate,
        fused_attention_gate_reference,
    )
    from shm_tpu_torch.ops.fused_attention import _launch, kernel_info, plan

    for T, H in ((512, 128), (400, 64), (269, 32)):
        info = kernel_info(T, H)
        print(f"[phase19] the long body at H={H}: {info['registers']} registers "
              f"and {info['spill_bytes']} B of local memory (spills) a thread, "
              f"{info['threads']} threads and {info['shared_bytes']} B of shared "
              f"memory a block, {info['blocks_per_sm']} block(s) an SM; "
              f"{plan(T, H).slot_floats * 4} B of device memory a block at T={T}")
        check(info["blocks_per_sm"] >= 1, f"the long body does not fit an SM at H={H}")
    errs = {(k, p): 0.0 for k in ("stream", "long") for p in ("f32", "bf16")}
    for i, (name, N, T, D, Zd, H, L, ln, wr) in enumerate(P19_CASES):
        vae, rng = random_vae(1900 + i, D, Zd, H, L, ln, "attention")
        ws = {False: attention_params_to_kernel_weights(vae),
              True: attention_params_to_kernel_weights(vae, torch.bfloat16)}
        Z = torch.from_numpy(rng.normal(size=(N, T, D)).astype(np.float32)).cuda()
        long = plan(T, H).body == "long"
        long16 = plan(T, H, torch.bfloat16).body == "long"
        print(f"[phase19] {name}: N={N} T={T} D={D} H={H} Z={Zd} L={L} LN={ln} "
              f"with_residual={wr}: the {'long' if long else 'resident'} body, "
              f"in bf16 the {'long' if long16 else 'resident'} body")
        for stream in (False, True):
            form = "streaming" if stream else "packed"
            kw = dict(num_layers=L, use_layernorm=ln, with_residual=wr,
                      stream=stream)
            mse, resid = p19_launch(lambda: fused_attention_gate(ws[False], Z, **kw),
                                    False, stream, long)
            torch.cuda.synchronize()
            mse_p, resid_p = fused_attention_gate_reference(ws[False], Z, **kw)
            err = {"f32": compare(f"{form} float32 mse", mse, mse_p)}
            if wr:
                err["f32"] = max(err["f32"], compare(f"{form} float32 resid",
                                                     resid, resid_p))
            err["bf16"] = 0.0
            for io in (None, torch.bfloat16):
                tag = f"attention {name} {form} io={'bf16' if io else 'f32'}"
                err["bf16"] = max(err["bf16"], p19_launch(
                    lambda: bf16_kernel_vs_plain(tag, "attention", ws[True], Z,
                                                 kw, io, P19_BF16_TOL[name]),
                    True, stream, long16))
                p19_form_control(tag, ws[True], Z, kw, io, P19_BF16_TOL[name][1],
                                 long16)
            for prec, lg in (("f32", long), ("bf16", long16)):
                for key, on in (("stream", stream and not lg), ("long", lg)):
                    if on:
                        errs[key, prec] = max(errs[key, prec], err[prec])
        if long:
            continue
        kw = dict(num_layers=L, use_layernorm=ln, with_residual=wr)
        for bf16 in (False, True):
            dt = torch.bfloat16 if bf16 else torch.float32
            a, b = (p19_launch(lambda: _launch(
                ws[bf16], Z, stream=True, dtype=dt, io_dtype=None, body=body,
                **kw), bf16, True, body == "long") for body in ("resident", "long"))
            if bf16:
                # the bf16 resident body runs its scores and P.V on the tensor
                # cores, the long body on the FMA pipes: other sums, held to
                # each other within phase 17's bars
                rel = (b[0].double() - a[0].double()).abs() / a[0].double().abs()
                tmax, tmean, _ = BF16_GATE_TOL["attention"]
                ok = float(rel.max()) <= tmax and float(rel.mean()) <= tmean
                print(f"[phase19]   the long body's streaming form ({dt}) against "
                      f"the resident body's: mse rel max {float(rel.max()):.3e} "
                      f"mean {float(rel.mean()):.3e} (tolerance {tmax:g} / "
                      f"{tmean:g}) {'ok' if ok else 'FAIL'}")
                check(ok, f"{name}: the two bodies' bf16 streaming forms disagree")
                continue
            same = torch.equal(a[0], b[0]) and (not wr or torch.equal(a[1], b[1]))
            print(f"[phase19]   the long body's streaming form ({dt}) against the "
                  f"resident body's: {'bit for bit' if same else 'DIFFERENT'} "
                  f"(max |mse diff| {float((a[0] - b[0]).abs().max()):.3e})")
            check(same, f"{name}: the two bodies' streaming forms differ ({dt})")
        a, b = (p19_launch(lambda: _launch(
            ws[False], Z, stream=False, dtype=torch.float32, io_dtype=None,
            body=body, **kw), False, False, body == "long")
            for body in ("resident", "long"))
        err = compare("the long body's packed form against the resident body's, mse",
                      b[0], a[0])
        if wr:
            err = max(err, compare("... resid", b[1], a[1]))
        errs["long", "f32"] = max(errs["long", "f32"], err)
    return errs


def phase19_openlab() -> dict:
    """(b) OpenLabScorer of data/openlab_attention on the 2,042 test pairs,
    float32 and bf16 io: the streaming form launched and nothing else, gate
    and y_pred equal to the packed form's (the scorer's gate swapped for
    stream=False) and the CNN row's confusion matrix the committed
    cm3_all.npz's. Returns {scorer: row 7's launches}."""
    import functools

    import torch

    from shm_tpu_torch.cli import openlab as ol
    from shm_tpu_torch.evals import confusion_matrix
    from shm_tpu_torch.ops import fused_attention_gate
    from shm_tpu_torch.serve_openlab import OpenLabScorer

    src, base = ROOT / OPENLAB_ATTENTION_ROOT, ROOT / OPENLAB_ROOT
    Xc, Xr, meta = ol._load_extracted(ol.Paths(str(base)))
    test = ol._in_runs(meta, openlab_json(base, "extracted/run_split.json")
                       ["test_runs"])
    X = np.stack([Xc[test], Xr[test]], axis=-1)
    idx = {label: i for i, label in enumerate(ol.LABELS_3)}
    y = np.array([idx[v] for v in ol._labels(meta)[test]])
    with np.load(src / "output/Hybrid_Pipeline/reports/cm3_all.npz") as z:
        want = z["VAE + CNN"]
    launches = {}
    for io in (torch.float32, torch.bfloat16):
        bf16 = io == torch.bfloat16
        tag = f"OpenLabScorer(gate_io_dtype={'bf16' if bf16 else 'float32'})"
        sc = OpenLabScorer.from_artifacts(src, gate_io_dtype=io)
        bf16_counts(reset=True)
        reset_lstm_launch_counts()
        attention_counts(reset=True)
        out = sc.score(X)
        a = attention_counts()
        others = {k: v for k, v in bf16_counts().items()
                  if not k.startswith("fused_attention_gate")}
        others.update({f"{k} ({p})": v for p in (False, True)
                       for k, v in lstm_launch_counts(p).items()})
        n = a["bf16_launches" if bf16 else "launches"]
        launches[tag] = a
        check(n > 0 and a["stream_launches"] == n and a["long_launches"] == 0
              and a["launches" if bf16 else "bf16_launches"] == 0
              and not any(others.values()),
              f"{tag}: row 7's streaming form did not run alone: {a}, {others}")
        cm = confusion_matrix(y, out["y_pred"], 3)
        sc._gate = functools.partial(fused_attention_gate, stream=False)
        packed = sc.score(X)
        gates = int((out["anomalous"] != packed["anomalous"]).sum())
        ys = int((out["y_pred"] != packed["y_pred"]).sum())
        m, mp = out["mse"].astype(np.float64), packed["mse"].astype(np.float64)
        margin = float(np.min(np.abs(m - sc.threshold)) / sc.threshold)
        print(f"[phase19] {tag} on {len(X)} pairs: row 7 {a}; against the "
              f"packed form: gates differing {gates}, y_pred differing {ys}, "
              f"mse rel max {np.max(np.abs(m - mp) / mp):.3e} mean "
              f"{np.mean(np.abs(m - mp) / mp):.3e}; nearest mse to the "
              f"threshold {margin:.3e} relative; the CNN row's matrix "
              f"{cm.tolist()} (committed {want.tolist()})")
        check(gates == 0 and ys == 0, f"{tag}: the two forms' gates or y_pred differ")
        check(np.array_equal(cm, want), f"{tag}: the matrix differs from the "
                                        f"committed cm3_all.npz")
    return launches


def root_4dof_mse(W, root: str) -> np.ndarray:
    """The float32 mse of ``W`` through ``root``'s HybridScorer of the
    importable package (its defaults: the root's gate kernel in float32,
    the default forms)."""
    from shm_tpu_torch.serve import HybridScorer

    sc = HybridScorer.from_artifacts(ROOT / root)
    return np.ascontiguousarray(sc.score(W)["mse"], np.float32)


def root_mse(tree: str, root: str, out: str) -> int:
    """``--root-mse TREE ROOT OUT``: the 3,636 committed 4DOF test windows
    (this checkout's data) through ROOT's HybridScorer (a root of this
    checkout) of the package at TREE, on the card; the mse saved to OUT
    with ``np.save``. How ``GATE_4DOF_MSE`` was made; ``--attention-mse
    TREE OUT`` is ROOT data/4dof_attention, how ``ATTENTION_4DOF_MSE`` was
    made."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(tree).resolve()))
    import shm_tpu_torch
    from shm_tpu_torch.device import set_full_f32_precision
    from shm_tpu_torch.tools.workload import load_trained_workload

    set_full_f32_precision()
    mse = root_4dof_mse(load_trained_workload(ROOT / "data" / "4dof").W, root)
    np.save(out, mse)
    print(f"[root-mse] {root} through {Path(shm_tpu_torch.__file__).parent}: "
          f"{len(mse)} windows, sha256 "
          f"{hashlib.sha256(mse.tobytes()).hexdigest()}; {gpu_line()}")
    return 0


def phase19_4dof(W) -> None:
    """(c) data/4dof_attention's scorer on the 3,636 committed windows at
    T=100: the resident body's packed form alone, its mse bit for bit the
    one the tree before the softmax forms gave (ATTENTION_4DOF_MSE)."""
    attention_counts(reset=True)
    mse = root_4dof_mse(W, "data/4dof_attention")
    a = attention_counts()
    want = np.load(ROOT / ATTENTION_4DOF_MSE)
    same = mse.shape == want.shape and mse.tobytes() == want.tobytes()
    print(f"[phase19] data/4dof_attention HybridScorer on {len(W)} windows: "
          f"row 7 {a}; mse sha256 {hashlib.sha256(mse.tobytes()).hexdigest()}, "
          f"{ATTENTION_4DOF_MSE} {hashlib.sha256(want.tobytes()).hexdigest()}: "
          f"{'bit for bit' if same else 'DIFFERENT'}")
    check(a["launches"] > 0 and a["bf16_launches"] == a["stream_launches"]
          == a["long_launches"] == 0, f"4DOF attention root: row 7 ran {a}")
    check(same, f"4DOF attention root: the mse differs from {ATTENTION_4DOF_MSE}")


def phase19_timing() -> tuple:
    """(d) CUDA-event times: both forms at the 2,042 openLAB test windows
    (the root's VAE, gate-only), at 3,636 windows of T=100 (the 4DOF
    attention root's VAE) and the long body at P19_LONG (a random VAE
    at the 4DOF widths, gate-only), each beside its plain version, the SDPA
    + torch.matmul composition and its bounds (float32 FMA rate; weight
    products in 3xTF32), and at the two resident shapes the long body's
    streaming form beside the resident body's; then
    ``reconstruction_mse`` at P19_LONG with the counts at 0 just before.
    Returns (the numbers, the long body's launches)."""
    import torch

    from shm_tpu_torch.cli import openlab as ol
    from shm_tpu_torch.ops import (
        attention_params_to_kernel_weights, fused_attention_gate,
        fused_attention_gate_reference,
    )
    from shm_tpu_torch.ops.fused_attention import _launch, plan
    from shm_tpu_torch.serve import HybridScorer
    from shm_tpu_torch.serve_openlab import OpenLabScorer
    from shm_tpu_torch.tools.workload import (
        PEAK_BYTES, PEAK_F32_FLOPS, PEAK_TF32_FLOPS, bound_ms,
    )
    from shm_tpu_torch.train import reconstruction_mse

    base = ROOT / OPENLAB_ROOT
    sc = OpenLabScorer.from_artifacts(ROOT / OPENLAB_ATTENTION_ROOT)
    Xc, _, meta = ol._load_extracted(ol.Paths(str(base)))
    test = ol._in_runs(meta, openlab_json(base, "extracted/run_split.json")
                       ["test_runs"])
    Zg = ol.standardize_clip(Xc[test][:, :, list(sc.ch_idx)],
                             sc.gate_mu.cpu().numpy(), sc.gate_sd.cpu().numpy(),
                             sc.clip_z)
    N, D, Zd = len(Zg), Zg.shape[2], sc.vae.latent_dim
    NL, TL, DL, HL, ZL, LL = P19_LONG
    long_vae, rng = random_vae(1999, DL, ZL, HL, LL, True, "attention")
    vae4 = HybridScorer.from_artifacts(ROOT / "data/4dof_attention").vae
    shapes = {
        "openlab": (sc.vae, torch.from_numpy(np.ascontiguousarray(Zg)).cuda(),
                    attention_work(N, 200, D, 64, Zd, 1, with_residual=False)),
        # the 4DOF attention root's VAE on 3,636 random windows of T=100
        "4dof": (vae4, torch.from_numpy(rng.normal(size=(3636, 100, 12)).astype(
            np.float32)).cuda(), attention_work(3636, 100, 12, 128, 16, 2,
                                                with_residual=False)),
        "long": (long_vae, torch.from_numpy(rng.normal(size=(NL, TL, DL)).astype(
            np.float32)).cuda(), attention_work(*P19_LONG, with_residual=False)),
    }
    nums = {}
    for key, (vae, Z, (flops, nbytes)) in shapes.items():
        w = attention_params_to_kernel_weights(vae)
        kw = dict(num_layers=vae.num_layers, use_layernorm=vae.use_layernorm,
                  with_residual=False)
        lib = sdpa_attention_pass(vae)
        b_ms, b_by = bound_ms(flops, nbytes, PEAK_F32_FLOPS)
        # the weight products in 3xTF32 on the tensor cores, the rest
        # (scores, P.V, the heads) at the float32 rate
        dense = attention_dense_flops(Z.shape[0], Z.shape[1], vae.hidden_dim,
                                      vae.num_layers)
        tf32_ms = max(nbytes / PEAK_BYTES, 3 * dense / PEAK_TF32_FLOPS
                      + (flops - dense) / PEAK_F32_FLOPS) * 1e3
        row = dict(windows=Z.shape[0], T=Z.shape[1], H=vae.hidden_dim,
                   L=vae.num_layers, bound_ms=b_ms, bound_by=b_by,
                   bound_tf32_ms=tf32_ms,
                   library_ms=time_ms(lambda: lib(Z), P19_REPS))
        for stream in (True, False):
            pre = "" if stream else "packed_"
            row[f"{pre}ms"] = time_ms(lambda: fused_attention_gate(
                w, Z, stream=stream, **kw), P19_REPS)
            row[f"{pre}plain_ms"] = time_ms(lambda: fused_attention_gate_reference(
                w, Z, stream=stream, **kw), P19_REPS)
        if plan(Z.shape[1], vae.hidden_dim).body == "resident":
            # the long body's streaming form where the resident body's runs:
            # what keeping the resident body's STREAM instance saves
            row["long_body_ms"] = time_ms(lambda: _launch(
                w, Z, stream=True, body="long", dtype=torch.float32,
                io_dtype=None, **kw), P19_REPS)
        nums[key] = row
        print(f"[phase19] times at N={Z.shape[0]} T={Z.shape[1]} H={vae.hidden_dim} "
              f"L={vae.num_layers} gate-only (CUDA events, median of {P19_REPS}): "
              f"streaming form {row['ms']:.3f} ms (plain {row['plain_ms']:.3f}), "
              f"packed form {row['packed_ms']:.3f} ms (plain "
              f"{row['packed_plain_ms']:.3f}), "
              + (f"the long body's streaming form {row['long_body_ms']:.3f} ms, "
                 if "long_body_ms" in row else "") +
              f"SDPA + torch.matmul "
              f"{row['library_ms']:.3f} ms; bound {b_ms:.3f} ms ({b_by}: "
              f"{flops / 1e9:.2f} GFLOP at {PEAK_F32_FLOPS / 1e12:g} TFLOP/s "
              f"float32), {tf32_ms:.3f} ms with its {dense / 1e9:.2f} GFLOP of "
              f"weight products at 3 x {PEAK_TF32_FLOPS / 1e12:g} TFLOP/s TF32; "
              f"{gpu_line()}")
        del Z
        torch.cuda.empty_cache()
    Zl = rng.normal(size=(NL, TL, DL)).astype(np.float32)
    attention_counts(reset=True)
    mse = reconstruction_mse(long_vae, Zl, device="cuda")
    a = attention_counts()
    print(f"[phase19] reconstruction_mse of {NL} windows of T={TL} at H={HL}, "
          f"L={LL}: row 7 {a}")
    check(a["long_launches"] > 0 and a["launches"] == a["long_launches"]
          == a["stream_launches"] and bool(np.isfinite(mse).all()),
          f"reconstruction_mse at T={TL} did not run the long body's "
          f"streaming form alone: {a}")
    return nums, a["long_launches"]


def phase_attention_stream(W) -> list:
    """Phase 19: row 7's streaming form and long body. Returns their rows
    of the kernels line."""
    import torch

    print(f"[phase19] {gpu_line()}")
    t_phase = time.perf_counter()
    errs = phase19_kernels()
    torch.cuda.empty_cache()
    ol_launches = phase19_openlab()
    phase19_4dof(W)
    nums, long_launches = phase19_timing()
    src = "shm_tpu_torch/ops/csrc/fused_attention.cu"
    stream_n = ol_launches["OpenLabScorer(gate_io_dtype=float32)"]["launches"]
    rows = [
        dict(name="fused_attention_gate/stream", route="cuda", source=src,
             replaces="shm_tpu/ops/fused_attention.py:292",
             launches=stream_n, max_abs_err=errs["stream", "f32"],
             max_abs_err_bf16=errs["stream", "bf16"], **nums["openlab"],
             openlab_launches=ol_launches),
        dict(name="fused_attention_gate/long", route="cuda", source=src,
             replaces="shm_tpu/ops/fused_attention.py:157",
             launches=long_launches, max_abs_err=errs["long", "f32"],
             max_abs_err_bf16=errs["long", "bf16"], **nums["long"]),
    ]
    print(f"[phase19] phase 19 {time.perf_counter() - t_phase:.2f} s")
    return rows


# ---------------------------------------------------------------------------
# Phase 20: the activation forms of rows 1 and 6 (sigmoid_impl / tanh_impl)
# and row 1's transposed residual with the batch-in-columns CNN
# ---------------------------------------------------------------------------

P20_FORMS = {  # cell: the forms, (sigmoid_impl, tanh_impl); the first the default
    "lstm": (("exact", "exact"), ("tanh", "exact"), ("exact", "rational"),
             ("tanh", "rational")),
    "min_gru": (("exact", "exact"), ("tanh", "exact")),
}
P20_PRECISIONS = ("f32", "bf16", "bf16_io")
# (b)'s shapes: name, N, T, D, Z, H, L, LN (the 4DOF and openLAB presets)
P20_TRANSPOSED = (("4DOF", 1000, 100, 12, 16, 128, 2, True),
                  ("openLAB", 300, 200, 3, 8, 64, 1, True),
                  # padded H, 32 feature rows (slots past the registers')
                  ("H=48 D=20 Z=40", 300, 60, 20, 40, 48, 2, True))
# (d): the 3,636 committed test windows' float32 mse through each root's
# HybridScorer, made on the card by the tree before the forms and the
# transposed residual existed: `git archive add5d7e shm_tpu_torch | tar -x
# -C build/p23`, then `python3 chip_smoke.py --root-mse build/p23 ROOT OUT`
GATE_4DOF_MSE = {"lstm": ("data/4dof", "tests/lstm_4dof_mse.npy"),
                 "min_gru": ("data/4dof_mingru", "tests/mingru_4dof_mse.npy")}
P20_COUNTERS = ("launches", "bf16_launches", "sigmoid_tanh_launches",
                "tanh_rational_launches", "transposed_launches")
P20_REPS = 7
# launches of rows 1 and 6 in (a), by (row, form): p20_launch counts them
P20_FORM_LAUNCHES: dict = {}


def p20_precision(prec: str):
    import torch

    return {"f32": (torch.float32, None), "bf16": (torch.bfloat16, None),
            "bf16_io": (torch.bfloat16, torch.bfloat16)}[prec]


def form_counts(reset: bool = False) -> dict:
    """{"<row> <counter>": launches} of rows 1 and 6, every instance, form
    and layout counter."""
    from shm_tpu_torch.ops import fused_mingru_gate, fused_vae_gate

    out = {}
    for g in (fused_vae_gate, fused_mingru_gate):
        for k in P20_COUNTERS:
            if hasattr(g, k):
                out[f"{g.__name__} {k}"] = getattr(g, k)
                if reset:
                    setattr(g, k, 0)
    return out


def p20_launch(call, cell: str, bf16: bool, form, transposed: bool = False):
    """``call()``, which launches ``cell``'s gate once: the counters of
    rows 1 and 6 must move for that row, instance, form and layout alone."""
    from shm_tpu_torch.ops import FUSED_GATES

    name = FUSED_GATES[cell][1].__name__
    before = form_counts()
    out = call()
    got = {k: v - before[k] for k, v in form_counts().items()}
    want = {k: 0 for k in got}
    want[f"{name} {'bf16_launches' if bf16 else 'launches'}"] = 1
    if form[0] == "tanh":
        want[f"{name} sigmoid_tanh_launches"] = 1
    if form[1] == "rational":
        want[f"{name} tanh_rational_launches"] = 1
    if transposed:
        want[f"{name} transposed_launches"] = 1
    check(got == want, f"the counters moved {got}, want {want}")
    key = (name, "/".join(form))
    P20_FORM_LAUNCHES[key] = P20_FORM_LAUNCHES.get(key, 0) + 1
    return out


def form_kw(cell: str, form) -> dict:
    kw = dict(sigmoid_impl=form[0])
    if cell == "lstm":
        kw["tanh_impl"] = form[1]
    return kw


def mean_rel(a, b) -> float:
    return float(((a.double() - b.double()).abs() / b.double().abs()).mean())


def p20_forms() -> dict:
    """(a) each form of rows 1 and 6 against its plain version at phase 2's
    shapes (the minGRU's 3-layer case too), float32 under phase 2's bar and
    bf16 with float32 and bf16 io under phase 17's (``bf16_kernel_vs_plain``),
    every launch moving its form's counters alone; where a case's form gap
    (one plain form against another) passes the bar, the kernel run in a
    form must be nearer, in mean relative mse, to its own plain form than to
    the other. Below the bar the counters and the bits carry the check:
    wherever a non-default plain form gives other mse bits than the default
    one on some window, so must the kernel in that form (in bf16 the
    rounding of h and y often hides the form on the plain version too).
    Returns {cell: {precision: max |mse diff|}} and the launches by
    counter."""
    import torch

    from shm_tpu_torch.ops import FUSED_GATES

    cases = [  # phase 2's: name, N, T, D, Z, H, L, LN, with_residual
        ("4dof N=1000 (ragged tile)", 1000, 100, 12, 16, 128, 2, True, True),
        ("openLAB 1-layer H=64 T=200 D=3", 300, 200, 3, 8, 64, 1, True, True),
        ("1dof 2-layer H=32 T=80 no LN", 300, 80, 12, 5, 32, 2, False, True),
        ("4dof with_residual=False", 333, 100, 12, 16, 128, 2, True, False),
    ]
    form_counts(reset=True)
    P20_FORM_LAUNCHES.clear()
    errs = {}
    for cell, forms in P20_FORMS.items():
        weights_fn, gate, reference = FUSED_GATES[cell]
        errs[cell] = {p: 0.0 for p in P20_PRECISIONS}
        extra = ([("3-layer H=64 T=60", 200, 60, 12, 16, 64, 3, True, True)]
                 if cell == "min_gru" else []) + REACH_CASES[cell][:1]
        for i, (name, N, T, D, Zd, H, L, ln, wr) in enumerate(cases + extra):
            vae, rng = random_vae(2000 + i, D, Zd, H, L, ln, cell)
            ws = {False: weights_fn(vae), True: weights_fn(vae, torch.bfloat16)}
            Z = torch.from_numpy(rng.normal(size=(N, T, D)).astype(np.float32)).cuda()
            base = dict(num_layers=L, use_layernorm=ln, with_residual=wr)
            for prec in P20_PRECISIONS:
                dt, io = p20_precision(prec)
                bf16 = dt == torch.bfloat16
                kern, plain = {}, {}
                for form in forms:
                    kw = dict(base, dtype=dt, io_dtype=io, **form_kw(cell, form))
                    tag = f"{cell} {name} {prec} {'/'.join(form)}"
                    if bf16:
                        errs[cell][prec] = max(errs[cell][prec], p20_launch(
                            lambda: bf16_kernel_vs_plain(tag, cell, ws[True], Z,
                                                         kw, io),
                            cell, True, form))
                    kern[form] = p20_launch(lambda: gate(ws[bf16], Z, **kw),
                                            cell, bf16, form)
                    torch.cuda.synchronize()
                    plain[form] = reference(ws[bf16], Z, **kw)
                    if not bf16:
                        print(f"[phase20] {tag}: N={N} T={T} D={D} H={H} L={L}")
                        err = compare("mse", kern[form][0], plain[form][0])
                        if wr:
                            err = max(err, compare("resid", kern[form][1],
                                                   plain[form][1]))
                        errs[cell][prec] = max(errs[cell][prec], err)
                # a launch that ignored its form gives the default's bits
                for form in forms[1:]:
                    n_k, n_p = (int((d[form][0] != d[forms[0]][0]).sum())
                                for d in (kern, plain))
                    print(f"[phase20]   {cell} {name} {prec}: windows whose mse "
                          f"in {'/'.join(form)} has other bits than in "
                          f"{'/'.join(forms[0])}: kernel {n_k}, plain {n_p} "
                          f"of {N}")
                    check(n_k > 0 or n_p == 0, f"{cell} {name} {prec}: the "
                          f"kernel in {form} gives the default form's mse bit "
                          f"for bit, where the plain forms differ")
                # the form control, where a form gap passes the bar
                tmean = BF16_GATE_TOL[cell][1]
                for a in forms:
                    for b in forms:
                        if a == b:
                            continue
                        pa, pb = plain[a][0], plain[b][0]
                        if bf16:
                            gap, bar = mean_rel(pb, pa), tmean
                        else:
                            gap = float(((pb - pa).abs() - RTOL * pa.abs()).max())
                            bar = ATOL
                        near = (mean_rel(kern[a][0], pa), mean_rel(kern[a][0], pb))
                        line = (f"[phase20]   {cell} {name} {prec}: form gap "
                                f"{'/'.join(b)} from {'/'.join(a)} {gap:.3e} "
                                f"(bar {bar:g})")
                        if gap <= bar:
                            print(line + ": under the bar, the counters and "
                                         "the bits above carry the check")
                            continue
                        print(line + f"; the kernel in {'/'.join(a)} {near[0]:.3e} "
                                     f"from its plain form, {near[1]:.3e} from "
                                     f"{'/'.join(b)}'s")
                        check(near[0] < near[1], f"{cell} {name} {prec}: the "
                              f"kernel in {a} is nearer the plain form {b}")
            del Z
    counts = dict(P20_FORM_LAUNCHES)
    print(f"[phase20] (a) launches by row and form: {counts}; counters "
          f"{form_counts()}")
    return errs, counts


def p20_transposed() -> dict:
    """(b) row 1's transposed residual against its NHWC one, bit for bit (the
    mse too), and against the plain transposed version on the same inputs
    (float32 under phase 2's bar, bf16 under phase 17's), at the 4DOF and
    openLAB shapes, in every precision, in the default forms and in the
    tanh-form sigmoid with the rational tanh. Returns {precision: max |diff|
    against the plain version}: mse and residual in float32, mse in bf16."""
    import torch

    from shm_tpu_torch.ops import (fused_vae_gate, fused_vae_gate_reference,
                                   vae_params_to_kernel_weights)
    from shm_tpu_torch.ops.fused_vae import padded_features

    errs = {p: 0.0 for p in P20_PRECISIONS}
    for i, (name, N, T, D, Zd, H, L, ln) in enumerate(P20_TRANSPOSED):
        vae, rng = random_vae(2100 + i, D, Zd, H, L, ln)
        Z = torch.from_numpy(rng.normal(size=(N, T, D)).astype(np.float32)).cuda()
        for prec in P20_PRECISIONS:
            dt, io = p20_precision(prec)
            bf16 = dt == torch.bfloat16
            w = vae_params_to_kernel_weights(vae, dt)
            for form in (("exact", "exact"), ("tanh", "rational")):
                kw = dict(num_layers=L, use_layernorm=ln, dtype=dt, io_dtype=io,
                          sigmoid_impl=form[0], tanh_impl=form[1])
                tkw = dict(kw, residual_layout="transposed")
                tag = f"{name} {prec} {'/'.join(form)} transposed"
                mse, r = p20_launch(lambda: fused_vae_gate(w, Z, **kw), "lstm",
                                    bf16, form)
                mse_t, r_t = p20_launch(lambda: fused_vae_gate(w, Z, **tkw),
                                        "lstm", bf16, form, True)
                same = (torch.equal(mse_t, mse) and r_t.shape == (T, padded_features(D), N)
                        and torch.equal(r_t[:, :D], r.permute(1, 2, 0))
                        and not bool(r_t[:, D:].any()))
                print(f"[phase20] (b) {name} N={N} T={T} D={D} H={H} L={L} {prec} "
                      f"{'/'.join(form)}: transposed residual {tuple(r_t.shape)} "
                      f"{r_t.dtype} against the NHWC one permuted and the mse: "
                      f"{'bit for bit' if same else 'DIFFERENT'}")
                check(same, f"{name} {prec} {form}: the transposed residual or "
                            f"its mse differs from the NHWC call's")
                if bf16:
                    err = p20_launch(lambda: bf16_kernel_vs_plain(
                        tag, "lstm", w, Z, tkw, io), "lstm", True, form, True)
                else:
                    torch.cuda.synchronize()
                    mse_p, r_p = fused_vae_gate_reference(w, Z, **tkw)
                    err = max(compare(f"{tag} mse", mse_t, mse_p),
                              compare(f"{tag} resid", r_t, r_p))
                errs[prec] = max(errs[prec], err)
        del Z
        torch.cuda.empty_cache()
    return errs


def p20_hybrid(wl) -> dict:
    """(c) the LSTM root's 3,636 committed test windows through
    ``make_hybrid_fn(use_fused_vae=True, fused_layout="transposed")`` in
    float32 and with ``fused_dtype=bf16``, every count at 0 just before each
    run: row 1 launched once in its transposed layout and nothing else; the
    gates those of the NHWC path of the same ``fused_dtype`` (whose CNN runs
    in the same precision), ``y_pred`` agreement printed, the confusion
    matrix within ``FAMILIES["lstm"]["cm_limit"]`` windows of
    ``pipeline_metrics.json``. Returns the launches by precision."""
    import copy

    import torch

    from shm_tpu_torch.evals import confusion_matrix
    from shm_tpu_torch.pipeline import make_hybrid_fn
    from shm_tpu_torch.utils.io import load_json

    ref = load_json(ROOT / "data/4dof/figures/pipeline_metrics.json")
    cm_ref = np.asarray(ref["confusion_matrix_counts"])
    vae, W = wl.vae.cuda(), torch.from_numpy(wl.W).cuda()
    mean, std = (torch.as_tensor(a).cuda() for a in (wl.mean, wl.std))
    thr = torch.tensor(wl.threshold, dtype=torch.float32).cuda()
    launches = {}
    for prec in ("f32", "bf16"):
        dt = p20_precision(prec)[0]
        cnn = copy.deepcopy(wl.cnn).cuda()
        cnn.dtype = dt                      # the NHWC path's CNN in dt too
        nhwc = make_hybrid_fn(vae, cnn, use_fused_vae=True, fused_dtype=dt)(
            W, mean, std, thr)
        fn = make_hybrid_fn(vae, cnn, use_fused_vae=True, fused_dtype=dt,
                            fused_layout="transposed")
        form_counts(reset=True)
        bf16_counts(reset=True)
        reset_lstm_launch_counts()
        out = fn(W, mean, std, thr)
        torch.cuda.synchronize()
        counts = form_counts()
        others = {k: v for k, v in bf16_counts().items()
                  if not k.startswith("fused_vae_gate")}
        others.update({f"{k} ({p})": v for p in (False, True)
                       for k, v in lstm_launch_counts(p).items()})
        launches[prec] = counts
        row1 = f"fused_vae_gate {'bf16_launches' if prec == 'bf16' else 'launches'}"
        want = {k: int(k in (row1, "fused_vae_gate transposed_launches"))
                for k in counts}
        y_pred = out.y_pred.cpu().numpy()
        gates = int((out.anomalous != nhwc.anomalous).sum())
        agree = float((out.y_pred == nhwc.y_pred).float().mean())
        cm = confusion_matrix(wl.y, y_pred, 3)
        moved = int(np.abs(cm - cm_ref).sum()) // 2
        ok_out = (bool(torch.isfinite(out.mse).all()) and bool(torch.isfinite(
            out.logits).all()) and out.logits.shape == (len(W), 2))
        print(f"[phase20] (c) make_hybrid_fn(fused_layout='transposed', "
              f"fused_dtype={dt}) on {len(W)} windows: counters {counts}; "
              f"other kernels {others}; gates differing from the NHWC path "
              f"{gates}; y_pred agreement {agree:.6f}; confusion matrix "
              f"{cm.tolist()} (committed {cm_ref.tolist()}), {moved} windows "
              f"moved (limit {FAMILIES['lstm']['cm_limit']})")
        check(counts == want and not any(others.values()),
              f"{prec}: the transposed hybrid launched {counts}, {others}")
        check(ok_out and gates == 0, f"{prec}: the transposed hybrid's gates "
                                     f"differ from the NHWC path's")
        check(moved <= FAMILIES["lstm"]["cm_limit"],
              f"{prec}: the transposed hybrid's confusion matrix is off by {moved}")
    return launches


def p20_default_bits(W) -> None:
    """(d) the default forms' float32 mse of the LSTM and minGRU roots on the
    3,636 committed windows, bit for bit ``GATE_4DOF_MSE``."""
    for cell, (root, ref) in GATE_4DOF_MSE.items():
        mse = root_4dof_mse(W, root)
        want = np.load(ROOT / ref)
        same = mse.shape == want.shape and mse.tobytes() == want.tobytes()
        print(f"[phase20] (d) {root} HybridScorer on {len(W)} windows: mse sha256 "
              f"{hashlib.sha256(mse.tobytes()).hexdigest()}, {ref} "
              f"{hashlib.sha256(want.tobytes()).hexdigest()}: "
              f"{'bit for bit' if same else 'DIFFERENT'}")
        check(same, f"{root}: the default float32 mse differs from {ref}")


def cnn4dof_work(N: int, T: int = 100, D: int = 12):
    """(FLOPs, patch bytes) of ``cnn4dof_apply_transposed`` on N windows:
    the two convolutions' and two dense layers' products, and its float32
    patch buffers written once and read once."""
    t2, d2 = T // 2, D // 2
    flops = 2 * (16 * 18 * T * D + 32 * 144 * t2 * d2
                 + 128 * 32 * (T // 4) * (D // 4) + 2 * 128)
    patches = 4 * (18 * T * D + 144 * t2 * d2)
    return float(N * flops), float(2 * N * patches)


def p20_timing(wl) -> dict:
    """(e) CUDA-event times at N_BENCH windows (the committed test windows
    tiled): the hybrid in each layout, float32 and bf16; the CNN alone,
    CNN4DOF on cuDNN against ``cnn4dof_apply_transposed``, beside its bounds;
    row 1 with its residual in each layout; rows 1 and 6 in each form,
    float32 and bf16, each beside its plain version and a library
    composition. Returns the numbers."""
    import copy

    import torch

    from shm_tpu_torch.data.windows import normalize_windows
    from shm_tpu_torch.models.cnn import cnn4dof_apply_transposed
    from shm_tpu_torch.ops import FUSED_GATES
    from shm_tpu_torch.ops.fused_vae import padded_features, transposed_residual
    from shm_tpu_torch.pipeline import make_hybrid_fn
    from shm_tpu_torch.serve import HybridScorer
    from shm_tpu_torch.tools.workload import (
        PEAK_BYTES, PEAK_F32_FLOPS, PEAK_TF32_FLOPS, bound_ms,
    )

    N = N_BENCH
    Wn = np.resize(wl.W, (N,) + wl.W.shape[1:]).astype(np.float32)
    W = torch.from_numpy(Wn).cuda()
    vae = wl.vae.cuda()
    mean, std = (torch.as_tensor(a).cuda() for a in (wl.mean, wl.std))
    thr = torch.tensor(wl.threshold, dtype=torch.float32).cuda()
    Z = normalize_windows(W, mean, std).contiguous()
    _, T, D = Z.shape
    nums = {"windows": N}
    ms = lambda fn: time_ms(fn, P20_REPS)
    for prec in ("f32", "bf16"):
        dt = p20_precision(prec)[0]
        cnn = copy.deepcopy(wl.cnn).cuda()
        cnn.dtype = dt
        for layout in ("nhwc", "transposed"):
            fn = make_hybrid_fn(vae, cnn, use_fused_vae=True, fused_dtype=dt,
                                fused_layout=layout)
            nums[f"hybrid {layout} {prec}"] = ms(lambda: fn(W, mean, std, thr))
        # the CNN alone on the gate's own residual
        w = FUSED_GATES["lstm"][0](vae, dt)
        _, r = FUSED_GATES["lstm"][1](w, Z, num_layers=vae.num_layers,
                                      use_layernorm=vae.use_layernorm, dtype=dt)
        xin = torch.stack([Z, r], dim=-1)
        Zt = torch.nn.functional.pad(Z, (0, padded_features(D) - D)).permute(1, 2, 0)
        Rt = transposed_residual(r)
        with torch.inference_mode():
            nums[f"cnn cudnn {prec}"] = ms(lambda: cnn(xin))
            nums[f"cnn transposed {prec}"] = ms(
                lambda: cnn4dof_apply_transposed(cnn, Zt, Rt, d_real=D, dtype=dt))
    flops, patch_bytes = cnn4dof_work(N, T, D)
    nums["cnn flops"], nums["cnn patch bytes"] = flops, patch_bytes
    nums["cnn bound_ms"] = flops / PEAK_F32_FLOPS * 1e3
    nums["cnn patch_ms"] = patch_bytes / PEAK_BYTES * 1e3
    print(f"[phase20] (e) at {N} windows (CUDA events, median of {P20_REPS}): "
          f"hybrid NHWC {nums['hybrid nhwc f32']:.3f} / transposed "
          f"{nums['hybrid transposed f32']:.3f} ms float32, NHWC "
          f"{nums['hybrid nhwc bf16']:.3f} / transposed "
          f"{nums['hybrid transposed bf16']:.3f} ms bf16; the CNN alone: "
          f"cuDNN {nums['cnn cudnn f32']:.3f} / transposed "
          f"{nums['cnn transposed f32']:.3f} ms float32, cuDNN "
          f"{nums['cnn cudnn bf16']:.3f} / transposed "
          f"{nums['cnn transposed bf16']:.3f} ms bf16; bounds {flops / 1e9:.2f} "
          f"GFLOP at {PEAK_F32_FLOPS / 1e12:g} TFLOP/s {nums['cnn bound_ms']:.3f} "
          f"ms, the transposed form's {patch_bytes / 1e9:.2f} GB of float32 "
          f"patches at {PEAK_BYTES / 1e12:g} TB/s {nums['cnn patch_ms']:.3f} ms; "
          f"{gpu_line()}")

    rows = {}
    roots = {"lstm": "data/4dof", "min_gru": "data/4dof_mingru"}
    for cell, root in roots.items():
        weights_fn, gate, reference = FUSED_GATES[cell]
        v = HybridScorer.from_artifacts(ROOT / root).vae if cell != "lstm" else vae
        kw = dict(num_layers=v.num_layers, use_layernorm=v.use_layernorm)
        lib = LIBRARY_PASS[cell](v)
        H, Zd, L = v.hidden_dim, v.latent_dim, v.num_layers
        work = (vae_work if cell == "lstm" else mingru_work)(N, T, D, H, Zd, L)
        row = dict(library_ms=ms(lambda: lib(Z)), form_ms={}, form_plain_ms={})
        row["bound_ms"], row["bound_by"] = bound_ms(*work, PEAK_F32_FLOPS)
        # the gate products run in 3xTF32 on the tensor cores, as phase 2's
        dense = (lstm_gate_flops if cell == "lstm" else mingru_gate_flops)(
            N, T, D, H, L)
        row["bound_3xtf32_ms"] = 3 * dense / PEAK_TF32_FLOPS * 1e3
        for prec in ("f32", "bf16"):
            dt = p20_precision(prec)[0]
            w = weights_fn(v, dt)
            mse = {}
            for form in P20_FORMS[cell]:
                fk = dict(kw, dtype=dt, **form_kw(cell, form))
                key = f"{prec} {'/'.join(form)}"
                row["form_ms"][key] = ms(lambda: gate(w, Z, **fk))
                row["form_plain_ms"][key] = ms(lambda: reference(w, Z, **fk))
                mse[form] = (gate(w, Z, **fk)[0], reference(w, Z, **fk)[0])
            # the kernel's bits move with its form where the plain version's do
            d0 = P20_FORMS[cell][0]
            for form in P20_FORMS[cell][1:]:
                n_k, n_p = (int((mse[form][i] != mse[d0][i]).sum()) for i in (0, 1))
                print(f"[phase20] (e) {gate.__name__} {prec} at {N} windows: "
                      f"windows whose mse in {'/'.join(form)} has other bits "
                      f"than in {'/'.join(d0)}: kernel {n_k}, plain {n_p}")
                check(n_k > 0 or n_p == 0, f"{gate.__name__} {prec} {form} at "
                      f"{N}: the default form's mse bit for bit")
        rows[cell] = row
        print(f"[phase20] (e) {gate.__name__} ({root}) at {N} windows by form "
              f"(sigmoid/tanh): " + ", ".join(
                  f"{k} {t:.3f} ms (plain {row['form_plain_ms'][k]:.3f})"
                  for k, t in row["form_ms"].items())
              + f"; {FAMILIES[cell]['library']} {row['library_ms']:.3f} ms; "
                f"bound {row['bound_ms']:.3f} ms ({row['bound_by']}), 3xTF32 "
                f"tensor-core bound {row['bound_3xtf32_ms']:.3f} ms; {gpu_line()}")
    # row 1 with its residual in each layout, float32, and its library
    # composition with the residual transposed
    weights_fn, gate, reference = FUSED_GATES["lstm"]
    w = weights_fn(vae)
    kw = dict(num_layers=vae.num_layers, use_layernorm=vae.use_layernorm)
    cudnn = LIBRARY_PASS["lstm"](vae)
    tr = dict(layout_ms={}, layout_plain_ms={})
    for layout in ("nhwc", "transposed"):
        tr["layout_ms"][layout] = ms(lambda: gate(w, Z, residual_layout=layout, **kw))
        tr["layout_plain_ms"][layout] = ms(lambda: reference(
            w, Z, residual_layout=layout, **kw))
    tr["library_ms"] = ms(lambda: transposed_residual(cudnn(Z)[1]))
    flops, nbytes = vae_work(N, T, D, vae.hidden_dim, vae.latent_dim,
                             vae.num_layers)
    nbytes += 4.0 * N * T * (padded_features(D) - D)     # the zero rows
    tr["bound_ms"], tr["bound_by"] = bound_ms(flops, nbytes, PEAK_F32_FLOPS)
    tr["bound_3xtf32_ms"] = rows["lstm"]["bound_3xtf32_ms"]
    rows["transposed"] = tr
    print(f"[phase20] (e) fused_vae_gate with its residual at {N} windows, "
          f"float32: NHWC {tr['layout_ms']['nhwc']:.3f} ms (plain "
          f"{tr['layout_plain_ms']['nhwc']:.3f}), transposed "
          f"{tr['layout_ms']['transposed']:.3f} ms (plain "
          f"{tr['layout_plain_ms']['transposed']:.3f}); cuDNN nn.LSTM with the "
          f"residual transposed {tr['library_ms']:.3f} ms; bound "
          f"{tr['bound_ms']:.3f} ms ({tr['bound_by']}), 3xTF32 tensor-core "
          f"bound {tr['bound_3xtf32_ms']:.3f} ms; {gpu_line()}")
    nums["rows"] = rows
    return nums


def phase_forms_transposed(wl) -> list:
    """Phase 20: rows 1 and 6's activation forms and row 1's transposed
    residual with the batch-in-columns CNN. Returns their rows of the
    kernels line."""
    import torch

    from shm_tpu_torch.ops.fused_mingru import kernel_info as mingru_info
    from shm_tpu_torch.ops.fused_vae import kernel_info as vae_info

    print(f"[phase20] {gpu_line()}")
    t_phase = time.perf_counter()
    for H in (32, 64, 128):
        for prec in P20_PRECISIONS:
            dt, io = p20_precision(prec)
            for form in P20_FORMS["lstm"][::3]:
                i = vae_info(100, H, 2, dtype=dt, io_dtype=io,
                             sigmoid_impl=form[0], tanh_impl=form[1])
                print(f"[phase20] fused_vae_gate H={H} {prec} "
                      f"{'default' if form[0] == 'exact' else 'forms'} instance: "
                      f"{i['registers']} registers, {i['spill_bytes']} B of "
                      f"spills a thread, {i['blocks_per_sm']} block(s) an SM")
            for form in P20_FORMS["min_gru"]:
                i = mingru_info(100, H, 2, dtype=dt, io_dtype=io,
                                sigmoid_impl=form[0])
                print(f"[phase20] fused_mingru_gate H={H} {prec} sigmoid "
                      f"{form[0]} instance: {i['registers']} registers, "
                      f"{i['spill_bytes']} B of spills a thread, "
                      f"{i['blocks_per_sm']} block(s) an SM")
    errs, a_counts = p20_forms()
    torch.cuda.empty_cache()
    t_errs = p20_transposed()
    hybrid_launches = p20_hybrid(wl)
    torch.cuda.empty_cache()
    p20_default_bits(wl.W)
    nums = p20_timing(wl)
    rows = nums.pop("rows")
    torch.cuda.empty_cache()
    sel = lambda d, k: {n.split(" ", 1)[1]: v for n, v in d.items()
                        if n.startswith(k + " ")}
    # (a)'s launches of a row by form, and of its non-default forms in all
    by_form = lambda k: {f: n for (g, f), n in a_counts.items() if g == k}
    others = lambda k: sum(n for f, n in by_form(k).items() if f != "exact/exact")
    lstm, mingru, tr = rows["lstm"], rows["min_gru"], rows["transposed"]
    out = [
        dict(name="fused_vae_gate/forms", route="cuda",
             source="shm_tpu_torch/ops/csrc/fused_vae.cu",
             replaces="shm_tpu/ops/fused_vae.py:125",
             launches=others("fused_vae_gate"), max_abs_err=errs["lstm"]["f32"],
             max_abs_err_bf16=max(errs["lstm"]["bf16"], errs["lstm"]["bf16_io"]),
             ms=lstm["form_ms"]["f32 tanh/exact"],
             plain_ms=lstm["form_plain_ms"]["f32 tanh/exact"],
             bound_ms=lstm["bound_ms"], bound_by=lstm["bound_by"],
             bound_3xtf32_ms=lstm["bound_3xtf32_ms"],
             library_ms=lstm["library_ms"], form_ms=lstm["form_ms"],
             form_plain_ms=lstm["form_plain_ms"],
             form_launches=by_form("fused_vae_gate")),
        dict(name="fused_vae_gate/transposed", route="cuda",
             source="shm_tpu_torch/ops/csrc/fused_vae.cu",
             replaces="shm_tpu/ops/fused_vae.py:402",
             launches=hybrid_launches["f32"]["fused_vae_gate transposed_launches"],
             max_abs_err=t_errs["f32"],
             max_abs_err_bf16=max(t_errs["bf16"], t_errs["bf16_io"]),
             ms=tr["layout_ms"]["transposed"],
             plain_ms=tr["layout_plain_ms"]["transposed"],
             bound_ms=tr["bound_ms"], bound_by=tr["bound_by"],
             bound_3xtf32_ms=tr["bound_3xtf32_ms"],
             library_ms=tr["library_ms"], nhwc_ms=tr["layout_ms"]["nhwc"],
             hybrid_launches={p: sel(c, "fused_vae_gate")
                              for p, c in hybrid_launches.items()},
             hybrid_ms={k[7:]: v for k, v in nums.items()
                        if k.startswith("hybrid ")},
             cnn_ms={k[4:]: v for k, v in nums.items()
                     if k.startswith("cnn ") and k.endswith(("f32", "bf16"))},
             cnn_bound_ms=nums["cnn bound_ms"], cnn_patch_ms=nums["cnn patch_ms"]),
        dict(name="fused_mingru_gate/forms", route="cuda",
             source="shm_tpu_torch/ops/csrc/fused_mingru.cu",
             replaces="shm_tpu/ops/fused_mingru.py:69",
             launches=others("fused_mingru_gate"),
             max_abs_err=errs["min_gru"]["f32"],
             max_abs_err_bf16=max(errs["min_gru"]["bf16"], errs["min_gru"]["bf16_io"]),
             ms=mingru["form_ms"]["f32 tanh/exact"],
             plain_ms=mingru["form_plain_ms"]["f32 tanh/exact"],
             bound_ms=mingru["bound_ms"], bound_by=mingru["bound_by"],
             bound_3xtf32_ms=mingru["bound_3xtf32_ms"],
             library_ms=mingru["library_ms"], form_ms=mingru["form_ms"],
             form_plain_ms=mingru["form_plain_ms"],
             form_launches=by_form("fused_mingru_gate")),
    ]
    print(f"[phase20] phase 20 {time.perf_counter() - t_phase:.2f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 21: row 7's MLP width (mlp_ratio) in both bodies and both softmax
# forms, and the plain modules' bf16 (dtype=) on the card
# ---------------------------------------------------------------------------

P21_WIDTHS = (  # name, H, mlp_ratio, D, Z, L: M = 256, 128, 256, 768, 512 (4H)
    ("H=32 r=8", 32, 8, 12, 5, 2),
    ("H=64 r=2", 64, 2, 3, 8, 1),
    ("H=128 r=2", 128, 2, 12, 16, 2),
    ("H=128 r=6", 128, 6, 12, 16, 2),
    ("H=128 r=4", 128, 4, 12, 16, 2),
)
P21_BODIES = ((100, 40), (512, 12))   # (T, N): the resident body, the long body
# (a)'s bf16 mean bar, by (width, T, form): the midpoint of the card's
# reading of the kernel against its plain version (the larger of the two
# io's) and the float32 gap (the plain float32 version against the plain
# bf16 one on the same inputs; the smaller of the two), both read on the
# card by `p21_readings()` (NVIDIA H100 80GB HBM3, 700 W; reading / gap in
# the comments); the max and |x - y| bars are phase 17's attention bars
P21_BF16_MEAN = {
    ('H=32 r=8', 100, 'packed'): 0.00015,      # 1.129e-05 / 2.906e-04
    ('H=32 r=8', 100, 'streaming'): 0.00016,   # 2.901e-05 / 2.895e-04
    ('H=32 r=8', 512, 'packed'): 5.3e-05,      # 4.044e-06 / 1.014e-04
    ('H=32 r=8', 512, 'streaming'): 5e-05,     # 1.396e-05 / 8.529e-05
    ('H=64 r=2', 100, 'packed'): 0.00024,      # 5.327e-05 / 4.343e-04
    ('H=64 r=2', 100, 'streaming'): 0.00024,   # 3.801e-05 / 4.482e-04
    ('H=64 r=2', 512, 'packed'): 0.00013,      # 3.468e-05 / 2.238e-04
    ('H=64 r=2', 512, 'streaming'): 0.00011,   # 1.308e-05 / 2.108e-04
    ('H=128 r=2', 100, 'packed'): 0.00024,     # 1.278e-04 / 3.490e-04
    ('H=128 r=2', 100, 'streaming'): 0.00024,  # 1.536e-04 / 3.230e-04
    ('H=128 r=2', 512, 'packed'): 6.2e-05,     # 4.979e-05 / 7.490e-05
    ('H=128 r=2', 512, 'streaming'): 5.4e-05,  # 2.398e-05 / 8.393e-05
    ('H=128 r=6', 100, 'packed'): 0.00024,     # 1.460e-04 / 3.334e-04
    ('H=128 r=6', 100, 'streaming'): 0.00021,  # 1.088e-04 / 3.168e-04
    ('H=128 r=6', 512, 'packed'): 6.6e-05,     # 5.230e-05 / 7.874e-05
    ('H=128 r=6', 512, 'streaming'): 9.1e-05,  # 5.374e-05 / 1.278e-04
    ('H=128 r=4', 100, 'packed'): 0.00028,     # 1.189e-04 / 4.468e-04
    ('H=128 r=4', 100, 'streaming'): 0.00027,  # 8.264e-05 / 4.560e-04
    ('H=128 r=4', 512, 'packed'): 0.00032,     # 5.808e-05 / 5.895e-04
    ('H=128 r=4', 512, 'streaming'): 0.00034,  # 7.212e-05 / 6.042e-04
}
P21_TIME_N = 5440
P21_REPS = 5
# (c): the JAX package's flax modules at bf16 against float32 on the CPU
# (tests/plain_dtype_readings.py jax; jitted with XLA's excess precision
# off): relative mse max / mean on the 3,636 committed 4DOF test windows
# through each root, p(ST) |diff| max / mean of CNNOpenLab on the 1,437
# openLAB test fault windows; no gate or label flipped. The port's bf16
# plain path on the card is held to twice these against its float32 plain
# path, its mean to at least PLAIN_BF16_FLOOR of JAX's (a float32 module
# fails), at most PLAIN_BF16_FLIPS decisions apart
PLAIN_BF16_READINGS = {"lstm": (3.2748e-03, 2.7519e-04),
                       "min_gru": (6.3261e-03, 6.4595e-04),
                       "attention": (1.4711e-03, 1.1111e-04),
                       "cnn_openlab": (2.2374e-03, 3.0506e-04)}
PLAIN_BF16_TOL = {k: (2 * a, 2 * b) for k, (a, b) in PLAIN_BF16_READINGS.items()}
PLAIN_BF16_FLOOR = 0.5
PLAIN_BF16_FLIPS = 2


def p21_vae(seed: int, H: int, r: int, D: int, Zd: int, L: int):
    """A random attention VAE (every MLP r*H wide) on the card, and its rng."""
    from shm_tpu_torch.config import VAEConfig
    from shm_tpu_torch.convert import random_flax_vae_params, vae_from_flax

    cfg = VAEConfig(input_dim=D, latent_dim=Zd, hidden_dim=H, num_layers=L,
                    use_layernorm=True, cell="attention")
    rng = np.random.default_rng(seed)
    vae = vae_from_flax(random_flax_vae_params(rng, cfg, mlp_ratio=r), cfg)
    check(vae.mlp_ratio == r, f"the VAE's MLP is {vae.mlp_ratio}H, not {r}H")
    return vae.cuda(), rng


def p21_launch(call, bf16: bool, stream: bool, long: bool, mlp: bool):
    """``call()``, which launches row 7 once: its instance, form, body and
    MLP-width counters move for that launch alone."""
    from shm_tpu_torch.ops import fused_attention_gate as g

    before = dict(attention_counts(), mlp_launches=g.mlp_launches)
    out = call()
    now = dict(attention_counts(), mlp_launches=g.mlp_launches)
    got = {k: v - before[k] for k, v in now.items()}
    want = dict(launches=int(not bf16), bf16_launches=int(bf16),
                stream_launches=int(stream), long_launches=int(long),
                mlp_launches=int(mlp))
    check(got == want, f"row 7's counters moved {got}, want {want}")
    return out


def p21_bf16(tag: str, w, Z, kw: dict, io, tmean) -> float:
    """The bf16 instance at ``kw`` against its plain bf16 version: the
    relative mse (max, mean), the largest |x - y| difference and the float32
    gap's mean printed; held to phase 17's attention max and |x - y| bars
    and, unless ``tmean`` is None (``p21_readings``), to the mean bar
    ``tmean`` below the gap. Returns the largest |mse diff|."""
    import torch

    from shm_tpu_torch.ops import fused_attention_gate, fused_attention_gate_reference

    kw = dict(kw, dtype=torch.bfloat16, io_dtype=io)
    mse_k, r_k = fused_attention_gate(w, Z, **kw)
    torch.cuda.synchronize()
    mse_p, r_p = fused_attention_gate_reference(w, Z, **kw)
    mse_32, _ = fused_attention_gate_reference(
        w, Z.to(io or torch.float32).float(), **dict(kw, dtype=torch.float32,
                                                     io_dtype=None))
    rel = (mse_k.double() - mse_p.double()).abs() / mse_p.double().abs()
    gap = float(((mse_32.double() - mse_p.double()).abs() / mse_p.double().abs()).mean())
    dy = float((r_k.double().sqrt() - r_p.double().sqrt()).abs().max())
    tmax, _, tdy = BF16_GATE_TOL["attention"]
    ok = float(rel.max()) <= tmax and dy <= tdy and (
        tmean is None or float(rel.mean()) <= tmean < gap)
    print(f"[phase21]   {tag}: mse rel max {float(rel.max()):.3e} mean "
          f"{float(rel.mean()):.3e} (bars {tmax:g} / {tmean}); |x - y| max "
          f"diff {dy:.3e} (bar {tdy:g}); float32 gap mean {gap:.3e} "
          f"{'ok' if ok else 'FAIL'}")
    check(bool(torch.isfinite(mse_k).all()) and r_k.dtype == (io or torch.float32),
          f"{tag}: mse not finite or residual of another type")
    check(ok, f"{tag}: bf16 kernel disagrees with its plain bf16 version, or "
              f"the mean bar does not separate bf16 from float32")
    return float((mse_k - mse_p).abs().max())


def phase21_kernels(readings: bool = False) -> dict:
    """(a) each width of P21_WIDTHS in the resident body (T=100) and the long
    body (T=512), each softmax form, against its plain version: float32
    under phase 2's bar, bf16 with float32 and bf16 io under phase 17's
    with the mean bar of P21_BF16_MEAN (``readings``: print the numbers
    that bar rests on instead); every launch moves its counters alone, the
    MLP-width counter for M other than 4H. Returns the largest |mse diff|
    by precision."""
    import torch

    from shm_tpu_torch.ops import (
        attention_params_to_kernel_weights, fused_attention_gate,
        fused_attention_gate_reference,
    )
    from shm_tpu_torch.ops.fused_attention import plan

    errs = {"f32": 0.0, "bf16": 0.0}
    for i, (name, H, r, D, Zd, L) in enumerate(P21_WIDTHS):
        vae, rng = p21_vae(2100 + i, H, r, D, Zd, L)
        ws = {False: attention_params_to_kernel_weights(vae),
              True: attention_params_to_kernel_weights(vae, torch.bfloat16)}
        for T, N in P21_BODIES:
            Z = torch.from_numpy(rng.normal(size=(N, T, D)).astype(np.float32)).cuda()
            long = plan(T, H).body == "long"
            long16 = plan(T, H, torch.bfloat16).body == "long"
            print(f"[phase21] {name} (M={r * H}): N={N} T={T} D={D} Z={Zd} L={L}: "
                  f"the {'long' if long else 'resident'} body, in bf16 the "
                  f"{'long' if long16 else 'resident'} body")
            for stream in (False, True):
                form = "streaming" if stream else "packed"
                kw = dict(num_layers=L, use_layernorm=True, with_residual=True,
                          stream=stream, mlp_ratio=r)
                mse, resid = p21_launch(lambda: fused_attention_gate(
                    ws[False], Z, **kw), False, stream, long, r != 4)
                torch.cuda.synchronize()
                mse_p, resid_p = fused_attention_gate_reference(ws[False], Z, **kw)
                errs["f32"] = max(errs["f32"], compare(f"{name} T={T} {form} "
                                                       "float32 mse", mse, mse_p),
                                  compare("... resid", resid, resid_p))
                for io in (None, torch.bfloat16):
                    tag = f"{name} T={T} {form} bf16 io={'bf16' if io else 'f32'}"
                    tmean = None if readings else P21_BF16_MEAN[name, T, form]
                    errs["bf16"] = max(errs["bf16"], p21_launch(
                        lambda: p21_bf16(tag, ws[True], Z, kw, io, tmean),
                        True, stream, long16, r != 4))
        del vae, ws
        torch.cuda.empty_cache()
    return errs


def p21_readings() -> None:
    """(a)'s bf16 numbers alone, for setting P21_BF16_MEAN: ``python -c
    "import chip_smoke as c; c.phase_build(); c.p21_readings()"``."""
    from shm_tpu_torch.device import set_full_f32_precision

    set_full_f32_precision()
    print(gpu_line())
    phase21_kernels(readings=True)


def p21_root_vae(cell: str, dtype):
    """The ``cell`` 4DOF root's trained VAE at ``dtype``, on the card."""
    from dataclasses import replace

    from shm_tpu_torch.cli.stage4dof import Paths, _load_vae
    from shm_tpu_torch.config import Stage4DofConfig
    from shm_tpu_torch.models.vae import vae_from_config

    cfg = Stage4DofConfig()
    f32 = _load_vae(Paths(str(ROOT / FAMILIES[cell]["root"])), cfg)
    vae = vae_from_config(replace(cfg.vae, cell=cell), dtype).eval()
    vae.load_state_dict(f32.state_dict())
    return vae.cuda()


def p21_held(tag: str, key: str, rel, flips: int) -> dict:
    """The bf16 plain path's relative gap ``rel`` to the float32 one, held
    to PLAIN_BF16_TOL[key], its mean to at least PLAIN_BF16_FLOOR of JAX's
    and at most PLAIN_BF16_FLIPS decisions apart; printed."""
    tmax, tmean = PLAIN_BF16_TOL[key]
    jmean = PLAIN_BF16_READINGS[key][1]
    mx, mn = float(np.max(rel)), float(np.mean(rel))
    ok = mx <= tmax and PLAIN_BF16_FLOOR * jmean <= mn <= tmean and flips <= PLAIN_BF16_FLIPS
    print(f"[phase21]   {tag}: bf16 against float32 max {mx:.4e} mean {mn:.4e} "
          f"(bars {tmax:.4e} / {tmean:.4e}, mean at least "
          f"{PLAIN_BF16_FLOOR * jmean:.4e}); decisions apart {flips} "
          f"(at most {PLAIN_BF16_FLIPS}) {'ok' if ok else 'FAIL'}")
    check(ok, f"{tag}: the bf16 plain path is not the JAX package's bf16")
    return dict(max=mx, mean=mn, flips=flips)


def phase21_plain_bf16(W) -> dict:
    """(c) each 4DOF root's VAE at bf16 through ``reconstruction_mse(fused=
    False)`` on the card against the same at float32, on the 3,636
    committed windows, the gates at the root's threshold; ``CNNOpenLab``
    of data/openlab at bf16 against float32 on the openLAB test fault
    windows, the labels at the CNN's threshold. No kernel launches."""
    import torch

    from shm_tpu_torch.cli import openlab as ol
    from shm_tpu_torch.cli.stage4dof import Paths, _load_stats
    from shm_tpu_torch.config import OpenLabConfig
    from shm_tpu_torch.convert import cnn_openlab_from_flax
    from shm_tpu_torch.models.cnn import CNNOpenLab
    from shm_tpu_torch.train import reconstruction_mse
    from shm_tpu_torch.utils.checkpoint import load_checkpoint
    from shm_tpu_torch.utils.io import load_json

    out = {}
    before = bf16_counts()
    for cell, fam in FAMILIES.items():
        root = ROOT / fam["root"]
        mean, std = _load_stats(Paths(str(root)))
        Z = ((W - mean) / std).astype(np.float32)
        thr = float(load_json(root / "processed/vae_threshold.json")["threshold"])
        m = {dt: reconstruction_mse(p21_root_vae(cell, dt), Z, fused=False,
                                    device="cuda")
             for dt in (torch.float32, torch.bfloat16)}
        a, b = (m[dt].astype(np.float64) for dt in (torch.float32, torch.bfloat16))
        check(np.isfinite(b).all() and b.shape == (len(W),), f"{cell}: bf16 mse")
        out[cell] = p21_held(f"{fam['root']} plain VAE, {len(W)} windows",
                             cell, np.abs(b - a) / a, int(((b > thr) != (a > thr)).sum()))
    base = ROOT / OPENLAB_ROOT
    paths, cfg = ol.Paths(str(base)), OpenLabConfig()
    _, Xr, meta = ol._load_extracted(paths)
    X, _ = ol._sf_st_split_data(Xr, meta, openlab_json(
        base, "extracted/run_split.json"), "test")
    mu, sd = np.load(paths.cnn_dir / "artifacts/cnn_raw_mu_sd.npy")
    thr = float(np.load(paths.cnn_val_dir / "artifacts/cnn_best_threshold.npy").ravel()[0])
    x = torch.from_numpy(ol.standardize_clip(X, mu, sd, cfg.standardize_clip)[..., None]).cuda()
    f32 = cnn_openlab_from_flax(load_checkpoint(
        paths.cnn_dir / "artifacts/cnn_model_openlab.msgpack")).cuda()
    b16 = CNNOpenLab(f32.num_classes, f32.dropout, dtype=torch.bfloat16).cuda().eval()
    b16.load_state_dict(f32.state_dict())
    with torch.inference_mode():
        p = {k: torch.softmax(c(x), dim=1)[:, 1].double().cpu().numpy()
             for k, c in (("f32", f32), ("bf16", b16))}
    check(np.isfinite(p["bf16"]).all(), "CNNOpenLab bf16: p(ST) not finite")
    out["cnn_openlab"] = p21_held(
        f"data/openlab CNNOpenLab, {len(X)} test fault windows (p(ST) |diff|)",
        "cnn_openlab", np.abs(p["bf16"] - p["f32"]),
        int(((p["bf16"] >= thr) != (p["f32"] >= thr)).sum()))
    check(bf16_counts() == before, "the plain bf16 path launched a gate kernel")
    return out


def phase21_timing() -> dict:
    """(d) CUDA-event times of row 7 at P21_TIME_N windows of T=100,
    gate-only, at each width, beside its plain version, the SDPA +
    ``torch.matmul`` composition and its bounds (float32 FMA rate; weight
    products in 3xTF32), the work counted at the width."""
    import torch

    from shm_tpu_torch.ops import (
        attention_params_to_kernel_weights, fused_attention_gate,
        fused_attention_gate_reference,
    )
    from shm_tpu_torch.tools.workload import (
        PEAK_BYTES, PEAK_F32_FLOPS, PEAK_TF32_FLOPS, bound_ms,
    )

    nums = {}
    N, T = P21_TIME_N, 100
    for i, (name, H, r, D, Zd, L) in enumerate(P21_WIDTHS):
        vae, rng = p21_vae(2150 + i, H, r, D, Zd, L)
        w = attention_params_to_kernel_weights(vae)
        Z = torch.from_numpy(rng.normal(size=(N, T, D)).astype(np.float32)).cuda()
        kw = dict(num_layers=L, use_layernorm=True, with_residual=False,
                  mlp_ratio=r)
        flops, nbytes = attention_work(N, T, D, H, Zd, L, with_residual=False,
                                       M=r * H)
        dense = attention_dense_flops(N, T, H, L, M=r * H)
        b_ms, b_by = bound_ms(flops, nbytes, PEAK_F32_FLOPS)
        tf32_ms = max(nbytes / PEAK_BYTES, 3 * dense / PEAK_TF32_FLOPS
                      + (flops - dense) / PEAK_F32_FLOPS) * 1e3
        lib = sdpa_attention_pass(vae)
        row = dict(windows=N, T=T, H=H, M=r * H, L=L,
                   ms=time_ms(lambda: fused_attention_gate(w, Z, **kw), P21_REPS),
                   plain_ms=time_ms(lambda: fused_attention_gate_reference(
                       w, Z, **kw), P21_REPS),
                   library_ms=time_ms(lambda: lib(Z), P21_REPS),
                   bound_ms=b_ms, bound_by=b_by, bound_3xtf32_ms=tf32_ms)
        nums[name] = row
        print(f"[phase21] times at N={N} T={T} {name} (M={r * H}) L={L} "
              f"gate-only (CUDA events, median of {P21_REPS}): kernel "
              f"{row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, SDPA + "
              f"torch.matmul {row['library_ms']:.3f} ms; bound {b_ms:.3f} ms "
              f"({b_by}: {flops / 1e9:.2f} GFLOP at {PEAK_F32_FLOPS / 1e12:g} "
              f"TFLOP/s float32), {tf32_ms:.3f} ms with its {dense / 1e9:.2f} "
              f"GFLOP of weight products at 3 x {PEAK_TF32_FLOPS / 1e12:g} "
              f"TFLOP/s TF32; {gpu_line()}")
        del vae, w, Z
        torch.cuda.empty_cache()
    return nums


def phase21_main_path(W) -> int:
    """(e) the main path at an MLP other than 4H: a ``HybridScorer`` of a
    random attention VAE at the 4DOF widths with its MLP 6H wide (M = 768)
    and the data/4dof_attention root's statistics and CNN, on the 3,636
    committed windows, the counts at 0 just before: every launch of row 7
    at that width; finite outputs of the right shape. Returns the launches."""
    import torch

    from shm_tpu_torch.serve import HybridScorer

    root = HybridScorer.from_artifacts(ROOT / "data/4dof_attention")
    vae, _ = p21_vae(2199, 128, 6, 12, 16, 2)
    sc = HybridScorer(vae, root.cnn, root.mean.cpu().numpy(),
                      root.std.cpu().numpy(), float(root.threshold),
                      device="cuda")
    from shm_tpu_torch.ops import fused_attention_gate as g

    attention_counts(reset=True)
    g.mlp_launches = 0
    out = sc.score(W)
    a = dict(attention_counts(), mlp_launches=g.mlp_launches)
    print(f"[phase21] (e) HybridScorer of an attention VAE with a 6H MLP on "
          f"{len(W)} windows: row 7 {a}")
    check(a["mlp_launches"] > 0 and a["mlp_launches"] == a["launches"]
          and a["bf16_launches"] == a["long_launches"] == 0,
          f"the scorer at M=768 did not run row 7 at that width alone: {a}")
    check(all(out[k].shape == (len(W),) for k in ("mse", "y_pred"))
          and bool(np.isfinite(out["mse"]).all()), "the scorer's outputs")
    del sc, root
    torch.cuda.empty_cache()
    return a["mlp_launches"]


def phase_mlp_dtype(W) -> list:
    """Phase 21: row 7's MLP width and the plain modules' bf16. Returns row
    7's ``fused_attention_gate/mlp`` row of the kernels line."""
    import torch

    print(f"[phase21] {gpu_line()}")
    t_phase = time.perf_counter()
    errs = phase21_kernels()
    torch.cuda.empty_cache()
    print("[phase21] (b) the 4DOF attention root's default float32 mse:")
    phase19_4dof(W)
    plain = phase21_plain_bf16(W)
    torch.cuda.empty_cache()
    nums = phase21_timing()
    launches = phase21_main_path(W)
    main = nums["H=128 r=6"]
    row = dict(name="fused_attention_gate/mlp", route="cuda",
               source="shm_tpu_torch/ops/csrc/fused_attention.cu",
               replaces="shm_tpu/ops/fused_attention.py:166",
               launches=launches, mlp_launches=launches,
               max_abs_err=errs["f32"], max_abs_err_bf16=errs["bf16"],
               **main, widths=nums, plain_bf16=plain)
    print(f"[phase21] phase 21 {time.perf_counter() - t_phase:.2f} s")
    return [row]


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        return child(argv[1], argv[2])
    if argv[:1] == ["--attention-mse"] and len(argv) == 3:
        return root_mse(argv[1], "data/4dof_attention", argv[2])
    if argv[:1] == ["--root-mse"] and len(argv) == 4:
        return root_mse(*argv[1:])
    parent = None
    if argv[:1] == ["--parent"]:
        parent = str(Path(argv[1]).resolve())
    elif argv:
        print("usage: chip_smoke.py [--parent DIR | --attention-mse DIR OUT | "
              "--root-mse DIR ROOT OUT]", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (ROOT / "shm_tpu_torch" / "ops" / "csrc").is_dir() or not all(
            (ROOT / r / "models").is_dir()
            for r in [fam["root"] for fam in FAMILIES.values()] + [STAGE1_ROOT]
    ) or not (ROOT / OPENLAB_ROOT / "output").is_dir():
        print(f"chip_smoke: {ROOT} does not hold the repository "
              "(shm_tpu_torch/, data/4dof*/, data/1dof/ and data/openlab/)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from shm_tpu_torch.device import set_full_f32_precision

    set_full_f32_precision()
    t_start = time.perf_counter()
    try:
        print(gpu_line())
        phase_build()
        from shm_tpu_torch.tools.workload import load_trained_workload

        wl = load_trained_workload(ROOT / "data" / "4dof")
        W, y = wl.W, wl.y                  # the 3,636 committed test windows
        gate_rows = []
        for cell, fam in FAMILIES.items():
            err = phase_kernel_vs_plain(cell)
            scorer, launches = phase_main_path(W, y, cell)
            nums = phase_timing(scorer, W, cell)
            nums["max_abs_err"] = max(nums["max_abs_err"], err)
            gate_rows.append(dict(
                name=fam["kernel"], route="cuda", source=fam["source"],
                replaces=fam["replaces"], launches=launches, **nums))
            del scorer
            torch.cuda.empty_cache()
        errs = phase_lstm_kernels_vs_plain()
        counts, ctx = phase_train_path()
        lstm_rows = phase_lstm_timing(errs, counts, ctx)
        parent_ms = {}
        if parent is not None:
            parent_ms = phase_parent(parent, lstm_rows + gate_rows)
        else:
            print("[parent] no --parent DIR given: the parent tree's rows 1-7, "
                  "9 and 10 are not timed in this run")
        torch.cuda.empty_cache()
        probe_rows = phase_probe_path(phase_probes_vs_plain(), wl)
        f32_name = f"matmul_loop/f32 {PARENT_PROBE_TILES[0]} tiles"
        if f32_name in parent_ms:          # row 10's f32 mode, the row's `ms`
            probe_rows[-1]["parent_ms"] = parent_ms[f32_name]
        row9_name = mingru_probe_name(None, probe_rows[1]["windows"])
        if row9_name in parent_ms:         # row 9 at full T, the row's `ms`
            probe_rows[1]["parent_ms"] = parent_ms[row9_name]
        torch.cuda.empty_cache()
        chain_launches = phase_chains()
        torch.cuda.empty_cache()
        serve_launches = phase_serving(W)
        torch.cuda.empty_cache()
        for name, got in phase_stage().items():
            chain_launches.setdefault(name, {}).update(got)
        torch.cuda.empty_cache()
        stage1dof_launches = phase_stage1dof()
        torch.cuda.empty_cache()
        openlab_launches = phase_openlab()
        torch.cuda.empty_cache()
        for cmd, c in phase_extract_export(W, y).items():
            openlab_launches[f"phase 15 {cmd}"] = c
        torch.cuda.empty_cache()
        mesh_launches = phase_mesh(W)
        torch.cuda.empty_cache()
        bf16_rows = phase_bf16(W, y)
        torch.cuda.empty_cache()
        bf16_rows += phase_bf16_training()
        torch.cuda.empty_cache()
        stream_rows = phase_attention_stream(W)
        torch.cuda.empty_cache()
        form_rows = phase_forms_transposed(wl)
        torch.cuda.empty_cache()
        mlp_rows = phase_mlp_dtype(W)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    # the kernel table's order: rows 1-5, the two other families, the probes;
    # `launches` is the scoring or training path's count, `chain_launches`
    # phases 10 and 12's by command, `serve_launches` phase 11's by step,
    # `stage1dof_launches` phase 13's by command (rows 1-7),
    # `openlab_launches` phases 14 and 15's by command (rows 1, 6 and 7),
    # `mesh_launches` phase 16's by scorer and mesh (rows 1, 6 and 7)
    kernels = gate_rows[:1] + lstm_rows + gate_rows[1:] + probe_rows
    for row in kernels:
        row["chain_launches"] = chain_launches.get(row["name"], {})
        row["serve_launches"] = serve_launches.get(row["name"], {})
        row["stage1dof_launches"] = {cmd: c[row["name"]]
                                     for cmd, c in stage1dof_launches.items()
                                     if row["name"] in c}
        if row["name"] in OPENLAB_ROWS:
            row["openlab_launches"] = {cmd: c[row["name"]]
                                       for cmd, c in openlab_launches.items()}
            row["mesh_launches"] = {step: c[row["name"]]
                                    for step, c in mesh_launches.items()}
    # the bf16 instances of rows 1, 6 and 7 (phase 17): `launches` is the
    # bf16 scorer's main path; of rows 2-5 (phase 18): the bf16 training run's
    kernels += bf16_rows
    # row 7's streaming form (phase 19: `launches` the openLAB attention
    # root's float32 scorer's) and its long body (`reconstruction_mse` at
    # T=512's)
    kernels += stream_rows
    # rows 1 and 6's activation forms (phase 20: `launches` (a)'s launches
    # of the non-default forms, by form in `form_launches`) and row 1's
    # transposed residual (`launches` the float32 transposed hybrid's)
    kernels += form_rows
    # row 7 at an MLP width other than 4H (phase 21: `launches` and
    # `mlp_launches` the 6H-MLP scorer's main path; its times at M = 768,
    # `widths` each width's)
    kernels += mlp_rows
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
