#!/usr/bin/env python3
"""Chip smoke test of the torch port on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json] [--long]

Run from the repository root on a machine with one CUDA card, the CUDA
toolkit (``nvcc``) and PyTorch built for CUDA.  It drives the port's serving
path and its dataset preprocessing path end to end and holds every
hand-written kernel against its plain PyTorch version:

1. device: require CUDA; print ``nvidia-smi``'s name and power limit;
2. build every kernel from the checkout's sources (``ops/build.py``);
3. K1 (``block1``) against ``block1_reference`` on the card at the serving
   shapes, random and perturbed BatchNorm, at T=1125, at B=1024 and with T
   on the edges of K1's time tile, atol 1e-5 / rtol 1e-5 (only the order of
   the f32 sums differs);
4. the engine's fused forward on the card against the plain ``EEGNet``
   forward on the CPU: logits to atol 1e-5 / rtol 1e-4, equal argmax;
5. serve: a seeded checkpoint (perturbed BatchNorm) written by the port's
   ``save_checkpoint``, ``python -m eegnetreplication_tpu_torch.serve``
   answering JSON, npz and 8 concurrent requests plus ``/healthz``; its
   predictions must equal the ``predict`` CLI's, every forward must have
   replayed its bucket's CUDA graph and so launched K1 exactly once, and
   SIGTERM must drain and exit 75;
6. the timer's floor (an empty event window and one one-element kernel);
   times per bucket (1/8/32/128): K1, the plain version and one library
   composite (cuDNN ``conv1d`` + ELU + ``avg_pool1d``) as the median of
   CUDA-event timings, the engine's end-to-end ``infer`` and ``/predict``
   latency on the host clock, each beside its bound on the card;
7. K2 (``ems``) against ``ems_reference`` on the card at a competition
   session's (22, 345600) and at the edge shapes (ragged, short init block,
   init block past T, a constant signal, ``factor_new`` 0.1, K2's tile
   boundaries with up to 86 tiles a channel, 64 channels), atol/rtol 1e-4;
   three calls at the session shape bitwise equal; and against the port's
   ``associative`` and ``scan`` methods;
8. the dataset path: a synthetic raw tree (2 subjects x Train/Eval,
   45-minute 25-channel 250 Hz GDF sessions with 288 cues each and
   ``TrueLabels``) through ``EEGTPU_EMS_METHOD=pallas python -m
   eegnetreplication_tpu_torch.dataset`` and, in process,
   ``build_processed_tree`` (one K2 launch per session); trial shapes and
   labels, one session against the port's CPU run (plain versions) and the
   card's ``associative`` run to 1e-3, and ``predict --subject 1`` on the
   result.  Every session is read by the C++ GDF reader
   (``data/gdf_native.py``, built here with ``g++`` from
   ``native/gdf_reader.cc``): the in-process run counts one native read a
   session, its arrays equal the numpy reader's byte for byte, and A01T
   through the numpy reader gives that run's trials bit for bit (the
   CLI's are held to them above); the build and both readers' times a
   session are printed;
8c. the moabb path (``dataset --src moabb``): the card's machine has no
   MNE, so ``tests/fake_mne.py`` (numpy only; ``.npz`` payloads under
   ``.fif`` names) is loaded by path and installed as ``mne`` in this
   process only.  One subject's BNCI2014-001 tree, sessions T and E of 6
   runs of 48 named cues (22 EEG + 3 EOG channels at 250 Hz, 387 s a
   run), goes through ``preprocess_moabb_data`` on the card with
   ``EEGTPU_EMS_METHOD=pallas``: K2 launches once a run (12), the trials
   are (288, 22, 257) a session with labels equal to the cues, and both
   files of each session are within 1e-3 of the port's CPU run.  ``python
   -m eegnetreplication_tpu_torch.dataset --src moabb`` in a process
   without the double exits non-zero naming MNE.  The leg's wall and K2's
   time a run are printed;
9. times at (22, 345600): K2, ``ems_reference`` and ``associative`` as the
   median of CUDA-event timings with the L2 cache flushed, beside the
   bound, and the two things ``ems`` runs besides K2 (the seed statistics,
   the zeroed status words); and a session's stages on the host clock;
10. training, in phase 8's tree (2 subjects x 576 trials: 8 folds of 346
   train, 86 validation and 144 test trials): ``python -m
   eegnetreplication_tpu_torch.train --trainingType Within-Subject``
   writes the JAX report's keys and both model files per subject, and
   ``predict`` serves the trained ``.npz``; in process, the protocol at
   dropout 0 on the card launches the stacked K1 exactly ``epochs *
   val_steps + test_steps`` times and its per-epoch losses agree with the
   CPU run from the same seed to TRAIN_ATOL/TRAIN_RTOL; on a separable
   pool drawn from a seed it learns well above chance; fold-epochs/s and
   wall per epoch at 8 and at 36 folds (the two subjects replicated), and
   the device's idle share over one epoch under ``torch.profiler``; the
   CLI's run journal holds one ``epoch`` event per epoch; ``--profileDir``
   over one epoch writes a Chrome trace naming K1-stacked's kernel; and,
   each in turns on, off, off, on in this process, fold-epochs/s with the
   card's deterministic mode and without it (8 and 36 folds) and with
   ``--debugNans``'s checks and without them (8 folds);
11. cross-subject training over the two subjects replicated to nine (90
   folds): the CLI (report keys, journal, ``predict`` on its model), the
   counted in-process runs (one group, groups of 15), groups against one
   group at dropout 0, the separable pool, the group-size sweep with one
   epoch under the profiler (the determinism cost at 90 folds is cut for
   the time limit; phase 10 prices it at 8 and 36), the size of
   one epoch's ``--profileDir`` trace and the journal's host time per
   epoch, the snapshot writer; the resume drill through the CLI (two
   unbroken runs, the second with ``--ckptFormat orbax``: its Orbax
   directories, read by the port's loader, equal the first run's ``.npz``
   and its own ``.pth`` bit for bit, with as many K1-stacked launches;
   SIGTERM -> 75 -> ``--resume``, ``--chaos train.chunk:after=1`` ->
   ``--resume``: all bitwise equal, each journal read back with its
   ``run_end`` status and an ``epoch`` event per epoch trained); and the
   chaos leg (``--chaos train.step:if_folds_over=4`` in
   groups of 8 halves them to 4, journals ``device_fault`` and ``retry``,
   and equals a run in groups of 4 bit for bit);
12. serving beyond one fp32 model: nine seeded checkpoints behind
   ``serve --zoo`` (``/healthz`` stacked with nine tenants; mixed-tenant
   JSON and npz requests 8 at once, each answer equal to ``predict
   --zoo --model``'s; one K1-stacked launch per coalesced chunk and no
   K1; ``stack_gate`` journaled ``pass``), ``serve --precision int8``
   (``/healthz`` says int8, ``quant_gate`` pass at >= 0.99, answers equal
   to ``predict --precision int8``'s, logits within atol 1e-5 / rtol 1e-4
   of the plain int8 forward on the CPU, K1 once per chunk), ``/reload``
   of a tenant and of the int8 model under 8 concurrent clients (200 with
   the new digest, no request failed, answers after the swap equal the new
   checkpoint's; a corrupt file 400 with the old digest serving), the int8
   server's ``/reload`` to phase 11's Orbax directory under the same
   clients (no request failed, ``/healthz`` names its ``.npz`` twin's
   digest, K1 launches = the gate's eager chunks + warm runs + replays),
   the committed JAX-written Orbax fixture (OCDBT, zstd) loaded on the
   card (its ``.npz`` twin's digest, logits at batch 1 and 128 bit for bit
   the twin's and within atol 1e-5 / rtol 1e-4 of the plain CPU forward),
   the Orbax load and write times beside the card's name and power limit,
   and the timings: K1-stacked at a 128-trial chunk over nine tenants beside its
   plain version, a grouped cuDNN composite and its bound, the engines'
   ``infer`` at buckets 1 and 128, ``/predict`` at 1 and 128 trials;
13. live streaming sessions (K2s, ``ems_stream``, the EMS carry): K2s
   against its plain version with the carry threaded through 3 chunks at C
   in {1, 22, 64} and n from 1 to 15000, atol/rtol 1e-6 (and whether they
   are bitwise equal); a (22, 15000) stream in chunks of 25, 64, 997, 1
   (the first 2000 samples) and whole gives the one-shot ``scan``'s bytes
   and final carry; three calls bitwise equal; a whole 45-minute session at
   1 and at 64 channels in pushes of 25 and in chunks of 997 gives the
   one-shot call's bits, out and carry.  Three servers start at
   once: nine concurrent sessions, one per subject, each 60 s of a seeded
   22-channel 250 Hz recording pushed as raw f32 chunks of 25 samples
   (window 257, hop 64, seed block 1000, deadline 1024 ms): every decision
   ``ok`` and equal to the offline pipeline (one-shot ``scan`` on the card,
   the same windows, the engine), each exported carry equal to the
   one-shot kernel's bit for bit, ``/healthz``'s ``ems_stream`` launches
   equal to the pushes from the seeding push on, p95 window latency under
   the 256 ms hop, the journal read back with its session events; a
   session SIGKILLed after half its windows (``--sessionSnapshotEvery
   20``), relaunched with ``--resume`` and replayed from the acked cursor
   equals the uninterrupted stream, every window decided again equals
   what the client was told, and SIGTERM exits 75 with the open session
   in ``sessions.npz``; one session against a ``--zoo`` server equals the
   offline pipeline through the default tenant's engine.  Then K2s's
   times at (22, 25), (22, 250) and (22, 345600), its plain version at the
   first two, K2 and ``associative`` at the last, beside the bound and the
   serial chain's latency at the card's maximum SM clock.

14. the serving control plane: at every bucket of the fp32, int8 and
   nine-tenant engines the replay of the bucket's captured CUDA graph gives
   the eager forward's logits bit for bit and the plain CPU forward's to
   atol 1e-5 / rtol 1e-4, with the capture's wall and memory pool bytes and
   ``infer`` eager against graphed (host ms, the device's idle share and
   device ops per call under ``torch.profiler``); ``serve --tuneEveryS 1``
   under 8 clients of steady 40-trial requests (each one every 100 ms,
   on a kept-alive connection) applies a ``ladder_retune``
   under load with no request failed and every answer equal to
   ``predict_trials`` (and the ``predict`` CLI's accuracy line and class
   counts), K1's launches equal to the eager warm runs plus the graph
   replays, ``/metrics`` (JSON and Prometheus text) agreeing with
   ``/healthz``, and ``POST /profile``'s trace naming ``block1_kernel``
   inside the replays; then the breaker (a retried ``serve.forward``
   fault, a persistent one opening the circuit, the close after the
   cooldown), adaptive admission (429 ``shed``), parented trace spans
   under a client's trace id and an SLO breach degrading ``/healthz``, in
   process on the card;
15. online adaptation (``utils/adapt_drill.py``) at the product width: a
   baseline trained on the card with the port's step on a synthetic cue
   stream serves as the default tenant of a nine-tenant ``serve --zoo``;
   one 250 Hz session streams a window a push and drifts after 16 pushes
   (``--chaos session.drift``).  A server without ``--adapt`` is the
   no-adaptation control; then ``--adapt --probeIntervalS 0.2`` with the
   JAX defaults (60 steps of 32, 16 labels, floor 0.55 over 12 shadow / 8
   labeled evals) and ``adapt.promote`` armed once: the client labels every
   drifted window, the fine-tune runs on its own stream beside the
   serving, the shadow's bucket-1 graph is captured under load, the first
   promotion fails mid-swap with the prior digest serving and the retry
   promotes; accuracy before, during and after, recovery above the
   drifted accuracy, the journal's causal order, ``POST /adapt/rollback``
   under 8 ``/predict`` clients with none failed, probes outside
   ``requests_total``, exact K1, K1-stacked and K2s counts from the
   journal, the candidate's card logits against its CPU forward, two card
   fine-tunes bitwise equal, and the fine-tune's wall, the shadow's capture,
   the promotion's reload and ``/predict`` and window latency during the
   fine-tune against the control.

16. supervised training: phase 8's two subjects replicated to nine, the
   within-subject protocol (36 folds) at 60 of the reference's 500
   epochs (since phase 20, for the time limit; 100 since phase 19, 500
   before), a snapshot every 10, unbroken and, at once, under ``python -m
   eegnetreplication_tpu_torch.resil.supervise --hang step=10 --graceS 2``
   with a chaos plan file: launch 1 reads ``host.preempt`` (exit 75 at
   epoch 20), and the file then holds ``train.hang`` for every later
   launch (a plan re-armed in every launch counts its hits per process,
   so one plan on the same chunk boundaries cannot preempt one launch and
   stall the next): launch 2 stalls at epoch 50, the ``step`` beat goes
   stale, SIGTERM cannot end the stall, SIGKILL does, and launch 3
   completes.  The supervisor exits 0 with ``preempted, hang,
   completed``, every relaunch carries ``--resume`` once, the nine best
   models are bitwise the unbroken run's and the reports equal, each
   launch's journal holds the epochs it trained and the K1-stacked
   launches they imply, ``event_summary`` counts the restarts, and peak
   memory of the relaunched child is the unbroken run's; ``python -m
   eegnetreplication_tpu_torch.obs.top --json`` shows the supervisor and
   the live child while they run and every launch after.  Beside them,
   ``serve`` under the supervisor on a fixed port with ``serve.hang`` armed: the
   4th dispatch stalls, ``serve_forward`` (5 s) runs out, SIGTERM then
   SIGKILL, the relaunch answers ``/predict`` as before the hang (the
   reply but its ``latency_ms``) from its replayed bucket graphs, and
   SIGTERM to the supervisor ends it with the server's 75.  With
   ``--long``: the 90-fold cross-subject protocol at 500 epochs under the
   supervisor through one ``host.preempt``.

17. the model layer, run last, in phase 8's tree: (a) ``train --model
   shallow_convnet`` and ``--model deep_convnet`` (8 folds, at once):
   the JAX report's keys, ``.npz`` checkpoints with the JAX metadata and
   no ``.pth``, clean journals, no K1 and no K1-stacked launch; in
   process, the card against the CPU at dropout 0 on the separable pool
   (TRAIN_ATOL/RTOL; on phase 8's label-free tree, where the fit memorizes
   noise, the card-vs-CPU gap is reported beside the CPU's own gap under
   a 1e-7 scaling of the trials), the separable pool above chance, two
   runs bitwise equal, fold-epochs/s,
   GFLOP/s and MFU at 8 and 36 folds; (b) ``serve`` and ``predict`` on
   each trained ``.npz`` (byte-equal predictions), the card's logits
   against the CPU's (atol 1e-5 / rtol 1e-4), every bucket's graph replay
   bitwise its eager forward, int8 and a two-tenant zoo behind their
   gates; (c) EEGNet's banded schedule: the stacked forward's logits,
   statistics and gradients against ``"lax"`` at T = 257 and 1125 (1e-5
   / 1e-4), the tiled depthwise op; the A/B of fold-epochs/s at 36
   folds in two turns (banded, then lax), one epoch of each under the
   profiler and its peak memory; K1-stacked launches under both; two
   banded runs bitwise equal; (d) the permutation test (8 permutations
   at 22 x 257 on the separable pool, twice, bitwise), CSP+LDA and the
   tangent-space classifier on the card against the CPU (equal
   predictions, features within 1e-4).

18. the replica fleet, run alone after every other phase (its three
   fleets boot at once; (f)'s load step runs beside (c) and (d), its
   scale-down beside (e)): (a) ``python -m
   eegnetreplication_tpu_torch.serve.fleet --replicas 3`` (a seeded
   EEGNet, F1=8, D=2, the ladder 1/8/32/128) boots on the card; all
   three go live with one digest; ``/predict`` at 1 and 128 trials
   through the fleet is a replica's reply byte for byte but its
   ``latency_ms``, equal to ``predict_trials`` and the ``predict`` CLI,
   the argmax of card logits within atol 1e-5 / rtol 1e-4 of the plain
   CPU forward; every replica's K1 launches are its warm runs plus its
   graph replays; a 20 s live session stays on one replica, equals the
   offline pipeline, and its K2s launches equal its pushes; (b) the
   saturating load through an in-process ``FleetRouter`` over one replica
   then three (rps, p50/p95/p99, ``linear_fraction``, each replica's card
   memory from ``nvidia-smi``); (c) SIGKILL of one replica under 8
   clients: no request fails, the journal shows ``out``, the
   ``MultiSupervisor``'s relaunch on the same port, ``rejoined``; (d) a
   second checkpoint rolled under 8 clients (``fleet_canary``,
   ``fleet_shadow``, ``fleet_reload(converged)``, every replica on the new
   digest, none failed, each answer the old model's or the new one's),
   then a corrupt push failing at the canary; (e)
   ``spawn_replica_fleet(per_replica_args=...)`` in process: r1 slowed by
   ``serve.degrade`` until it runs out (``replica_ejected`` then
   ``replica_readmitted``), hedges counted, r2 cutting replies with
   ``replica.network`` (``fleet_retry``, none failed), every trace rooted
   at ``router.request`` with each ``replica.request`` parented on the
   router's dispatch; (f) ``--autoscale --autoscaleMin 1 --autoscaleMax
   2``: a load step scales up and the new replica joins, the load off
   gives ``down``, ``drained``, the member's ``out`` in that order, and
   the retired process leaves the card.
19. the cell tier, run alone after phase 18: ``python -m
   eegnetreplication_tpu_torch.serve.cells --cells 2 --ha D --haOwner f0
   --haTtlS 3`` (checkpoint A, the phase-18 model) goes active, and a
   second front attached to its cells (``--attachCells``, booting beside
   19a-c) stands by: (a) both cells live on one digest, ``/predict`` at
   1 and 128 trials through the front a cell's reply byte for byte but
   its ``latency_ms``, equal to ``predict_trials`` and the ``predict``
   CLI, the argmax of card logits within atol 1e-5 / rtol 1e-4 of the
   CPU forward, 8 clients of 1 trial through the front for 3 s (rps,
   p50/p95/p99, none failed), every cell's K1 launches its warm runs
   plus replays; (b) a
   paced 250 Hz session drained off its home cell mid-stream
   (``session_migrate``, 0 windows expired, equal to the offline
   pipeline, its later pushes on the other cell), then undrained; (c)
   SIGKILL of the cell holding a second session under 8 bulk clients:
   ``cell_member(failed)`` before ``session_failover``, the client's 409
   ``{"resume": true}`` and replay from its acked cursor to a stream
   equal to the offline one, no bulk request failed, the supervisor's
   ``--resume`` relaunch on the cell's port rejoins (the state of the
   front's breaker for it then is printed: open if the kill failed five
   dispatches, and its cooldown outlasts the relaunch); (d) straight
   after that rejoin, ``POST /cells/upgrade`` to checkpoint B (A with
   every classifier bias + 1: another digest, the same argmax) under a
   live session and 8 clients: per cell, one at a time, ``cell_upgrade``
   drain, relaunch, live, shadow (agreement at least 0.8), undrain, the
   upgrader draining a cell only while another is dispatchable (live,
   its breaker closed) and waiting for the upgraded one to be (the time
   it waited is printed); no failure, no expired window, both cells on
   B; (e) SIGKILL of the active front: the standby
   journals ``affinity_replay`` (f0's table) and ``front_lease(takeover)``
   within TTL + 2 s and before the first request it serves, every bulk
   request completes with at most one leader switch, the session equals
   the offline pipeline; (f) every cell process's K1 launches equal its
   warm runs plus replays and its K2s launches the pushes it ran (named
   by their trace ids in its journal), added to the kernels line; no
   front fenced itself; f1 exits 75 on SIGTERM, the orphaned cells are
   killed by the pids in f0's journal, and the card lists no process of
   the phase.
20. the tooling, in this process, over what earlier phases wrote (no
   process started): ``viz.load_model_filters`` gives equal filter sets
   from phase 10's card-trained ``subject_0X_best_model.npz`` and
   ``.pth``; the three figures render under Agg to PNG files where
   matplotlib is installed, and otherwise their plotted data (the
   topomaps' fields, the spectra) is computed and checked finite; the
   GUI's report helpers read phase 10's report, and its evaluate command
   names the port's ``predict`` and passes that CLI's parser; a
   ``BENCH_ONCHIP_LAST.json`` written by ``obs.schema.write_json_artifact``
   into the work directory (phase 10's 36-fold rate, ``platform: gpu``,
   the card's name and power limit) is what the Performance tab renders;
   ``obs.report --json`` summarizes phase 19's front trees and every
   nested cell journal; ``obs.trace_report --require-cross-process``
   stitches phase 18's journals into cross-process traces.  Budget 20 s.
   Then the lint leg: ``python -m eegnetreplication_tpu_torch.analysis.cli
   --root <checkout> --json`` exits 0 with no new finding, no stale
   baseline entry and all six passes; over a copy with one unknown flag
   on a spawned cell's command line and one ``logger.info`` inside the
   engine's capture window it exits 1 with exactly those two findings;
   the linter's ``wall_s`` is printed.
21. the mesh (``parallel/``), run after phase 17 in phase 8's tree (its
   two subjects replicated to nine: 36 folds, EEGNet F1=8, D=2, batch 64,
   the reference's hyperparameters); the rank processes are forked by the
   train CLI and share the card, their collectives over gloo: (a) ``train
   --meshFold 2`` and ``--maxFoldsPerProgram 18`` at once, 20 epochs with
   a snapshot every 10: the nine best models bitwise equal, the reports
   equal but their timestamps, both journals clean (``mesh_shape`` in the
   mesh run's ``run_start``), K1-stacked launches summed over the ranks
   (``run_end``) equal to the grouped run's, each rank's the same;
   fold-epochs/s of both and the ranks' start; (b) ``--meshFold 2
   --meshData 2`` (4 ranks) twice and once stopped, at once: the two
   unbroken runs bitwise, SIGTERM after the first 5-epoch chunk exits 75
   with the snapshot, ``--resume`` (beside (e)) is the unbroken run bit for
   bit; (c) ``utils/mesh_drill.py`` alone, four ranks on ``cuda:0``: the
   DP step over 2 data ranks at dropout 0 against the one-process step on
   the whole batch over 20 steps (loss within rtol 1e-5 at the first step,
   1e-3 at every step; every parameter within 1e-4 but the temporal
   BatchNorm's scale and shift, whose true gradient is 0 and which Adam
   moves by rounding noise, held to steps x lr), both BatchNorm modes;
   the same DP step under the ``bf16`` numerics mode against the
   one-process bf16 step, every step's loss within 8 x 2**-8 relative;
   ZeRO over a 2-wide model axis bitwise the replicated step over 20
   steps; the DP step's and the one-process step's ms and the gloo
   ``all_reduce`` of the flat gradient; (d) ``ems_time_sharded`` of a
   (22, 345600) session over 2 and 4 ranks within atol 2e-4 / rtol 2e-3 of
   the one-shot K2s ``scan`` and of K2, K2s launches per rank 1 at the ends
   of the line and 2 in its middle; (e) one rank of a 2x2 run SIGKILLed
   mid-epoch: the launcher exits non-zero within the gloo timeout (30 s)
   + 10 s and no rank survives.
22. the numerics modes (``--precision``; ``utils/device.py::numerics``),
   run after phase 21 on the separable pool: (a) in process, EEGNet at
   full width (C=22, T=257, F1=8, D=2, batch 64), 36 within-subject folds
   (the pool's two subjects replicated to nine), the modes in turns
   highest, high, default, bf16, bf16, default, high, highest, each run a
   fresh trainer in its mode's scope for 1 + 4 + 1 epochs and the test
   pass: fold-epochs/s (the 4 timed epochs), GFLOP/s and the MFU against
   that mode's peak (FP32, TF32 or BF16), the peak memory, and, in each
   mode's first run, one profiled epoch (idle share, top five kernels,
   the tensor-core kernels by name); then 90 cross-subject folds in one
   group, one run a mode (1 + 1 + 1 epochs; high's and bf16's last epoch
   profiled); (b) each mode's two runs
   bitwise equal, high bitwise default, the last highest run bitwise the
   first; K1-stacked launched ``(epochs + 2) x val_steps + test_steps``
   times under highest and never under the others; TF32 (high,
   default) or BF16 (bf16) tensor-core GEMMs or convolutions in each
   profile and none under highest; each mode's first-step losses at
   dropout 0 within 8 unit roundoffs (2**-11 for TF32, 2**-8 for bf16)
   of highest's, relative; the separable pool above 50% in every mode;
   (c) a bf16 run stopped after its first chunk (``train.chunk``) in
   process, its resume under highest refused ("different run"), then
   ``train --precision bf16 --resume`` exits 0 with the JAX report's
   keys, an f32 ``.npz`` whose digest the engine serves, ``predict``'s
   accuracy line equal to the engine's, ``run_start`` naming bf16 and no
   K1-stacked launch; (d) beside it ``train --meshData 2 --precision
   bf16`` exits 0 the same way (its losses draw dropout per data rank, so
   the loss comparison at dropout 0 is 21c's bf16 DP step).

Phases 10 and 11 print GFLOP/s and the MFU against the card's FP32 peak
(``utils/flops.py``) beside fold-epochs/s at 8, 36 and 90 folds; phase
22 against the peak of each mode's arithmetic.

Phase 3b holds the stacked form of K1 (``block1_stacked``: G weight sets,
an index per trial, what the training loop's validation and test passes
launch) against ``block1_stacked_reference`` at G in {1, 8, 36}, B in {1,
64}, T in {257, 1125} and permuted indices, atol/rtol 1e-5, checks three
calls at (512, 22, 257) bitwise equal, and holds it to K1 bit for bit per
weight set at the 90-fold validation batch (90 x 64 trials, permuted) and
at a zoo chunk (128 trials over nine sets); the timing phase times it at
(512, 22, 257) and (2304, 22, 257), the 8- and 36-fold validation batches,
beside its plain version, a grouped cuDNN composite and its bound.

The last lines are the ``{"kernels": [...]}`` record and, last of all,
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before the
result line.  Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import http.client
import io
import json
import os
import queue
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.error
import urllib.parse
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# The port is imported from the checkout this script sits in, whatever the
# working directory and even where Python leaves the script's directory off
# the path (``-P``, ``-I``, ``PYTHONSAFEPATH``).  Its subprocesses get the
# same through PYTHONPATH.
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and f32
# without tensor cores.  The bound of a call is the larger of its bytes over
# the first and its FLOPs over the second.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

K1_ATOL, K1_RTOL = 1e-5, 1e-5
# The JAX package's own Pallas-vs-scan tolerance (tests/test_ems.py).
K2_ATOL, K2_RTOL = 1e-4, 1e-4
DATASET_ATOL, DATASET_RTOL = 1e-3, 1e-3
SESSION = (22, 345_600)   # a 45-minute session after the 128 Hz resample
SESSION_S = 45 * 60       # a competition session: 45 minutes at 250 Hz,
N_TRIALS = 288            # 288 cued trials (6 runs of 48)
LOGITS_ATOL, LOGITS_RTOL = 1e-5, 1e-4
BUCKETS = (1, 8, 32, 128)
N_TIMED = 60             # timed runs per measurement (median)
N_LATENCY = 30           # /predict requests per size (median)
SERVE_START_TIMEOUT_S = 300.0
# Training (phase 10).  Per-epoch losses of the card and the CPU from one
# seed at dropout 0 agree to the tolerance the CPU tests hold the port to
# against the JAX package (tests/test_torch_train_step.py): only the order
# of f32 sums differs (cuDNN's algorithms, grouped convolutions), and Adam
# carries the differences along.
TRAIN_ATOL, TRAIN_RTOL = 2e-3, 2e-3
TRAIN_EPOCHS = 5          # the CLI and the card's in-process run
# The CPU half of the card-vs-CPU check: one epoch since phase 20 joined
# the smoke (two before; the 1200 s limit).
CPU_EPOCHS = 1
LEARN_EPOCHS = 30         # the separable pool
TIME_EPOCHS = 10          # the throughput runs
# (folds, batch): the 8- and 36-fold within-subject validation batches and
# the 90-fold cross-subject one (512, 2304 and 5760 trials)
K1_STACKED_SIZES = ((8, 64), (36, 64), (90, 64))
# Cross-subject training and resume (phase 11).
CS_EPOCHS = 2             # the CLI and the counted runs
CS_GROUP = 15             # the counted run in groups: 6 groups of 15
# The group-size sweep's ends (30 and 45 dropped since phase 21, for the
# time limit: the sweep has always picked 90, and its rates rose with the
# size).
CS_SWEEP = (15, 90)
CS_SWEEP_EPOCHS = 2       # timed, after one warm-up epoch
CS_LEARN_EPOCHS = 10
# The resume drill: a resumed card run against an unbroken one, and two
# unbroken ones.  The card's runs are deterministic (utils/device.py), so
# every leg must give the same weights bit for bit.
RESUME_EPOCHS, RESUME_EVERY = 4, 2
RESUME_WAIT_S = 600.0
# The chaos leg: an out-of-memory error injected into every group of more
# than 4 folds halves the cross-subject CLI's groups of 8 to 4.
CHAOS_GROUP, CHAOS_OVER = 8, 4
# The cost legs: epochs timed per measurement, in turns on, off, off, on.
# (5, 5, 2 and 2 before phase 21, cut for the time limit; the 90-fold
# determinism leg went for phase 22.)
DET_EPOCHS = {8: 3, 36: 3}
NAN_EPOCHS = 1
WS_REPORT_KEYS = {
    "": {"training_type", "timestamp", "model_parameters",
         "overall_results", "per_subject_results", "model_info",
         "summary_statistics"},
    "model_parameters": {"batch_size", "epochs", "learning_rate",
                         "dropout_probability", "cross_validation_folds"},
    "overall_results": {"average_test_accuracy", "number_of_subjects",
                        "best_subject_accuracy", "worst_subject_accuracy",
                        "accuracy_std"},
    "model_info": {"architecture", "optimizer", "loss_function",
                   "saved_models_count"},
    "summary_statistics": {"accuracy_distribution", "accuracy_quartiles"},
}
CS_REPORT_KEYS = {
    "": WS_REPORT_KEYS[""],
    "model_parameters": {"batch_size", "epochs", "learning_rate",
                         "dropout_probability", "total_folds",
                         "repeats_per_subject", "train_subjects_per_fold",
                         "validation_subjects_per_fold"},
    "overall_results": {"average_test_accuracy", "standard_error",
                        "number_of_test_subjects", "best_subject_accuracy",
                        "worst_subject_accuracy", "accuracy_std"},
    "model_info": {"architecture", "optimizer", "loss_function",
                   "saved_model"},
    "summary_statistics": WS_REPORT_KEYS["summary_statistics"],
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


# --------------------------------------------------------------------------
# Seeded models and inputs
# --------------------------------------------------------------------------

def seeded_model(torch, c, t, f1, d, seed, device, perturb_bn=True):
    """An EEGNet drawn from ``seed``; with ``perturb_bn`` its BatchNorm
    affine and running statistics are moved off the identity so the
    folding is exercised."""
    from eegnetreplication_tpu_torch.models import EEGNet

    g = torch.Generator().manual_seed(seed)
    model = EEGNet(c, t, F1=f1, D=d, device="cpu", generator=g)
    if perturb_bn:
        with torch.no_grad():
            for bn in (model.temporal[1], model.aggregation[0],
                       model.block_2[2]):
                n = bn.num_features
                bn.weight.copy_(1.0 + 0.2 * torch.randn(n, generator=g))
                bn.bias.copy_(0.2 * torch.randn(n, generator=g))
                bn.running_mean.copy_(0.3 * torch.randn(n, generator=g))
                bn.running_var.copy_(0.5 + torch.rand(n, generator=g))
    return model.to(device)


def trials(torch, n, c, t, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, c, t), generator=g)


# --------------------------------------------------------------------------
# Timing
# --------------------------------------------------------------------------

def device_ms(torch, fn, n=N_TIMED, warmup=5, flush=None):
    """Median device time of one ``fn()`` call from CUDA events.  Each
    timed call is enqueued behind a spin kernel, so the events bracket the
    call's device work and not the host's launch overhead.  With ``flush``
    (a large tensor) it is zeroed before each call, outside the events, so
    the call finds the L2 cache cold."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(10_000_000)  # ~5 ms of spinning: host gets ahead
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in times)


def call_ms(torch, fn, n=N_TIMED, warmup=5):
    """Median time of one ``fn()`` call from an idle stream (CUDA events):
    what one call costs its caller, host launch overhead included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, n=N_TIMED, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1000.0)
    return statistics.median(times)


def block1_bound(b, c, t, f2, sets=0):
    """(bound_ms, bound_by, bytes, flops) of one block-1 call: x read once,
    weights read once, the pooled output written once; the mix, the 32
    taps, the affine, ELU and the pool as this input needs them.  With
    ``sets`` (the stacked form) the weights are that many sets and an int32
    index per trial is read too."""
    t_used = 4 * (t // 4)
    nbytes = 4 * (b * c * t + max(sets, 1) * f2 * (c + 32 + 2)
                  + b * f2 * (t // 4) + (b if sets else 0))
    flops = (2 * b * f2 * c * t           # mix
             + 2 * b * f2 * 32 * t_used   # taps
             + 2 * b * f2 * t_used        # affine
             + b * f2 * t_used            # ELU
             + b * f2 * t_used)           # pool
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / F32_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops
            else "operations", nbytes, flops)


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------

def phase_device(torch):
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(),
          f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s), "
        f"device 0: {torch.cuda.get_device_name(0)}")
    return card


def phase_build():
    from eegnetreplication_tpu_torch.ops import build

    t0 = time.perf_counter()
    results = build.build()
    wall = time.perf_counter() - t0
    for r in results.values():
        log(f"built {r.name} -> {r.path.name} in {r.seconds:.2f}s")
        for line in r.log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas: {line.strip()}")
    log(f"build: {wall:.2f}s for {len(results)} kernel source(s)")
    return wall


def phase_k1(torch, dev):
    from eegnetreplication_tpu_torch.ops.fused_eegnet import (
        block1,
        block1_reference,
        fold_block1_params,
    )

    cases = [(c, t, f1, d, b, p)
             for c, t in ((22, 257), (22, 256))
             for f1, d in ((8, 2), (16, 4))
             for b in BUCKETS
             for p in (False, True)]
    cases += [(8, 64, 8, 2, 8, False), (8, 64, 8, 2, 8, True),
              # a 4.5 s trial at 250 Hz: 36 time tiles a trial
              (22, 1125, 8, 2, 8, True), (22, 1125, 8, 2, 1, True),
              # the largest batch a caller may hand the kernel at once
              (22, 257, 8, 2, 1024, True)]
    # T on the edges of K1's time tile (32 conv positions) and of a pool
    # window, one trial each.
    cases += [(22, t, 8, 2, 1, True)
              for t in (4, 31, 32, 33, 35, 36, 63, 64, 65)]
    worst = 0.0
    for i, (c, t, f1, d, b, p) in enumerate(cases):
        # Block 1's folded weights do not depend on T; an EEGNet of fewer
        # than 32 samples has no classifier to build, so take a longer one.
        model = seeded_model(torch, c, max(t, 64), f1, d, 100 + i, dev,
                             perturb_bn=p)
        with torch.inference_mode():
            S, W, A, B = fold_block1_params(model.state_dict(),
                                            model.bn_epsilon)
            x = trials(torch, b, c, t, 200 + i).to(dev)
            got = block1(x, S, W, A, B)
            want = block1_reference(x, S, W, A, B)
        torch.cuda.synchronize()
        check(got.shape == want.shape,
              f"K1 shape {tuple(got.shape)} != {tuple(want.shape)}")
        err = float((got - want).abs().max())
        worst = max(worst, err)
        check(bool(torch.isfinite(got).all()), f"K1 non-finite at {cases[i]}")
        check(torch.allclose(got, want, atol=K1_ATOL, rtol=K1_RTOL),
              f"K1 disagrees with block1_reference at (C,T,F1,D,B,bn)="
              f"{cases[i]}: max abs err {err:.3e}")
    log(f"K1 vs block1_reference: {len(cases)} cases, max abs err "
        f"{worst:.3e} (atol {K1_ATOL}, rtol {K1_RTOL})")
    return worst


def stacked_weights(torch, g, c, f2, seed):
    """G folded block-1 weight sets ``(S, W, A, B)`` drawn from ``seed``,
    at the scales folding a trained EEGNet gives."""
    gen = torch.Generator().manual_seed(seed)
    return (0.3 * torch.randn((g, f2, c), generator=gen),
            0.2 * torch.randn((g, f2, 32), generator=gen),
            1.0 + 0.2 * torch.randn((g, f2), generator=gen),
            0.2 * torch.randn((g, f2), generator=gen))


def phase_k1_stacked(torch, dev):
    from eegnetreplication_tpu_torch.ops.fused_eegnet import (
        block1_stacked,
        block1_stacked_reference,
        fold_index,
    )

    cases = [(g, b, t, False) for g in (1, 8, 36) for b in (1, 64)
             for t in (257, 1125)]
    cases += [(8, 64, 257, True), (36, 64, 257, True), (36, 1, 1125, True),
              # a cross-subject validation batch of 90 folds: 5760 trials
              (90, 64, 257, False), (90, 64, 257, True)]
    worst = 0.0
    for i, (g, b, t, permuted) in enumerate(cases):
        S, W, A, B = (v.to(dev) for v in stacked_weights(torch, g, 22, 16,
                                                         300 + i))
        x = trials(torch, g * b, 22, t, 400 + i).to(dev)
        idx = fold_index(g, b, dev)
        if permuted:
            perm = torch.randperm(g * b,
                                  generator=torch.Generator().manual_seed(i))
            idx = idx[perm.to(dev)].contiguous()
        with torch.no_grad():
            got = block1_stacked(x, S, W, A, B, idx)
            want = block1_stacked_reference(x, S, W, A, B, idx)
        torch.cuda.synchronize()
        check(got.shape == want.shape == (g * b, 16, t // 4),
              f"K1-stacked shape {tuple(got.shape)} at {cases[i]}")
        check(bool(torch.isfinite(got).all()),
              f"K1-stacked non-finite at (G,B,T,permuted)={cases[i]}")
        err = float((got - want).abs().max())
        worst = max(worst, err)
        check(torch.allclose(got, want, atol=K1_ATOL, rtol=K1_RTOL),
              f"K1-stacked disagrees with block1_stacked_reference at "
              f"(G,B,T,permuted)={cases[i]}: max abs err {err:.3e}")
    log(f"K1-stacked vs block1_stacked_reference: {len(cases)} cases, max "
        f"abs err {worst:.3e} (atol {K1_ATOL}, rtol {K1_RTOL})")

    S, W, A, B = (v.to(dev) for v in stacked_weights(torch, 8, 22, 16, 9))
    x = trials(torch, 512, 22, 257, 10).to(dev)
    idx = fold_index(8, 64, dev)
    with torch.no_grad():
        runs = [block1_stacked(x, S, W, A, B, idx) for _ in range(3)]
    torch.cuda.synchronize()
    check(torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2]),
          "K1-stacked gave different bits on three calls at (512, 22, 257)")
    log("K1-stacked at (512, 22, 257): three calls, bitwise equal")
    _k1_stacked_equals_k1(torch, dev)
    return worst


def _k1_stacked_equals_k1(torch, dev):
    """K1-stacked keeps K1's order of every sum (csrc/block1_stacked.cu), so
    each trial equals K1 on its trial and weight set bit for bit: the
    90-fold validation batch permuted, and a zoo chunk of 128 trials mixed
    over nine sets (the short work items)."""
    from eegnetreplication_tpu_torch.ops.fused_eegnet import (
        block1,
        block1_stacked,
        fold_index,
    )

    for what, g, n, seed in (("(90, 64, 257) permuted", 90, 5760, 31),
                             ("the zoo chunk, 128 over 9", N_TENANTS, 128,
                              32)):
        S, W, A, B = (v.to(dev) for v in stacked_weights(torch, g, 22, 16,
                                                         seed))
        x = trials(torch, n, 22, 257, seed + 1).to(dev)
        idx = (fold_index(g, n // g, dev) if n % g == 0 else
               (torch.arange(n, dtype=torch.int32, device=dev) % g))
        perm = torch.randperm(n, generator=torch.Generator().manual_seed(seed))
        idx = idx[perm.to(dev)].contiguous()
        with torch.no_grad():
            got = block1_stacked(x, S, W, A, B, idx)
            for s in range(g):
                rows = (idx == s).nonzero()[:, 0]
                want = block1(x[rows].contiguous(), S[s], W[s], A[s], B[s])
                check(torch.equal(got[rows], want),
                      f"K1-stacked differs from K1 on set {s} at {what}")
        torch.cuda.synchronize()
        log(f"K1-stacked equals K1 bit for bit per weight set at {what}")


def phase_forward(torch, dev):
    from eegnetreplication_tpu_torch.serve.engine import InferenceEngine

    worst = 0.0
    for f1, d in ((8, 2), (16, 4)):
        gpu_model = seeded_model(torch, 22, 257, f1, d, 7, dev)
        cpu_model = seeded_model(torch, 22, 257, f1, d, 7, "cpu")
        engine = InferenceEngine(gpu_model, device=dev)
        x = trials(torch, 37, 22, 257, 8)
        with torch.inference_mode():
            got = engine.forward(x.to(dev)).cpu()
            want = cpu_model(x)
        err = float((got - want).abs().max())
        worst = max(worst, err)
        check(torch.allclose(got, want, atol=LOGITS_ATOL, rtol=LOGITS_RTOL),
              f"engine logits (F1={f1}, D={d}) disagree with the CPU "
              f"forward: max abs err {err:.3e}")
        check(torch.equal(got.argmax(-1), want.argmax(-1)),
              f"engine argmax (F1={f1}, D={d}) differs from the CPU forward")
        preds = engine.infer(x.numpy())
        check((preds == want.argmax(-1).numpy()).all(),
              f"engine.infer (F1={f1}, D={d}) differs from the CPU argmax")
    log(f"engine forward (cuda) vs EEGNet.forward (cpu): max abs logit err "
        f"{worst:.3e} (atol {LOGITS_ATOL}, rtol {LOGITS_RTOL}), argmax equal")
    return worst


def _post(url, body: bytes, ctype: str, timeout=60.0, headers=None):
    """POST; ``(status, JSON reply)``, an HTTP error's too."""
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": ctype,
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read().decode())


def _get(url, timeout=30.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read().decode())


def _npz_body(np, x) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, X=np.asarray(x, np.float32))
    return buf.getvalue()


def _json_body(x) -> bytes:
    return json.dumps({"trials": x.tolist()}).encode()


def _spawn_cli(module: str, args: list, work: Path, env: dict, name: str,
               new_session: bool = False):
    """Start ``python -m module`` with ``args`` on an ephemeral port, its
    stdout read line by line; ``(process, lines queue, stderr file, stderr
    path)``.  ``new_session`` gives it a process group of its own."""
    log_path = work / f"{name}.stderr.log"
    stderr = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", module, *args, "--port", "0"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=stderr, text=True,
        start_new_session=new_session)
    lines: queue.Queue = queue.Queue()

    def pump():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    threading.Thread(target=pump, daemon=True).start()
    return proc, lines, stderr, log_path


def _await_url(started, prefix: str, timeout: float) -> str:
    """The URL a CLI started by :func:`_spawn_cli` prints after
    ``prefix`` once it serves; fails at the deadline or if it exits."""
    proc, lines, _, log_path = started
    deadline = time.monotonic() + timeout
    while True:
        try:
            line = lines.get(timeout=max(0.1, deadline - time.monotonic()))
        except queue.Empty:
            raise SmokeFailure(f"{proc.args[3]} did not print {prefix!r} in "
                               f"{timeout:.0f}s")
        if line is None:
            raise SmokeFailure(
                f"{proc.args[3]} exited {proc.wait()} before serving:\n"
                + log_path.read_text()[-4000:])
        if line.startswith(prefix):
            return line[len(prefix):].split()[0]


def _start_server(args: list, work: Path, env: dict, name: str = "serve"):
    """Start the serve CLI with ``args`` on an ephemeral port and wait for
    its ``serving at`` line; ``(process, url, stderr file)``."""
    started = _spawn_cli("eegnetreplication_tpu_torch.serve", args, work,
                         env, name)
    return (started[0], _await_url(started, "serving at ",
                                   SERVE_START_TIMEOUT_S), started[2])


def phase_serve(torch, np, dev, work: Path, env: dict):
    from eegnetreplication_tpu_torch.data.containers import BCICI2ADataset
    from eegnetreplication_tpu_torch.data.io import save_trials
    from eegnetreplication_tpu_torch.predict import predict_trials
    from eegnetreplication_tpu_torch.serve.engine import (
        CLASS_NAMES,
        load_model_from_checkpoint,
    )
    from eegnetreplication_tpu_torch.training import checkpoint as ckpt_lib
    from eegnetreplication_tpu_torch.ops.fused_eegnet import block1

    model = seeded_model(torch, 22, 257, 8, 2, 11, "cpu")
    ckpt = ckpt_lib.save_checkpoint(
        work / "smoke_model.npz", model.state_dict(),
        metadata={"model": "eegnet", "n_channels": 22, "n_times": 257,
                  "F1": 8, "D": 2})
    x = trials(torch, 37, 22, 257, 12).numpy()
    y = np.random.RandomState(13).randint(0, 4, size=37).astype(np.int64)
    trials_path = save_trials(BCICI2ADataset(X=x, y=y),
                              work / "A01E-trials.npz")

    # The CLI's own function, in process: the reference predictions.
    block1.launches = 0
    ref_preds = predict_trials(load_model_from_checkpoint(ckpt, device=dev),
                               x, device=dev)
    in_process_launches = block1.launches

    result: dict = {"in_process_launches": in_process_launches}
    proc, url, stderr = _start_server(["--checkpoint", str(ckpt)], work,
                                      env)
    try:
        log(f"server up at {url}")
        status, one = _post(url + "/predict", _json_body(x[:1]),
                            "application/json")
        check(status == 200 and one["n"] == 1, f"JSON /predict: {one}")
        status, many = _post(url + "/predict", _npz_body(np, x),
                             "application/octet-stream")
        check(status == 200 and many["n"] == 37, f"npz /predict: {many}")
        served = np.asarray(many["predictions"], np.int64)
        check(one["predictions"][0] == served[0],
              "bucket padding changed trial 0's prediction")
        check((served == ref_preds).all(),
              f"served predictions {served.tolist()} != predict_trials "
              f"{ref_preds.tolist()}")

        # 8 concurrent requests: the batcher coalesces them.
        chunks = [x[4 * i:4 * i + 4] for i in range(8)]
        answers: list = [None] * 8

        def send(i):
            body = (_json_body(chunks[i]) if i % 2 else _npz_body(np,
                                                                   chunks[i]))
            ctype = "application/json" if i % 2 else "application/octet-stream"
            answers[i] = _post(url + "/predict", body, ctype)

        threads = [threading.Thread(target=send, args=(i,)) for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
        for i, ans in enumerate(answers):
            check(ans is not None and ans[0] == 200,
                  f"concurrent request {i} failed: {ans}")
            check(ans[1]["predictions"] == served[4 * i:4 * i + 4].tolist(),
                  f"concurrent request {i} predictions differ")

        # Latency of /predict at 1 and 128 trials (host clock, median).
        x128 = trials(torch, 128, 22, 257, 14).numpy()
        body1, body128 = _npz_body(np, x[:1]), _npz_body(np, x128)
        lat = {}
        for n, body in ((1, body1), (128, body128)):
            lat[n] = host_ms(lambda body=body: _post(
                url + "/predict", body, "application/octet-stream"),
                n=N_LATENCY)
        result["predict_latency_ms"] = lat

        status, health = _get(url + "/healthz")
        check(status == 200 and health["status"] == "ok", f"/healthz: {health}")
        check(health["model_digest"] == many["model_digest"]
              == health["variables_digest"], "digest mismatch in /healthz")
        check(health["geometry"] == {"n_channels": 22, "n_times": 257},
              f"/healthz geometry {health['geometry']}")
        launches = health["kernel_launches"]["block1"]
        batches = health["batches"]
        n_warm = len(health["buckets"])
        # Every forward is one bucket chunk (no request here exceeds 128
        # trials), one replay of its bucket's CUDA graph and so exactly one
        # K1 launch, after one eager warm run per bucket (the capture
        # itself launches nothing).
        check(health["graph_replays"] == batches,
              f"{health['graph_replays']} graph replays for {batches} "
              "forwards")
        check(launches == n_warm + batches,
              f"K1 launches {launches} != {n_warm} warmup + {batches} "
              "forwards")
        n_requests = 2 + 8 + 2 * (N_LATENCY + 3)
        log(f"/healthz: {batches} forwards for {n_requests} requests, "
            f"K1 launches {launches}")
        result.update(launches=launches, batches=batches,
                      requests=n_requests, digest=health["model_digest"])

        # The predict CLI on the same trials and checkpoint.
        cli = subprocess.run(
            [sys.executable, "-m", "eegnetreplication_tpu_torch.predict",
             "--checkpoint", str(ckpt), "--input", str(trials_path)],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        check(cli.returncode == 0, f"predict CLI exited {cli.returncode}:\n"
              + cli.stderr[-4000:])
        want_line = f"accuracy: {100.0 * float(np.mean(served == y)):.2f}%"
        got_line = cli.stdout.strip().splitlines()[-1]
        check(got_line == want_line,
              f"predict CLI printed {got_line!r}, served trials give "
              f"{want_line!r}")
        counts = np.bincount(served, minlength=4)
        for k, name in enumerate(CLASS_NAMES):
            check(f"class {k} ({name}): {counts[k]} trials" in cli.stderr,
                  f"predict CLI's count for class {k} differs from served")
        log(f"predict CLI: {got_line!r} == served; class counts equal")

        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        check(rc == 75, f"server exited {rc} after SIGTERM, want 75")
        log("SIGTERM: drained, exit 75")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        stderr.close()
    return result


def phase_times(torch, np, dev):
    import torch.nn.functional as F

    from eegnetreplication_tpu_torch.ops.fused_eegnet import (
        block1,
        block1_reference,
        fold_block1_params,
    )
    from eegnetreplication_tpu_torch.serve.engine import InferenceEngine

    model = seeded_model(torch, 22, 257, 8, 2, 21, dev)
    engine = InferenceEngine(model, device=dev)
    engine.warmup()
    with torch.inference_mode():
        S, W, A, B = fold_block1_params(model.state_dict(), model.bn_epsilon)
    f2 = S.shape[0]

    def library(x):
        # One library composite of the same function (never used by the
        # port): cuDNN conv1d for the mix and the taps, then the affine,
        # ELU and avg_pool1d.
        mixed = F.conv1d(x, S[:, :, None])
        acc = F.conv1d(F.pad(mixed, (15, 16)), W[:, None, :], groups=f2)
        return F.avg_pool1d(F.elu(A[:, None] * acc + B[:, None]), 4)

    per_bucket = {}
    for b in BUCKETS:
        x = trials(torch, b, 22, 257, 30 + b).to(dev)
        xn = x.cpu().numpy()
        with torch.inference_mode():
            lib_out = library(x)
            ref_out = block1_reference(x, S, W, A, B)
            check(torch.allclose(lib_out, ref_out, atol=1e-5, rtol=1e-5),
                  f"library composite disagrees at B={b}")
            k1 = lambda: block1(x, S, W, A, B)              # noqa: E731
            plain = lambda: block1_reference(x, S, W, A, B)  # noqa: E731
            lib = lambda: library(x)                        # noqa: E731
            row = {
                "ms": device_ms(torch, k1),
                "plain_ms": device_ms(torch, plain),
                "library_ms": device_ms(torch, lib),
                "call_ms": call_ms(torch, k1),
                "plain_call_ms": call_ms(torch, plain),
                "library_call_ms": call_ms(torch, lib),
            }
        row["engine_infer_ms"] = host_ms(lambda: engine.infer(xn))
        bound, by, nbytes, flops = block1_bound(b, 22, 257, f2)
        row.update(bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops)
        per_bucket[b] = row
        log(f"B={b}: K1 {row['ms']:.4f} ms (call {row['call_ms']:.4f}), "
            f"plain {row['plain_ms']:.4f}, library {row['library_ms']:.4f}, "
            f"bound {bound:.5f} ({by}), engine infer "
            f"{row['engine_infer_ms']:.3f} ms")
    return per_bucket


def phase_timer_floor(torch, dev):
    """What ``device_ms`` reads for no work and for one one-element kernel:
    the floor under every kernel time of phases 6 and 9."""
    tiny = torch.zeros(1, device=dev)
    floor = {"empty_window_ms": device_ms(torch, lambda: None),
             "one_tiny_kernel_ms": device_ms(torch, lambda: tiny.add_(1))}
    log(f"timer floor: empty window {floor['empty_window_ms']:.4f} ms, one "
        f"one-element kernel {floor['one_tiny_kernel_ms']:.4f} ms")
    return floor


def phase_k1_stacked_times(torch, dev):
    """K1-stacked at the validation batches of 8, 36 and 90 folds (CUDA
    events, median), beside its plain version, one grouped cuDNN composite
    of the same function and its bound."""
    import torch.nn.functional as F

    from eegnetreplication_tpu_torch.ops.fused_eegnet import (
        block1_stacked,
        block1_stacked_reference,
        fold_index,
    )

    rows = {}
    for g, b in K1_STACKED_SIZES:
        n = g * b
        S, W, A, B = (v.to(dev) for v in stacked_weights(torch, g, 22, 16,
                                                         600 + g))
        f2 = S.shape[1]
        x = trials(torch, n, 22, 257, 700 + g).to(dev)
        idx = fold_index(g, b, dev)

        def library():
            # Never used by the port: the folds as groups of cuDNN
            # convolutions (mix, then taps), the affine, ELU and the pool.
            xs = x.reshape(g, b, 22, 257).transpose(0, 1).reshape(
                b, g * 22, 257)
            mixed = F.conv1d(xs, S.reshape(g * f2, 22, 1), groups=g)
            acc = F.conv1d(F.pad(mixed, (15, 16)),
                           W.reshape(g * f2, 1, 32), groups=g * f2)
            out = F.avg_pool1d(F.elu(A.reshape(-1, 1) * acc
                                     + B.reshape(-1, 1)), 4)
            return out.reshape(b, g, f2, -1).transpose(0, 1).reshape(
                n, f2, -1)

        with torch.no_grad():
            check(torch.allclose(library(), block1_stacked_reference(
                x, S, W, A, B, idx), atol=1e-5, rtol=1e-5),
                f"grouped library composite disagrees at {n} trials")
            block1_stacked(x, S, W, A, B, idx)   # checks idx once
            row = {
                "ms": device_ms(torch, lambda: block1_stacked(
                    x, S, W, A, B, idx)),
                "plain_ms": device_ms(torch, lambda: block1_stacked_reference(
                    x, S, W, A, B, idx)),
                "library_ms": device_ms(torch, library),
                "call_ms": call_ms(torch, lambda: block1_stacked(
                    x, S, W, A, B, idx)),
            }
        bound, by, nbytes, flops = block1_bound(n, 22, 257, f2, sets=g)
        row.update(folds=g, batch=b, trials=n, bound_ms=bound, bound_by=by,
                   bytes=nbytes, flops=flops)
        rows[n] = row
        log(f"K1-stacked at ({n}, 22, 257): {row['ms']:.4f} ms (call "
            f"{row['call_ms']:.4f}), plain {row['plain_ms']:.4f}, grouped "
            f"library {row['library_ms']:.4f}, bound {bound:.5f} ({by})")
    return rows


def ems_bound(c, t, init_block_size=1000):
    """(bound_ms, bound_by, bytes, flops) of one EMS call on (C, T) f32:
    x read once and the output written once; per sample the centring, both
    recurrences (3 each), the deviation and its square, eps, the square
    root and the division (12), plus the seed statistics of the first
    ``init_block_size`` samples (3 per sample)."""
    nbytes = 4 * 2 * c * t
    flops = 12 * c * t + 3 * c * min(init_block_size, t)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / F32_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops
            else "operations", nbytes, flops)


def session_signal(np, c, t, seed):
    """An EEG-like (C, T) float32 session from ``seed``: per-channel
    offsets, 10 Hz alpha and 20 Hz beta rhythms and broadband noise, in
    microvolts."""
    rng = np.random.RandomState(seed)
    tt = np.arange(t, dtype=np.float32) / np.float32(250.0)
    sig = rng.standard_normal((c, t)).astype(np.float32)
    sig *= np.float32(8.0)
    sig += rng.uniform(-30, 30, (c, 1)).astype(np.float32)
    sig += (np.float32(12.0) * np.sin(np.float32(2 * np.pi * 10.0) * tt))
    sig += (np.float32(5.0) * np.sin(np.float32(2 * np.pi * 20.0) * tt
                                      + np.float32(0.7)))
    return sig


def phase_k2(torch, np, dev):
    from eegnetreplication_tpu_torch.ops.ems import (
        exponential_moving_standardize,
    )
    from eegnetreplication_tpu_torch.ops.ems_kernel import ems, ems_reference

    rng = np.random.RandomState(40)
    session = torch.from_numpy(session_signal(np, *SESSION, 41)).to(dev)
    cases = [
        ("session (22, 345600)", session, {}),
        ("(4, 3000)", rng.randn(4, 3000) * 5.0 + 2.0, {}),
        ("ragged (3, 700)", rng.randn(3, 700), {}),
        ("(1, 500) init 100", rng.randn(1, 500), {"init_block_size": 100}),
        ("(2, 50) init 1000 > T", rng.randn(2, 50), {}),
        ("constant (3, 400)", np.full((3, 400), 5.0), {"init_block_size": 100}),
        ("(4, 3000) factor_new 0.1", rng.randn(4, 3000) * 5.0 + 2.0,
         {"factor_new": 0.1}),
        # K2's tile boundaries (4096 samples a block), many tiles a channel
        ("(1, 4095)", rng.randn(1, 4095), {}),
        ("(1, 4096)", rng.randn(1, 4096), {}),
        ("(2, 3 x 4096 - 1)", rng.randn(2, 3 * 4096 - 1), {}),
        ("(2, 3 x 4096 + 1)", rng.randn(2, 3 * 4096 + 1), {}),
        ("(1, 85 x 4096 - 1)", rng.randn(1, 85 * 4096 - 1), {}),
        ("(1, 85 x 4096 + 1)", rng.randn(1, 85 * 4096 + 1), {}),
        ("(64, 345600)", rng.randn(64, 345_600) * 5.0 + 2.0, {}),
    ]
    worst = 0.0
    for name, x, kw in cases:
        if not torch.is_tensor(x):
            x = torch.from_numpy(x.astype(np.float32)).to(dev)
        got = ems(x, **kw)
        want = ems_reference(x, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        worst = max(worst, err)
        check(got.shape == x.shape, f"K2 shape {tuple(got.shape)} at {name}")
        check(bool(torch.isfinite(got).all()), f"K2 non-finite at {name}")
        check(torch.allclose(got, want, atol=K2_ATOL, rtol=K2_RTOL),
              f"K2 disagrees with ems_reference at {name}: max abs err "
              f"{err:.3e}")
        if name.startswith("constant"):
            check(float(got.abs().max()) < 1e-3,
                  f"K2 on a constant signal is not ~0: {got.abs().max()}")
    log(f"K2 vs ems_reference: {len(cases)} cases, max abs err {worst:.3e} "
        f"(atol {K2_ATOL}, rtol {K2_RTOL})")

    # Deterministic: three calls at the session shape, the same bits.
    runs = [ems(session) for _ in range(3)]
    torch.cuda.synchronize()
    check(torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2]),
          "K2 gave different bits on three calls at the session shape")
    log("K2 at the session shape: three calls, bitwise equal")

    other = {}
    x4 = session[:4, :3000].contiguous()
    for method, x in (("associative", session), ("scan", x4)):
        got = ems(x)
        want = exponential_moving_standardize(x, method=method)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, atol=K2_ATOL, rtol=K2_RTOL),
              f"K2 disagrees with method={method!r} at {tuple(x.shape)}: "
              f"max abs err {err:.3e}")
        other[method] = err
        log(f"K2 vs {method} at {tuple(x.shape)}: max abs err {err:.3e}")
    return worst, other


def write_raw_tree(np, raw, subjects=(1, 2), sfreq=250.0):
    """The competition's raw layout under ``raw``: ``{Train,Eval}/A0sX.gdf``
    sessions of 25 channels (22 EEG + 3 EOG) and ``TrueLabels/A0sE.mat``.
    Each session holds ``N_TRIALS`` trials: a trial start (768) 2 s before
    each cue, cues 8 s apart from the first minute on, codes 769-772 in
    Train (a quarter each, shuffled) and 783 in Eval, whose classes go to
    the .mat.  One second of channel 3 of the first Train session is NaN,
    like the competition's artifact spans.  Returns the expected labels by
    stem."""
    from scipy.io import savemat

    from eegnetreplication_tpu_torch.config import (
        EEG_CHANNEL_NAMES,
        EOG_CHANNEL_NAMES,
    )
    from eegnetreplication_tpu_torch.data.gdf import write_gdf

    n = int(SESSION_S * sfreq)
    labels = list(EEG_CHANNEL_NAMES + EOG_CHANNEL_NAMES)
    cue_pos = (int(60 * sfreq) + np.arange(N_TRIALS) * int(8 * sfreq)
               ).astype(np.int64)
    expected = {}
    for s in subjects:
        for mode in ("Train", "Eval"):
            seed = 1000 * s + (mode == "Eval")
            rng = np.random.RandomState(seed)
            classes = rng.permutation(np.repeat(np.arange(4),
                                                N_TRIALS // 4))
            sig = session_signal(np, 25, n, seed)
            if s == subjects[0] and mode == "Train":
                sig[3, 5000:5250] = np.nan
            cue_typ = (769 + classes) if mode == "Train" \
                else np.full(N_TRIALS, 783)
            pos = np.stack([cue_pos - int(2 * sfreq), cue_pos], 1).ravel()
            typ = np.stack([np.full(N_TRIALS, 768), cue_typ], 1).ravel()
            stem = f"A{s:02d}{mode[0]}"
            write_gdf(raw / mode / f"{stem}.gdf", sig, sfreq, labels=labels,
                      event_pos=pos, event_typ=typ)
            if mode == "Eval":
                (raw / "TrueLabels").mkdir(parents=True, exist_ok=True)
                savemat(raw / "TrueLabels" / f"{stem}.mat",
                        {"classlabel": (classes + 1).astype(np.uint8)})
            expected[stem] = classes.astype(np.int64)
    return expected


def _session_trials(np, rec_path, mode, paths, device, method,
                    prefer_native=True):
    """One session through the port's chain on ``device`` with
    ``EEGTPU_EMS_METHOD=method`` (read with the numpy reader unless
    ``prefer_native``): (X, y)."""
    from eegnetreplication_tpu_torch.data.epoching import (
        break_recording_into_epochs,
    )
    from eegnetreplication_tpu_torch.data.gdf import read_gdf
    from eegnetreplication_tpu_torch.data.preprocess import (
        EMS_METHOD_ENV,
        preprocess_recording,
    )

    saved = os.environ.get(EMS_METHOD_ENV)
    os.environ[EMS_METHOD_ENV] = method
    try:
        rec = preprocess_recording(
            read_gdf(rec_path, prefer_native=prefer_native), device=device)
    finally:
        if saved is None:
            os.environ.pop(EMS_METHOD_ENV, None)
        else:
            os.environ[EMS_METHOD_ENV] = saved
    reader = "native" if prefer_native else "numpy"
    out = paths.project_root / f"{method}-{device.type}-{reader}" / (
        rec_path.stem + "-preprocessed.npz")
    rec.save(out)
    return break_recording_into_epochs(out, mode=mode, paths=paths)


def _native_reader(np, raw: Path, stems) -> dict:
    """The native GDF reader against the numpy one on every session of
    the raw tree: arrays equal byte for byte; one read of each, in turns,
    on the host clock."""
    from eegnetreplication_tpu_torch.data import gdf, gdf_native

    per_session = {}
    for stem in stems:
        path = raw / ("Train" if stem.endswith("T") else "Eval") \
            / f"{stem}.gdf"
        t0 = time.perf_counter()
        nat = gdf_native.read_gdf(path)
        t1 = time.perf_counter()
        ref = gdf.read_gdf_python(path)
        t2 = time.perf_counter()
        for name in ("signals", "event_pos", "event_typ",
                     "event_durations"):
            a, b = getattr(nat, name), getattr(ref, name)
            check(a.dtype == b.dtype and a.shape == b.shape
                  and a.tobytes() == b.tobytes(), f"{stem}: the native "
                  f"reader's {name} differ from the numpy reader's")
        check(nat.labels == ref.labels and nat.sfreq == ref.sfreq,
              f"{stem}: the native reader's labels or rate differ")
        per_session[stem] = {"native_ms": (t1 - t0) * 1e3,
                             "numpy_ms": (t2 - t1) * 1e3,
                             "mb": ref.signals.nbytes / 1e6}
    return per_session


def phase_dataset(torch, np, dev, work: Path, env: dict):
    from eegnetreplication_tpu_torch.config import Paths
    from eegnetreplication_tpu_torch.data import gdf_native
    from eegnetreplication_tpu_torch.data.io import (
        load_subject_dataset,
        load_trials,
    )
    from eegnetreplication_tpu_torch.dataset import build_processed_tree
    from eegnetreplication_tpu_torch.ops.ems_kernel import ems
    from eegnetreplication_tpu_torch.ops.fused_eegnet import block1
    from eegnetreplication_tpu_torch.training import checkpoint as ckpt_lib

    cli_paths = Paths.from_root(work / "cli")
    t0 = time.perf_counter()
    expected = write_raw_tree(np, cli_paths.data_raw)
    log(f"raw tree: {len(expected)} sessions written in "
        f"{time.perf_counter() - t0:.1f}s")

    # The C++ GDF reader, built with g++ from the checkout (the dataset
    # CLI below reads through it).
    cached = gdf_native.library_path().is_file()
    t0 = time.perf_counter()
    built = gdf_native.ensure_built()
    native_build_s = time.perf_counter() - t0
    check(built and gdf_native.available(), f"the native GDF reader did "
          f"not build or load: {gdf_native.load_error()}")
    log(f"native GDF reader: {gdf_native.library_path().name} "
        f"{'found built' if cached else 'built'} in {native_build_s:.2f}s")

    # The CLI a user runs, on the card, EMS in K2.
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "eegnetreplication_tpu_torch.dataset",
         "--src", "kaggle"], cwd=ROOT,
        env=dict(env, EEGTPU_EMS_METHOD="pallas",
                 EEGTPU_DATA_ROOT=str(cli_paths.project_root)),
        capture_output=True, text=True, timeout=900)
    cli_s = time.perf_counter() - t0
    check(cli.returncode == 0, f"dataset CLI exited {cli.returncode}:\n"
          + cli.stderr[-4000:])
    log(f"dataset CLI (pallas): {cli_s:.1f}s for {len(expected)} sessions")

    # The same path in process, so K2's launches are counted: the main path.
    paths = Paths.from_root(work / "inproc")
    paths.data_processed.parent.mkdir(parents=True)
    paths.data_raw.symlink_to(cli_paths.data_raw, target_is_directory=True)
    os.environ["EEGTPU_EMS_METHOD"] = "pallas"
    try:
        ems.launches = 0
        block1.launches = 0
        gdf_native.read_gdf.reads = 0
        t0 = time.perf_counter()
        build_processed_tree(paths)
        inproc_s = time.perf_counter() - t0
        launches = ems.launches
        native_reads = gdf_native.read_gdf.reads
    finally:
        os.environ.pop("EEGTPU_EMS_METHOD", None)
    check(launches == len(expected),
          f"K2 launched {launches} times for {len(expected)} sessions")
    check(native_reads == len(expected), f"the native GDF reader served "
          f"{native_reads} of {len(expected)} sessions")
    log(f"build_processed_tree in process: {inproc_s:.1f}s, K2 launches "
        f"{launches}, native GDF reads {native_reads}")
    readers = _native_reader(np, cli_paths.data_raw, expected)
    log("native vs numpy GDF reader, arrays byte-equal on every session; "
        "host ms per session (native / numpy): " + ", ".join(
            f"{k} {v['native_ms']:.1f} / {v['numpy_ms']:.1f} "
            f"({v['mb']:.0f} MB)" for k, v in readers.items()))

    worst_repeat = 0.0
    for stem, classes in expected.items():
        mode = "Train" if stem.endswith("T") else "Eval"
        for p in (cli_paths, paths):
            for suffix in ("-preprocessed.npz", "-trials.npz"):
                check((p.data_processed / mode / f"{stem}{suffix}").is_file(),
                      f"{stem}{suffix} missing under {p.data_processed}")
        ds = load_trials(cli_paths.data_processed / mode
                         / f"{stem}-trials.npz")
        again = load_trials(paths.data_processed / mode
                            / f"{stem}-trials.npz")
        check(ds.X.shape == (N_TRIALS, 22, 257)
              and ds.X.dtype == np.float32,
              f"{stem}: trials {ds.X.shape} {ds.X.dtype}")
        check(bool(np.isfinite(ds.X).all()), f"{stem}: non-finite trials")
        check(np.array_equal(ds.y, classes),
              f"{stem}: labels differ from the cue codes / TrueLabels")
        check(np.array_equal(again.y, classes), f"{stem}: in-process labels")
        worst_repeat = max(worst_repeat,
                           float(np.abs(ds.X - again.X).max()))
    check(worst_repeat <= 1e-5,
          f"CLI and in-process runs differ by {worst_repeat:.3e}")
    log(f"{len(expected)} sessions: ({N_TRIALS}, 22, 257) trials, labels "
        f"equal to "
        f"the cues and TrueLabels; CLI vs in-process max diff "
        f"{worst_repeat:.3e}")

    # One session against the port on the CPU (plain versions) and against
    # the card's default method.
    raw = cli_paths.data_raw / "Train" / "A01T.gdf"
    card = load_trials(cli_paths.data_processed / "Train" / "A01T-trials.npz")
    # The native reader changes no trial: A01T read by the numpy reader
    # gives the in-process run's trials bit for bit (and the CLI's, which
    # equal those, above).
    native = load_trials(paths.data_processed / "Train" / "A01T-trials.npz")
    numpy_X, numpy_y = _session_trials(np, raw, "Train", paths, dev,
                                       "pallas", prefer_native=False)
    check(native.X.tobytes() == numpy_X.tobytes()
          and np.array_equal(native.y, numpy_y), "A01T's trials through the "
          "native reader differ from the numpy reader's")
    cli_diff = float(np.abs(card.X - numpy_X).max())
    log(f"A01T's trials through the numpy reader equal the native reader's "
        f"bit for bit; the CLI's differ from them by {cli_diff:.3e}")
    cpu_X, cpu_y = _session_trials(np, raw, "Train", paths,
                                   torch.device("cpu"), "pallas")
    assoc_X, assoc_y = _session_trials(np, raw, "Train", paths, dev,
                                       "associative")
    cmp = {}
    for name, X, y in (("cpu", cpu_X, cpu_y), ("associative", assoc_X,
                                               assoc_y)):
        err = float(np.abs(card.X - X).max())
        check(np.array_equal(card.y, y), f"A01T labels differ from {name}")
        check(np.allclose(card.X, X, atol=DATASET_ATOL, rtol=DATASET_RTOL),
              f"A01T trials on the card (pallas) differ from {name}: max "
              f"abs err {err:.3e}")
        cmp[name] = err
    log(f"A01T card (pallas) vs CPU (plain): {cmp['cpu']:.3e}; vs card "
        f"associative: {cmp['associative']:.3e} (atol {DATASET_ATOL}, rtol "
        f"{DATASET_RTOL})")

    # The port's predict CLI reads what the dataset CLI wrote.
    model = seeded_model(torch, 22, 257, 8, 2, 11, "cpu")
    ckpt = ckpt_lib.save_checkpoint(
        work / "smoke_model.npz", model.state_dict(),
        metadata={"model": "eegnet", "n_channels": 22, "n_times": 257,
                  "F1": 8, "D": 2})
    pred = subprocess.run(
        [sys.executable, "-m", "eegnetreplication_tpu_torch.predict",
         "--checkpoint", str(ckpt), "--subject", "1", "--mode", "Train"],
        cwd=ROOT, env=dict(env, EEGTPU_DATA_ROOT=str(cli_paths.project_root)),
        capture_output=True, text=True, timeout=600)
    check(pred.returncode == 0, f"predict --subject 1 exited "
          f"{pred.returncode}:\n" + pred.stderr[-4000:])
    marker = "block1 kernel launches: "
    check(marker in pred.stderr, "predict did not report K1 launches")
    k1 = int(pred.stderr.split(marker, 1)[1].split()[0])
    check(k1 > 0, "predict --subject 1 launched K1 no time")
    check(len(load_subject_dataset(1, "Train", cli_paths)) == N_TRIALS,
          f"load_subject_dataset(1, 'Train') did not give {N_TRIALS} trials")
    log(f"predict --subject 1 --mode Train: "
        f"{pred.stdout.strip().splitlines()[-1]!r}, K1 launches {k1}")
    return {"launches": launches, "sessions": len(expected),
            "cli_s": cli_s, "inproc_s": inproc_s,
            "repeat_max_abs_diff": worst_repeat,
            "cpu_max_abs_err": cmp["cpu"],
            "associative_max_abs_err": cmp["associative"],
            "predict_k1_launches": k1, "raw_session": str(raw),
            "native_gdf": {"build_s": native_build_s, "cached": cached,
                           "reads": native_reads, "sessions": readers}}


# --------------------------------------------------------------------------
# Phase 8c: the moabb path
# --------------------------------------------------------------------------

MOABB_RUNS = 6            # BNCI2014-001: 6 runs a session, 48 cues a run
MOABB_CUES = 48
MOABB_RUN_S = 387.0       # cues 8 s apart from 3 s on, 8 s after the last
MOABB_CLASSES = ("left_hand", "right_hand", "feet", "tongue")


def _fake_mne():
    """``tests/fake_mne.py`` loaded by path: the numpy-only slice of MNE
    that ``data/moabb.py`` reads runs through (``.npz`` payloads under
    ``.fif`` names).  The card's machine has no MNE."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "fake_mne", ROOT / "tests" / "fake_mne.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_moabb_tree(np, write_fake_fif, moabb_dir: Path,
                     subject: int = 1) -> dict:
    """The run layout ``fetch --src moabb`` writes for BNCI2014-001 under
    ``moabb_dir``: ``{Train,Eval}/A0sT_run_k.fif``, each of ``MOABB_RUNS``
    runs 22 EEG and 3 EOG channels at 250 Hz in volts, ``MOABB_CUES`` cues
    named by class as moabb names them (a quarter each, shuffled).
    Returns each session's labels in run order."""
    from eegnetreplication_tpu_torch.config import (
        EEG_CHANNEL_NAMES,
        EOG_CHANNEL_NAMES,
    )

    sfreq = 250.0
    n = int(MOABB_RUN_S * sfreq)
    names = list(EEG_CHANNEL_NAMES + EOG_CHANNEL_NAMES)
    types = ["eeg"] * 22 + ["eog"] * 3
    onsets = 3.0 + 8.0 * np.arange(MOABB_CUES)
    expected = {}
    for mode in ("Train", "Eval"):
        stem = f"A{subject:02d}{mode[0]}"
        classes = []
        for k in range(MOABB_RUNS):
            seed = 5000 + 10 * k + (mode == "Eval")
            cls = np.random.RandomState(seed).permutation(
                np.repeat(np.arange(4), MOABB_CUES // 4))
            out = moabb_dir / mode / f"{stem}_run_{k}.fif"
            out.parent.mkdir(parents=True, exist_ok=True)
            write_fake_fif(out, session_signal(np, 25, n, seed) * 1e-6,
                           sfreq, names, onsets,
                           [MOABB_CLASSES[c] for c in cls], ch_types=types)
            classes.append(cls)
        expected[stem] = np.concatenate(classes).astype(np.int64)
    return expected


def phase_moabb(torch, np, dev, work: Path, env: dict, card: str) -> dict:
    """Phase 8c: ``dataset --src moabb``'s path on the card over the MNE
    double: one subject's two sessions of ``MOABB_RUNS`` runs through
    ``preprocess_moabb_data`` with ``EEGTPU_EMS_METHOD=pallas`` (K2 once a
    run), held to the port's CPU run; and the CLI without the double,
    which must refuse naming MNE."""
    from eegnetreplication_tpu_torch.config import Paths
    from eegnetreplication_tpu_torch.data.io import load_trials
    from eegnetreplication_tpu_torch.data.moabb import preprocess_moabb_data
    from eegnetreplication_tpu_torch.data.preprocess import EMS_METHOD_ENV
    from eegnetreplication_tpu_torch.ops.ems_kernel import ems

    t_leg = time.perf_counter()
    fake = _fake_mne()
    paths = Paths.from_root(work / "card")
    expected = write_moabb_tree(np, fake.write_fake_fif, paths.data_moabb)
    n_runs = 2 * MOABB_RUNS
    write_s = time.perf_counter() - t_leg

    # The CLI a user runs, in a process without the double, beside the
    # in-process legs: this machine has no MNE, so it must refuse.
    bare = Paths.from_root(work / "no_mne")
    bare.data_moabb.parent.mkdir(parents=True)
    bare.data_moabb.symlink_to(paths.data_moabb, target_is_directory=True)
    refusal = subprocess.Popen(
        [sys.executable, "-m", "eegnetreplication_tpu_torch.dataset",
         "--src", "moabb"], cwd=ROOT,
        env=dict(env, EEGTPU_EMS_METHOD="pallas",
                 EEGTPU_DATA_ROOT=str(bare.project_root)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    cpu_paths = Paths.from_root(work / "cpu")
    cpu_paths.data_moabb.parent.mkdir(parents=True)
    cpu_paths.data_moabb.symlink_to(paths.data_moabb,
                                    target_is_directory=True)
    saved = os.environ.get(EMS_METHOD_ENV)
    os.environ[EMS_METHOD_ENV] = "pallas"
    fake.install()    # as ``mne`` in this process only
    log("phase 8c: tests/fake_mne.py stands in for MNE in this process "
        "only (the card's machine has none): the runs are .npz payloads "
        "under .fif names")
    try:
        ems.launches = 0
        t0 = time.perf_counter()
        written = preprocess_moabb_data(paths, device=dev)
        card_s = time.perf_counter() - t0
        launches = ems.launches
        t0 = time.perf_counter()
        preprocess_moabb_data(cpu_paths, device=torch.device("cpu"))
        cpu_s = time.perf_counter() - t0
    finally:
        fake.uninstall()
        if saved is None:
            os.environ.pop(EMS_METHOD_ENV, None)
        else:
            os.environ[EMS_METHOD_ENV] = saved
    check(launches == n_runs,
          f"K2 launched {launches} times for {n_runs} moabb runs")
    check([p.name for p in written] == [f"{s}-preprocessed.npz"
                                        for s in expected],
          f"preprocess_moabb_data wrote {[p.name for p in written]}")

    errs = {"trials": 0.0, "preprocessed": 0.0}
    for stem, classes in expected.items():
        mode = "Train" if stem.endswith("T") else "Eval"
        got = load_trials(paths.data_moabb_processed / mode
                          / f"{stem}-trials.npz")
        ref = load_trials(cpu_paths.data_moabb_processed / mode
                          / f"{stem}-trials.npz")
        check(got.X.shape == (len(classes), 22, 257)
              and got.X.dtype == np.float32
              and bool(np.isfinite(got.X).all()),
              f"moabb {stem}: trials {got.X.shape} {got.X.dtype}")
        check(np.array_equal(got.y, classes) and np.array_equal(ref.y,
                                                                classes),
              f"moabb {stem}: labels differ from the cues")
        check(np.allclose(got.X, ref.X, atol=DATASET_ATOL,
                          rtol=DATASET_RTOL),
              f"moabb {stem}: card trials differ from the CPU's")
        errs["trials"] = max(errs["trials"],
                             float(np.abs(got.X - ref.X).max()))
        with np.load(paths.data_moabb_processed / mode
                     / f"{stem}-preprocessed.npz") as a, \
                np.load(cpu_paths.data_moabb_processed / mode
                        / f"{stem}-preprocessed.npz") as b:
            check(a["data"].shape == b["data"].shape
                  == (22, n_runs // 2 * int(MOABB_RUN_S * 128))
                  and np.array_equal(a["event_pos"], b["event_pos"])
                  and np.array_equal(a["event_typ"], b["event_typ"]),
                  f"moabb {stem}: the session recordings differ in shape "
                  f"or events")
            check(np.allclose(a["data"], b["data"], atol=DATASET_ATOL,
                              rtol=DATASET_RTOL),
                  f"moabb {stem}: the card's session differs from the "
                  f"CPU's")
            errs["preprocessed"] = max(
                errs["preprocessed"],
                float(np.abs(a["data"] - b["data"]).max()))

    # K2 at one run's shape after the 128 Hz resample (not counted above).
    x = torch.from_numpy(session_signal(
        np, 22, int(MOABB_RUN_S * 128), 77)).to(dev)
    k2_ms = device_ms(torch, lambda: ems(x))
    bound_ms, bound_by, _, _ = ems_bound(22, int(MOABB_RUN_S * 128))

    try:
        _, err = refusal.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        refusal.kill()
        raise
    check(refusal.returncode != 0 and "requires MNE" in err,
          f"dataset --src moabb without MNE exited {refusal.returncode}: "
          + err[-2000:])
    wall = time.perf_counter() - t_leg
    log(f"phase 8c on {card}: {n_runs} moabb runs ({MOABB_CUES} cues, "
        f"{MOABB_RUN_S:.0f} s each) -> ({len(expected['A01T'])}, 22, 257) "
        f"trials a session, labels equal to the cues; K2 launches "
        f"{launches}; card {card_s:.2f} s ({card_s / n_runs * 1e3:.0f} ms a "
        f"run), CPU {cpu_s:.2f} s; card vs CPU max abs diff trials "
        f"{errs['trials']:.3e}, sessions {errs['preprocessed']:.3e} (atol "
        f"{DATASET_ATOL}, rtol {DATASET_RTOL}); K2 {k2_ms:.4f} ms a run at "
        f"(22, {int(MOABB_RUN_S * 128)}) (bound {bound_ms:.4f} ms, "
        f"{bound_by}); the CLI without MNE exited {refusal.returncode}: "
        f"{err.strip().splitlines()[-1][:160]!r}; tree written in "
        f"{write_s:.1f} s; leg {wall:.1f} s")
    return {"launches": launches, "runs": n_runs, "wall_s": wall,
            "write_s": write_s, "card_s": card_s, "cpu_s": cpu_s,
            "card_ms_per_run": card_s / n_runs * 1e3,
            "k2_ms_per_run": k2_ms, "k2_bound_ms": bound_ms,
            "k2_bound_by": bound_by, "max_abs_err": errs,
            "refusal_rc": refusal.returncode}


def phase_k2_times(torch, np, dev, raw_session: Path, work: Path):
    from eegnetreplication_tpu_torch.config import (
        BANDPASS_HIGH_HZ,
        BANDPASS_LOW_HZ,
        N_EEG_CHANNELS,
        TARGET_SFREQ,
    )
    from eegnetreplication_tpu_torch.config import Paths
    from eegnetreplication_tpu_torch.data.containers import BCICI2ADataset
    from eegnetreplication_tpu_torch.data.epoching import (
        break_recording_into_epochs,
    )
    from eegnetreplication_tpu_torch.data.gdf import read_gdf
    from eegnetreplication_tpu_torch.data.io import save_trials
    from eegnetreplication_tpu_torch.data.preprocess import ProcessedRecording
    from eegnetreplication_tpu_torch.ops.dsp import (
        fir_bandpass,
        mne_style_bandpass_design,
        resample_fft,
    )
    from eegnetreplication_tpu_torch.ops.ems import (
        exponential_moving_standardize,
    )
    from eegnetreplication_tpu_torch.ops.ems_kernel import (
        ems,
        ems_reference,
        n_tiles,
        seed_stats,
    )

    x = torch.from_numpy(session_signal(np, *SESSION, 42)).to(dev)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    with torch.inference_mode():
        row = {
            "ms": device_ms(torch, lambda: ems(x), flush=flush),
            "plain_ms": device_ms(torch, lambda: ems_reference(x),
                                  flush=flush),
            "associative_ms": device_ms(
                torch, lambda: exponential_moving_standardize(x),
                flush=flush),
            "warm_ms": device_ms(torch, lambda: ems(x)),
            "call_ms": call_ms(torch, lambda: ems(x)),
            # What ems(x) runs besides K2: the seed statistics and the
            # zeroed status words K2 publishes its aggregates in.
            "seed_stats_ms": device_ms(
                torch, lambda: seed_stats(x, 1000), flush=flush),
            "status_zeros_ms": device_ms(torch, lambda: torch.zeros(
                1 + 2 * SESSION[0] * n_tiles(SESSION[1]), dtype=torch.int64,
                device=dev)),
        }
    del flush
    bound, by, nbytes, flops = ems_bound(*SESSION)
    row.update(bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops,
               shape=list(SESSION))
    log(f"K2 at {SESSION}: {row['ms']:.4f} ms cold L2 ({row['warm_ms']:.4f} "
        f"warm, {row['call_ms']:.4f} from an idle stream), ems_reference "
        f"{row['plain_ms']:.3f}, associative {row['associative_ms']:.4f}, "
        f"bound {bound:.5f} ({by}); of ems(x): seed statistics "
        f"{row['seed_stats_ms']:.4f}, status zeros {row['status_zeros_ms']:.4f}")

    # One session's stages on the host clock, each ended by a synchronize.
    kernel = mne_style_bandpass_design(TARGET_SFREQ, BANDPASS_LOW_HZ,
                                       BANDPASS_HIGH_HZ)
    stages = {k: [] for k in ("read_gdf", "to_device", "resample_fft",
                              "fir_bandpass", "ems", "to_host",
                              "save_preprocessed", "epoch_and_save_trials")}
    paths = Paths.from_root(work / "stages")
    bundle = paths.data_processed / "Train" / "A01T-preprocessed.npz"

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        stages[name].append((time.perf_counter() - t0) * 1e3)
        return out

    for _ in range(6):
        rec = timed("read_gdf", lambda: read_gdf(raw_session))
        sig = np.ascontiguousarray(rec.signals[:N_EEG_CHANNELS])
        sig = np.where(np.isfinite(sig), sig, 0.0).astype(np.float32)
        num = int(round(sig.shape[1] * TARGET_SFREQ / rec.sfreq))
        xt = timed("to_device", lambda: torch.from_numpy(sig).to(dev))
        xt = timed("resample_fft", lambda: resample_fft(xt, num))
        xt = timed("fir_bandpass", lambda: fir_bandpass(
            xt, TARGET_SFREQ, BANDPASS_LOW_HZ, BANDPASS_HIGH_HZ,
            kernel=kernel))
        xt = timed("ems", lambda: exponential_moving_standardize(
            xt, method="pallas"))
        out = timed("to_host", lambda: xt.cpu().numpy())
        processed = ProcessedRecording(
            data=out, sfreq=TARGET_SFREQ, labels=[], event_pos=np.round(
                rec.event_pos * (TARGET_SFREQ / rec.sfreq)).astype(np.int64),
            event_typ=rec.event_typ)
        timed("save_preprocessed", lambda: processed.save(bundle))
        timed("epoch_and_save_trials", lambda: save_trials(
            BCICI2ADataset(*break_recording_into_epochs(bundle, "Train",
                                                        paths)),
            bundle.with_name("A01T-trials.npz")))
    session = {k: statistics.median(v[1:]) for k, v in stages.items()}
    log("session stages (host ms, median of 5 after one warmup): "
        + ", ".join(f"{k} {v:.3f}" for k, v in session.items()))
    row["session_stage_ms"] = session
    return row


def separable_subject(np, subject, mode, n=N_TRIALS, c=22, t=257):
    """A session of ``n`` trials at the product width in which each class
    adds its own rhythm (6, 10, 14 or 18 Hz at 128 Hz) through its own
    spatial pattern to unit noise, drawn from the subject and session."""
    from eegnetreplication_tpu_torch.data.containers import BCICI2ADataset

    rng = np.random.RandomState(5000 + 10 * subject + (mode == "Eval"))
    y = rng.randint(0, 4, size=n)
    x = rng.standard_normal((n, c, t)).astype(np.float32)
    patterns = np.random.RandomState(77).standard_normal((4, c))
    tt = np.arange(t) / 128.0
    for k in range(4):
        wave = np.sin(2 * np.pi * (6.0 + 4.0 * k) * tt)
        x[y == k] += (patterns[k][:, None] * wave[None, :]).astype(np.float32)
    return BCICI2ADataset(X=x, y=y.astype(np.int64))


@contextlib.contextmanager
def _deterministic(torch, on: bool):
    """The card's deterministic mode (``utils/device.py``) for the block,
    or the settings before it (cuDNN's autotuner off either way); on again
    after."""
    torch.use_deterministic_algorithms(on)
    torch.backends.cudnn.deterministic = on
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(True)
        torch.backends.cudnn.deterministic = True


def _rates_in_turns(torch, run_epoch, n_folds, epochs, mode) -> dict:
    """fold-epochs/s of ``run_epoch`` under ``mode(True)`` and
    ``mode(False)`` in turns True, False, False, True: one warm-up epoch in
    each, then ``epochs`` timed (host clock ended by a synchronize)."""
    rates = {True: [], False: []}
    for on in (True, False, False, True):
        with mode(on):
            run_epoch()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(epochs):
                run_epoch()
            torch.cuda.synchronize()
            rates[on].append(n_folds * epochs / (time.perf_counter() - t0))
    return {"on": rates[True], "off": rates[False],
            "on_over_off": statistics.mean(rates[True])
            / statistics.mean(rates[False])}


def _determinism_cost(torch, run_epoch, n_folds) -> dict:
    """fold-epochs/s with the card's deterministic mode and without it."""
    row = _rates_in_turns(torch, run_epoch, n_folds, DET_EPOCHS[n_folds],
                          lambda on: _deterministic(torch, on))
    log(f"determinism at {n_folds} folds: {statistics.mean(row['on']):.2f} "
        f"fold-epochs/s on, {statistics.mean(row['off']):.2f} off "
        f"(on/off {row['on_over_off']:.3f}; turns on, off, off, on: "
        f"{', '.join(f'{r:.2f}' for r in row['on'][:1] + row['off'] + row['on'][1:])})")
    return row


def _epoch_times(torch, np, dev, loader, subjects, config):
    """Wall per epoch and fold-epochs/s of the protocol's trainer (host
    clock, TIME_EPOCHS epochs after one warm-up epoch, ended by a
    synchronize), and one epoch's device busy time and idle share under
    ``torch.profiler``."""
    from eegnetreplication_tpu_torch.training.protocols import (
        build_pool,
        within_subject_trainer,
    )
    from eegnetreplication_tpu_torch.utils.profiling import breakdown

    datasets = [loader(s, "Train").concat(loader(s, "Eval"))
                for s in subjects]
    trainer, _, folds = within_subject_trainer(
        *build_pool(datasets), config=config, seed=3, device=dev)
    trainer.run_epoch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIME_EPOCHS):
        trainer.run_epoch()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    profile = breakdown(trainer.run_epoch, n_calls=1, top=10)
    row = {"folds": len(folds), "epochs": TIME_EPOCHS,
           "wall_s": wall, "wall_per_epoch_ms": wall * 1e3 / TIME_EPOCHS,
           "fold_epochs_per_s": len(folds) * TIME_EPOCHS / wall,
           "train_steps": trainer.train_steps,
           "val_steps": trainer.val_steps, "epoch_profile": profile,
           "determinism": _determinism_cost(torch, trainer.run_epoch,
                                            len(folds))}
    row.update(_mfu_fields(row))
    if len(folds) == 8:
        from eegnetreplication_tpu_torch.training.loop import debug_nans

        row["debug_nans"] = _rates_in_turns(torch, trainer.run_epoch, 8,
                                            NAN_EPOCHS, debug_nans)
        log(f"--debugNans at 8 folds: "
            f"{statistics.mean(row['debug_nans']['on']):.2f} fold-epochs/s "
            f"checked, {statistics.mean(row['debug_nans']['off']):.2f} "
            f"unchecked")
    return row


def phase_train(torch, np, dev, work: Path, env: dict, data_root: Path):
    from eegnetreplication_tpu_torch.config import DEFAULT_TRAINING, Paths
    from eegnetreplication_tpu_torch.data.io import load_subject_dataset
    from eegnetreplication_tpu_torch.ops.fused_eegnet import block1_stacked
    from eegnetreplication_tpu_torch.training.loop import n_steps
    from eegnetreplication_tpu_torch.training.protocols import (
        within_subject_training,
    )

    # The CLI a user runs, on the card, over phase 8's processed tree.
    data_paths = Paths.from_root(data_root)
    run_env = dict(env, EEGTPU_DATA_ROOT=str(data_root))
    profiled = _start_profile_leg(work, env, data_root)
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "eegnetreplication_tpu_torch.train",
         "--trainingType", "Within-Subject", "--epochs", str(TRAIN_EPOCHS),
         "--subjects", "1,2"],
        cwd=ROOT, env=run_env, capture_output=True, text=True, timeout=900)
    cli_s = time.perf_counter() - t0
    check(cli.returncode == 0, f"train CLI exited {cli.returncode}:\n"
          + cli.stderr[-4000:])
    report = json.loads((data_paths.reports
                         / "latest_within_subject_report.json").read_text())
    for section, keys in WS_REPORT_KEYS.items():
        got = set(report[section] if section else report)
        check(got == keys, f"report {section or 'top level'} keys {got} != "
              f"the JAX report's {keys}")
    check([e["subject_id"] for e in report["per_subject_results"]] == [1, 2],
          f"report subjects {report['per_subject_results']}")
    for s in (1, 2):
        for ext in ("pth", "npz"):
            f = data_paths.models / f"subject_{s:02d}_best_model.{ext}"
            check(f.is_file(), f"train CLI did not write {f.name}")
    log(f"train CLI: {TRAIN_EPOCHS} epochs of 8 folds in {cli_s:.1f}s, "
        f"report keys equal the JAX report's, 4 model files; average test "
        f"accuracy {report['overall_results']['average_test_accuracy']}%")

    # The trained checkpoint, served by the predict CLI.
    pred = subprocess.run(
        [sys.executable, "-m", "eegnetreplication_tpu_torch.predict",
         "--checkpoint", str(data_paths.models / "subject_01_best_model.npz"),
         "--subject", "1"],
        cwd=ROOT, env=run_env, capture_output=True, text=True, timeout=600)
    check(pred.returncode == 0, f"predict on the trained checkpoint exited "
          f"{pred.returncode}:\n" + pred.stderr[-4000:])
    marker = "block1 kernel launches: "
    check(marker in pred.stderr, "predict did not report K1 launches")
    predict_k1 = int(pred.stderr.split(marker, 1)[1].split()[0])
    check(predict_k1 > 0, "predict on the trained checkpoint launched no K1")
    log(f"predict --checkpoint subject_01_best_model.npz --subject 1: "
        f"{pred.stdout.strip().splitlines()[-1]!r}, K1 launches {predict_k1}")
    cli_events = _journal(np, data_paths.reports / "obs", "ok")
    check(_epochs_journaled(cli_events) == list(range(1, TRAIN_EPOCHS + 1)),
          "the train CLI's journal lacks an epoch event per epoch")
    profile_leg = _finish_profile_leg(*profiled)

    # In process at dropout 0, the card against the CPU from one seed: the
    # main path whose stacked-K1 launches are counted.
    def loader(s, mode):
        return load_subject_dataset(s, mode, data_paths)

    p0 = DEFAULT_TRAINING.replace(dropout_within_subject=0.0)
    kw = dict(config=p0, loader=loader, subjects=(1, 2), seed=0,
              save_models=False, paths=Paths.from_root(work / "p0"))
    block1_stacked.launches = 0
    card = within_subject_training(TRAIN_EPOCHS, device=dev, **kw)
    launches = block1_stacked.launches
    n_sub = N_TRIALS * 2               # Train + Eval sessions of a subject
    val_steps = n_steps(n_sub * 3 // 4 // 5, p0.batch_size, 1)
    test_steps = n_steps(n_sub // 4, p0.batch_size, 1)
    want = TRAIN_EPOCHS * val_steps + test_steps
    check(launches == want,
          f"K1-stacked launched {launches} times in {TRAIN_EPOCHS} epochs; "
          f"want {TRAIN_EPOCHS} x {val_steps} validation + {test_steps} test "
          f"= {want}")
    log(f"in process (card, dropout 0): 8 folds x {TRAIN_EPOCHS} epochs, "
        f"K1-stacked launches {launches} = {TRAIN_EPOCHS} x {val_steps} + "
        f"{test_steps}")
    cpu = within_subject_training(CPU_EPOCHS, device=torch.device("cpu"),
                                  **kw)
    deltas = {}
    for name in ("train_losses", "val_losses"):
        a = getattr(card.folds, name)[:, :CPU_EPOCHS]
        b = getattr(cpu.folds, name)
        check(bool(torch.isfinite(a).all()), f"card {name} not finite")
        deltas[name] = float((a - b).abs().max())
        check(torch.allclose(a, b, atol=TRAIN_ATOL, rtol=TRAIN_RTOL),
              f"card vs CPU {name} over {CPU_EPOCHS} epochs differ by "
              f"{deltas[name]:.3e} (atol {TRAIN_ATOL}, rtol {TRAIN_RTOL})")
    log(f"card vs CPU, {CPU_EPOCHS} epochs of 8 folds: train losses "
        f"{deltas['train_losses']:.3e}, validation losses "
        f"{deltas['val_losses']:.3e} (atol {TRAIN_ATOL}, rtol {TRAIN_RTOL})")

    # The port learns on the card (phase 8's tree carries no class signal).
    def sep_loader(s, mode):
        return separable_subject(np, (s - 1) % 2 + 1, mode)

    learn = within_subject_training(
        LEARN_EPOCHS, loader=sep_loader, subjects=(1, 2), seed=1,
        save_models=False, paths=Paths.from_root(work / "learn"), device=dev)
    check(learn.avg_test_acc > 50.0,
          f"separable pool: test accuracy {learn.avg_test_acc:.2f}% after "
          f"{LEARN_EPOCHS} epochs (chance 25%)")
    log(f"separable pool, {LEARN_EPOCHS} epochs at dropout 0.5: test "
        f"accuracy {learn.avg_test_acc:.2f}% (chance 25%), "
        f"{learn.epoch_throughput:.1f} fold-epochs/s")

    times = {}
    for n_folds, subjects in ((8, (1, 2)), (36, tuple(range(1, 10)))):
        row = _epoch_times(torch, np, dev, sep_loader, subjects,
                           DEFAULT_TRAINING)
        check(row["folds"] == n_folds, f"{row['folds']} folds")
        times[n_folds] = row
        prof = row["epoch_profile"]
        log(f"{n_folds} folds: {row['fold_epochs_per_s']:.1f} fold-epochs/s, "
            f"{row['gflops_per_s']:.2f} GFLOP/s = "
            f"{100 * (row['mfu'] or 0):.4f}% MFU ({row['peak']}), "
            f"{row['wall_per_epoch_ms']:.1f} ms per epoch ({row['train_steps']}"
            f" train steps, {row['val_steps']} validation batches); one epoch "
            f"under the profiler: wall {prof['wall_ms_per_call']:.1f} ms, "
            f"device busy {prof['device_busy_ms_per_call']:.1f} ms, idle "
            f"share {prof['device_idle_share']}")
    return {"cli_s": cli_s, "predict_k1_launches": predict_k1,
            "profile_leg": profile_leg,
            "launches": launches, "val_steps": val_steps,
            "test_steps": test_steps, "card_vs_cpu_max_abs": deltas,
            "card_p0_fold_epochs_per_s": card.epoch_throughput,
            "learn_test_acc": learn.avg_test_acc,
            "learn_fold_epochs_per_s": learn.epoch_throughput,
            "times_by_folds": times}

def _start_profile_leg(work: Path, env: dict, data_root: Path):
    """Start ``train --profileDir`` over one epoch of 8 folds (it runs
    beside the phase's CLI run); :func:`_finish_profile_leg` checks it."""
    paths = _replicated_tree(data_root, work / "profiled", (1, 2))
    trace_dir = work / "profiled" / "trace"
    log_path = work / "profiled.log"
    proc = _spawn(
        [sys.executable, "-m", "eegnetreplication_tpu_torch.train",
         "--subjects", "1,2", "--epochs", "1", "--profileDir",
         str(trace_dir)], dict(env, EEGTPU_DATA_ROOT=str(paths.project_root)),
        log_path)
    return proc, log_path, trace_dir, time.perf_counter()


def _finish_profile_leg(proc, log_path: Path, trace_dir: Path,
                        t0: float) -> dict:
    """The ``torch.profiler`` trace of the ``--profileDir`` run landed in
    its directory and names K1-stacked's kernel (the ``kStacked`` instance
    ``block1_stacked_kernel``, ``csrc/block1_stacked.cu``)."""
    ((rc, err),) = _wait_all({"p": proc}, {"p": log_path}, 900).values()
    wall = time.perf_counter() - t0
    check(rc == 0, f"train --profileDir exited {rc}:\n" + err[-4000:])
    traces = sorted(trace_dir.glob("trace-*.json"))
    check(len(traces) == 1, f"--profileDir wrote {traces}")
    text = traces[0].read_text()
    check("block1_stacked_kernel" in text, "the --profileDir trace does not "
          "name K1-stacked's kernel block1_stacked_kernel")
    mb = traces[0].stat().st_size / 1e6
    log(f"train --profileDir, 8 folds x 1 epoch: {mb:.1f} MB Chrome trace "
        f"naming block1_stacked_kernel ({wall:.1f}s)")
    return {"trace_mb": mb, "wall_s": wall}


def _replicated_tree(src: Path, dst: Path, subjects=tuple(range(1, 10))):
    """A processed tree under ``dst`` whose subject ``s`` is ``src``'s
    subject ``(s - 1) % 2 + 1`` (symlinks to phase 8's two subjects)."""
    from eegnetreplication_tpu_torch.config import Paths
    from eegnetreplication_tpu_torch.data.io import trials_filename

    src_paths, dst_paths = Paths.from_root(src), Paths.from_root(dst)
    for mode in ("Train", "Eval"):
        (dst_paths.data_processed / mode).mkdir(parents=True)
        for s in subjects:
            (dst_paths.data_processed / mode / trials_filename(s, mode)
             ).symlink_to(src_paths.data_processed / mode
                          / trials_filename((s - 1) % 2 + 1, mode))
    return dst_paths


def _check_report(path: Path, keys: dict, what: str) -> dict:
    report = json.loads(path.read_text())
    for section, want in keys.items():
        got = set(report[section] if section else report)
        check(got == want, f"{what} report {section or 'top level'} keys "
              f"{got} != the JAX report's {want}")
    return report


def _journal(np, metrics_dir: Path, status: str) -> list:
    """The one run journal under ``metrics_dir``, read with the port's
    ``read_events``: no event flagged ``_schema_error``, ``run_end`` with
    ``status``; returns its events."""
    from eegnetreplication_tpu_torch.obs import read_events

    runs = sorted(metrics_dir.iterdir())
    check(len(runs) == 1, f"{metrics_dir}: {len(runs)} run journals")
    events = read_events(runs[0] / "events.jsonl")
    bad = [e for e in events if "_schema_error" in e]
    check(not bad, f"{runs[0]}: events flagged by the schema: {bad[:2]}")
    end = events[-1]
    check(end["status"] == status, f"{runs[0]}: run_end status "
          f"{end['status']!r}, want {status!r} ({end.get('error')})")
    return events


def _epochs_journaled(events) -> list:
    return [e["epoch"] for e in events if e["event"] == "epoch"]


def _same_weights(got_dir: Path, want_dir: Path, names, what: str,
                  got_names=None) -> None:
    """Every tensor of each named ``.npz`` model equal bit for bit (the
    ``got`` side read from ``got_names`` where given: an Orbax directory
    reads through the port's Orbax loader)."""
    from eegnetreplication_tpu_torch.training import checkpoint as ckpt_lib
    from eegnetreplication_tpu_torch.training import orbax_io

    for name, got_name in zip(names, got_names or names):
        got_path = got_dir / got_name
        got, _ = (orbax_io.load_orbax_checkpoint(got_path)
                  if got_path.is_dir() else ckpt_lib.load_checkpoint(got_path))
        want, _ = ckpt_lib.load_checkpoint(want_dir / name)
        check(got.keys() == want.keys(), f"{what}: {name} has other keys")
        for key in want:
            diff = float((got[key] - want[key]).abs().max())
            check(bool((got[key] == want[key]).all()),
                  f"{what}: {name} {key} differs by {diff:.3e}; the card's "
                  "runs must repeat bit for bit")


def _spawn(argv, env: dict, log_path: Path, out_path: Path | None = None):
    """Start a CLI from the checkout with its stderr in ``log_path`` (and
    its stdout in ``out_path``, else dropped)."""
    with open(log_path, "w") as stderr, \
            open(out_path or os.devnull, "w") as stdout:
        return subprocess.Popen(argv, cwd=ROOT, stdout=stdout,
                                stderr=stderr, env=env)


def _wait_all(procs: dict, logs: dict, timeout: float) -> dict:
    """Wait for every process, killing what is left at the deadline or on
    an error; ``{name: (exit code, stderr)}``."""
    deadline = time.monotonic() + timeout
    out = {}
    try:
        for name, proc in procs.items():
            rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            out[name] = (rc, logs[name].read_text())
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def _orbax_twin(models: Path, twin: Path, events: list,
                twin_events: list) -> dict:
    """(a): the ``--ckptFormat orbax`` run wrote an Orbax directory and a
    ``.pth`` per subject and no ``.npz``; each directory (equal bit for bit
    to the twin's ``.npz``, checked by the caller) equals the same run's
    ``.pth``, and the run launched K1-stacked as often as its twin."""
    import torch

    from eegnetreplication_tpu_torch.training import orbax_io

    for s in (1, 2):
        stem = f"subject_{s:02d}_best_model"
        check(not (models / f"{stem}.npz").exists(),
              f"the --ckptFormat orbax run wrote {stem}.npz")
        got, meta = orbax_io.load_orbax_checkpoint(models / f"{stem}.orbax")
        pth = torch.load(models / f"{stem}.pth", map_location="cpu",
                         weights_only=True)
        check(meta["model"] == "eegnet" and pth.keys() <= got.keys(),
              f"{stem}.orbax: metadata {meta}, keys beside the .pth's")
        for key, value in pth.items():
            check(torch.equal(got[key], value),
                  f"{stem}.orbax {key} differs from the same run's .pth")
    launches = [e[-1]["kernel_launches"]["block1_stacked"]
                for e in (events, twin_events)]
    check(launches[0] == launches[1] > 0,
          f"K1-stacked launches: --ckptFormat orbax {launches[0]}, its "
          f"twin {launches[1]}")
    return {"dir": str(models / "subject_01_best_model.orbax"),
            "npz_twin": str(twin / "subject_01_best_model.npz"),
            "k1_stacked_launches": launches[0]}


def _resume_drill(np, work: Path, env: dict, data_root: Path) -> dict:
    """Within-subject training at 8 folds through the CLI, each leg with
    its own ``--metricsDir``: two unbroken runs, the second with
    ``--ckptFormat orbax`` (its Orbax directories equal the first run's
    ``.npz`` and its own ``.pth`` bit for bit); SIGTERM once the first
    run snapshot exists (exit 75, a snapshot left, ``run_end`` preempted),
    then ``--resume``; ``train.chunk:after=1`` in 1-epoch chunks (a crash
    after the second chunk), then ``--resume``.  Every leg's weights equal
    the unbroken run's bit for bit, and each journal holds one ``epoch``
    event per epoch it trained.  The legs that do not wait for one another
    run at once (deterministic kernels give the same bits under any load);
    that halves the drill's wall."""
    from eegnetreplication_tpu_torch.training import checkpoint as ckpt_lib

    argv = [sys.executable, "-m", "eegnetreplication_tpu_torch.train",
            "--trainingType", "Within-Subject", "--subjects", "1,2",
            "--epochs", str(RESUME_EPOCHS)]
    every = {"unbroken": RESUME_EVERY, "unbroken2": RESUME_EVERY,
             "stopped": RESUME_EVERY, "crashed": 1}
    roots = {name: _replicated_tree(data_root, work / name, (1, 2))
             for name in every}
    models = [f"subject_{s:02d}_best_model.npz" for s in (1, 2)]

    def start(name, leg, extra=()):
        obs_dir = work / "obs" / name / leg
        cmd = argv + ["--checkpointEvery", str(every[name]), "--metricsDir",
                      str(obs_dir), *extra]
        env_leg = dict(env, EEGTPU_DATA_ROOT=str(roots[name].project_root))
        return _spawn(cmd, env_leg, work / f"{name}-{leg}.log")

    def journal(name, leg, status):
        return _journal(np, work / "obs" / name / leg, status)

    # Round 1: the unbroken runs, the SIGTERM'd run, the crashed run.
    snap = roots["stopped"].models / "within_subject_eegnet.run.npz"
    legs = {"unbroken": (), "unbroken2": ("--ckptFormat", "orbax"),
            "stopped": (), "crashed": ("--chaos", "train.chunk:after=1")}
    procs = {name: start(name, "first", extra) for name, extra in legs.items()}
    logs = {name: work / f"{name}-first.log" for name in legs}
    try:
        deadline = time.monotonic() + RESUME_WAIT_S
        stopped = procs["stopped"]
        while not snap.exists() and stopped.poll() is None \
                and time.monotonic() < deadline:
            time.sleep(0.001)
        signalled = stopped.poll() is None and snap.exists()
        if signalled:
            stopped.send_signal(signal.SIGTERM)
    finally:
        done = _wait_all(procs, logs, RESUME_WAIT_S)
    unbroken = {}
    for name in ("unbroken", "unbroken2"):
        rc, err = done[name]
        check(rc == 0, f"{name} train CLI exited {rc}:\n{err[-4000:]}")
        unbroken[name] = journal(name, "first", "ok")
        check(_epochs_journaled(unbroken[name])
              == list(range(1, RESUME_EPOCHS + 1)),
              f"{name}: not one epoch event per epoch")
    _same_weights(roots["unbroken2"].models, roots["unbroken"].models,
                  models, "two unbroken card runs (--ckptFormat orbax vs "
                  "npz)", got_names=[m.replace(".npz", ".orbax")
                                     for m in models])
    orbax = _orbax_twin(roots["unbroken2"].models,
                        roots["unbroken"].models, unbroken["unbroken2"],
                        unbroken["unbroken"])
    log("resume drill: two unbroken card runs give the same weights bit "
        "for bit; the second wrote Orbax directories (read back by the "
        "port's loader: its twin's .npz and its own .pth bit for bit, "
        f"K1-stacked launches {orbax['k1_stacked_launches']} as its twin's)")

    rc, err = done["stopped"]
    check(signalled, f"the drill missed its window: the run exited {rc} "
          f"before SIGTERM:\n{err[-4000:]}")
    check(rc == 75, f"SIGTERM'd train CLI exited {rc}, want 75:\n"
          + err[-4000:])
    stored = ckpt_lib.read_snapshot_signature(snap)
    check(stored is not None, "no readable run snapshot after exit 75")
    _, epochs_done = ckpt_lib.load_run_snapshot(snap, stored)
    events = journal("stopped", "first", "preempted")
    check(_epochs_journaled(events) == list(range(1, epochs_done + 1)),
          f"the SIGTERM'd leg journaled epochs {_epochs_journaled(events)} "
          f"with the epoch-{epochs_done} snapshot on disk")
    log(f"resume drill: SIGTERM once the first snapshot existed -> exit "
        f"75 with the epoch-{epochs_done} snapshot on disk, run_end "
        f"preempted")

    rc, err = done["crashed"]
    check(rc != 0 and "injected crash after chunk 2" in err,
          f"train.chunk:after=1 exited {rc}:\n{err[-4000:]}")
    events = journal("crashed", "first", "error")
    check([e["site"] for e in events if e["event"] == "fault_injected"]
          == ["train.chunk"] and _epochs_journaled(events) == [1, 2],
          "the crashed leg's journal lacks its firing or its epochs")

    # Round 2: both resumes.
    procs = {name: start(name, "resumed", ("--resume",))
             for name in ("stopped", "crashed")}
    done = _wait_all(procs, {name: work / f"{name}-resumed.log"
                             for name in procs}, RESUME_WAIT_S)
    for name, first_epoch in (("stopped", epochs_done + 1), ("crashed", 3)):
        rc, err = done[name]
        check(rc == 0, f"--resume of the {name} run exited {rc}:\n"
              f"{err[-4000:]}")
        check(f"at epoch {first_epoch - 1}" in err,
              f"the {name} run's --resume did not report resuming at epoch "
              f"{first_epoch - 1}")
        check(_epochs_journaled(journal(name, "resumed", "ok"))
              == list(range(first_epoch, RESUME_EPOCHS + 1)),
              f"the resumed {name} leg did not journal the epochs it trained")
        left = sorted(p.name for p in roots[name].models.glob("*.run.npz*"))
        check(not left, f"--resume left run snapshots behind: {left}")
        _same_weights(roots[name].models, roots["unbroken"].models, models,
                      f"{name}, resumed, vs unbroken")
    log("resume drill: --resume after the SIGTERM and after "
        "train.chunk:after=1 (a crash after chunk 2) completed, cleaned up, "
        "and gave the unbroken run's weights bit for bit")
    return {"epochs_done_at_stop": epochs_done, "bitwise": True,
            "orbax": orbax}


def _chaos_leg(np, work: Path, env: dict, cs_paths) -> dict:
    """``--chaos train.step:if_folds_over=4`` on the cross-subject CLI in
    groups of 8 (the CLI trains every subject's 10 repeats, so 90 folds):
    the first group's out-of-memory error halves the groups to 4
    (``device_fault`` and ``retry`` journaled), the report is written, and
    the weights equal a run started in groups of 4, bit for bit (a halved
    group has the folds, shapes and dropout generator of a group of 4).
    The two runs go at once; each keeps the halving's record of the card's
    group size in a temporary directory of its own."""
    base = [sys.executable, "-m", "eegnetreplication_tpu_torch.train",
            "--trainingType", "Cross-Subject", "--epochs", "1"]
    legs = {"chaos": ["--maxFoldsPerProgram", str(CHAOS_GROUP), "--chaos",
                      f"train.step:if_folds_over={CHAOS_OVER}"],
            "fours": ["--maxFoldsPerProgram", str(CHAOS_OVER)]}
    paths, procs = {}, {}
    t0 = time.perf_counter()
    for name, extra in legs.items():
        paths[name] = _replicated_tree(cs_paths.project_root, work / name)
        (work / name / "tmp").mkdir()
        procs[name] = _spawn(
            base + extra + ["--metricsDir", str(work / name / "obs")],
            dict(env, EEGTPU_DATA_ROOT=str(paths[name].project_root),
                 TMPDIR=str(work / name / "tmp")), work / f"{name}.log")
    done = _wait_all(procs, {n: work / f"{n}.log" for n in legs}, 900)
    wall = time.perf_counter() - t0
    for name, (rc, err) in done.items():
        check(rc == 0, f"chaos leg {name} exited {rc}:\n" + err[-4000:])
    events = _journal(np, work / "chaos" / "obs", "ok")
    faults = [e for e in events if e["event"] == "device_fault"]
    check(len(faults) == 1 and (faults[0]["fold_lo"], faults[0]["fold_hi"],
                                faults[0]["retry_fold_batch"])
          == (0, CHAOS_GROUP, CHAOS_OVER), f"device_fault events {faults}")
    retries = [e for e in events if e["event"] == "retry"]
    check(len(retries) == 1 and retries[0]["classification"]
          == "device_fault", f"retry events {retries}")
    groups = [e["fold_hi"] - e["fold_lo"] for e in events
              if e["event"] == "fold_group"]
    check(groups[0] == CHAOS_GROUP and set(groups[1:]) <= {CHAOS_OVER, 2},
          f"fold groups {groups}")
    _journal(np, work / "fours" / "obs", "ok")
    _check_report(paths["chaos"].reports / "latest_cross_subject_report.json",
                  CS_REPORT_KEYS, "chaos leg")
    _same_weights(paths["chaos"].models, paths["fours"].models,
                  ["cross_subject_best_model.npz"],
                  "halved groups vs groups of 4")
    log(f"chaos leg: train.step:if_folds_over={CHAOS_OVER} halved the 90-fold"
        f" CLI's groups of {CHAOS_GROUP} to {CHAOS_OVER} ({len(groups)} "
        f"fold_group events, one device_fault and one retry), wrote the "
        f"report, and its weights equal a run in groups of {CHAOS_OVER} bit "
        f"for bit ({wall:.1f}s for both runs at once)")
    return {"fold_groups": groups, "wall_s": wall}


def _group_sweep(torch, dev, setup) -> dict:
    """Fold-epochs/s of the whole protocol at each group size: every
    group's trainer takes one warm-up epoch, then CS_SWEEP_EPOCHS timed
    epochs each, group after group (host clock, ended by a synchronize);
    the peak device memory of the size."""
    rows = {}
    for size in CS_SWEEP:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        trainers = [setup.trainer(lo, min(lo + size, setup.n_folds))
                    for lo in range(0, setup.n_folds, size)]
        for trainer in trainers:
            trainer.run_epoch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for trainer in trainers:
            for _ in range(CS_SWEEP_EPOCHS):
                trainer.run_epoch()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rows[size] = {
            "groups": len(trainers), "wall_s": wall,
            "wall_per_epoch_ms": wall * 1e3 / CS_SWEEP_EPOCHS,
            "fold_epochs_per_s": setup.n_folds * CS_SWEEP_EPOCHS / wall,
            "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            "train_steps": trainers[0].train_steps,
            "val_steps": trainers[0].val_steps}
        rows[size].update(_mfu_fields(rows[size]))
        log(f"group size {size} ({len(trainers)} groups): "
            f"{rows[size]['fold_epochs_per_s']:.2f} fold-epochs/s, "
            f"{rows[size]['gflops_per_s']:.2f} GFLOP/s = "
            f"{100 * (rows[size]['mfu'] or 0):.4f}% MFU, "
            f"{rows[size]['wall_per_epoch_ms']:.1f} ms per protocol epoch, "
            f"peak memory {rows[size]['peak_memory_gb']:.2f} GiB")
        del trainers
    return rows


def _trace_size(torch, run_epoch, log_dir: Path) -> float:
    """The Chrome trace of one protocol epoch under ``utils/profiling.py::
    trace`` (what ``--profileDir`` writes), in MB on disk."""
    from eegnetreplication_tpu_torch.utils.profiling import trace

    with trace(log_dir) as path:
        run_epoch()
        torch.cuda.synchronize()
    mb = path.stat().st_size / 1e6
    path.unlink()
    log(f"one 90-fold epoch under --profileDir's trace: {mb:.1f} MB")
    return mb


def _journal_cost(np, work: Path, epoch_ms: float) -> dict:
    """Host time the journal adds to a 90-fold epoch: one chunk's
    ``epoch`` events (fold means of a (90, 100) history already on the
    host, written and flushed) and the chunk's metrics, against the
    epoch's wall from the sweep."""
    from eegnetreplication_tpu_torch import obs
    from eegnetreplication_tpu_torch.training.protocols import (
        _journal_epochs,
    )

    epochs = 100
    history = [np.random.RandomState(i).rand(90, epochs).astype(np.float32)
               for i in range(4)]
    with obs.run(work) as jr:
        t0 = time.perf_counter()
        _journal_epochs(jr, history, 0, epochs, epochs, 90)
        jr.metrics.observe("chunk_wall_s", 1.0)
        jr.metrics.inc("fold_epochs_total", 90.0 * epochs)
        per_epoch_ms = (time.perf_counter() - t0) * 1e3 / epochs
    share = per_epoch_ms / epoch_ms
    log(f"journal at 90 folds: {per_epoch_ms:.4f} ms of host time an epoch, "
        f"{100 * share:.4f}% of a {epoch_ms:.1f} ms epoch")
    return {"ms_per_epoch": per_epoch_ms, "share_of_epoch": share}


def _writer_times(torch, trainer, work: Path) -> dict:
    """The snapshot writer at a 90-fold carry, both modes: two snapshots
    each with an epoch between them; what the write takes and what the
    loop waits (host clock)."""
    from eegnetreplication_tpu_torch.training.async_ckpt import SnapshotWriter

    carry_mb = sum(v.numel() * v.element_size()
                   for v in trainer.carry().values()) / 1e6
    out = {"carry_mb": carry_mb}
    for mode in ("async", "sync"):
        writer = SnapshotWriter(work / f"writer_{mode}.run.npz",
                                {"smoke": mode}, async_=mode == "async")
        submit_s = []
        for i in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            writer.submit(trainer.carry(), epochs_done=trainer.epoch)
            submit_s.append(time.perf_counter() - t0)
            if i == 0:
                trainer.run_epoch()
        writer.close()
        recs = writer.records
        loop_waits = [r["stage_s"] + r["blocked_s"] for r in recs
                      if not r["drain"]]
        out[mode] = {
            "write_ms": [r["write_s"] * 1e3 for r in recs],
            "stage_ms": [r["stage_s"] * 1e3 for r in recs],
            "loop_blocked_ms": [w * 1e3 for w in loop_waits],
            "submit_call_ms": [t * 1e3 for t in submit_s]}
        log(f"snapshot writer ({mode}) at 90 folds ({carry_mb:.2f} MB "
            f"carry): write {', '.join(f'{x:.1f}' for x in out[mode]['write_ms'])}"
            f" ms; the loop waited "
            f"{', '.join(f'{x:.2f}' for x in out[mode]['loop_blocked_ms'])} ms")
    return out


def phase_cross_subject(torch, np, dev, work: Path, env: dict,
                        data_root: Path):
    """Phase 11: cross-subject training over phase 8's two subjects
    replicated to nine, group sizes, the snapshot writer, and the resume
    drill."""
    from eegnetreplication_tpu_torch.config import DEFAULT_TRAINING, Paths
    from eegnetreplication_tpu_torch.data.io import load_subject_dataset
    from eegnetreplication_tpu_torch.ops.fused_eegnet import block1_stacked
    from eegnetreplication_tpu_torch.training.loop import n_steps
    from eegnetreplication_tpu_torch.training.protocols import (
        CS_CARD_FOLD_BATCH,
        cross_subject_setup,
        cross_subject_training,
    )
    from eegnetreplication_tpu_torch.utils.profiling import breakdown

    cs_paths = _replicated_tree(data_root, work / "tree")
    run_env = dict(env, EEGTPU_DATA_ROOT=str(cs_paths.project_root))

    # The CLI a user runs, on the card, 9 subjects x 10 repeats = 90 folds.
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "eegnetreplication_tpu_torch.train",
         "--trainingType", "Cross-Subject", "--epochs", str(CS_EPOCHS)],
        cwd=ROOT, env=run_env, capture_output=True, text=True, timeout=900)
    cli_s = time.perf_counter() - t0
    check(cli.returncode == 0, f"cross-subject train CLI exited "
          f"{cli.returncode}:\n" + cli.stderr[-4000:])
    report = _check_report(
        cs_paths.reports / "latest_cross_subject_report.json",
        CS_REPORT_KEYS, "cross-subject")
    check(report["model_parameters"]["total_folds"] == 90,
          f"report total_folds {report['model_parameters']['total_folds']}")
    for ext in ("pth", "npz"):
        f = cs_paths.models / f"cross_subject_best_model.{ext}"
        check(f.is_file(), f"cross-subject CLI did not write {f.name}")
    log(f"cross-subject train CLI: {CS_EPOCHS} epochs of 90 folds in "
        f"{cli_s:.1f}s, report keys equal the JAX report's, average test "
        f"accuracy {report['overall_results']['average_test_accuracy']}%")
    check(_epochs_journaled(_journal(np, cs_paths.reports / "obs", "ok"))
          == list(range(1, CS_EPOCHS + 1)),
          "the cross-subject CLI's journal lacks an epoch event per epoch")
    pred = subprocess.run(
        [sys.executable, "-m", "eegnetreplication_tpu_torch.predict",
         "--checkpoint", str(cs_paths.models / "cross_subject_best_model.npz"),
         "--subject", "1"],
        cwd=ROOT, env=run_env, capture_output=True, text=True, timeout=600)
    check(pred.returncode == 0, f"predict on the cross-subject checkpoint "
          f"exited {pred.returncode}:\n" + pred.stderr[-4000:])
    marker = "block1 kernel launches: "
    check(marker in pred.stderr, "predict did not report K1 launches")
    predict_k1 = int(pred.stderr.split(marker, 1)[1].split()[0])
    check(predict_k1 > 0, "predict on the cross-subject model launched no K1")
    log(f"predict --checkpoint cross_subject_best_model.npz --subject 1: "
        f"{pred.stdout.strip().splitlines()[-1]!r}, K1 launches {predict_k1}")

    # In process: the main path whose stacked-K1 launches are counted.
    def loader(s, mode):
        return load_subject_dataset(s, mode, cs_paths)

    subjects = tuple(range(1, 10))
    kw = dict(loader=loader, subjects=subjects, save_models=False,
              paths=Paths.from_root(work / "inproc"), device=dev)
    val_steps = n_steps(3 * N_TRIALS, DEFAULT_TRAINING.batch_size, 1)
    test_steps = n_steps(N_TRIALS, DEFAULT_TRAINING.batch_size, 1)
    per_group = CS_EPOCHS * val_steps + test_steps
    launches = {}
    for fold_batch, n_groups in ((0, 1), (CS_GROUP, 90 // CS_GROUP)):
        block1_stacked.launches = 0
        run = cross_subject_training(CS_EPOCHS, fold_batch=fold_batch, **kw)
        launches[fold_batch] = block1_stacked.launches
        want = n_groups * per_group
        check(launches[fold_batch] == want,
              f"K1-stacked launched {launches[fold_batch]} times in "
              f"{n_groups} group(s) of {CS_EPOCHS} epochs; want {n_groups} x "
              f"({CS_EPOCHS} x {val_steps} + {test_steps}) = {want}")
        check(np.isfinite(run.fold_min_val_loss).all()
              and run.fold_test_acc.shape == (90,),
              f"cross-subject run at fold_batch={fold_batch}: non-finite "
              "losses or a wrong fold count")
        log(f"in process: 90 folds x {CS_EPOCHS} epochs in {n_groups} "
            f"group(s), K1-stacked launches {launches[fold_batch]} = "
            f"{n_groups} x ({CS_EPOCHS} x {val_steps} + {test_steps}); "
            f"{run.epoch_throughput:.2f} fold-epochs/s")

    # Groups against one group at dropout 0, 18 folds.
    p0 = DEFAULT_TRAINING.replace(dropout_cross_subject=0.0,
                                  cs_repeats_per_subject=2)
    runs = {fb: cross_subject_training(CS_EPOCHS, config=p0, fold_batch=fb,
                                       **kw) for fb in (0, 6)}
    group_delta = {}
    for name in ("train_losses", "val_losses", "min_val_loss"):
        a, b = (getattr(runs[fb].folds, name) for fb in (6, 0))
        check(bool(torch.isfinite(a).all()), f"grouped {name} not finite")
        group_delta[name] = float((a - b).abs().max())
        check(torch.allclose(a, b, atol=TRAIN_ATOL, rtol=TRAIN_RTOL),
              f"fold_batch=6 vs one group: {name} differ by "
              f"{group_delta[name]:.3e} (atol {TRAIN_ATOL})")
    log(f"18 folds at dropout 0, groups of 6 vs one group: train losses "
        f"{group_delta['train_losses']:.3e}, validation losses "
        f"{group_delta['val_losses']:.3e} (atol {TRAIN_ATOL})")

    # Learning: the separable pool, class patterns shared across subjects.
    def sep_loader(s, mode):
        return separable_subject(np, s, mode)

    learn = cross_subject_training(
        CS_LEARN_EPOCHS, config=DEFAULT_TRAINING.replace(
            cs_repeats_per_subject=2), **dict(kw, loader=sep_loader))
    check(learn.avg_test_acc > 50.0,
          f"separable pool, cross-subject: test accuracy "
          f"{learn.avg_test_acc:.2f}% after {CS_LEARN_EPOCHS} epochs")
    log(f"separable pool, cross-subject, 18 folds x {CS_LEARN_EPOCHS} epochs "
        f"at dropout 0.25: test accuracy {learn.avg_test_acc:.2f}% (chance "
        f"25%)")

    # The resume drill and the chaos leg share nothing: they run at once
    # (since phase 21, for the time limit).
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(1) as pool:
        chaos_leg = pool.submit(_chaos_leg, np, work / "chaos", env,
                                cs_paths)
        try:
            drill = _resume_drill(np, work / "drill", env, data_root)
        finally:
            chaos = chaos_leg.result()

    # Group sizes of the full protocol, then one epoch of the best under
    # the profiler, and the snapshot writer at 90 folds.
    setup, _ = cross_subject_setup(loader, subjects, device=dev)
    sweep = _group_sweep(torch, dev, setup)
    best = max(sweep, key=lambda size: sweep[size]["fold_epochs_per_s"])
    trainers = [setup.trainer(lo, min(lo + best, 90))
                for lo in range(0, 90, best)]
    for trainer in trainers:
        trainer.run_epoch()
    profile = breakdown(lambda: [t.run_epoch() for t in trainers],
                        n_calls=1, top=10)
    log(f"fastest group size {best} (CS_CARD_FOLD_BATCH = "
        f"{CS_CARD_FOLD_BATCH}); one epoch under the profiler: wall "
        f"{profile['wall_ms_per_call']:.1f} ms, device busy "
        f"{profile['device_busy_ms_per_call']:.1f} ms, idle share "
        f"{profile['device_idle_share']}; top kernels: " + "; ".join(
            f"{k['name'][:48]} {k['ms']:.1f} ms"
            for k in profile["top_device_ms_per_call"]))

    def protocol_epoch():
        for t in trainers:
            t.run_epoch()

    trace_mb = _trace_size(torch, protocol_epoch, work / "trace90")
    del trainers
    journal_cost = _journal_cost(np, work / "journal_cost",
                                 sweep[best]["wall_per_epoch_ms"])
    writer = _writer_times(torch, setup.trainer(0, 90), work)
    return {"cli_s": cli_s, "predict_k1_launches": predict_k1,
            "launches_one_group": launches[0],
            "launches_groups": launches[CS_GROUP],
            "val_steps": val_steps, "test_steps": test_steps,
            "group_vs_one_max_abs": group_delta,
            "learn_test_acc": learn.avg_test_acc,
            "learn_fold_epochs_per_s": learn.epoch_throughput,
            "resume_drill": drill, "group_sweep": sweep, "best_group": best,
            "card_fold_batch": CS_CARD_FOLD_BATCH, "epoch_profile": profile,
            "writer": writer, "chaos": chaos,
            "trace_mb_per_epoch": trace_mb, "journal_cost": journal_cost}


# --------------------------------------------------------------------------
# Phase 12: serving beyond one fp32 model
# --------------------------------------------------------------------------

N_TENANTS = 9
ZOO_REQ_TRIALS = 16       # 8 concurrent requests of 16 trials: 128 a batch
ZOO_ROUNDS = 3
RELOAD_CLIENTS = 8


def _save_seeded(torch, path: Path, seed: int) -> Path:
    from eegnetreplication_tpu_torch.training import checkpoint as ckpt_lib

    model = seeded_model(torch, 22, 257, 8, 2, seed, "cpu")
    return ckpt_lib.save_checkpoint(
        path, model.state_dict(),
        metadata={"model": "eegnet", "n_channels": 22, "n_times": 257,
                  "F1": 8, "D": 2})


def _spawn_predict(args: list, env: dict, work: Path, name: str):
    """Start the predict CLI with ``args``, its stdout and stderr in files
    under ``work``."""
    return _spawn([sys.executable, "-m",
                   "eegnetreplication_tpu_torch.predict", *args], env,
                  work / f"{name}.stderr.log", work / f"{name}.stdout.log")


def _check_predict_cli(np, proc, work: Path, name: str, served, y,
                       what: str) -> str:
    """The predict CLI's accuracy line and class counts equal those of the
    served predictions."""
    from eegnetreplication_tpu_torch.serve.engine import CLASS_NAMES

    rc = proc.wait(timeout=600)
    stdout = (work / f"{name}.stdout.log").read_text()
    stderr = (work / f"{name}.stderr.log").read_text()
    check(rc == 0, f"{what} exited {rc}:\n" + stderr[-4000:])
    served = np.asarray(served)
    want_line = f"accuracy: {100.0 * float(np.mean(served == y)):.2f}%"
    got_line = stdout.strip().splitlines()[-1]
    check(got_line == want_line, f"{what} printed {got_line!r}, served "
          f"trials give {want_line!r}")
    counts = np.bincount(served, minlength=4)
    for k, cname in enumerate(CLASS_NAMES):
        check(f"class {k} ({cname}): {counts[k]} trials" in stderr,
              f"{what}: class {k} count differs from the served one")
    return got_line


def _health_counts(url) -> tuple[int, int, int]:
    """(K1 launches, K1-stacked launches, coalesced forwards) of a
    server, read from /healthz."""
    status, health = _get(url + "/healthz")
    check(status == 200, f"/healthz answered {status}")
    k = health["kernel_launches"]
    return k["block1"], k["block1_stacked"], health["batches"]


def _reload_under_load(np, url, body: bytes, headers: dict, reload_body,
                       what: str) -> tuple[dict, list]:
    """POST /reload while RELOAD_CLIENTS clients send ``body`` to
    /predict in a loop; every answer must be 200.  Returns the reload's
    reply and the answers (status, reply) in the order they came."""
    answers, stop = [], threading.Event()
    lock = threading.Lock()

    def client():
        while not stop.is_set():
            got = _post(url + "/predict", body, "application/octet-stream",
                        headers=headers)
            with lock:
                answers.append(got)

    threads = [threading.Thread(target=client)
               for _ in range(RELOAD_CLIENTS)]
    for th in threads:
        th.start()
    try:
        time.sleep(0.3)
        status, reply = _post(url + "/reload",
                              json.dumps(reload_body).encode(),
                              "application/json", timeout=300)
        time.sleep(0.3)
    finally:
        stop.set()
        for th in threads:
            th.join(120)
    check(status == 200, f"{what}: /reload answered {status}: {reply}")
    failed = [a for a in answers if a[0] != 200]
    check(not failed, f"{what}: {len(failed)} of {len(answers)} requests "
          f"failed during the reload: {failed[:2]}")
    return reply, answers


def _stacked_library(torch, x, S, W, A, B, idx):
    """One library composite of K1-stacked on a mixed-tenant batch (never
    used by the port): the per-trial weights gathered, then cuDNN grouped
    convolutions (a group per trial for the mix, per trial and filter for
    the taps), the affine, ELU and the pool."""
    import torch.nn.functional as F

    n, c, t = x.shape
    f2 = S.shape[1]
    i = idx.long()
    mixed = F.conv1d(x.reshape(1, n * c, t), S[i].reshape(n * f2, c, 1),
                     groups=n)
    acc = F.conv1d(F.pad(mixed, (15, 16)), W[i].reshape(n * f2, 1, 32),
                   groups=n * f2)
    out = F.avg_pool1d(F.elu(A[i].reshape(1, -1, 1) * acc
                             + B[i].reshape(1, -1, 1)), 4)
    return out.reshape(n, f2, -1)


def _orbax_reload(np, url: str, orbax: dict, body: bytes) -> dict:
    """(b): ``/reload`` of a running server to phase 11's Orbax directory
    under the reload clients: no request fails, ``/healthz`` names the
    digest of the directory's ``.npz`` twin, and the server's K1 launches
    over the reload are the quant gate's eager chunks (both engines over
    the gate set), the new engine's warm runs (one per bucket) and the
    graph replays."""
    import math

    from eegnetreplication_tpu_torch.serve.engine import (
        default_gate_set,
        load_model_from_checkpoint,
        model_digest,
    )

    want = model_digest(load_model_from_checkpoint(orbax["npz_twin"],
                                                   device="cpu"))
    _, before = _get(url + "/healthz")
    reply, answers = _reload_under_load(
        np, url, body, {}, {"checkpoint": orbax["dir"]},
        "reload to an Orbax directory")
    _, after = _get(url + "/healthz")
    check(reply["model_digest"] == after["model_digest"]
          == after["variables_digest"] == want,
          f"after the reload to {orbax['dir']} /healthz names "
          f"{after['model_digest'][:12]}, its .npz twin is {want[:12]}")
    top = after["buckets"][-1]
    gate = 2 * sum(math.ceil(len(gx) / top)
                   for _, gx in default_gate_set(22, 257)[1])
    replays = after["graph_replays"] - before["graph_replays"]
    k1 = (after["kernel_launches"]["block1"]
          - before["kernel_launches"]["block1"])
    check(k1 == gate + len(after["buckets"]) + replays,
          f"K1 launched {k1} times over the Orbax reload; want the gate's "
          f"{gate} eager chunks + {len(after['buckets'])} warm runs + "
          f"{replays} replays")
    log(f"reload to an Orbax directory under {RELOAD_CLIENTS} clients: "
        f"200, {len(answers)} requests, none failed; digest = its .npz "
        f"twin's; serving {after['precision']}; K1 {k1} = gate {gate} + "
        f"warm {len(after['buckets'])} + replays {replays}")
    return {"requests": len(answers), "k1_launches": k1, "gate": gate,
            "warm": len(after["buckets"]), "replays": replays,
            "precision": after["precision"]}


ORBAX_FIXTURE = ROOT / "tests" / "fixtures" / "orbax_eegnet"
ORBAX_TIMED = 5


def _orbax_fixture(torch, dev, work: Path, card: str,
                   orbax: dict) -> dict:
    """(c): the committed JAX-written Orbax fixture (OCDBT, zstd) loaded in
    this process on the card: its digest is its ``.npz`` twin's, its
    logits at batch 1 and 128 (the engine's fused forward, K1) are the
    twin's bit for bit and within LOGITS_ATOL/RTOL of the plain CPU
    forward.  Then the load of the fixture and of phase 11's directory
    and the write of a save (host clock, median of ORBAX_TIMED)."""
    from eegnetreplication_tpu_torch.serve.engine import (
        InferenceEngine,
        load_model_from_checkpoint,
        model_digest,
    )
    from eegnetreplication_tpu_torch.training import orbax_io

    orb = load_model_from_checkpoint(ORBAX_FIXTURE / "eegnet.orbax",
                                     device=dev)
    npz = load_model_from_checkpoint(ORBAX_FIXTURE / "eegnet.npz",
                                     device=dev)
    plain = load_model_from_checkpoint(ORBAX_FIXTURE / "eegnet.orbax",
                                       device="cpu")
    check(model_digest(orb) == model_digest(npz) == model_digest(plain),
          "the Orbax fixture's digest differs from its .npz twin's")
    engines = [InferenceEngine(m, device=dev) for m in (orb, npz)]
    errs = {}
    for n in (1, 128):
        x = trials(torch, n, 22, 257, 1500 + n)
        with torch.inference_mode():
            got, twin = (e.forward(x.to(dev)).cpu() for e in engines)
            want = plain(x)
        check(torch.equal(got, twin), f"the Orbax fixture's logits at "
              f"batch {n} differ from its .npz twin's on the card")
        errs[n] = float((got - want).abs().max())
        check(torch.allclose(got, want, atol=LOGITS_ATOL, rtol=LOGITS_RTOL),
              f"the Orbax fixture's logits at batch {n} vs the plain CPU "
              f"forward: {errs[n]:.3e}")
    state_dict, meta = orbax_io.load_orbax_checkpoint(orbax["dir"])
    ms = {
        "load_fixture_ms": host_ms(lambda: orbax_io.load_orbax_checkpoint(
            ORBAX_FIXTURE / "eegnet.orbax"), n=ORBAX_TIMED),
        "load_trained_ms": host_ms(lambda: orbax_io.load_orbax_checkpoint(
            orbax["dir"]), n=ORBAX_TIMED),
        "write_ms": host_ms(lambda: orbax_io.save_orbax_checkpoint(
            work / "orbax_write", state_dict, meta), n=ORBAX_TIMED),
    }
    check(orbax_io.load_orbax_checkpoint(work / "orbax_write")[1] == meta,
          "a written Orbax directory does not read back")
    log(f"Orbax fixture on the card: digest = its .npz twin's, logits at "
        f"batch 1 and 128 bit for bit the twin's, vs the plain CPU forward "
        f"{errs[1]:.3e} and {errs[128]:.3e}")
    for what, key in (("load of the JAX-written fixture (OCDBT, zstd)",
                       "load_fixture_ms"),
                      ("load of phase 11's --ckptFormat orbax directory",
                       "load_trained_ms"),
                      ("write of a save (EEGNet, product width)",
                       "write_ms")):
        log(f"orbax {what}: {ms[key]:.3f} ms (host clock, median of "
            f"{ORBAX_TIMED}; {card})")
    return {"logits_max_abs_err": errs, **ms, "card": card}


def phase_serving_zoo(torch, np, dev, work: Path, env: dict, card: str,
                      orbax: dict):
    """Phase 12: the zoo of nine tenants behind ``serve --zoo`` (one
    K1-stacked launch per coalesced chunk, no K1), int8 behind its gate
    (``serve --precision int8``, K1 once per chunk), hot ``/reload`` under
    8 concurrent clients for both, then the int8 server's ``/reload`` to
    phase 11's Orbax directory (``orbax``: :func:`_orbax_twin`'s record),
    the committed Orbax fixture on the card, and their timings."""
    from concurrent.futures import ThreadPoolExecutor

    from eegnetreplication_tpu_torch.data.containers import BCICI2ADataset
    from eegnetreplication_tpu_torch.data.io import save_trials
    from eegnetreplication_tpu_torch.ops import quant
    from eegnetreplication_tpu_torch.ops.fused_eegnet import (
        block1_stacked,
        block1_stacked_reference,
    )
    from eegnetreplication_tpu_torch.predict import predict_trials
    from eegnetreplication_tpu_torch.serve.engine import (
        InferenceEngine,
        load_model_from_checkpoint,
    )
    from eegnetreplication_tpu_torch.serve.zoo import StackedEngine

    zoo_dir = work / "zoo"
    zoo_dir.mkdir(parents=True)
    ids = [f"subject_{z + 1:02d}_best_model" for z in range(N_TENANTS)]
    paths = {mid: _save_seeded(torch, zoo_dir / f"{mid}.npz", 1200 + z)
             for z, mid in enumerate(ids)}
    single = _save_seeded(torch, work / "single.npz", 1300)
    new_tenant = _save_seeded(torch, work / "new_tenant.npz", 1301)
    new_single = _save_seeded(torch, work / "new_single.npz", 1302)
    corrupt = work / "corrupt.npz"
    corrupt.write_bytes(new_single.read_bytes()[:400])
    x = trials(torch, ZOO_REQ_TRIALS * 8, 22, 257, 1400).numpy()
    y = np.random.RandomState(1401).randint(0, 4, len(x)).astype(np.int64)
    trials_path = save_trials(BCICI2ADataset(X=x, y=y),
                              work / "A01E-trials.npz")
    zoo_obs, int8_obs = work / "obs_zoo", work / "obs_int8"

    # Both servers and the predict CLIs start at once.
    cli = {
        "predict_zoo_3": _spawn_predict(
            ["--zoo", str(zoo_dir), "--model", ids[3], "--input",
             str(trials_path)], env, work, "predict_zoo_3"),
        "predict_int8": _spawn_predict(
            ["--checkpoint", str(single), "--precision", "int8", "--input",
             str(trials_path)], env, work, "predict_int8"),
    }
    with ThreadPoolExecutor(2) as pool:
        zoo_f = pool.submit(_start_server, [
            "--zoo", str(zoo_dir), "--metricsDir", str(zoo_obs)], work, env,
            "serve_zoo")
        int8_f = pool.submit(_start_server, [
            "--checkpoint", str(single), "--precision", "int8",
            "--metricsDir", str(int8_obs)], work, env, "serve_int8")
        servers = {}
        for name, fut in (("zoo", zoo_f), ("int8", int8_f)):
            try:
                servers[name] = fut.result()
            except Exception:
                for proc, _, _ in servers.values():
                    proc.kill()
                raise
    result: dict = {}
    try:
        zoo_url, int8_url = servers["zoo"][1], servers["int8"][1]

        # --- the zoo --------------------------------------------------------
        status, health = _get(zoo_url + "/healthz")
        check(health["stacked"] is True and len(health["tenants"]) ==
              N_TENANTS and health["precision"] == "fp32",
              f"zoo /healthz: stacked {health['stacked']}, "
              f"{len(health['tenants'] or [])} tenants, "
              f"{health['precision']}")
        tenant_digest = {e["model"]: e["digest"] for e in health["tenants"]}
        want = {mid: predict_trials(load_model_from_checkpoint(
            paths[mid], device=dev), x, device=dev) for mid in ids}
        k1_0, k1s_0, b_0 = _health_counts(zoo_url)
        n_requests = 0
        for r in range(ZOO_ROUNDS):
            answers: list = [None] * 8

            def send(i, r=r):
                mid = ids[(i + 3 * r) % N_TENANTS]
                chunk = x[ZOO_REQ_TRIALS * i:ZOO_REQ_TRIALS * (i + 1)]
                if i % 2:
                    body = json.dumps({"trials": chunk.tolist(),
                                       "model": mid}).encode()
                    got = _post(zoo_url + "/predict", body,
                                "application/json")
                else:
                    got = _post(zoo_url + "/predict", _npz_body(np, chunk),
                                "application/octet-stream",
                                headers={"X-Model": mid})
                answers[i] = (mid, got)

            threads = [threading.Thread(target=send, args=(i,))
                       for i in range(8)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(120)
            for i, ans in enumerate(answers):
                check(ans is not None and ans[1][0] == 200,
                      f"zoo request {i} of round {r} failed: {ans}")
                mid, (_, reply) = ans
                sl = slice(ZOO_REQ_TRIALS * i, ZOO_REQ_TRIALS * (i + 1))
                check(reply["model"] == mid
                      and reply["model_digest"] == tenant_digest[mid],
                      f"zoo reply names {reply['model']} "
                      f"{reply['model_digest'][:12]}, sent {mid}")
                check(reply["predictions"] == want[mid][sl].tolist(),
                      f"zoo answer for {mid} differs from predict --zoo "
                      f"--model {mid}")
            n_requests += 8
        k1_1, k1s_1, b_1 = _health_counts(zoo_url)
        batches = b_1 - b_0
        check(k1_1 == k1_0, f"the zoo launched K1 {k1_1 - k1_0} times; a "
              "stacked zoo launches K1-stacked only")
        check(k1s_1 - k1s_0 == batches and batches > 0,
              f"K1-stacked launched {k1s_1 - k1s_0} times for {batches} "
              "coalesced chunks; want one each")
        log(f"zoo: {n_requests} mixed-tenant requests of {ZOO_REQ_TRIALS} "
            f"trials (JSON and npz, 8 at once) in {batches} chunks, "
            f"K1-stacked launches {k1s_1 - k1s_0}, K1 0; every answer equal "
            "to predict_trials of its tenant")
        result["zoo"] = {"requests": n_requests, "chunks": batches,
                         "k1_stacked_launches": k1s_1 - k1s_0}
        status, whole = _post(zoo_url + "/predict", _npz_body(np, x),
                              "application/octet-stream",
                              headers={"X-Model": ids[3]})
        check(status == 200
              and whole["predictions"] == want[ids[3]].tolist(),
              f"zoo answer for {ids[3]} (128 trials) differs from predict "
              f"--zoo --model {ids[3]}")
        result["zoo"]["predict_cli"] = _check_predict_cli(
            np, cli.pop("predict_zoo_3"), work, "predict_zoo_3",
            whole["predictions"], y, f"predict --zoo --model {ids[3]}")

        # /predict latency, zoo (mixed tenants) and the int8 single model.
        x128 = trials(torch, 128, 22, 257, 1402).numpy()
        lat = {}
        for name, url, hdr in (("zoo", zoo_url, {"X-Model": ids[5]}),
                               ("int8", int8_url, {})):
            for n, body in ((1, _npz_body(np, x128[:1])),
                            (128, _npz_body(np, x128))):
                lat[f"{name}_{n}"] = host_ms(
                    lambda body=body, url=url, hdr=hdr: _post(
                        url + "/predict", body, "application/octet-stream",
                        headers=hdr), n=N_LATENCY)
        result["predict_latency_ms"] = lat
        log("/predict latency (median, host clock): " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in lat.items()))

        # A corrupt tenant reload: 400, the old digest still serves.
        mid = ids[2]
        status, reply = _post(zoo_url + "/reload", json.dumps(
            {"model": mid, "checkpoint": str(corrupt)}).encode(),
            "application/json", timeout=300)
        check(status == 400, f"zoo /reload of a corrupt file: {status}")
        status, reply = _post(zoo_url + "/predict", _npz_body(np, x[:4]),
                              "application/octet-stream",
                              headers={"X-Model": mid})
        check(status == 200 and reply["model_digest"] == tenant_digest[mid],
              "after a refused reload the tenant's old digest must serve")
        reply, answers = _reload_under_load(
            np, zoo_url, _npz_body(np, x[:8]), {"X-Model": mid},
            {"model": mid, "checkpoint": str(new_tenant)}, "zoo reload")
        check(reply["model_digest"] != tenant_digest[mid]
              and reply["stacked"] is True,
              f"zoo reload reply {reply}")
        new_want = predict_trials(load_model_from_checkpoint(
            new_tenant, device=dev), x[:8], device=dev).tolist()
        old_want = want[mid][:8].tolist()
        # An answer computed across the swap may name either digest (the
        # reply reads it after the forward), but its predictions must be
        # the old model's or the new one's.
        for status, ans in answers:
            check(ans["predictions"] in (old_want, new_want)
                  and ans["model_digest"] in (tenant_digest[mid],
                                              reply["model_digest"]),
                  "an answer during the zoo reload is neither the old "
                  "model's nor the new one's")
        status, after = _post(zoo_url + "/predict", _npz_body(np, x[:8]),
                              "application/octet-stream",
                              headers={"X-Model": mid})
        check(after["model_digest"] == reply["model_digest"]
              and after["predictions"] == new_want,
              "after the zoo reload the tenant serves other answers than "
              "its new checkpoint's predict")
        log(f"zoo reload of {mid} under {RELOAD_CLIENTS} clients: 200, "
            f"{len(answers)} requests, none failed; corrupt file 400 with "
            "the old digest serving")
        result["zoo"]["reload_requests"] = len(answers)

        # --- int8 -----------------------------------------------------------
        status, health = _get(int8_url + "/healthz")
        check(health["precision"] == "int8",
              f"int8 server serves {health['precision']}")
        int8_digest = health["model_digest"]
        model = load_model_from_checkpoint(single, device=dev)
        int8_want = predict_trials(model, x, device=dev, precision="int8")
        k1_0, k1s_0, b_0 = _health_counts(int8_url)
        status, many = _post(int8_url + "/predict", _npz_body(np, x),
                             "application/octet-stream")
        check(status == 200 and many["predictions"] == int8_want.tolist(),
              "int8 served predictions differ from predict --precision "
              "int8's")
        k1_1, k1s_1, b_1 = _health_counts(int8_url)
        check(k1_1 - k1_0 == b_1 - b_0 == 1 and k1s_1 == k1s_0,
              f"int8: K1 {k1_1 - k1_0} launches for {b_1 - b_0} chunks")
        engine = InferenceEngine(model, device=dev, precision="int8")
        cpu = InferenceEngine(load_model_from_checkpoint(single,
                                                         device="cpu"),
                              device="cpu", precision="int8")
        with torch.inference_mode():
            got = engine.forward(torch.from_numpy(x).to(dev)).cpu()
            plain = quant.quantized_eval_forward_reference(
                cpu._qpack, torch.from_numpy(x))
        err = float((got - plain).abs().max())
        check(torch.allclose(got, plain, atol=LOGITS_ATOL, rtol=LOGITS_RTOL)
              and torch.equal(got.argmax(-1), plain.argmax(-1)),
              f"int8 logits on the card vs the plain CPU forward: {err:.3e}")
        log(f"int8: served, predict_trials(precision=int8) equal; K1 once "
            f"per chunk; logits vs the plain CPU int8 forward {err:.3e}")
        result["int8"] = {"logits_max_abs_err": err,
                          "k1_launches": k1_1 - k1_0,
                          "predict_cli": _check_predict_cli(
                              np, cli.pop("predict_int8"), work,
                              "predict_int8", int8_want, y,
                              "predict --precision int8")}
        status, reply = _post(int8_url + "/reload", json.dumps(
            {"checkpoint": str(corrupt)}).encode(), "application/json",
            timeout=300)
        check(status == 400, f"int8 /reload of a corrupt file: {status}")
        status, reply = _post(int8_url + "/predict", _npz_body(np, x[:4]),
                              "application/octet-stream")
        check(reply["model_digest"] == int8_digest,
              "after a refused reload the old digest must serve")
        reply, answers = _reload_under_load(
            np, int8_url, _npz_body(np, x[:8]), {},
            {"checkpoint": str(new_single)}, "int8 reload")
        new_want = predict_trials(load_model_from_checkpoint(
            new_single, device=dev), x[:8], device=dev,
            precision="int8").tolist()
        for status, ans in answers:
            check(ans["predictions"] in (int8_want[:8].tolist(), new_want),
                  "an answer during the int8 reload is neither the old "
                  "model's nor the new one's")
        status, after = _post(int8_url + "/predict", _npz_body(np, x[:8]),
                              "application/octet-stream")
        check(reply["model_digest"] != int8_digest
              and after["model_digest"] == reply["model_digest"]
              and after["predictions"] == new_want,
              "after the reload the server answers other than the new "
              "checkpoint's predict --precision int8")
        log(f"int8 reload under {RELOAD_CLIENTS} clients: 200, "
            f"{len(answers)} requests, none failed; corrupt file 400")
        result["int8"]["reload_requests"] = len(answers)
        result["int8"]["orbax_reload"] = _orbax_reload(
            np, int8_url, orbax, _npz_body(np, x[:8]))

        for name, (proc, _, stderr) in servers.items():
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
            check(rc == 75, f"{name} server exited {rc} after SIGTERM")
    finally:
        for proc, _, stderr in servers.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            stderr.close()
        for proc in cli.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    # The journals: the gates passed, the restacks and swaps are there.
    zoo_events = _journal(np, zoo_obs, "ok")
    gates = [e for e in zoo_events if e["event"] == "stack_gate"]
    restacks = [e["outcome"] for e in zoo_events
                if e["event"] == "zoo_restack"]
    check(gates and all(g["outcome"] == "pass" and g["agreement"] == 1.0
                        for g in gates), f"zoo stack_gate events {gates}")
    check(restacks == ["pass", "pass"], f"zoo_restack outcomes {restacks}")
    int8_events = _journal(np, int8_obs, "ok")
    qgates = [e for e in int8_events if e["event"] == "quant_gate"]
    # The third gate is the Orbax reload's, of a model phase 11 trained:
    # it may pass (int8 serves) or refuse (fp32 serves), as /healthz says.
    check(len(qgates) == 3 and all(
        g["outcome"] == "pass" and g["agreement"] >= 0.99
        for g in qgates[:2]) and (qgates[2]["outcome"] == "pass") == (
            result["int8"]["orbax_reload"]["precision"] == "int8"),
        f"quant_gate events {qgates}")
    for events, what, n in ((zoo_events, "zoo", 1), (int8_events, "int8",
                                                      2)):
        swaps = [e for e in events if e["event"] == "model_swap"]
        check(len(swaps) == n, f"{what}: {len(swaps)} model_swap events")
    result["stack_gate_agreement"] = gates[-1]["agreement"]
    result["quant_gate_agreement"] = [g["agreement"] for g in qgates]
    log(f"journals: stack_gate pass (agreement 1.0 over "
        f"{gates[0]['n_trials']} trials), zoo_restack pass x2, quant_gate "
        f"pass {result['quant_gate_agreement']}, model_swap: zoo 1, int8 "
        "2 (a checkpoint, then an Orbax directory)")
    result["orbax"] = _orbax_fixture(torch, dev, work, card, orbax)

    # Timings: K1-stacked at a 128-trial chunk mixed over nine tenants,
    # beside its plain version, a grouped cuDNN composite and its bound;
    # the engines' infer at buckets 1 and 128.
    models = [load_model_from_checkpoint(paths[mid], device=dev)
              for mid in ids]
    stack = StackedEngine(list(zip(ids, models)), device=dev)
    pack = stack._pack
    S, W, A, B = pack["S"], pack["W"], pack["A"], pack["B"]
    xt = torch.from_numpy(x128).to(dev)
    idx = (torch.arange(128, dtype=torch.int32, device=dev) % N_TENANTS)
    idx = idx[torch.randperm(128, generator=torch.Generator().manual_seed(
        5)).to(dev)].contiguous()
    with torch.inference_mode():
        k1s = block1_stacked(xt, S, W, A, B, idx)
        ref = block1_stacked_reference(xt, S, W, A, B, idx)
        lib = _stacked_library(torch, xt, S, W, A, B, idx)
        check(torch.allclose(k1s, ref, atol=K1_ATOL, rtol=K1_RTOL)
              and torch.allclose(lib, ref, atol=K1_ATOL, rtol=K1_RTOL),
              "K1-stacked or the library composite disagrees at the zoo "
              "chunk")
        row = {
            "max_abs_err": float((k1s - ref).abs().max()),
            "ms": device_ms(torch, lambda: block1_stacked(
                xt, S, W, A, B, idx)),
            "plain_ms": device_ms(torch, lambda: block1_stacked_reference(
                xt, S, W, A, B, idx)),
            "library_ms": device_ms(torch, lambda: _stacked_library(
                torch, xt, S, W, A, B, idx)),
            "call_ms": call_ms(torch, lambda: block1_stacked(
                xt, S, W, A, B, idx)),
        }
    bound, by, nbytes, flops = block1_bound(128, 22, 257, 16,
                                            sets=N_TENANTS)
    row.update(bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops)
    result["k1_stacked_zoo_chunk"] = row
    log(f"K1-stacked at a 128-trial chunk over {N_TENANTS} tenants: "
        f"{row['ms']:.4f} ms (call {row['call_ms']:.4f}), plain "
        f"{row['plain_ms']:.4f}, grouped library {row['library_ms']:.4f}, "
        f"bound {bound:.5f} ({by})")
    infer = {}
    fp32 = InferenceEngine(models[0], device=dev)
    int8 = InferenceEngine(models[0], device=dev, precision="int8")
    for eng in (fp32, int8, stack):
        eng.warmup()
    for n in (1, 128):
        xn = x128[:n]
        tn = np.arange(n) % N_TENANTS
        infer[f"fp32_{n}"] = host_ms(lambda xn=xn: fp32.infer(xn))
        infer[f"int8_{n}"] = host_ms(lambda xn=xn: int8.infer(xn))
        infer[f"zoo_{n}"] = host_ms(lambda xn=xn, tn=tn: stack.infer(xn,
                                                                     tn))
    result["infer_ms"] = infer
    log("engine infer (median, host clock): " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in infer.items()))
    return result


# --------------------------------------------------------------------------
# Phase 13: live streaming sessions
# --------------------------------------------------------------------------

# K2s against its plain version: each operation is rounded on its own in
# both (csrc/ems_stream.cu, ops/ems_kernel.py), so they should agree to the
# bit; 1e-6 leaves room for nothing but that.
K2S_ATOL, K2S_RTOL = 1e-6, 1e-6
K2S_CHANNELS = (1, 22, 64)
K2S_LENGTHS = (1, 2, 25, 64, 250, 1000, 4096, 15000)
K2S_SPLITS = (25, 64, 997, 1)
K2S_SPLIT_ONE = 2000     # chunks of one sample over the first 2000
K2S_SESSION_CHANNELS = (1, 64)   # whole sessions, chunked and one-shot
# K2s's step (csrc/ems_stream.cu::step): 12 operations a sample, and a
# chain of a dependent multiply and add (4 cycles each) from one sample's
# m (and v) to the next.
K2S_OPS_PER_SAMPLE = 12
K2S_CHAIN_CYCLES = 8
# The live streams: one headset per BCI IV 2a subject, 22 channels at
# 250 Hz for 60 s, pushed 100 ms at a time; EEGNet's 257-sample window
# every 64 samples; the stream bench's per-window deadline of four hops.
STREAM_SUBJECTS = 9
STREAM_HZ = 250
STREAM_SAMPLES = 60 * STREAM_HZ
STREAM_CHUNK = 25
STREAM_WINDOW, STREAM_HOP = 257, 64
STREAM_BLOCK = 1000
STREAM_DEADLINE_MS = 1024.0
HOP_MS = 1000.0 * STREAM_HOP / STREAM_HZ        # 256 ms
STREAM_OPEN = {"window": STREAM_WINDOW, "hop": STREAM_HOP,
               "ems_init_block_size": STREAM_BLOCK,
               "deadline_ms": STREAM_DEADLINE_MS}
KILL_SNAPSHOT_EVERY = 20
K2S_TIMED = (STREAM_CHUNK, 250, SESSION[1])


def stream_recording(np, seed, c=22, n=None):
    """A seeded synthetic headset recording ``(c, n)`` f32 in microvolts
    (``n`` defaults to STREAM_SAMPLES): noise, a 10 Hz rhythm and a
    per-channel offset."""
    n = STREAM_SAMPLES if n is None else n
    rng = np.random.RandomState(seed)
    t = np.arange(n) / STREAM_HZ
    x = (8.0 * rng.randn(c, n) + 20.0 * rng.randn(c, 1)
         + 5.0 * np.sin(2 * np.pi * 10.0 * t + rng.rand(c, 1) * 6.28))
    return x.astype(np.float32)


def n_windows(n, window=STREAM_WINDOW, hop=STREAM_HOP) -> int:
    return (n - window) // hop + 1 if n >= window else 0


def k2s_bound(c, n):
    """(bound_ms, bound_by, bytes, ops) of one K2s call: x read once, the
    seed mean and the carry read once, out and the carry written once; 12
    operations a sample."""
    nbytes = 4 * (2 * c * n + 5 * c)
    ops = K2S_OPS_PER_SAMPLE * c * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


def max_sm_clock_ghz() -> float:
    """The card's maximum SM clock from ``nvidia-smi``."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    return float(smi.stdout.strip().splitlines()[0]) / 1e3


def _get_bytes(url, timeout=60.0) -> bytes:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read()


def _k2s_against_plain(torch, np, dev) -> dict:
    """13a: K2s against ``ems_stream_reference`` on the card, the carry
    threaded through 3 chunks, at every (C, n) of the grid."""
    from eegnetreplication_tpu_torch.ops.ems_kernel import (
        ems_stream,
        ems_stream_reference,
        seed_stats,
    )

    worst, bitwise = 0.0, True
    for c in K2S_CHANNELS:
        for n in K2S_LENGTHS:
            x = torch.from_numpy(stream_recording(np, 500 + c, c, 3 * n)
                                 ).to(dev)
            mean0, var0 = seed_stats(x, STREAM_BLOCK)
            mk, vk = torch.zeros_like(mean0), var0.clone()
            mp, vp = torch.zeros_like(mean0), var0.clone()
            for k in range(3):
                chunk = x[:, k * n:(k + 1) * n].contiguous()
                got = ems_stream(chunk, mean0, mk, vk)
                want = ems_stream_reference(chunk, mean0, mp, vp)
                torch.cuda.synchronize()
                for g, w, what in ((got, want, "out"), (mk, mp, "m"),
                                   (vk, vp, "v")):
                    check(torch.allclose(g, w, atol=K2S_ATOL,
                                         rtol=K2S_RTOL),
                          f"K2s {what} at C={c}, n={n}, chunk {k}: max "
                          f"err {float((g - w).abs().max()):.3e}")
                    bitwise = bitwise and bool(torch.equal(g, w))
                worst = max(worst, float((got - want).abs().max()))
    log(f"K2s vs its plain version at C {K2S_CHANNELS} x n {K2S_LENGTHS}, "
        f"3 chunks each: max abs err {worst:.3e} (atol/rtol {K2S_ATOL}); "
        f"bitwise equal: {bitwise}")
    return {"max_abs_err": worst, "bitwise": bitwise}


def _k2s_invariance(torch, np, dev) -> None:
    """13a: any split of a (22, 15000) stream through the carrier gives the
    one-shot ``scan``'s bytes and final carry; three calls repeat."""
    from eegnetreplication_tpu_torch.ops.ems import (
        StreamingEMS,
        exponential_moving_standardize,
        scan_with_carry,
    )
    from eegnetreplication_tpu_torch.ops.ems_kernel import (
        ems_stream,
        seed_stats,
    )

    x = stream_recording(np, 600)
    xt = torch.from_numpy(x).to(dev)
    check(torch.equal(scan_with_carry(xt, init_block_size=STREAM_BLOCK)[0],
                      exponential_moving_standardize(
                          xt, init_block_size=STREAM_BLOCK, method="scan")),
          "scan_with_carry and method='scan' differ on the card")
    for split in K2S_SPLITS + (STREAM_SAMPLES,):
        n = K2S_SPLIT_ONE if split == 1 else STREAM_SAMPLES
        out, m, v = (t.cpu().numpy() for t in scan_with_carry(
            xt[:, :n].contiguous(), init_block_size=STREAM_BLOCK))
        ems = StreamingEMS(22, init_block_size=STREAM_BLOCK, device=dev)
        got = np.concatenate([ems.push(x[:, p:min(p + split, n)])
                              for p in range(0, n, split)], axis=1)
        state = ems.state_arrays()
        check(np.array_equal(got, out) and np.array_equal(state["m"], m)
              and np.array_equal(state["v"], v),
              f"a stream in chunks of {split} differs from the one-shot "
              "scan on the card")
    mean0, var0 = seed_stats(xt, STREAM_BLOCK)
    runs = []
    for _ in range(3):
        mm, vv = torch.zeros_like(mean0), var0.clone()
        runs.append((ems_stream(xt, mean0, mm, vv), mm, vv))
    check(all(torch.equal(a, b) for r in runs[1:]
              for a, b in zip(runs[0], r)),
          "three K2s calls on one input differ")
    # A whole 45-minute session at one channel (one SM) and at 64 (64
    # SMs): the one-shot call against pushes of 25 (one warp each) and
    # chunks of 997 (the ring), out and carry to the bit.
    for c in K2S_SESSION_CHANNELS:
        xs = torch.from_numpy(stream_recording(np, 610 + c, c, SESSION[1])
                              ).to(dev)
        mean0, var0 = seed_stats(xs, STREAM_BLOCK)
        m1, v1 = torch.zeros_like(mean0), var0.clone()
        one = ems_stream(xs, mean0, m1, v1)
        for split in (STREAM_CHUNK, 997):
            mm, vv = torch.zeros_like(mean0), var0.clone()
            parts = [ems_stream(xs[:, p:p + split].contiguous(), mean0, mm,
                                vv) for p in range(0, SESSION[1], split)]
            torch.cuda.synchronize()
            check(torch.equal(torch.cat(parts, dim=1), one)
                  and torch.equal(mm, m1) and torch.equal(vv, v1),
                  f"K2s at ({c}, {SESSION[1]}) in chunks of {split} differs "
                  "from the one-shot call")
    log(f"chunk invariance on the card: chunks of "
        f"{list(K2S_SPLITS + (STREAM_SAMPLES,))} (1 over the first "
        f"{K2S_SPLIT_ONE}) give the one-shot scan's out and carry bit for "
        f"bit; three calls bitwise equal; {SESSION[1]} samples at "
        f"{' and '.join(map(str, K2S_SESSION_CHANNELS))} channels in chunks "
        f"of {STREAM_CHUNK} and 997 give the one-shot call's bits")


def _k2s_times(torch, np, dev) -> dict:
    """13b: K2s at a push, a second's chunk and a 45-minute session; its
    plain version at the first two; K2 and ``associative`` at the last."""
    from eegnetreplication_tpu_torch.ops.ems import (
        exponential_moving_standardize,
    )
    from eegnetreplication_tpu_torch.ops.ems_kernel import (
        ems,
        ems_stream,
        ems_stream_reference,
        seed_stats,
    )

    clock = max_sm_clock_ghz()
    rows = {}
    for n in K2S_TIMED:
        x = torch.from_numpy(stream_recording(np, 700, 22, n)).to(dev)
        mean0, var0 = seed_stats(x, STREAM_BLOCK)
        m, v = torch.zeros_like(mean0), var0.clone()
        bound, by, nbytes, ops = k2s_bound(22, n)
        row = {"ms": device_ms(torch, lambda: ems_stream(x, mean0, m, v)),
               "call_ms": call_ms(torch, lambda: ems_stream(x, mean0, m,
                                                            v)),
               "bound_ms": bound, "bound_by": by, "bytes": nbytes,
               "ops": ops, "chain_ms": n * K2S_CHAIN_CYCLES / clock / 1e6,
               "plain_ms": None}
        if n < STREAM_BLOCK:
            mp, vp = m.clone(), v.clone()
            row["plain_ms"] = device_ms(torch, lambda: ems_stream_reference(
                x, mean0, mp, vp), warmup=2)
        else:
            flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
            row["k2_ms"] = device_ms(torch, lambda: ems(x), flush=flush)
            row["associative_ms"] = device_ms(
                torch, lambda: exponential_moving_standardize(
                    x, method="associative"), flush=flush)
        rows[n] = row
        log(f"K2s at (22, {n}): {row['ms']:.4f} ms (call "
            f"{row['call_ms']:.4f}), plain {row['plain_ms']}, bound "
            f"{bound:.6f} ({by}), serial chain {row['chain_ms']:.4f} at "
            f"{clock:.2f} GHz" + (
                f"; K2 {row['k2_ms']:.4f}, associative "
                f"{row['associative_ms']:.4f}" if "k2_ms" in row else ""))
    # A push's host side: StreamingEMS.push of 25 samples once seeded, and
    # the two copies in it (the chunk to the card, the samples back).
    from eegnetreplication_tpu_torch.ops.ems import StreamingEMS

    rec = stream_recording(np, 701, 22, STREAM_BLOCK + STREAM_CHUNK)
    ems = StreamingEMS(22, init_block_size=STREAM_BLOCK, device=dev)
    ems.push(rec[:, :STREAM_BLOCK])
    chunk = np.ascontiguousarray(rec[:, STREAM_BLOCK:])
    on_card = torch.from_numpy(chunk).to(dev)

    def to_card():
        torch.from_numpy(chunk).to(dev)
        torch.cuda.synchronize()

    push = {"push_ms": host_ms(lambda: ems.push(chunk), n=N_TIMED),
            "to_card_ms": host_ms(to_card, n=N_TIMED),
            "to_host_ms": host_ms(lambda: on_card.cpu().numpy(),
                                  n=N_TIMED)}
    push["copies_share"] = ((push["to_card_ms"] + push["to_host_ms"])
                            / push["push_ms"])
    log(f"StreamingEMS.push of (22, {STREAM_CHUNK}) on the host clock: "
        f"{push['push_ms']:.4f} ms, of which the copies to the card "
        f"{push['to_card_ms']:.4f} and back {push['to_host_ms']:.4f} "
        f"({100 * push['copies_share']:.1f}%)")
    return {"sm_clock_ghz": clock, "by_n": rows, "push": push}


def _stream_client(np, url, sid, x, start=0, open_session=True) -> dict:
    """Open ``sid`` (unless resuming) and push ``x[:, start:]`` in raw f32
    chunks of STREAM_CHUNK as fast as the server answers; the decisions,
    the push round trips and the pushes that ran the EMS carry."""
    if open_session:
        status, opened = _post(url + "/session/open", json.dumps(
            dict(STREAM_OPEN, session=sid)).encode(), "application/json")
        check(status == 200 and not opened["resumed"],
              f"/session/open {sid}: {status} {opened}")
    decisions, push_ms, seeded_pushes = [], [], 0
    for pos in range(start, x.shape[1], STREAM_CHUNK):
        body = np.ascontiguousarray(
            x[:, pos:pos + STREAM_CHUNK]).astype("<f4").tobytes()
        t0 = time.perf_counter()
        status, reply = _post(f"{url}/session/{sid}/samples", body,
                              "application/octet-stream")
        push_ms.append((time.perf_counter() - t0) * 1000.0)
        check(status == 200, f"{sid} push at {pos}: {status} {reply}")
        decisions.extend(reply["decisions"])
        seeded_pushes += bool(reply["seeded"])
    return {"decisions": decisions, "push_ms": push_ms,
            "seeded_pushes": seeded_pushes}


def _offline(torch, np, engine, x, dev):
    """The offline pipeline: one-shot ``scan`` on the card, the same
    windows, the engine; ``(preds, m, v)``."""
    from eegnetreplication_tpu_torch.ops.ems import scan_with_carry

    std, m, v = scan_with_carry(torch.from_numpy(x).to(dev),
                                init_block_size=STREAM_BLOCK)
    std = std.cpu().numpy()
    wins = np.stack([std[:, k * STREAM_HOP:k * STREAM_HOP + STREAM_WINDOW]
                     for k in range(n_windows(x.shape[1]))])
    return engine.infer(wins), m.cpu().numpy(), v.cpu().numpy()


def _exported_carry(np, url, sid):
    from eegnetreplication_tpu_torch.serve.sessions.store import (
        unpack_session,
    )

    got, state = unpack_session(_get_bytes(f"{url}/session/{sid}/export"))
    check(got == sid, f"export of {sid} names {got}")
    return np.asarray(state["ems/m"]), np.asarray(state["ems/v"])


def _ems_launches(url) -> int:
    status, health = _get(url + "/healthz")
    check(status == 200, f"/healthz answered {status}")
    return health["kernel_launches"]["ems_stream"]


def _live_streams(torch, np, dev, url, engine) -> dict:
    """13c: nine concurrent sessions, one per subject, against one server;
    every gate of the live path."""
    from concurrent.futures import ThreadPoolExecutor

    xs = {f"subject{s:02d}": stream_recording(np, 800 + s)
          for s in range(1, STREAM_SUBJECTS + 1)}
    check(_ems_launches(url) == 0, "ems_stream launched before any push")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(STREAM_SUBJECTS) as pool:
        futs = {sid: pool.submit(_stream_client, np, url, sid, x)
                for sid, x in xs.items()}
        runs = {sid: f.result() for sid, f in futs.items()}
    wall = time.perf_counter() - t0
    launches = _ems_launches(url)
    want_launches = sum(r["seeded_pushes"] for r in runs.values())
    n_pushes = sum(len(r["push_ms"]) for r in runs.values())
    check(launches == want_launches, f"ems_stream launched {launches} "
          f"times; {want_launches} pushes ran the carry")
    lat = []
    for sid, x in xs.items():
        decs = runs[sid]["decisions"]
        n_win = n_windows(x.shape[1])
        check(len(decs) == n_win and [d["window"] for d in decs]
              == list(range(n_win)), f"{sid}: {len(decs)} decisions in "
              f"order, want {n_win}")
        check(all(d["status"] == "ok" for d in decs),
              f"{sid}: statuses {sorted({d['status'] for d in decs})}")
        preds, m, v = _offline(torch, np, engine, x, dev)
        got = np.asarray([d["pred"] for d in decs])
        check(np.array_equal(got, preds), f"{sid}: "
              f"{int((got != preds).sum())} decisions differ from the "
              "offline pipeline")
        em, ev = _exported_carry(np, url, sid)
        check(np.array_equal(em, m) and np.array_equal(ev, v),
              f"{sid}: the exported carry differs from the one-shot "
              "kernel's final carry")
        status, closed = _post(f"{url}/session/{sid}/close", b"{}",
                               "application/json")
        check(status == 200 and closed["preds"] == got.tolist(),
              f"{sid}: close answered {status} with other predictions")
        lat.extend(d["latency_ms"] for d in decs)
    lat = np.asarray(lat)
    push = np.concatenate([r["push_ms"] for r in runs.values()])
    row = {
        "sessions": len(xs), "windows": int(lat.size), "pushes": n_pushes,
        "ems_stream_launches": launches, "wall_s": wall,
        "window_ms": {f"p{q}": float(np.percentile(lat, q))
                      for q in (50, 95, 99)},
        "push_ms": {f"p{q}": float(np.percentile(push, q))
                    for q in (50, 95, 99)},
        "windows_per_s": lat.size / wall, "pushes_per_s": n_pushes / wall,
    }
    check(row["window_ms"]["p95"] < HOP_MS, f"p95 window latency "
          f"{row['window_ms']['p95']:.1f} ms is not under the {HOP_MS:.0f} "
          "ms hop interval")
    log(f"live streams: {len(xs)} sessions x {n_windows(STREAM_SAMPLES)} "
        f"windows, all ok and equal to the offline pipeline, carries "
        f"bitwise; {launches} ems_stream launches = pushes from the seed "
        f"on; window latency p50/p95/p99 "
        + "/".join(f"{row['window_ms'][k]:.2f}" for k in ("p50", "p95",
                                                          "p99"))
        + f" ms; push p50/p95 {row['push_ms']['p50']:.2f}/"
        f"{row['push_ms']['p95']:.2f} ms; {row['windows_per_s']:.1f} "
        f"windows/s, {row['pushes_per_s']:.1f} pushes/s over {wall:.2f} s")
    return row


def _kill_and_resume(torch, np, dev, url, proc, args, work, env,
                     engine) -> dict:
    """13d: SIGKILL mid-stream, relaunch with --resume, replay from the
    acked cursor; then a SIGTERM leg on the relaunched server."""
    x = stream_recording(np, 900)
    total = n_windows(STREAM_SAMPLES)
    sid = "killed"
    status, _ = _post(url + "/session/open", json.dumps(
        dict(STREAM_OPEN, session=sid)).encode(), "application/json")
    check(status == 200, f"/session/open {sid}: {status}")
    told, pos = [], 0
    while len(told) < total // 2:
        body = np.ascontiguousarray(
            x[:, pos:pos + STREAM_CHUNK]).astype("<f4").tobytes()
        status, reply = _post(f"{url}/session/{sid}/samples", body,
                              "application/octet-stream")
        check(status == 200, f"{sid} push at {pos}: {status}")
        told.extend(reply["decisions"])
        pos += STREAM_CHUNK
    proc.kill()
    proc.wait(timeout=60)
    proc2, url2, stderr2 = _start_server(args + ["--resume"], work, env,
                                         "serve_resumed")
    try:
        status, state = _get(f"{url2}/session/{sid}/state")
        acked, restored = state["acked"], state["windows"]
        check(status == 200 and 0 < acked <= pos
              and 0 < restored <= len(told),
              f"restored cursor {acked} / {restored} windows past what was "
              f"pushed ({pos}) or told ({len(told)})")
        status, reopened = _post(url2 + "/session/open", json.dumps(
            dict(STREAM_OPEN, session=sid)).encode(), "application/json")
        check(reopened["resumed"] and reopened["acked"] == acked,
              f"re-open after --resume: {reopened}")
        replay = _stream_client(np, url2, sid, x, start=acked,
                                open_session=False)
        again = {d["window"]: d for d in replay["decisions"]}
        redecided = list(range(restored, len(told)))
        check(all(again[w]["pred"] == told[w]["pred"] for w in redecided),
              "a window decided again after the resume differs from what "
              "the client was told before the kill")
        status, closed = _post(f"{url2}/session/{sid}/close", b"{}",
                               "application/json")
        preds, _, _ = _offline(torch, np, engine, x, dev)
        check(status == 200 and closed["preds"] == preds.tolist(),
              "the resumed decision stream differs from the uninterrupted "
              "one")
        # SIGTERM: the drain snapshots the open session and exits 75.
        term = _stream_client(np, url2, "drained", x[:, :2000])
        launches = _ems_launches(url2)
        check(launches == replay["seeded_pushes"] + term["seeded_pushes"],
              f"resumed server: {launches} ems_stream launches for "
              f"{replay['seeded_pushes'] + term['seeded_pushes']} pushes")
        proc2.send_signal(signal.SIGTERM)
        rc = proc2.wait(timeout=120)
        check(rc == 75, f"resumed server exited {rc} after SIGTERM")
    finally:
        if proc2.poll() is None:
            proc2.kill()
            proc2.wait()
        stderr2.close()
    snap = Path(args[args.index("--sessionsDir") + 1]) / "sessions.npz"
    with np.load(snap) as npz:
        meta = json.loads(bytes(npz["__meta__"]).decode())
        check(meta["sessions"] == ["drained"]
              and "s/drained/ems/m" in npz.files,
              f"the SIGTERM drain left {meta['sessions']} in {snap}")
    row = {"pushed_before_kill": pos, "told_before_kill": len(told),
           "acked": acked, "restored_windows": restored,
           "redecided": len(redecided),
           "replay_pushes": len(replay["push_ms"]),
           "drained_sessions": meta["sessions"],
           "ems_stream_launches": launches}
    log(f"kill and resume: SIGKILL after {len(told)} of {total} windows "
        f"({pos} samples); --resume restored acked {acked}, {restored} "
        f"windows; {len(redecided)} windows decided again as told; the "
        f"stream equals the uninterrupted one; SIGTERM -> 75 with "
        f"{meta['sessions']} in {snap.name}")
    return row


def _zoo_session(torch, np, dev, url, zoo_dir) -> dict:
    """13e: one session against a ``--zoo`` server classifies under the
    default tenant."""
    from eegnetreplication_tpu_torch.serve.engine import (
        InferenceEngine,
        load_model_from_checkpoint,
    )

    status, health = _get(url + "/healthz")
    check(status == 200 and health["stacked"] is True,
          f"zoo /healthz: {status}, stacked {health.get('stacked')}")
    default = health["zoo"]["default"]
    engine = InferenceEngine(load_model_from_checkpoint(
        zoo_dir / f"{default}.npz", device=dev), device=dev)
    x = stream_recording(np, 950)
    run = _stream_client(np, url, "zoo", x)
    preds, _, _ = _offline(torch, np, engine, x, dev)
    got = [d["pred"] for d in run["decisions"]]
    check(all(d["status"] == "ok" for d in run["decisions"])
          and got == preds.tolist(), "the zoo session differs from the "
          f"offline pipeline through the default tenant {default}")
    launches = _ems_launches(url)
    check(launches == run["seeded_pushes"], f"zoo server: {launches} "
          f"ems_stream launches for {run['seeded_pushes']} pushes")
    log(f"zoo session: {len(got)} windows under the default tenant "
        f"{default}, equal to its engine's offline pipeline")
    return {"default": default, "windows": len(got),
            "ems_stream_launches": launches}


def phase_streams(torch, np, dev, work: Path, env: dict) -> dict:
    """Phase 13: K2s against its plain version and chunk invariance on the
    card, live sessions through ``serve`` (nine at once, kill -> --resume,
    SIGTERM, a zoo), and the times of K2s."""
    from concurrent.futures import ThreadPoolExecutor

    from eegnetreplication_tpu_torch.serve.engine import (
        InferenceEngine,
        load_model_from_checkpoint,
    )

    t_phase = time.perf_counter()
    ckpt = _save_seeded(torch, work / "stream.npz", 1500)
    zoo_dir = work / "zoo"
    zoo_dir.mkdir(parents=True)
    for z in range(N_TENANTS):
        _save_seeded(torch, zoo_dir / f"subject_{z + 1:02d}_best_model.npz",
                     1600 + z)

    def server_args(name, *extra):
        return [*extra, "--sessionsDir", str(work / f"sess_{name}"),
                "--metricsDir", str(work / f"obs_{name}")]

    kill_flags = ("--sessionSnapshotEvery", str(KILL_SNAPSHOT_EVERY))
    args = {"live": server_args("live", "--checkpoint", str(ckpt)),
            "kill": server_args("kill", "--checkpoint", str(ckpt),
                                *kill_flags),
            "zoo": server_args("zoo", "--zoo", str(zoo_dir))}
    servers: dict = {}
    errors = []
    try:
        # The servers start while K2s is checked in this process.
        with ThreadPoolExecutor(len(args)) as pool:
            futs = {name: pool.submit(_start_server, a, work, env,
                                      f"serve_{name}")
                    for name, a in args.items()}
            try:
                result: dict = {"k2s": _k2s_against_plain(torch, np, dev)}
                _k2s_invariance(torch, np, dev)
            finally:
                for name, fut in futs.items():
                    try:
                        servers[name] = fut.result()
                    except Exception as exc:  # noqa: BLE001 — raised below
                        errors.append(exc)
        if errors:
            raise errors[0]
        engine = InferenceEngine(load_model_from_checkpoint(
            ckpt, device=dev), device=dev)
        result["live"] = _live_streams(torch, np, dev, servers["live"][1],
                                       engine)
        # The relaunch keeps the killed server's sessions and journals
        # apart from it.
        proc, url, stderr = servers.pop("kill")
        stderr.close()
        resumed_args = [*args["kill"][:-2], "--metricsDir",
                        str(work / "obs_resumed")]
        result["kill_resume"] = _kill_and_resume(
            torch, np, dev, url, proc, resumed_args, work, env, engine)
        result["zoo"] = _zoo_session(torch, np, dev, servers["zoo"][1],
                                     zoo_dir)
        for name, (proc, _, _) in servers.items():
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
            check(rc == 75, f"{name} server exited {rc} after SIGTERM")
    finally:
        for proc, _, stderr in servers.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            stderr.close()

    events = _journal(np, work / "obs_live", "ok")
    kinds = [e["event"] for e in events]
    for kind in ("session_start", "session_window", "session_snapshot",
                 "session_end"):
        check(kind in kinds, f"the live server's journal has no {kind}")
    check(kinds.count("session_window") == result["live"]["windows"],
          f"{kinds.count('session_window')} session_window events for "
          f"{result['live']['windows']} windows")
    end = [e for e in events if e["event"] == "serve_end"][-1]
    check(end["sessions"] == STREAM_SUBJECTS
          and end["session_windows"] == result["live"]["windows"],
          f"serve_end counts sessions {end['sessions']}, windows "
          f"{end['session_windows']}")
    resumed = _journal(np, work / "obs_resumed", "ok")
    check(any(e["event"] == "session_resume" for e in resumed),
          "the resumed server journaled no session_resume")
    result["journal"] = {"events": len(events),
                         "session_snapshots": end["session_snapshots"]}
    log(f"journals read back clean: {len(events)} events, "
        f"{end['session_snapshots']} session snapshots, run_end ok; the "
        "resumed server's session_resume")
    result["launches"] = (result["live"]["ems_stream_launches"]
                          + result["kill_resume"]["ems_stream_launches"]
                          + result["zoo"]["ems_stream_launches"])
    result["times"] = _k2s_times(torch, np, dev)
    result["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 13 in {result['wall_s']:.1f} s")
    return result


# --------------------------------------------------------------------------
# Phase 14: the serving control plane
# --------------------------------------------------------------------------

TUNE_CLIENTS = 8
TUNE_REQ_TRIALS = 40      # the steady 40-trial requests the tuner targets
TUNE_PERIOD_S = 0.1       # one request a client every 100 ms, staggered
TUNE_MAX_S = 30.0         # load until a retune has served, at most this
TUNE_AFTER_S = 3.0        # load kept on after the first applied retune
N_BREAKDOWN = 20          # calls under the profiler per breakdown


def _breakdown_row(torch, fn) -> dict:
    """``infer``'s host ms (median, no profiler) and, under the profiler,
    the device's idle share and device ops per call."""
    from eegnetreplication_tpu_torch.utils import profiling

    row = {"host_ms": host_ms(fn)}
    prof = profiling.breakdown(fn, N_BREAKDOWN)
    if prof["device_idle_share"] is None:
        # A window in which the profiler delivered no device activity at
        # all (seen once on the card, between two windows that had it):
        # measure it again rather than report a busy time of zero.
        log("the profiler saw no device activity in a window; again")
        prof = profiling.breakdown(fn, N_BREAKDOWN)
    row.update({k: prof[k] for k in (
        "wall_ms_per_call", "device_busy_ms_per_call", "device_idle_share",
        "device_ops_per_call")})
    return row


def _graph_phase(torch, np, dev) -> dict:
    """Every bucket of the fp32, int8 and nine-tenant engines: the
    replay's logits equal the eager forward's bit for bit and the plain CPU
    forward's to LOGITS_ATOL/RTOL; capture wall and pool bytes; ``infer``
    eager against graphed."""
    from eegnetreplication_tpu_torch.ops import quant
    from eegnetreplication_tpu_torch.ops import stacked as ops_stacked
    from eegnetreplication_tpu_torch.serve.engine import InferenceEngine
    from eegnetreplication_tpu_torch.serve.zoo import StackedEngine

    gpu = seeded_model(torch, 22, 257, 8, 2, 1500, dev)
    cpu = seeded_model(torch, 22, 257, 8, 2, 1500, "cpu")
    ids = [f"s{z}" for z in range(N_TENANTS)]
    gpu_zoo = [seeded_model(torch, 22, 257, 8, 2, 1510 + z, dev)
               for z in range(N_TENANTS)]
    cpu_zoo = [seeded_model(torch, 22, 257, 8, 2, 1510 + z, "cpu")
               for z in range(N_TENANTS)]
    cpu_int8 = InferenceEngine(cpu, device="cpu", precision="int8")
    cpu_stack = StackedEngine(list(zip(ids, cpu_zoo)), device="cpu")
    kinds = {
        "fp32": (InferenceEngine(gpu, BUCKETS, device=dev),
                 InferenceEngine(gpu, BUCKETS, device=dev),
                 lambda x, idx: cpu.eval()(x)),
        "int8": (InferenceEngine(gpu, BUCKETS, device=dev,
                                 precision="int8"),
                 InferenceEngine(gpu, BUCKETS, device=dev,
                                 precision="int8"),
                 lambda x, idx: quant.quantized_eval_forward_reference(
                     cpu_int8._qpack, x)),
        "zoo": (StackedEngine(list(zip(ids, gpu_zoo)), BUCKETS, device=dev),
                StackedEngine(list(zip(ids, gpu_zoo)), BUCKETS, device=dev),
                lambda x, idx: ops_stacked.stacked_eval_forward_reference(
                    cpu_stack._pack, x, idx)),
    }
    out: dict = {}
    for kind, (graphed, eager, plain) in kinds.items():
        t0 = time.perf_counter()
        graphed.warmup()            # the captures; `eager` is never warmed
        warm_s = time.perf_counter() - t0
        stats = graphed.graph_stats()
        check(sorted(stats) == list(BUCKETS),
              f"{kind}: graphs for buckets {sorted(stats)}")
        worst, rows = 0.0, {}
        for b in BUCKETS:
            x = trials(torch, b, 22, 257, 1600 + b)
            idx = torch.from_numpy(np.random.RandomState(b).randint(
                0, N_TENANTS, b).astype(np.int32))
            args = (x.to(dev),) if kind != "zoo" else (x.to(dev),
                                                       idx.to(dev))
            with torch.inference_mode():
                want = eager.forward(*args).cpu()
                ref = plain(x, idx)
            got = graphed.graph_logits(*args).cpu()
            check(torch.equal(got, want), f"{kind} B={b}: the replay's "
                  "logits differ from the eager forward's")
            err = float((got - ref).abs().max())
            check(torch.allclose(got, ref, atol=LOGITS_ATOL,
                                 rtol=LOGITS_RTOL),
                  f"{kind} B={b}: replay vs the plain CPU forward {err:.3e}")
            worst = max(worst, err)
            host = (x.numpy(),) if kind != "zoo" else (x.numpy(),
                                                       idx.numpy())
            check((graphed.infer(*host) == want.argmax(-1).numpy()).all(),
                  f"{kind} B={b}: graphed infer differs from the eager "
                  "argmax")
            if kind == "fp32" or b in (1, 128):
                rows[b] = {
                    "eager": _breakdown_row(torch,
                                            lambda: eager.infer(*host)),
                    "graphed": _breakdown_row(torch,
                                              lambda: graphed.infer(*host))}
                e, g = rows[b]["eager"], rows[b]["graphed"]
                log(f"{kind} B={b}: infer {e['host_ms']:.3f} -> "
                    f"{g['host_ms']:.3f} ms, device idle "
                    f"{e['device_idle_share']} -> "
                    f"{g['device_idle_share']}, device ops "
                    f"{e['device_ops_per_call']:.1f} -> "
                    f"{g['device_ops_per_call']:.1f} per call (eager -> "
                    "graphed)")
        out[kind] = {"max_abs_err_vs_plain": worst, "warmup_s": warm_s,
                     "graphs": {str(b): s for b, s in stats.items()},
                     "infer": {str(b): r for b, r in rows.items()}}
        log(f"{kind}: replay bitwise the eager forward at buckets "
            f"{list(BUCKETS)}, {worst:.3e} from the plain CPU forward; "
            "capture ms / pool MiB per bucket " + ", ".join(
                f"{b}: {s['capture_s'] * 1e3:.2f}/"
                f"{s['pool_bytes'] / 2**20:.1f}" for b, s in stats.items()))
    return out


def _get_text(url, headers=None, timeout=30.0) -> str:
    req = urllib.request.Request(url, headers=headers or {})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.read().decode()


def _prom_value(text: str, series: str) -> float:
    for line in text.splitlines():
        if line.startswith(series + " "):
            return float(line.rsplit(" ", 1)[1])
    raise SmokeFailure(f"/metrics text has no series {series}")


def _tuned_server(torch, np, dev, work: Path, env: dict) -> dict:
    """``serve --tuneEveryS 1`` under TUNE_CLIENTS clients of steady
    TUNE_REQ_TRIALS-trial requests: a retune applied under load, no
    request dropped, every answer the predict path's, K1's launches the
    warm runs plus the replays; ``/metrics`` against ``/healthz``;
    ``/profile``'s trace names ``block1_kernel``."""
    from eegnetreplication_tpu_torch.data.containers import BCICI2ADataset
    from eegnetreplication_tpu_torch.data.io import save_trials
    from eegnetreplication_tpu_torch.obs.metrics import quantile_from_buckets
    from eegnetreplication_tpu_torch.predict import predict_trials
    from eegnetreplication_tpu_torch.serve.engine import (
        load_model_from_checkpoint,
    )

    ckpt = _save_seeded(torch, work / "tuned.npz", 1520)
    x = trials(torch, TUNE_CLIENTS * TUNE_REQ_TRIALS, 22, 257, 1521).numpy()
    y = np.random.RandomState(1522).randint(0, 4, len(x)).astype(np.int64)
    trials_path = save_trials(BCICI2ADataset(X=x, y=y),
                              work / "A01E-trials.npz")
    cli = _spawn_predict(["--checkpoint", str(ckpt), "--input",
                          str(trials_path)], env, work, "predict_tuned")
    want = predict_trials(load_model_from_checkpoint(ckpt, device=dev), x,
                          device=dev)
    obs = work / "obs_tuned"
    proc, url, stderr = _start_server(
        ["--checkpoint", str(ckpt), "--tuneEveryS", "1", "--metricsDir",
         str(obs)], work, env, "serve_tuned")
    result: dict = {}
    try:
        bodies = [_npz_body(np, x[i * TUNE_REQ_TRIALS:
                                  (i + 1) * TUNE_REQ_TRIALS])
                  for i in range(TUNE_CLIENTS)]
        stop = threading.Event()
        answers: list = [[] for _ in range(TUNE_CLIENTS)]
        host, port = url.split("//", 1)[1].rsplit(":", 1)

        def client(i):
            # One kept-alive connection a client, as a streaming client
            # holds it, and one request every TUNE_PERIOD_S: the steady
            # traffic that pads 40-trial forwards up to 128.
            conn = http.client.HTTPConnection(host, int(port), timeout=60)
            due = time.monotonic() + i * TUNE_PERIOD_S / TUNE_CLIENTS
            try:
                while not stop.is_set():
                    time.sleep(max(0.0, due - time.monotonic()))
                    due += TUNE_PERIOD_S
                    try:
                        conn.request("POST", "/predict", bodies[i], {
                            "Content-Type": "application/octet-stream"})
                        resp = conn.getresponse()
                        answers[i].append((resp.status,
                                           json.loads(resp.read())))
                    except Exception as exc:  # noqa: BLE001 — checked
                        answers[i].append((None, repr(exc)))
                        conn.close()
            finally:
                conn.close()

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(TUNE_CLIENTS)]
        batches_0 = _get(url + "/healthz")[1]["batches"]
        t0 = time.monotonic()
        for th in threads:
            th.start()
        first_retune = None
        try:
            while time.monotonic() - t0 < TUNE_MAX_S:
                time.sleep(0.25)
                # A retune that moved the ladder: its graphs were captured
                # while the clients' forwards replayed the old ones.
                ladder = _get(url + "/healthz")[1]["buckets"]
                if ladder != list(BUCKETS) and first_retune is None:
                    first_retune = time.monotonic()
                if first_retune and time.monotonic() - first_retune \
                        >= TUNE_AFTER_S:
                    break
        finally:
            stop.set()
            for th in threads:
                th.join(120)
        load_s = time.monotonic() - t0
        rate = (_get(url + "/healthz")[1]["batches"] - batches_0) / load_s
        stderr.flush()
        server_log = [line for line in (
            work / "serve_tuned.stderr.log").read_text().splitlines()
            if "log_message" not in line]
        check(first_retune is not None, "no ladder_retune moved the "
              f"ladder in {load_s:.0f} s of {TUNE_CLIENTS} clients' load "
              f"({rate:.1f} forwards/s); the server's log ends:\n"
              + "\n".join(server_log[-30:]))
        n_answers = 0
        for i, got in enumerate(answers):
            sl = want[i * TUNE_REQ_TRIALS:(i + 1) * TUNE_REQ_TRIALS]
            for status, reply in got:
                check(status == 200, f"client {i}: a request failed under "
                      f"the tuner: {status} {reply}")
                check(reply["predictions"] == sl.tolist(),
                      f"client {i}: an answer differs from predict_trials")
                n_answers += 1
        served = np.concatenate([np.asarray(got[-1][1]["predictions"])
                                 for got in answers])
        result["predict_cli"] = _check_predict_cli(
            np, cli, work, "predict_tuned", served, y, "predict")
        # /profile under requests until its trace is written: its trace
        # names K1.  The window opens once the profiler's first start has
        # imported its modules (seconds on the card), so requests keep
        # coming until then.
        status, prof = _post(url + "/profile", json.dumps(
            {"seconds": 1.5}).encode(), "application/json")
        check(status == 202, f"/profile answered {status}: {prof}")
        trace_path, n_profiled = None, 0
        deadline = time.monotonic() + 60.0
        while trace_path is None and time.monotonic() < deadline:
            status, _ = _post(url + "/predict", bodies[0],
                              "application/octet-stream")
            check(status == 200, f"/predict under /profile: {status}")
            n_profiled += 1
            time.sleep(0.05)
            found = list(Path(prof["log_dir"]).glob("trace-*.json"))
            if found and found[0].stat().st_size:
                trace_path = found[0]
        check(trace_path is not None, "/profile wrote no trace")
        time.sleep(0.5)
        check("block1_kernel" in trace_path.read_text(),
              "/profile's trace does not name block1_kernel inside the "
              "graph replays")
        # The counts, /healthz against /metrics, with no traffic left.
        status, health = _get(url + "/healthz")
        check(status == 200 and health["status"] == "ok",
              f"/healthz {status}: {health.get('degraded')}")
        snap = json.loads(_get_text(url + "/metrics"))
        text = _get_text(url + "/metrics", {"Accept": "text/plain"})
        ok_json = next(e["value"] for e in snap["counters"]["requests_total"]
                       if e["labels"] == {"status": "ok"})
        check(ok_json == _prom_value(text, 'requests_total{status="ok"}')
              == n_answers + n_profiled, f"requests_total ok {ok_json} vs "
              f"{n_answers + n_profiled} answered")
        check(_prom_value(text, "ladder_retunes")
              == health["ladder_retunes"] >= 1,
              "ladder_retunes differs between /metrics and /healthz")
        lat = snap["histograms"]["request_latency_ms"][0]
        p50 = quantile_from_buckets(lat["bounds"], lat["buckets"], 0.5,
                                    lo=lat["min"], hi=lat["max"])
        check(abs(p50 - health["latency_ms"]["p50"]) < 1e-9,
              f"p50 {p50} from /metrics vs {health['latency_ms']['p50']}")
        launches = health["kernel_launches"]["block1"]
        replays, batches = health["graph_replays"], health["batches"]
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        check(rc == 75, f"tuned server exited {rc} after SIGTERM")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        stderr.close()
        if cli.poll() is None:
            cli.kill()
            cli.wait()
    events = _journal(np, obs, "ok")
    retunes = [e for e in events if e["event"] == "ladder_retune"]
    # A failed retune journals nothing (as the JAX tuner): it shows as
    # the tuner's warning in the server's log.
    failed = [line for line in (work / "serve_tuned.stderr.log").read_text(
        ).splitlines() if "Ladder tune pass failed" in line]
    compiles = [e for e in events if e["event"] == "compile"]
    check(retunes and not failed, f"{len(retunes)} ladder_retune, "
          f"{len(failed)} failed: {failed[:1]}")
    # One eager warm run a captured bucket, one launch a replay; each
    # forward is one chunk (the batcher's cap follows the top bucket).
    check(launches == len(compiles) + replays,
          f"K1 launches {launches} != {len(compiles)} warm runs + "
          f"{replays} replays")
    check(replays == batches, f"{replays} replays for {batches} forwards")
    graphs = {}
    for e in compiles:
        graphs.setdefault(e["what"], []).append(
            {"capture_s": e.get("capture_s"),
             "pool_bytes": e.get("pool_bytes")})
    result.update(
        load_s=load_s, forwards_per_s=rate,
        answers=n_answers, launches=launches, replays=replays,
        batches=batches, warm_runs=len(compiles),
        ladders=[r["new_buckets"] for r in retunes],
        reasons=[r["reason"] for r in retunes],
        final_buckets=health["buckets"], graphs=graphs,
        retune_s=[r["elapsed_s"] for r in retunes],
        trace_bytes=trace_path.stat().st_size)
    log(f"tuned server: {n_answers} requests of {TUNE_REQ_TRIALS} trials "
        f"from {TUNE_CLIENTS} clients in {load_s:.1f} s ({rate:.1f} "
        "forwards/s), none failed, every answer "
        f"predict_trials'; retunes {result['reasons']} -> "
        f"{result['ladders']}; K1 {launches} = {len(compiles)} warm runs + "
        f"{replays} replays; /metrics == /healthz; /profile trace names "
        "block1_kernel")
    return result


def _control_legs(torch, np, dev, work: Path) -> dict:
    """The breaker, admission, trace and SLO legs of the CPU tests, on the
    card, each through an in-process server and its own journal."""
    from eegnetreplication_tpu_torch.obs import journal as obs_journal
    from eegnetreplication_tpu_torch.obs import read_events
    from eegnetreplication_tpu_torch.resil import inject
    from eegnetreplication_tpu_torch.serve.service import ServeApp

    ckpt = _save_seeded(torch, work / "control.npz", 1530)
    x = trials(torch, 8, 22, 257, 1531).numpy()
    body = _npz_body(np, x)

    def post(app, headers=None):
        return _post(app.url + "/predict", body, "application/octet-stream",
                     headers=headers)

    def leg(name, **kw):
        kw.setdefault("buckets", (1, 8, 32))
        jr = obs_journal.run(work / f"obs_{name}", config={})
        journal = jr.__enter__()
        app = ServeApp(ckpt, port=0, device=dev, journal=journal,
                       **kw).start()
        return jr, journal, app

    def finish(jr, journal, app):
        app.stop()
        jr.__exit__(None, None, None)
        return read_events(journal.events_path)

    out = {}
    # Breaker: a retried fault answers; a persistent one opens the circuit
    # (fast 503s, /healthz 503), and it closes after the cooldown.
    jr, journal, app = leg("breaker", breaker_threshold=2,
                           breaker_reset_s=0.5)
    try:
        with inject.scoped(*inject.parse_plan("serve.forward:times=1")):
            check(post(app)[0] == 200, "a retried serve.forward fault "
                  "did not answer 200")
        handle = inject.arm("serve.forward", times=0)
        try:
            codes = [post(app)[0] for _ in range(2)]
            check(codes == [500, 500], f"persistent fault answered {codes}")
            status, health = _get_status(app.url + "/healthz")
            check(status == 503 and health["circuit"] == "open",
                  f"/healthz with the circuit open: {status}")
            t0 = time.perf_counter()
            status, reply = post(app)
            fast_ms = (time.perf_counter() - t0) * 1e3
            check(status == 503, f"open circuit answered {status}")
        finally:
            inject.disarm(handle)
        time.sleep(0.6)
        check(post(app)[0] == 200, "the half-open probe did not answer")
        check(_get(app.url + "/healthz")[1]["circuit"] == "closed",
              "the circuit did not close")
    finally:
        events = finish(jr, journal, app)
    states = [e["state"] for e in events if e["event"] == "circuit_state"]
    check(states == ["open", "half_open", "closed"], f"circuit {states}")
    out["breaker"] = {"fast_503_ms": fast_ms, "states": states}

    # Admission: slow forwards, 6 clients of 8 trials under the hard bound
    # of 64; the adaptive limit sheds bulk with 429.
    with inject.scoped(*inject.parse_plan(
            "serve.degrade:slow=0.05:times=0")):
        jr, journal, app = leg("admission", buckets=(1, 8),
                               max_queue_trials=64, admission_target_ms=1.0)
        codes: list = []
        try:
            stop = threading.Event()

            def client():
                while not stop.is_set():
                    status, reply = post(app)
                    codes.append((status, reply.get("shed")))

            threads = [threading.Thread(target=client) for _ in range(6)]
            for th in threads:
                th.start()
            time.sleep(3.0)
            stop.set()
            for th in threads:
                th.join(60)
            adm = _get_status(app.url + "/healthz")[1]["admission"]
        finally:
            events = finish(jr, journal, app)
    check((429, True) in codes and (200, None) in codes
          and set(codes) <= {(200, None), (429, True)},
          f"admission answers {sorted(set(codes), key=str)}")
    out["admission"] = {"shed": adm["shed"], "limit": adm["limit_trials"],
                        "answered": sum(c == 200 for c, _ in codes)}

    # Traces: the client's trace id kept, the spans parented.
    jr, journal, app = leg("trace", trace_sample=1.0)
    tid = "5eed" * 8
    try:
        check(post(app, {"X-Trace-Id": tid, "X-Parent-Span": "ab" * 8,
                         "X-Trace-Sampled": "1"})[0] == 200, "traced request")
    finally:
        events = finish(jr, journal, app)
    spans = {e["name"]: e for e in events
             if e["event"] == "span" and e["trace_id"] == tid}
    check({"replica.request", "http.parse", "queue.wait", "batch.forward",
           "engine.forward", "batch.scatter"} <= set(spans),
          f"spans {sorted(spans)}")
    check(spans["replica.request"]["parent_span_id"] == "ab" * 8
          and spans["engine.forward"]["parent_span_id"]
          == spans["batch.forward"]["span_id"], "span parents")
    out["trace"] = {"spans": sorted(spans)}

    # SLO: an objective no request meets degrades /healthz.
    jr, journal, app = leg("slo", slo_spec="p95_latency_ms<0.001",
                           slo_interval_s=0)
    try:
        check(post(app)[0] == 200, "SLO leg request")
        status, health = _get_status(app.url + "/healthz")
    finally:
        events = finish(jr, journal, app)
    check(status == 503 and health["degraded"] == [
        "slo:p95_latency_ms<0.001"], f"/healthz under the SLO: {status}")
    check(sum(e["event"] == "slo_breach" for e in events) == 1,
          "slo_breach not journaled once")
    out["slo"] = {"degraded": health["degraded"]}
    log(f"control legs on the card: breaker {states} (open circuit "
        f"answers in {fast_ms:.2f} ms), admission shed {adm['shed']} at "
        f"limit {adm['limit_trials']}, trace spans parented, SLO breach "
        "degrades /healthz")
    return out


def _get_status(url, timeout=30.0):
    """GET; ``(status, JSON reply)``, an HTTP error's too."""
    try:
        return _get(url, timeout)
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read().decode())


def phase_control(torch, np, dev, work: Path, env: dict) -> dict:
    """Phase 14: the serving control plane on the card."""
    t0 = time.perf_counter()
    result = {"graphs": _graph_phase(torch, np, dev),
              "tuned": _tuned_server(torch, np, dev, work, env),
              "legs": _control_legs(torch, np, dev, work)}
    result["wall_s"] = time.perf_counter() - t0
    log(f"phase 14 in {result['wall_s']:.1f} s")
    return result


# --------------------------------------------------------------------------
# Phase 15: online adaptation
# --------------------------------------------------------------------------

ADAPT_STEPS = 60          # the JAX defaults: --adaptSteps, batch 32,
ADAPT_TRIGGER = 16        # --adaptTriggerLabels, the 0.55 floor over
ADAPT_FLOOR = 0.55        # 12 shadow / 8 labeled evals
ADAPT_MIN_SHADOW = 12
ADAPT_MIN_LABELED = 8
LOGIT_ATOL, LOGIT_RTOL = 1e-5, 1e-4


def _candidate_logits(torch, np, dev, checkpoint: str, x) -> float:
    """The promoted candidate's logits on the card (K1) against its plain
    forward on the CPU; returns the largest difference."""
    from eegnetreplication_tpu_torch.serve.engine import (
        InferenceEngine,
        load_model_from_checkpoint,
    )

    card = InferenceEngine(load_model_from_checkpoint(checkpoint,
                                                      device=dev), (1,),
                           device=dev)
    cpu = load_model_from_checkpoint(checkpoint, device="cpu")
    with torch.inference_mode():
        got = card.forward(torch.from_numpy(x).to(dev)).cpu()
        want = cpu(torch.from_numpy(x))
    check(torch.allclose(got, want, atol=LOGIT_ATOL, rtol=LOGIT_RTOL),
          f"the candidate's card logits differ from its CPU forward by "
          f"{float((got - want).abs().max()):.3g}")
    check(torch.equal(got.argmax(-1), want.argmax(-1)),
          "the candidate's card argmax differs from its CPU forward")
    return float((got - want).abs().max())


def _repeat_fine_tune(torch, np, dev, work: Path, record: dict) -> dict:
    """Two card fine-tunes from the baseline checkpoint on the drifted
    windows the client labeled, one seed: bitwise equal candidates.  Their
    walls and steps/s."""
    from eegnetreplication_tpu_torch.adapt import (
        AdaptationWorker,
        ReplayBuffer,
    )
    from eegnetreplication_tpu_torch.utils import adapt_drill

    rec = record["recovery"]
    cue = adapt_drill.CueStream(22, 257, 7)
    x, y = adapt_drill.drifted_windows(cue, rec["promote_seen"],
                                       rec["drift_start"], device=dev)
    buf = ReplayBuffer()
    for k in range(rec["drift_start"], rec["promote_seen"]):
        buf.observe("adapted", "s", k, x[k])
        buf.label("adapted", "s", k, int(y[k]))
    runs = []
    for i in range(2):
        worker = AdaptationWorker(buf, work / f"repeat{i}",
                                  steps=ADAPT_STEPS, batch_size=32,
                                  seed=0, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cand = worker.fine_tune("adapted", work / "drill" / "baseline.npz")
        wall = time.perf_counter() - t0
        runs.append((cand, wall, cand.path.read_bytes()))
    (a, wall_a, bytes_a), (b, wall_b, bytes_b) = runs
    check(a.digest == b.digest and bytes_a == bytes_b,
          f"two card fine-tunes differ: {a.digest[:12]} vs {b.digest[:12]}")
    return {"digest": a.digest, "n_labeled": a.n_labeled,
            "wall_s": [wall_a, wall_b],
            "steps_per_s": [ADAPT_STEPS / wall_a, ADAPT_STEPS / wall_b],
            "loss": a.loss, "fit_accuracy": a.fit_accuracy}


def phase_adapt(torch, np, dev, work: Path, env: dict) -> dict:
    """Phase 15: online adaptation on the card (``utils/adapt_drill.py``):
    drift, labels, fine-tune, shadow, promotion, recovery, and a rollback
    under 8 ``/predict`` clients, at the product width."""
    from eegnetreplication_tpu_torch.utils import adapt_drill

    t0 = time.perf_counter()
    record = adapt_drill.run_drill(
        work / "drill", env, n_channels=22, window=257, F1=8, D=2,
        n_tenants=N_TENANTS, trigger_labels=ADAPT_TRIGGER,
        adapt_steps=ADAPT_STEPS, min_shadow=ADAPT_MIN_SHADOW,
        min_labeled=ADAPT_MIN_LABELED, accuracy_floor=ADAPT_FLOOR,
        probe_interval_s=0.2, device=dev)
    drill_s = time.perf_counter() - t0
    events = record["events"]
    base, rec = record["baseline"], record["recovery"]
    check(record["baseline_rc"] == record["adapt_rc"] == 75,
          f"servers exited {record['baseline_rc']}, {record['adapt_rc']} "
          "after SIGTERM")
    check(record["model"]["holdout_accuracy"] >= 0.7,
          f"the baseline learned the cue stream to only "
          f"{record['model']['holdout_accuracy']}")
    check(record["order"]["ordered"],
          f"journal order violated: {record['order']}")
    decisions = [e for e in events if e["event"] == "promotion"]
    refusals = [e for e in decisions if e["action"] == "refused"]
    steps = [e for e in decisions if e["action"] != "refused"]
    seen = [(e["action"], e.get("stage")) for e in decisions]
    check([(e["action"], e.get("stage")) for e in steps]
          == [("error", "reload"), ("promote", None), ("rollback", None)],
          f"promotion events: {seen}")
    err, prom, roll = steps
    i_err, i_prom = events.index(err), events.index(prom)
    swaps = [e for e in events[i_err:i_prom] if e["event"] == "model_swap"]
    check(len(swaps) == 1 and swaps[0]["previous_digest"]
          == record["prior_digest"] == prom["previous_digest"],
          "the failed promotion (adapt.promote) did not leave the prior "
          f"digest serving: {swaps}")
    check(roll["digest"] == record["prior_digest"]
          == record["counts_end"]["digest"],
          "the rollback did not restore the prior digest")
    rb = record["rollback"]
    check(rb["status"] == 200 and rb["failed"] == 0,
          f"rollback under load: {rb['status']}, {rb['failed']} of "
          f"{rb['requests']} requests failed")
    check(rec["failed"] == 0 and base["failed"] == 0,
          f"{rec['failed']} + {base['failed']} session pushes, windows or "
          "labels failed")
    pre, drifted = rec["pre_drift_accuracy"], rec["drifted_accuracy"]
    recovered = rec["recovered_accuracy"]
    log(f"accuracy: pre-drift {pre}, drifted {drifted}, after promotion "
        f"{recovered}; no-adaptation control {base['drifted_accuracy']}")
    check(drifted < pre, f"the drift cost no accuracy ({pre} -> {drifted})")
    check(recovered is not None and recovered > drifted,
          f"no recovery: drifted {drifted}, after promotion {recovered}")
    # Probes: ok while the model they pinned serves; outside
    # requests_total.
    probes = [e for e in events if e["event"] == "probe"]
    lo, hi = swaps[0]["t"] - 1.0, roll["t"] + 1.0
    check(probes and all(e["status"] == "ok" for e in probes
                         if not lo <= e["t"] <= hi)
          and {e["status"] for e in probes} <= {"ok", "mismatch"},
          f"probe statuses: {sorted({e['status'] for e in probes})}")
    end = next(e for e in events if e["event"] == "serve_end")
    n_user = len(record["predict_records"]) + rb["requests"]
    check(end["n_requests"] == n_user and end["probes"] == len(probes),
          f"serve_end counts {end['n_requests']} requests and "
          f"{end['probes']} probes; sent {n_user} and {len(probes)}")
    counters = record["metrics"]["counters"]
    check(sum(e["value"] for e in counters["requests_total"])
          <= n_user, "probes reached requests_total")
    launches = adapt_drill.expected_launches(record)
    check(launches["got"] == launches["want"],
          f"launch counts: got {launches['got']}, want {launches['want']}")
    # The promoted candidate on the card against its CPU forward, and two
    # card fine-tunes.
    cue = adapt_drill.CueStream(22, 257, 7)
    x, _ = adapt_drill.drifted_windows(cue, 32, 8, device=dev)
    max_err = _candidate_logits(torch, np, dev, prom["checkpoint"], x)
    repeat = _repeat_fine_tune(torch, np, dev, work, record)
    cand = next(e for e in events if e["event"] == "adaptation_candidate")
    shadow_compile = [e for e in events if e["event"] == "compile"
                      and e["what"] == "serve_forward_b1"]
    swap = swaps[0]
    result = {
        "drill_s": drill_s,
        "model": record["model"],
        "accuracy": {"pre_drift": pre, "drifted": drifted,
                     "recovered": recovered,
                     "no_adaptation_control": base["drifted_accuracy"]},
        "windows": {"baseline": base["windows_decided"],
                    "adapt": rec["windows_decided"],
                    "drift_start": rec["drift_start"],
                    "promote_seen": rec["promote_seen"],
                    "labels": rec["labels_posted"]},
        "refusals": len(refusals),
        "fine_tune_server": {"elapsed_s": cand["elapsed_s"],
                             "steps": cand["steps"],
                             "steps_per_s": cand["steps"]
                             / cand["elapsed_s"],
                             "n_labeled": cand["n_labeled"],
                             "fit_accuracy": cand["fit_accuracy"]},
        "fine_tune_repeat": repeat,
        "shadow_capture_s": [e.get("capture_s") for e in shadow_compile],
        "shadow_compile_s": [e["elapsed_s"] for e in shadow_compile],
        "adapt_warmup_s": next(e for e in events
                               if e["event"] == "serve_start"
                               )["adapt_warmup_s"],
        "promotion_s": prom["elapsed_s"],
        "promotion_reload_s": swap["elapsed_s"],
        "rollback": {k: rb[k] for k in ("status", "wall_s", "requests",
                                        "failed")},
        "latency": record["latency"],
        "launches": launches,
        "probes": {"n": len(probes),
                   "statuses": sorted({e["status"] for e in probes})},
        "candidate_max_abs_err": max_err,
    }
    result["wall_s"] = time.perf_counter() - t0
    log(f"phase 15 in {result['wall_s']:.1f} s: fine-tune "
        f"{cand['elapsed_s']} s in the server, repeat "
        f"{repeat['wall_s'][0]:.3f}/{repeat['wall_s'][1]:.3f} s; shadow "
        f"capture {result['shadow_capture_s']}; promotion reload "
        f"{swap['elapsed_s']} s; latency {record['latency']}")
    return result


# --------------------------------------------------------------------------
# Phase 16: supervised training, the console, and a
# supervised server
# --------------------------------------------------------------------------

# 16a-b run 60 of the reference's 500 epochs since phase 20 joined the
# smoke (100 since phase 19, 500 before; its 1200 s limit); the chunks and
# the preemption keep their boundaries.  --long runs its 500.
SUP_EPOCHS = 60
SUP_EVERY = 10            # a run snapshot every 10 epochs: 6 chunks
LONG_EPOCHS = 500         # --long: the reference's cross-subject protocol
LONG_EVERY = 50
# The watchdog's step budget (a healthy epoch < 1 s) and SIGTERM ->
# SIGKILL grace: 20 s and 5 s before phase 21, cut for the time limit.
SUP_STEP_S = 10.0
SUP_GRACE_S = 2.0
# Launch 1 reads the preempt plan and stops at its 2nd chunk boundary
# (epoch 20); every later launch reads the hang plan: launch 2 (resumed
# at 20) stalls at its 3rd boundary (epoch 50), and launch 3 (resumed at
# 50) has 1 boundary left, fewer than 3, so it completes.
SUP_PREEMPT_AFTER = 1
SUP_HANG_AFTER = 2
SUP_HANG_SLEEP_S = 600.0  # outlives SIGTERM (PEP 475): SIGKILL ends it
SUP_WAIT_S = 900.0
SERVE_HANG_AFTER = 3      # leg c: the 4th dispatch of a server stalls
SERVE_FORWARD_S = 5.0     # leg c's serve_forward budget
LONG_PREEMPT_AFTER = 6    # --long: the 7th boundary (epoch 350) of launch
LONG_WAIT_S = 1800.0      # 1; launch 2 has 3 left and completes


def _sup_cmd(args: list, child: list) -> list:
    return [sys.executable, "-m",
            "eegnetreplication_tpu_torch.resil.supervise", *args, "--",
            *child]


def _run_dirs(path: Path) -> list:
    return sorted(p for p in path.iterdir() if p.is_dir()) \
        if path.exists() else []


def _events_of(run_dir: Path, complete=False) -> list:
    """A run's journal read by the port, a killed run's torn tail
    skipped."""
    from eegnetreplication_tpu_torch.obs import read_events

    events = read_events(run_dir / "events.jsonl", complete=complete,
                         lenient_tail=True)
    bad = [e for e in events if "_schema_error" in e]
    check(not bad, f"{run_dir}: events flagged by the schema: {bad[:2]}")
    return events


def _wait_for(cond, timeout: float, what: str, procs=()):
    """Poll ``cond()`` until it is truthy; fails at the deadline or when
    one of ``procs`` exits first."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = cond()
        if got:
            return got
        for proc in procs:
            if proc.poll() is not None:
                raise SmokeFailure(f"waiting for {what}: a process exited "
                                   f"{proc.returncode} first")
        time.sleep(0.2)
    raise SmokeFailure(f"timed out after {timeout:.0f}s waiting for {what}")


def _write_plan(path: Path, specs: list) -> None:
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(specs))
    os.replace(tmp, path)


def _top_json(root: Path, env: dict) -> dict:
    """One ``obs.top --json`` snapshot over ``root``."""
    out = subprocess.run(
        [sys.executable, "-m", "eegnetreplication_tpu_torch.obs.top",
         "--json", str(root)], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120)
    check(out.returncode == 0, f"obs.top exited {out.returncode}:\n"
          + out.stderr[-2000:])
    return json.loads(out.stdout.strip().splitlines()[-1])


def _stop_supervised(proc, sup_obs: Path) -> None:
    """End a supervisor that is still running and every child it
    launched: SIGTERM (forwarded to the child), then SIGKILL to all."""
    if proc.poll() is not None:
        return
    proc.terminate()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    from eegnetreplication_tpu_torch.obs import read_events

    for run in _run_dirs(sup_obs):
        with contextlib.suppress(Exception):
            for ev in read_events(run / "events.jsonl", complete=False,
                                  lenient_tail=True):
                if ev["event"] == "supervisor_launch":
                    with contextlib.suppress(OSError):
                        os.kill(int(ev["pid"]), signal.SIGKILL)


def _run_end(events) -> dict:
    end = events[-1]
    check(end["event"] == "run_end", f"a journal ends with {end['event']}")
    return end


def _chunk_wall_s(run_dir: Path) -> float:
    """The training wall a run journaled: its chunks, each ended by a
    synchronize (``metrics.json``'s ``chunk_wall_s``)."""
    from eegnetreplication_tpu_torch.obs import read_metrics

    series = read_metrics(run_dir / "metrics.json")["histograms"].get(
        "chunk_wall_s", [])
    return float(sum(s["sum"] for s in series))


def _steps(setup: dict) -> dict:
    from eegnetreplication_tpu_torch.config import DEFAULT_TRAINING

    b = DEFAULT_TRAINING.batch_size
    return {"train_steps": -(-setup["train_pad"] // b),
            "val_steps": max(1, -(-setup["val_pad"] // b)),
            "test_steps": max(1, -(-setup["test_pad"] // b))}


def _supervised_training(torch, np, work: Path, env: dict,
                         data_root: Path) -> dict:
    """Legs a and b: the within-subject protocol, unbroken and under
    the supervisor through a preemption and a hang, at once; the console
    over both while they run and after."""
    from eegnetreplication_tpu_torch.obs.schema import event_summary

    work.mkdir(parents=True, exist_ok=True)
    base = [sys.executable, "-m", "eegnetreplication_tpu_torch.train",
            "--trainingType", "Within-Subject", "--epochs", str(SUP_EPOCHS),
            "--checkpointEvery", str(SUP_EVERY)]
    obs_root = work / "obs"
    children = obs_root / "children"
    plan = work / "plan.json"
    _write_plan(plan, [{"site": "host.preempt", "after": SUP_PREEMPT_AFTER,
                        "times": 1}])
    legs = {}
    for name in ("unbroken", "supervised"):
        paths = _replicated_tree(data_root, work / name)
        (work / name / "tmp").mkdir()
        legs[name] = (paths, dict(
            env, EEGTPU_DATA_ROOT=str(paths.project_root),
            TMPDIR=str(work / name / "tmp")))
    cmds = {
        "unbroken": base + ["--metricsDir", str(obs_root / "unbroken")],
        "supervised": _sup_cmd(
            ["--metricsDir", str(obs_root / "supervisor"), "--hang",
             f"step={SUP_STEP_S:g}", "--graceS", f"{SUP_GRACE_S:g}",
             "--backoffSeed", "0"],
            base + ["--metricsDir", str(children), "--chaos", f"@{plan}"])}
    t0 = time.perf_counter()
    procs = {name: _spawn(cmd, legs[name][1], work / f"{name}.log")
             for name, cmd in cmds.items()}
    walls: dict = {}
    try:
        # Launch 1 parses the plan before it opens its journal: from then
        # on a launch reads the hang plan.
        _wait_for(lambda: any((d / "events.jsonl").exists()
                              for d in _run_dirs(children)), 300,
                  "the first supervised launch's journal", procs.values())
        _write_plan(plan, [{"site": "train.hang", "after": SUP_HANG_AFTER,
                            "times": 1, "sleep": SUP_HANG_SLEEP_S}])

        def relaunched_chunk():
            # A run's directory exists a moment before its journal does.
            dirs = _run_dirs(children)
            return (len(dirs) >= 2 and (dirs[1] / "events.jsonl").exists()
                    and any(e["event"] == "epoch"
                            for e in _events_of(dirs[1])))

        _wait_for(relaunched_chunk, SUP_WAIT_S,
                  "the relaunched child's first chunk",
                  [procs["supervised"]])
        live = _top_json(obs_root, env)
        deadline = time.monotonic() + SUP_WAIT_S
        while len(walls) < len(procs) and time.monotonic() < deadline:
            for name, proc in procs.items():
                if name not in walls and proc.poll() is not None:
                    walls[name] = time.perf_counter() - t0
            time.sleep(0.2)
    finally:
        if procs["unbroken"].poll() is None:
            procs["unbroken"].kill()
            procs["unbroken"].wait()
        _stop_supervised(procs["supervised"], obs_root / "supervisor")
    for name, proc in procs.items():
        check(name in walls, f"the {name} leg did not end in "
              f"{SUP_WAIT_S:.0f}s")
        check(proc.returncode == 0, f"the {name} leg exited "
              f"{proc.returncode}:\n"
              + (work / f"{name}.log").read_text()[-4000:])

    # The supervisor's journal: the exit sequence, the hang, the relaunches.
    (sup_dir,) = _run_dirs(obs_root / "supervisor")
    sup = _events_of(sup_dir, complete=True)
    ends = [e for e in sup if e["event"] == "supervisor_end"]
    check(ends and ends[-1]["status"] == "completed",
          f"supervisor_end {ends}")
    exits = [e for e in sup if e["event"] == "supervisor_exit"]
    check([e["classification"] for e in exits]
          == ["preempted", "hang", "completed"],
          f"exit classifications {[e['classification'] for e in exits]}")
    (hang,) = [e for e in sup if e["event"] == "supervisor_hang"]
    check(hang["phase"] == "step" and hang["age_s"] > hang["threshold_s"]
          and hang["attempt"] == 2 and sup.index(hang) < sup.index(exits[1]),
          f"supervisor_hang {hang}")
    escalations = [e for e in sup if e["event"] == "supervisor_escalate"]
    check([e["signal"] for e in escalations] == ["SIGKILL"],
          f"escalations {escalations}: the stall must outlive SIGTERM")
    launches = [e for e in sup if e["event"] == "supervisor_launch"]
    check([e["cmd"].count("--resume") for e in launches] == [0, 1, 1],
          "every relaunch carries --resume once: "
          f"{[e['cmd'][-3:] for e in launches]}")
    summary = event_summary(sup)
    check(summary["supervisor_restarts"] == len(launches) - 1 == 2
          and summary["supervisor_status"] == "completed",
          f"event_summary {summary}")

    # The bits and the reports.
    supervised, unbroken = legs["supervised"][0], legs["unbroken"][0]
    _same_weights(supervised.models, unbroken.models,
                  [f"subject_{s:02d}_best_model.npz" for s in range(1, 10)],
                  f"the supervised {SUP_EPOCHS}-epoch run vs the unbroken "
                  "one")
    reports = [_check_report(p.reports / "latest_within_subject_report.json",
                             WS_REPORT_KEYS, "within-subject")
               for p in (supervised, unbroken)]
    for r in reports:
        r.pop("timestamp")
    check(reports[0] == reports[1], "the supervised run's report differs "
          "from the unbroken run's")

    # Every launch's journal: what it trained, how it ended, its launches.
    runs = _run_dirs(children)
    check(len(runs) == 3, f"{len(runs)} child journals, want 3")
    first, killed, last = (_events_of(r) for r in runs)
    check(_run_end(first)["status"] == "preempted", "launch 1 did not end "
          "preempted")
    check(killed[-1]["event"] != "run_end", "the SIGKILLed launch has a "
          "run_end")
    check(_run_end(last)["status"] == "ok", "launch 3 did not end ok")
    stop = SUP_EVERY * (SUP_PREEMPT_AFTER + 1)
    hang_at = stop + SUP_EVERY * (SUP_HANG_AFTER + 1)
    trained = [_epochs_journaled(j) for j in (first, killed, last)]
    # Launch 3 resumes from the newest whole snapshot: the one written at
    # the stall, or the generation before it had the SIGKILL torn it.
    resumed = trained[2][0] - 1 if trained[2] else SUP_EPOCHS
    check(trained[:2] == [list(range(1, stop + 1)),
                          list(range(stop + 1, hang_at + 1))]
          and resumed % SUP_EVERY == 0 and stop < resumed <= hang_at
          and trained[2] == list(range(resumed + 1, SUP_EPOCHS + 1)),
          f"the launches trained epochs {[(t[0], t[-1]) for t in trained]}")
    redone = hang_at - resumed
    fault = next(e for e in killed if e["event"] == "fault_injected"
                 and e["site"] == "train.hang")
    unbroken_events = _journal(np, obs_root / "unbroken", "ok")
    setup = next(e for e in unbroken_events if e["event"] == "train_setup")
    steps = _steps(setup)
    n_folds = setup["n_folds"]
    check(n_folds == 36, f"{n_folds} folds, want 36")
    want = {"unbroken": SUP_EPOCHS * steps["val_steps"] + steps["test_steps"],
            "launch 1": stop * steps["val_steps"],
            "launch 3": (SUP_EPOCHS - resumed) * steps["val_steps"]
            + steps["test_steps"]}
    ends = {"unbroken": _run_end(unbroken_events), "launch 1": first[-1],
            "launch 3": last[-1]}
    for name, end in ends.items():
        got = end["kernel_launches"]["block1_stacked"]
        check(got == want[name], f"{name}: {got} K1-stacked launches, want "
              f"{want[name]} (epochs x {steps['val_steps']} validation "
              f"batches + {steps['test_steps']} test batches)")
    peak = {name: (end["peak_memory_bytes"] or 0) / 2 ** 30
            for name, end in ends.items()}
    check(0 < peak["unbroken"]
          and abs(peak["launch 3"] - peak["unbroken"])
          <= 0.1 * peak["unbroken"],
          f"peak memory of the relaunched child {peak['launch 3']:.3f} GiB "
          f"against the unbroken run's {peak['unbroken']:.3f}")

    # Rates: training wall from the journaled chunks, and end to end.
    fold_epochs = n_folds * SUP_EPOCHS
    (unbroken_dir,) = _run_dirs(obs_root / "unbroken")
    unbroken_rate = fold_epochs / _chunk_wall_s(unbroken_dir)
    # The SIGKILLed launch flushed no metrics: launches 1 and 3 only.
    sup_rate = (n_folds * (stop + SUP_EPOCHS - resumed)
                / sum(_chunk_wall_s(r) for r in (runs[0], runs[2])))
    row = dict(steps, fold_epochs_per_s=unbroken_rate)
    row.update(_mfu_fields(row))
    detect_s = hang["t"] - fault["t"]
    relaunch_s = launches[2]["t"] - hang["t"]

    # The console, live and after the end.
    check(live["n_runs"] >= 3, f"obs.top saw {live['n_runs']} runs live")
    live_roles = {Path(r["dir"]).name: r for r in live["runs"]}
    sup_live = live_roles[sup_dir.name]
    child_live = live_roles[runs[1].name]
    check(sup_live["role"] == "supervisor" and sup_live["status"] == "live",
          f"the live console's supervisor row {sup_live}")
    check(child_live["role"] == "train" and child_live["status"] == "live"
          and (child_live.get("fold_epochs_per_s") or 0) > 0,
          f"the live console's child row {child_live}")
    after = _top_json(obs_root, env)
    rows = {Path(r["dir"]).name: r for r in after["runs"]}
    check(rows[sup_dir.name]["status"] == "ok", "the console's supervisor "
          "row after the end")
    child_rows = [rows[r.name] for r in runs]
    check(len(child_rows) - 1 == summary["supervisor_restarts"]
          and [r["status"] for r in child_rows]
          == ["preempted", "live", "ok"],
          f"the console's child rows after the end: "
          f"{[r['status'] for r in child_rows]}")
    out = {"walls_s": walls, "fold_epochs": fold_epochs,
           "unbroken_fold_epochs_per_s": unbroken_rate,
           "supervised_train_fold_epochs_per_s": sup_rate,
           "end_to_end_fold_epochs_per_s": {
               name: fold_epochs / wall for name, wall in walls.items()},
           "mfu": row["mfu"], "gflops_per_s": row["gflops_per_s"],
           "peak_memory_gib": peak, "hang_detect_s": detect_s,
           "hang_age_s": hang["age_s"],
           "hang_to_relaunch_s": relaunch_s, "epochs_redone": redone,
           "exits": [e["classification"] for e in exits],
           "restarts": summary["supervisor_restarts"],
           "launches_block1_stacked": sum(
               e["kernel_launches"]["block1_stacked"] for e in ends.values()),
           "console_live_child_fold_epochs_per_s":
               child_live["fold_epochs_per_s"]}
    log(f"phase 16a: {n_folds} folds x {SUP_EPOCHS} epochs, unbroken "
        f"{walls['unbroken']:.1f}s and supervised {walls['supervised']:.1f}s "
        f"at once ({fold_epochs / walls['unbroken']:.1f} and "
        f"{fold_epochs / walls['supervised']:.1f} fold-epochs/s end to end; "
        f"training {unbroken_rate:.1f} fold-epochs/s unbroken, "
        f"{sup_rate:.1f} supervised (launches 1 and 3), "
        f"{row['gflops_per_s']:.1f} GFLOP/s, {100 * (row['mfu'] or 0):.4f}% "
        f"MFU); exits {out['exits']}; stall -> supervisor_hang "
        f"{detect_s:.2f}s (the beat file's age {hang['age_s']:.2f}s, budget "
        f"{SUP_STEP_S:g}s), supervisor_hang -> "
        f"relaunch {relaunch_s:.2f}s (grace {SUP_GRACE_S:g}s); {redone} "
        f"epochs trained again; peak memory "
        + ", ".join(f"{k} {v:.3f} GiB" for k, v in peak.items())
        + "; nine best models bitwise the unbroken run's")
    log(f"phase 16b: obs.top live saw the supervisor and the relaunched "
        f"child (role train, {child_live['fold_epochs_per_s']} fold-epochs/s "
        f"over its window); after the end {len(child_rows)} child runs = "
        f"{summary['supervisor_restarts']} restarts + 1")
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _healthy(url: str) -> bool:
    try:
        return _get(url + "/healthz", timeout=2.0)[0] == 200
    except (OSError, ValueError):
        return False


def _supervised_server(torch, np, work: Path, env: dict) -> dict:
    """Leg c: ``serve`` under the supervisor on a fixed port; the 4th
    dispatch stalls (``serve.hang``), the ``serve_forward`` budget runs out,
    SIGTERM then SIGKILL, and the relaunched server answers as before."""
    work.mkdir(parents=True, exist_ok=True)
    checkpoint = _save_seeded(torch, work / "serve.npz", seed=1601)
    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    obs_root = work / "obs"
    cmd = _sup_cmd(
        ["--metricsDir", str(obs_root / "supervisor"), "--hang",
         f"serve_forward={SERVE_FORWARD_S:g}", "--graceS", "3", "--pollS",
         "0.2", "--backoffSeed", "0"],
        [sys.executable, "-u", "-m", "eegnetreplication_tpu_torch.serve",
         "--checkpoint", str(checkpoint), "--port", str(port),
         "--metricsDir", str(obs_root / "children"), "--chaos",
         f"serve.hang:after={SERVE_HANG_AFTER}:times=1:"
         f"sleep={SUP_HANG_SLEEP_S:g}"])
    body = _json_body(trials(torch, 16, 22, 257, seed=1602).numpy())

    def answers():
        out = []
        for _ in range(SERVE_HANG_AFTER):
            status, reply = _post(url + "/predict", body,
                                  "application/json")
            check(status == 200, f"/predict answered {status}: {reply}")
            reply.pop("latency_ms")
            out.append(json.dumps(reply, sort_keys=True))
        return out

    def launches():
        return [e for run in _run_dirs(obs_root / "supervisor")
                if (run / "events.jsonl").exists()
                for e in _events_of(run)
                if e["event"] == "supervisor_launch"]

    t0 = time.perf_counter()
    proc = _spawn(cmd, env, work / "serve_sup.log")
    stalled: list = []
    try:
        _wait_for(lambda: _healthy(url), SERVE_START_TIMEOUT_S,
                  "the supervised server", [proc])
        start_s = time.perf_counter() - t0
        before = answers()
        health_before = _get(url + "/healthz")[1]

        def stall():
            try:
                stalled.append(_post(url + "/predict", body,
                                     "application/json", timeout=120))
            except (OSError, ValueError) as exc:
                stalled.append(exc)

        t_stall = time.time()
        client = threading.Thread(target=stall, daemon=True)
        client.start()
        _wait_for(lambda: len(launches()) >= 2, 120,
                  "the relaunch after the hang", [proc])
        t1 = time.perf_counter()
        _wait_for(lambda: _healthy(url), SERVE_START_TIMEOUT_S,
                  "the relaunched server", [proc])
        back_s = time.perf_counter() - t1
        after = answers()
        health_after = _get(url + "/healthz")[1]
        client.join(timeout=30)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        _stop_supervised(proc, obs_root / "supervisor")
    wall = time.perf_counter() - t0
    check(rc == 75, f"the supervisor exited {rc} after SIGTERM, want the "
          "server's 75")
    check(after == before, "the relaunched server answers otherwise than "
          "before the hang")
    check(stalled and not (isinstance(stalled[0], tuple)
                           and stalled[0][0] == 200),
          f"the stalled request was answered: {stalled}")
    (sup_dir,) = _run_dirs(obs_root / "supervisor")
    sup = _events_of(sup_dir, complete=True)
    exits = [e["classification"] for e in sup
             if e["event"] == "supervisor_exit"]
    check(exits == ["hang", "preempted"], f"exit classifications {exits}")
    check([e["cmd"].count("--resume") for e in sup
           if e["event"] == "supervisor_launch"] == [0, 1],
          "the relaunched server lacks --resume")
    (hang,) = [e for e in sup if e["event"] == "supervisor_hang"]
    check(hang["phase"] == "serve_forward"
          and hang["age_s"] > hang["threshold_s"], f"supervisor_hang {hang}")
    ends = [e for e in sup if e["event"] == "supervisor_end"]
    check(ends[-1]["status"] == "stopped", f"supervisor_end {ends}")
    k1 = {n: h["kernel_launches"]["block1"]
          for n, h in (("before", health_before), ("after", health_after))}
    replays = health_after["graph_replays"]
    check(replays >= SERVE_HANG_AFTER and k1["after"] >= replays,
          f"the relaunched server's K1 launches {k1['after']} and graph "
          f"replays {replays}: its answers must replay the bucket graphs")
    detect_s = hang["t"] - t_stall
    relaunch_s = launches()[1]["t"] - hang["t"]
    log(f"phase 16c: supervised server on port {port} up in {start_s:.1f}s; "
        f"the 4th dispatch stalled, supervisor_hang after {detect_s:.2f}s "
        f"(budget {SERVE_FORWARD_S:g}s), relaunch {relaunch_s:.2f}s later "
        f"with --resume, serving again {back_s:.1f}s after it, "
        f"{len(after)} answers equal to before the hang; K1 launches "
        f"{k1['before']} before, {k1['after']} after ({replays} replays); "
        f"SIGTERM -> 75 ({wall:.1f}s in all)")
    return {"wall_s": wall, "start_s": start_s, "hang_detect_s": detect_s,
            "hang_to_relaunch_s": relaunch_s, "back_s": back_s, "k1_launches": k1["before"] + k1["after"],
            "graph_replays": replays, "exits": exits}


def _long_cross_subject(torch, np, work: Path, env: dict,
                        data_root: Path) -> dict:
    """Leg d (``--long``): the 90-fold cross-subject protocol at 500
    epochs under the supervisor, one ``host.preempt`` (re-armed in the
    relaunch, which has too few chunk boundaries left to reach it)."""
    paths = _replicated_tree(data_root, work / "tree")
    (work / "tmp").mkdir(parents=True)
    run_env = dict(env, EEGTPU_DATA_ROOT=str(paths.project_root),
                   TMPDIR=str(work / "tmp"))
    obs_root = work / "obs"
    children = obs_root / "children"
    cmd = _sup_cmd(
        ["--metricsDir", str(obs_root / "supervisor"), "--hang",
         f"step={SUP_STEP_S:g}", "--graceS", f"{SUP_GRACE_S:g}",
         "--backoffSeed", "0"],
        [sys.executable, "-m", "eegnetreplication_tpu_torch.train",
         "--trainingType", "Cross-Subject", "--epochs", str(LONG_EPOCHS),
         "--checkpointEvery", str(LONG_EVERY), "--metricsDir", str(children),
         "--chaos", f"host.preempt:after={LONG_PREEMPT_AFTER}:times=1"])
    t0 = time.perf_counter()
    proc = _spawn(cmd, run_env, work / "long.log")
    try:
        rc = proc.wait(timeout=LONG_WAIT_S)
    except subprocess.TimeoutExpired:
        rc = None
    finally:
        _stop_supervised(proc, obs_root / "supervisor")
    wall = time.perf_counter() - t0
    check(rc == 0, f"the supervised cross-subject run exited {rc}:\n"
          + (work / "long.log").read_text()[-4000:])
    (sup_dir,) = _run_dirs(obs_root / "supervisor")
    sup = _events_of(sup_dir, complete=True)
    exits = [e["classification"] for e in sup
             if e["event"] == "supervisor_exit"]
    check(exits == ["preempted", "completed"], f"exits {exits}")
    runs = _run_dirs(children)
    journals = [_events_of(r) for r in runs]
    check([_run_end(j)["status"] for j in journals] == ["preempted", "ok"],
          "the launches' run_end statuses")
    stop = LONG_EVERY * (LONG_PREEMPT_AFTER + 1)
    check([_epochs_journaled(j) for j in journals]
          == [list(range(1, stop + 1)), list(range(stop + 1,
                                                   LONG_EPOCHS + 1))],
          "the launches' epochs")
    report = _check_report(paths.reports / "latest_cross_subject_report.json",
                           CS_REPORT_KEYS, "cross-subject")
    setup = next(e for e in journals[0] if e["event"] == "train_setup")
    steps = _steps(setup)
    n_folds = report["model_parameters"]["total_folds"]
    check(n_folds == 90, f"{n_folds} folds")
    fold_epochs = n_folds * LONG_EPOCHS
    train_s = sum(_chunk_wall_s(r) for r in runs)
    row = dict(steps, fold_epochs_per_s=fold_epochs / train_s)
    row.update(_mfu_fields(row))
    peak = max(j[-1]["peak_memory_bytes"] or 0 for j in journals) / 2 ** 30
    launches = sum(j[-1]["kernel_launches"]["block1_stacked"]
                   for j in journals)
    log(f"phase 16d (--long): cross-subject {n_folds} folds x {LONG_EPOCHS} "
        f"epochs under the supervisor in {wall:.1f}s (exits {exits}), "
        f"training {row['fold_epochs_per_s']:.2f} fold-epochs/s, "
        f"{row['gflops_per_s']:.1f} GFLOP/s, {100 * (row['mfu'] or 0):.4f}% "
        f"MFU, peak memory {peak:.3f} GiB, average test accuracy "
        f"{report['overall_results']['average_test_accuracy']}%")
    return {"wall_s": wall, "fold_epochs_per_s": row["fold_epochs_per_s"],
            "end_to_end_fold_epochs_per_s": fold_epochs / wall,
            "mfu": row["mfu"], "gflops_per_s": row["gflops_per_s"],
            "peak_memory_gib": peak, "exits": exits,
            "launches_block1_stacked": launches}


def phase_supervised(torch, np, dev, work: Path, env: dict,
                     data_root: Path, long: bool = False) -> dict:
    """Phase 16: supervised training (a), the console on
    it (b), a supervised server (c), and with ``--long`` the cross-subject
    protocol at full length (d).  The server's leg runs beside the
    training legs: neither waits on the other, and the smoke's time limit
    has no room for them in turn."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        server = pool.submit(_supervised_server, torch, np, work / "c", env)
        try:
            out = {"training": _supervised_training(torch, np, work / "a",
                                                    env, data_root)}
        finally:
            out_server = server.result()
    out["server"] = out_server
    if long:
        out["long"] = _long_cross_subject(torch, np, work / "d", env,
                                          data_root)
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 16: {out['wall_s']:.1f}s")
    return out


# --------------------------------------------------------------------------
# Phase 17: the model layer
# --------------------------------------------------------------------------

BASELINES = ("shallow_convnet", "deep_convnet")
ML_EPOCHS = 3             # the baselines' CLI runs
ML_CPU_FOLDS = 1          # folds of the card-vs-CPU check (CPU_EPOCHS each)
# The input scaling of the CPU-against-itself run on the label-free tree:
# one f32 rounding step of the trials, the size of the card's own
# rounding differences.
ML_SCALE = 1e-7
ML_LEARN_EPOCHS = 8       # the separable pool
ML_TIME_EPOCHS = 3        # timed epochs at 8 and 36 folds
# The banded-vs-lax A/B: timed epochs per turn, after one warm-up epoch
# each, by fold count.  The 90-fold A/B ({90: 2}) is left out to keep the
# smoke inside its time limit since phase 18; its result stands in
# PERF.md, and phase 11 times the 90 folds under the default schedule on
# every run.  Two turns (banded, lax) since phase 19: "auto" was decided
# on four (banded, lax, lax, banded).
AB_EPOCHS = {36: 3}
AB_TURNS = ("banded", "lax")
AB_LAUNCH_EPOCHS = 2      # the K1-stacked count and the bitwise repeat
BANDED_FWD_TOL, BANDED_GRAD_TOL = 1e-5, 1e-4
PERM_N, PERM_EPOCHS = 8, 10
# CSP features go through two eigh calls in f32; the tangent features
# through eleven (the Karcher loop) and a matrix log.
CSP_FEATURE_TOL, TANGENT_FEATURE_TOL = 1e-4, 1e-4


def _ml_trainer(name, dev, loader, subjects, config, seed, lo=0, hi=None,
                cross=False):
    """The protocol's fold trainer of model ``name`` over ``subjects``
    (folds ``lo..hi-1``), as the protocols build it; ``(trainer,
    setup)``."""
    from eegnetreplication_tpu_torch.training import protocols as pr

    if cross:
        setup, _ = pr.cross_subject_setup(loader, subjects, config=config,
                                          seed=seed, device=dev,
                                          model_name=name)
    else:
        pool_x, pool_y, offsets = pr.build_pool(
            [loader(s, "Train").concat(loader(s, "Eval")) for s in subjects])
        model = pr._protocol_model(name, pool_x,
                                   config.dropout_within_subject, config)
        setup = pr.FoldSetup.build(model, pr.within_subject_folds(
            offsets, config), pool_x, pool_y, config=config, seed=seed,
            device=dev)
    return setup.trainer(lo, hi or setup.n_folds), setup


def _ml_rate(torch, trainer, epochs) -> float:
    """fold-epochs/s of ``trainer`` over ``epochs`` epochs after one
    warm-up epoch (host clock, ended by a synchronize)."""
    trainer.run_epoch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(epochs):
        trainer.run_epoch()
    torch.cuda.synchronize()
    return trainer.spec.n_folds * epochs / (time.perf_counter() - t0)


def _ml_mfu(torch, trainer, rate) -> dict:
    """GFLOP/s and MFU of ``rate`` fold-epochs/s of ``trainer``'s model
    (``utils/flops.py``: the minimal convolution whatever the schedule)."""
    from eegnetreplication_tpu_torch.utils import flops

    per_fe = flops.fold_epoch_flops(
        trainer.model, batch_size=trainer.batch_size,
        train_pad=trainer.spec.train_idx.shape[1],
        val_pad=trainer.spec.val_idx.shape[1])
    peak, label = flops.assumed_peak_flops(torch.cuda.get_device_name(0))
    return {"fold_epochs_per_s": rate, "fold_epoch_gflop": per_fe / 1e9,
            "gflops_per_s": rate * per_fe / 1e9,
            "mfu": None if peak is None else rate * per_fe / peak,
            "peak": label}


def _ml_history(torch, name, where, loader, config, scale=0.0):
    """Per-epoch ``(train_losses, val_losses)`` of fold 0..ML_CPU_FOLDS-1
    after CPU_EPOCHS epochs on ``where`` from seed 0, the trials scaled by
    ``1 + scale``."""
    from eegnetreplication_tpu_torch.data.containers import BCICI2ADataset

    def scaled(s, mode):
        ds = loader(s, mode)
        if not scale:
            return ds
        return BCICI2ADataset(X=(ds.X * (1 + scale)).astype(ds.X.dtype),
                              y=ds.y)

    trainer, _ = _ml_trainer(name, where, scaled, (1, 2), config, 0, 0,
                             ML_CPU_FOLDS)
    for _ in range(CPU_EPOCHS):
        trainer.run_epoch()
    return [t.cpu() for t in trainer.history_tensors()[:2]]


def _max_abs(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def _same_state(a, b) -> bool:
    """Two fold states' parameters and statistics equal bit for bit."""
    return bool((a.params == b.params).all()) \
        and bool((a.stats == b.stats).all())


def _ml_baseline_training(torch, np, dev, work: Path, env: dict,
                          data_root: Path) -> dict:
    """17a: both baselines through the train CLI (8 folds, in phase 8's
    tree), then in process: the card against the CPU at dropout 0, the
    separable pool, a bitwise repeat, and fold-epochs/s at 8 and 36
    folds; no K1 and no K1-stacked launch anywhere."""
    from eegnetreplication_tpu_torch.config import DEFAULT_TRAINING, Paths
    from eegnetreplication_tpu_torch.data.io import load_subject_dataset
    from eegnetreplication_tpu_torch.ops.fused_eegnet import (
        block1,
        block1_stacked,
    )
    from eegnetreplication_tpu_torch.training import checkpoint as ckpt_lib
    from eegnetreplication_tpu_torch.training.protocols import (
        within_subject_training,
    )

    out: dict = {}
    procs, logs, roots = {}, {}, {}
    t0 = time.perf_counter()
    for name in BASELINES:
        roots[name] = _replicated_tree(data_root, work / name, (1, 2))
        logs[name] = work / f"train_{name}.stderr.log"
        procs[name] = _spawn(
            [sys.executable, "-m", "eegnetreplication_tpu_torch.train",
             "--model", name, "--epochs", str(ML_EPOCHS), "--subjects",
             "1,2", "--metricsDir", str(work / f"obs_{name}")],
            dict(env, EEGTPU_DATA_ROOT=str(work / name)), logs[name])
    done = _wait_all(procs, logs, 900)
    cli_s = time.perf_counter() - t0
    for name in BASELINES:
        rc, err = done[name]
        check(rc == 0, f"train --model {name} exited {rc}:\n{err[-4000:]}")
        paths = roots[name]
        _check_report(paths.reports / "latest_within_subject_report.json",
                      WS_REPORT_KEYS, f"train --model {name}")
        files = sorted(p.name for p in paths.models.iterdir())
        check(files == ["subject_01_best_model.npz",
                        "subject_02_best_model.npz"],
              f"train --model {name} wrote {files}; want the two .npz and "
              "no .pth")
        for f in files:
            _, meta = ckpt_lib.load_checkpoint(paths.models / f)
            check(meta == {"model": name, "n_channels": 22,
                           "n_times": 257}, f"{f} metadata {meta}")
        events = _journal(np, work / f"obs_{name}", "ok")
        check(_epochs_journaled(events) == list(range(1, ML_EPOCHS + 1)),
              f"train --model {name}: the journal lacks an epoch event per "
              "epoch")
        launches = events[-1]["kernel_launches"]
        check(launches == {"block1": 0, "block1_stacked": 0},
              f"train --model {name} launched {launches}; a baseline runs "
              "no K1 and no K1-stacked")
        out[name] = {"checkpoints": [str(paths.models / f) for f in files],
                     "cli_kernel_launches": launches}
    log(f"train --model {', '.join(BASELINES)}: {ML_EPOCHS} epochs of 8 "
        f"folds each, at once, in {cli_s:.1f}s; JAX report keys, .npz with "
        "the JAX metadata and no .pth, clean journals, 0 K1 and 0 "
        "K1-stacked launches")
    out["cli_s"] = cli_s

    def loader(s, mode):
        return load_subject_dataset(s, mode, roots[BASELINES[0]])

    def sep_loader(s, mode):
        return separable_subject(np, (s - 1) % 2 + 1, mode)

    p0 = DEFAULT_TRAINING.replace(dropout_within_subject=0.0)
    block1.launches = block1_stacked.launches = 0
    cpu = torch.device("cpu")
    for name in BASELINES:
        row = out[name]
        # The card against the CPU at dropout 0 from one seed, on the
        # separable pool, where the fit is well conditioned.  On phase 8's
        # label-free tree the baselines memorize noise within two epochs,
        # and there the CPU against itself with its trials scaled by one
        # rounding step moves as far: that pair is reported, not gated.
        hist = [_ml_history(torch, name, where, sep_loader, p0)
                for where in (dev, cpu)]
        deltas = {}
        for i, series in enumerate(("train_losses", "val_losses")):
            a, b = hist[0][i], hist[1][i]
            check(bool(torch.isfinite(a).all()), f"{name}: card {series}")
            deltas[series] = float((a - b).abs().max())
            check(torch.allclose(a, b, atol=TRAIN_ATOL, rtol=TRAIN_RTOL),
                  f"{name}: card vs CPU {series} differ by "
                  f"{deltas[series]:.3e} (atol {TRAIN_ATOL}, rtol "
                  f"{TRAIN_RTOL})")
        row["card_vs_cpu_max_abs"] = deltas
        noise = [_ml_history(torch, name, where, loader, p0, scale)
                 for where, scale in ((dev, 0.0), (cpu, 0.0),
                                      (cpu, ML_SCALE))]
        row["label_free"] = {
            "card_vs_cpu_max_abs": _max_abs(noise[0], noise[1]),
            "cpu_vs_scaled_cpu_max_abs": _max_abs(noise[1], noise[2]),
            "train_losses": noise[1][0].tolist()}
        # the separable pool, and two card runs bitwise equal
        learn = within_subject_training(
            ML_LEARN_EPOCHS, loader=sep_loader, subjects=(1, 2), seed=1,
            save_models=False, model_name=name, device=dev,
            paths=Paths.from_root(work / f"learn_{name}"))
        check(learn.avg_test_acc > 50.0,
              f"{name}: separable pool test accuracy {learn.avg_test_acc:.2f}"
              f"% after {ML_LEARN_EPOCHS} epochs (chance 25%)")
        row["learn_test_acc"] = learn.avg_test_acc
        runs = [within_subject_training(
            2, loader=loader, subjects=(1, 2), seed=2, save_models=False,
            model_name=name, device=dev,
            paths=Paths.from_root(work / f"rep_{name}")) for _ in range(2)]
        check(_same_state(runs[0].folds.best_state, runs[1].folds.best_state)
              and bool((runs[0].folds.train_losses
                        == runs[1].folds.train_losses).all()),
              f"{name}: two card runs differ; they must repeat bit for bit")
        # fold-epochs/s, GFLOP/s and MFU at 8 and 36 folds
        row["times_by_folds"] = {}
        for n_folds, subjects in ((8, (1, 2)), (36, tuple(range(1, 10)))):
            trainer, _ = _ml_trainer(name, dev, sep_loader, subjects,
                                     DEFAULT_TRAINING, 3)
            check(trainer.spec.n_folds == n_folds, f"{trainer.spec.n_folds}")
            rate = _ml_rate(torch, trainer, ML_TIME_EPOCHS)
            row["times_by_folds"][n_folds] = _ml_mfu(torch, trainer, rate)
            del trainer
        t8, t36 = row["times_by_folds"][8], row["times_by_folds"][36]
        lf = row["label_free"]
        log(f"{name}: card vs CPU ({ML_CPU_FOLDS} fold x {CPU_EPOCHS} "
            f"epochs, dropout 0, separable pool) train "
            f"{deltas['train_losses']:.2e}, val {deltas['val_losses']:.2e}; "
            f"on phase 8's label-free tree (not gated) card vs CPU "
            f"{lf['card_vs_cpu_max_abs']:.2e}, CPU vs the CPU on trials "
            f"scaled by 1 + {ML_SCALE:g} {lf['cpu_vs_scaled_cpu_max_abs']:.2e}"
            f" (train losses {lf['train_losses']}); separable pool "
            f"{learn.avg_test_acc:.2f}% after {ML_LEARN_EPOCHS} epochs; two "
            f"runs bitwise equal; 8 folds {t8['fold_epochs_per_s']:.2f} "
            f"fold-epochs/s = {t8['gflops_per_s']:.1f} GFLOP/s = "
            f"{100 * (t8['mfu'] or 0):.3f}% MFU; 36 folds "
            f"{t36['fold_epochs_per_s']:.2f} fold-epochs/s = "
            f"{t36['gflops_per_s']:.1f} GFLOP/s = "
            f"{100 * (t36['mfu'] or 0):.3f}% MFU ({t36['peak']})")
    check(block1.launches == 0 and block1_stacked.launches == 0,
          f"the baselines' in-process runs launched K1 {block1.launches} "
          f"and K1-stacked {block1_stacked.launches} times; want 0")
    return out


def _ml_baseline_serving(torch, np, dev, work: Path, env: dict,
                         trained: dict) -> dict:
    """17b: each trained baseline through ``serve`` and ``predict`` (both
    baselines' servers and CLIs at once, started before the in-process
    checks), the card's logits against the CPU's, every bucket's graph
    replay against its eager forward, and int8 and the zoo as the JAX
    package serves a baseline: behind their gates."""
    from eegnetreplication_tpu_torch.data.containers import BCICI2ADataset
    from eegnetreplication_tpu_torch.data.io import save_trials
    from eegnetreplication_tpu_torch.predict import predict_trials
    from eegnetreplication_tpu_torch.serve.engine import (
        InferenceEngine,
        build_gated_engine,
        load_model_from_checkpoint,
    )
    from eegnetreplication_tpu_torch.serve.zoo import build_stacked_engine

    x = trials(torch, 45, 22, 257, 70).numpy()
    y = np.random.RandomState(71).randint(0, 4, size=45).astype(np.int64)
    trials_path = save_trials(BCICI2ADataset(X=x, y=y),
                              work / "A01E-trials.npz")
    out: dict = {name: {} for name in BASELINES}
    servers: dict = {}
    starters = {name: threading.Thread(
        target=lambda name=name: servers.__setitem__(name, _start_server(
            ["--checkpoint", trained[name]["checkpoints"][0]], work, env,
            name=f"serve_{name}")), daemon=True) for name in BASELINES}
    clis = {name: _spawn_predict(
        ["--checkpoint", trained[name]["checkpoints"][0], "--input",
         str(trials_path)], env, work, f"predict_{name}")
        for name in BASELINES}
    for th in starters.values():
        th.start()
    try:
        refs = {}
        for name in BASELINES:
            ckpts, row = trained[name]["checkpoints"], out[name]
            model = load_model_from_checkpoint(ckpts[0], device=dev)
            cpu_model = load_model_from_checkpoint(ckpts[0], device="cpu")
            with torch.inference_mode():
                got = model(torch.from_numpy(x).to(dev)).cpu()
                want = cpu_model(torch.from_numpy(x))
            row["logits_max_abs_err"] = float((got - want).abs().max())
            check(torch.allclose(got, want, atol=LOGITS_ATOL,
                                 rtol=LOGITS_RTOL),
                  f"{name}: card logits differ from the CPU's by "
                  f"{row['logits_max_abs_err']:.3e}")
            engine = InferenceEngine(model, device=dev)
            engine.warmup()
            for b in engine.buckets:
                xb = trials(torch, b, 22, 257, 72 + b).to(dev)
                with torch.inference_mode():
                    eager = engine.forward(xb).cpu()
                check(torch.equal(engine.graph_logits(xb).cpu(), eager),
                      f"{name}: bucket {b}'s graph replay differs from its "
                      "eager forward")
                check(engine.graph_stats()[b]["kernels"] == {},
                      f"{name}: bucket {b}'s graph holds hand kernels")
            refs[name] = predict_trials(model, x, device=dev)
            # int8: served when the gate passes, fp32 kept when it refuses
            int8, gate = build_gated_engine(model, precision="int8",
                                            device=dev)
            check(int8.precision == ("int8" if gate.passed else "fp32"),
                  f"{name}: gate {gate.outcome} but {int8.precision} "
                  "serves")
            # the zoo: both subjects' models stacked behind the stack gate
            members = [(f"s{i + 1}", load_model_from_checkpoint(
                p, device=dev)) for i, p in enumerate(ckpts)]
            stacked, zgate = build_stacked_engine(members, device=dev)
            check(zgate.passed and stacked is not None,
                  f"{name}: stack gate {zgate.outcome} ({zgate.per_tenant})")
            for z, (mid, m) in enumerate(members):
                check((stacked.infer(x, z) == predict_trials(
                    m, x, device=dev)).all(),
                      f"{name}: tenant {mid} answers otherwise stacked")
            row.update(int8_gate=gate.outcome, int8_agreement=gate.agreement,
                       int8_serves=int8.precision, zoo_gate=zgate.outcome)
        for name in BASELINES:
            starters[name].join(SERVE_START_TIMEOUT_S + 30)
            check(name in servers, f"the {name} server did not start")
            proc, url = servers[name][:2]
            status, reply = _post(url + "/predict", _npz_body(np, x),
                                  "application/octet-stream")
            check(status == 200, f"{name}: /predict answered {status}")
            served = np.asarray(reply["predictions"], np.int64)
            check(served.tobytes() == refs[name].tobytes(),
                  f"{name}: served predictions differ from predict's")
            status, health = _get(url + "/healthz")
            k = health["kernel_launches"]
            check(k["block1"] == 0 and k["block1_stacked"] == 0,
                  f"{name}: the server launched {k}")
            check(health["graph_replays"] == health["batches"] > 0,
                  f"{name}: {health['graph_replays']} replays for "
                  f"{health['batches']} forwards")
            out[name]["predict_line"] = _check_predict_cli(
                np, clis[name], work, f"predict_{name}", served, y,
                f"predict on {name}")
            proc.send_signal(signal.SIGTERM)
            check(proc.wait(timeout=120) == 75, f"{name}: server exit")
    finally:
        for th in starters.values():
            th.join(SERVE_START_TIMEOUT_S + 30)
        for proc in [srv[0] for srv in servers.values()] + list(
                clis.values()):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for srv in servers.values():
            srv[2].close()
    for name in BASELINES:
        row = out[name]
        log(f"{name}: card logits within {row['logits_max_abs_err']:.2e} "
            "of the CPU's; every bucket's graph replay bitwise its eager "
            "forward, no hand kernel; serve == predict byte for byte, "
            f"{row['predict_line']!r}; int8 gate {row['int8_gate']} "
            f"(agreement {row['int8_agreement']:.4f}) -> "
            f"{row['int8_serves']} serves; zoo of 2 stacked, gate "
            f"{row['zoo_gate']}")
    return out


def _banded_ops_on_card(torch, np, dev) -> dict:
    """Each banded op, forward and gradients, against the grouped-conv
    path on the card at T = 257 and T = 1125 (the stacked forward holds
    every op, the temporal conv tiled at 1125), and the depthwise op tiled
    past 512 outputs against the grouped convolution."""
    import torch.nn.functional as F

    from eegnetreplication_tpu_torch.models import EEGNet
    from eegnetreplication_tpu_torch.models.eegnet import stacked_forward
    from eegnetreplication_tpu_torch.ops import banded
    from eegnetreplication_tpu_torch.training.loop import init_fold_states

    errs = {}
    for t in (257, 1125):
        init = init_fold_states(EEGNet(22, t, device="cpu"), 8,
                                torch.Generator().manual_seed(80)).to(dev)
        x = trials(torch, 8 * 16, 22, t, 81).reshape(8, 16, 22, t).to(dev)
        res = {}
        for impl in ("lax", "banded"):
            params = {k: v.clone().requires_grad_(True)
                      for k, v in init.param_views().items()}
            logits, new = stacked_forward(params, init.stat_views(), x,
                                          train=True, conv_impl=impl)
            grads = torch.autograd.grad(logits.square().sum(),
                                        list(params.values()))
            res[impl] = (logits.detach(), new, grads)
        fwd = float((res["banded"][0] - res["lax"][0]).abs().max())
        check(torch.allclose(res["banded"][0], res["lax"][0],
                             atol=BANDED_FWD_TOL, rtol=BANDED_FWD_TOL),
              f"banded vs lax logits at T={t} differ by {fwd:.3e}")
        for k in res["lax"][1]:
            check(torch.allclose(res["banded"][1][k], res["lax"][1][k],
                                 atol=BANDED_FWD_TOL, rtol=BANDED_FWD_TOL),
                  f"banded vs lax {k} at T={t}")
        grad = 0.0
        for a, b in zip(res["banded"][2], res["lax"][2]):
            grad = max(grad, float((a - b).abs().max()))
            check(torch.allclose(a, b, atol=BANDED_GRAD_TOL,
                                 rtol=BANDED_GRAD_TOL),
                  f"banded vs lax gradients at T={t} differ by {grad:.3e}")
        errs[t] = {"logits": fwd, "grads": grad}
    # the tiled depthwise conv (T' past 512) against the grouped conv
    h = trials(torch, 16 * 600, 16, 1, 82).reshape(4, 4, 600, 16).to(dev)
    w = (0.25 * trials(torch, 4 * 16, 16, 1, 83)).reshape(4, 16, 1, 1, 16
                                                          ).to(dev)
    hb, wb = h.clone().requires_grad_(True), w.clone().requires_grad_(True)
    hl, wl = h.clone().requires_grad_(True), w.clone().requires_grad_(True)
    band = banded.depthwise_conv_banded(hb, wb)
    lax = torch.stack([F.conv2d(F.pad(hl[g].permute(0, 2, 1)[:, :, None],
                                      (7, 8)), wl[g], groups=16)[:, :, 0]
                       .transpose(1, 2) for g in range(4)])
    check(torch.allclose(band, lax, atol=BANDED_FWD_TOL,
                         rtol=BANDED_FWD_TOL), "tiled depthwise forward")
    cot = trials(torch, 16 * 600, 16, 1, 84).reshape(band.shape).to(dev)
    for a, b in zip(torch.autograd.grad(band, (hb, wb), cot),
                    torch.autograd.grad(lax, (hl, wl), cot)):
        check(torch.allclose(a, b, atol=BANDED_GRAD_TOL,
                             rtol=BANDED_GRAD_TOL), "tiled depthwise grads")
    errs["tiled_depthwise"] = float((band - lax).detach().abs().max())
    log(f"banded vs lax on the card: T=257 logits {errs[257]['logits']:.2e}"
        f" grads {errs[257]['grads']:.2e}; T=1125 (tiled) logits "
        f"{errs[1125]['logits']:.2e} grads {errs[1125]['grads']:.2e}; tiled "
        f"depthwise {errs['tiled_depthwise']:.2e}")
    return errs


def _conv_ab(torch, np, dev, work: Path) -> dict:
    """17c: fold-epochs/s of the two schedules at AB_EPOCHS' folds in
    AB_TURNS; one epoch of each under the profiler; the
    peak memory of each; K1-stacked launches under both; two banded runs
    bitwise equal."""
    from eegnetreplication_tpu_torch.config import DEFAULT_TRAINING, Paths
    from eegnetreplication_tpu_torch.ops.fused_eegnet import block1_stacked
    from eegnetreplication_tpu_torch.training.loop import n_steps
    from eegnetreplication_tpu_torch.training.protocols import (
        within_subject_training,
    )
    from eegnetreplication_tpu_torch.utils.profiling import breakdown

    def sep_loader(s, mode):
        return separable_subject(np, (s - 1) % 2 + 1, mode)

    def with_impl(impl, fn):
        old = os.environ.get("EEGTPU_CONV_IMPL")
        os.environ["EEGTPU_CONV_IMPL"] = impl
        try:
            return fn()
        finally:
            if old is None:
                os.environ.pop("EEGTPU_CONV_IMPL")
            else:
                os.environ["EEGTPU_CONV_IMPL"] = old

    subjects = tuple(range(1, 10))
    out: dict = {}
    for n_folds in AB_EPOCHS:
        cross = n_folds == 90
        trainers = {impl: with_impl(impl, lambda: _ml_trainer(
            "eegnet", dev, sep_loader, subjects, DEFAULT_TRAINING, 4,
            cross=cross)[0]) for impl in ("banded", "lax")}
        for impl, tr in trainers.items():
            check(tr.model.conv_impl == impl, f"{impl} trainer runs "
                  f"{tr.model.conv_impl}")
            check(tr.spec.n_folds == n_folds, f"{tr.spec.n_folds} folds")
        rates = {"banded": [], "lax": []}
        for impl in AB_TURNS:
            rates[impl].append(_ml_rate(torch, trainers[impl],
                                        AB_EPOCHS[n_folds]))
        row = {}
        for impl, tr in trainers.items():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            tr.run_epoch()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            prof = breakdown(tr.run_epoch, n_calls=1, top=6)
            mean = statistics.mean(rates[impl])
            row[impl] = {"rates": rates[impl], **_ml_mfu(torch, tr, mean),
                         "peak_memory_gib": peak, "epoch_profile": prof}
        row["banded_over_lax"] = (row["banded"]["fold_epochs_per_s"]
                                  / row["lax"]["fold_epochs_per_s"])
        out[n_folds] = row
        for impl in ("banded", "lax"):
            r, prof = row[impl], row[impl]["epoch_profile"]
            top = ", ".join(f"{k['name'][:40]} {k['ms']:.1f} ms"
                            for k in prof["top_device_ms_per_call"][:3])
            log(f"A/B {n_folds} folds, {impl}: {r['fold_epochs_per_s']:.2f} "
                f"fold-epochs/s (turns {', '.join(f'{v:.2f}' for v in r['rates'])}"
                f") = {100 * (r['mfu'] or 0):.3f}% MFU, peak "
                f"{r['peak_memory_gib']:.2f} GiB; one epoch: wall "
                f"{prof['wall_ms_per_call']:.1f} ms, idle share "
                f"{prof['device_idle_share']}, top: {top}")
        log(f"A/B {n_folds} folds: banded/lax = {row['banded_over_lax']:.3f}")
        del trainers
        torch.cuda.empty_cache()

    # K1-stacked launches under both schedules, and two banded runs
    kw = dict(loader=sep_loader, subjects=(1, 2), seed=5, save_models=False,
              device=dev, paths=Paths.from_root(work / "ab_runs"))
    n_sub = N_TRIALS * 2
    val_steps = n_steps(n_sub * 3 // 4 // 5, DEFAULT_TRAINING.batch_size, 1)
    test_steps = n_steps(n_sub // 4, DEFAULT_TRAINING.batch_size, 1)
    want = AB_LAUNCH_EPOCHS * val_steps + test_steps
    results = {}
    for run, impl in (("banded_1", "banded"), ("lax", "lax"),
                      ("banded_2", "banded")):
        block1_stacked.launches = 0
        results[run] = with_impl(impl, lambda: within_subject_training(
            AB_LAUNCH_EPOCHS, **kw))
        check(block1_stacked.launches == want,
              f"{impl}: K1-stacked launched {block1_stacked.launches} times; "
              f"want {AB_LAUNCH_EPOCHS} x {val_steps} + {test_steps}")
    a, b = results["banded_1"].folds, results["banded_2"].folds
    check(_same_state(a.best_state, b.best_state)
          and bool((a.train_losses == b.train_losses).all()),
          "two banded card runs differ; they must repeat bit for bit")
    out["k1_stacked_launches_each"] = want
    log(f"K1-stacked: {want} launches ({AB_LAUNCH_EPOCHS} x {val_steps} + "
        f"{test_steps}) under banded and lax; two banded runs bitwise equal")
    return out


def _permutation_and_classical(torch, np, dev) -> dict:
    """17d: the permutation test at the product width on the separable
    pool, twice; CSP+LDA and the tangent-space classifier on the card
    against the CPU."""
    from eegnetreplication_tpu_torch.models import csp, riemann
    from eegnetreplication_tpu_torch.training.permutation import (
        p_value,
        permutation_test,
    )

    ds = separable_subject(np, 1, "Train").concat(
        separable_subject(np, 1, "Eval"))
    t0 = time.perf_counter()
    runs = [permutation_test(ds.X, ds.y, n_permutations=PERM_N,
                             epochs=PERM_EPOCHS, seed=6, device=dev)
            for _ in range(2)]
    wall = (time.perf_counter() - t0) / 2
    r = runs[0]
    check(r.real_accuracy > r.mean_permuted,
          f"permutation test: real {r.real_accuracy:.2f}% is not above the "
          f"permuted mean {r.mean_permuted:.2f}%")
    check(r.p_value == p_value(r.real_accuracy, r.permuted_accuracies),
          "the p-value is not the estimator's")
    check(r.real_accuracy == runs[1].real_accuracy
          and np.array_equal(r.permuted_accuracies,
                             runs[1].permuted_accuracies)
          and bool((r.folds.train_losses
                    == runs[1].folds.train_losses).all()),
          "two permutation tests on the card differ")
    log(f"permutation test ({PERM_N} permutations x {PERM_EPOCHS} epochs, "
        f"one trainer of {PERM_N + 1} runs, {wall:.1f}s): real "
        f"{r.real_accuracy:.2f}% vs permuted mean {r.mean_permuted:.2f}%, "
        f"p = {r.p_value:.4f}; two runs bitwise equal")

    train = separable_subject(np, 2, "Train")
    test = separable_subject(np, 2, "Eval")
    xs = [torch.from_numpy(a) for a in (train.X, train.y, test.X)]
    out = {"permutation": {"real": r.real_accuracy,
                           "permuted": r.permuted_accuracies.tolist(),
                           "p_value": r.p_value, "wall_s": wall}}
    for name, fit in (("csp_lda", csp.csp_lda_fit_predict),
                      ("tangent_lda", riemann.tangent_lda_fit_predict)):
        want = fit(*xs)
        got = fit(*(a.to(dev) for a in xs))
        check(got.is_cuda and torch.equal(got.cpu(), want),
              f"{name}: card predictions differ from the CPU's")
        out[name] = {"accuracy": float((want.numpy() == test.y).mean())}
    filters = csp.csp_fit(xs[0], xs[1])
    feats = csp.csp_transform(xs[0], filters)
    feats_card = csp.csp_transform(xs[0].to(dev),
                                   csp.csp_fit(xs[0].to(dev), xs[1].to(dev)))
    covs = riemann.trial_covariances(xs[0])
    tangent = riemann.tangent_features(covs, riemann.riemannian_mean(covs))
    covs_c = riemann.trial_covariances(xs[0].to(dev))
    tangent_card = riemann.tangent_features(covs_c,
                                            riemann.riemannian_mean(covs_c))
    for name, a, b, tol in (("csp_features", feats_card, feats,
                             CSP_FEATURE_TOL),
                            ("tangent_features", tangent_card, tangent,
                             TANGENT_FEATURE_TOL)):
        err = float((a.cpu() - b).abs().max())
        check(torch.allclose(a.cpu(), b, atol=tol, rtol=tol),
              f"{name}: card vs CPU differ by {err:.3e} (tolerance {tol})")
        out[name + "_max_abs_err"] = err
    log(f"CSP+LDA {100 * out['csp_lda']['accuracy']:.1f}% and tangent+LDA "
        f"{100 * out['tangent_lda']['accuracy']:.1f}%: card predictions equal"
        f" the CPU's; features within {out['csp_features_max_abs_err']:.2e} "
        f"and {out['tangent_features_max_abs_err']:.2e}")
    return out


def phase_model_layer(torch, np, dev, work: Path, env: dict,
                      data_root: Path) -> dict:
    """Phase 17: the model layer (see the module docstring)."""
    t0 = time.perf_counter()
    work.mkdir(parents=True, exist_ok=True)
    out = {"training": _ml_baseline_training(torch, np, dev, work, env,
                                             data_root)}
    out["serving"] = _ml_baseline_serving(torch, np, dev, work, env,
                                          out["training"])
    out["banded_ops"] = _banded_ops_on_card(torch, np, dev)
    out["conv_ab"] = _conv_ab(torch, np, dev, work)
    out["permutation_classical"] = _permutation_and_classical(torch, np,
                                                              dev)
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 17 (the model layer): {out['wall_s']:.1f}s")
    return out


def _mfu_fields(row: dict, precision: str = "highest") -> dict:
    """GFLOP/s and MFU of a fold-epochs/s row at the product width, from
    the port's FLOP count (``utils/flops.py``) and the card's peak for the
    arithmetic of ``precision`` (FP32 under highest)."""
    from types import SimpleNamespace

    import torch

    from eegnetreplication_tpu_torch.config import DEFAULT_TRAINING
    from eegnetreplication_tpu_torch.utils import flops

    model = SimpleNamespace(n_channels=22, n_times=257, F1=8, D=2,
                            n_classes=4)
    batch = DEFAULT_TRAINING.batch_size
    per_fe = (row["train_steps"] * flops.train_step_flops(model, batch)
              + row["val_steps"] * flops.eval_step_flops(model, batch))
    rate = row["fold_epochs_per_s"] * per_fe
    peak, label = flops.assumed_peak_flops(torch.cuda.get_device_name(0),
                                           precision)
    return {"fold_epoch_gflop": per_fe / 1e9, "gflops_per_s": rate / 1e9,
            "mfu": None if peak is None else rate / peak, "peak": label}


# --------------------------------------------------------------------------
# Phase 18: the replica fleet
# --------------------------------------------------------------------------

FLEET_REPLICAS = 3
FLEET_LOAD_S = 2.0        # each scaling run (4 s before phase 21)
FLEET_SUBMITTERS = 12     # a replica's submitters; 3 replicas get 24
FLEET_CLIENTS = 8         # HTTP clients under the kill
FLEET_SESSION_S = 20      # the sticky live session, seconds of 250 Hz
FLEET_START_TIMEOUT_S = 240.0
GRAY_K = 5.0              # outlier ejection at 5x the fleet median
GRAY_COOLDOWN_S = 1.0
GRAY_SLOW = "serve.degrade:times=8:slow=0.3:if_tag=r1"
GRAY_CUT = "replica.network:every=6:times=0:if_tag=r2"
GRAY_CLIENTS = 12
GRAY_MAX_S = 40.0
SCALE_CLIENTS = 16
SCALE_MAX_S = 120.0
LATENCY_MASK = re.compile(rb'"latency_ms": [-+0-9.eE]+')


@contextlib.contextmanager
def _environ(**updates):
    """``os.environ`` with ``updates`` for the block: an in-process
    supervisor launches its children with this process's environment."""
    saved = {k: os.environ.get(k) for k in updates}
    os.environ.update(updates)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _post_raw(url, body: bytes, ctype: str, timeout=60.0) -> tuple[int,
                                                                   bytes]:
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


def _start_fleet(args: list, work: Path, env: dict, name: str):
    """``python -m eegnetreplication_tpu_torch.serve.fleet`` in a process
    group of its own (see :func:`_spawn_cli`)."""
    return _spawn_cli("eegnetreplication_tpu_torch.serve.fleet", args, work,
                      env, name, new_session=True)


def _fleet_run_dir(metrics_dir: Path) -> Path:
    (run_dir,) = _run_dirs(metrics_dir)
    return run_dir


def _launched_pids(events, child=None) -> list:
    return [e["pid"] for e in events if e["event"] == "supervisor_launch"
            and (child is None or e.get("child") == child)]


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def _stop_fleet(proc, metrics_dir: Path | None, stderr) -> int | None:
    """SIGTERM the fleet (it drains and forwards SIGTERM to its replicas),
    then make sure that nothing it started is left: its process group and
    every replica pid its journal launched."""
    rc = None
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=90)
        except subprocess.TimeoutExpired:
            pass
    else:
        rc = proc.returncode
    with contextlib.suppress(ProcessLookupError, PermissionError):
        os.killpg(proc.pid, signal.SIGKILL)
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    if metrics_dir is not None and metrics_dir.exists():
        for run_dir in _run_dirs(metrics_dir):
            with contextlib.suppress(Exception):
                for pid in _launched_pids(_events_of(run_dir)):
                    if _pid_alive(pid):
                        os.kill(pid, signal.SIGKILL)
    stderr.close()
    return rc


def _gpu_apps() -> list:
    """``[(pid, MiB)]``, one row per compute process on the card, as
    ``nvidia-smi --query-compute-apps=pid,used_memory`` lists them (in a
    container every pid may read as the container's own)."""
    smi = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,"
                          "used_memory", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    rows = []
    for line in smi.stdout.strip().splitlines():
        with contextlib.suppress(ValueError):
            pid, mib = (p.strip() for p in line.split(","))
            rows.append((int(pid), float(mib)))
    return rows


def _gpu_used_mib() -> float:
    """The card's used memory, all processes (``nvidia-smi``)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    return float(smi.stdout.strip().splitlines()[0])


def _pcts(np, lat) -> dict:
    lat = np.asarray(lat, np.float64)
    return {f"p{q}": float(np.percentile(lat, q)) if lat.size else None
            for q in (50, 95, 99)}


class _HttpLoad:
    """Closed-loop clients, each on its own kept-alive connection, posting
    ``bodies`` to ``url + path`` in turn until stopped; every answer that
    is not a 200 (and every transport error) is a failed request."""

    def __init__(self, url: str, bodies: list, clients: int,
                 ctype: str = "application/octet-stream"):
        self.parts = urllib.parse.urlsplit(url)
        self.bodies, self.ctype = bodies, ctype
        self.stop_evt = threading.Event()
        self.lock = threading.Lock()
        self.latencies: list = []
        self.failures: list = []
        self.threads = [threading.Thread(target=self._client, args=(i,),
                                         daemon=True)
                        for i in range(clients)]

    def _client(self, i: int) -> None:
        conn = None
        k = i
        while not self.stop_evt.is_set():
            body = self.bodies[k % len(self.bodies)]
            k += 1
            if conn is None:
                conn = http.client.HTTPConnection(
                    self.parts.hostname, self.parts.port, timeout=120)
            t0 = time.perf_counter()
            try:
                conn.request("POST", "/predict", body=body,
                             headers={"Content-Type": self.ctype})
                resp = conn.getresponse()
                data = resp.read()
            except (OSError, http.client.HTTPException) as exc:
                conn.close()
                conn = None
                with self.lock:
                    self.failures.append(f"{type(exc).__name__}: {exc}")
                continue
            dt = (time.perf_counter() - t0) * 1000.0
            with self.lock:
                if resp.status == 200:
                    self.latencies.append(dt)
                else:
                    self.failures.append(f"http {resp.status}: "
                                         f"{data[:200]!r}")
        if conn is not None:
            conn.close()

    def start(self) -> "_HttpLoad":
        self.t0 = time.perf_counter()
        for th in self.threads:
            th.start()
        return self

    def stop(self, np) -> dict:
        self.stop_evt.set()
        for th in self.threads:
            th.join(180)
        wall = time.perf_counter() - self.t0
        return {"requests": len(self.latencies) + len(self.failures),
                "ok": len(self.latencies), "failed": len(self.failures),
                "failure_samples": self.failures[:3], "wall_s": wall,
                "rps": len(self.latencies) / wall,
                "latency_ms": _pcts(np, self.latencies)}


def _router_load(np, router, bodies: list, submitters: int,
                 seconds: float) -> dict:
    """The JAX fleet bench's saturating load through ``router.dispatch``:
    ``submitters`` threads, each sending its next request as soon as the
    last is answered, for ``seconds``; 429 is pacing (retried), anything
    else that is not a 200 is a failure."""
    from eegnetreplication_tpu_torch.serve.fleet.router import (
        AllReplicasBusy,
        NoLiveReplicas,
    )

    lock = threading.Lock()
    lat, failures = [], []
    deadline = time.perf_counter() + seconds

    def submitter(i):
        k = i
        while time.perf_counter() < deadline:
            body = bodies[k % len(bodies)]
            k += 1
            t0 = time.perf_counter()
            while True:
                try:
                    status, _, _ = router.dispatch(
                        body, "application/octet-stream")
                except AllReplicasBusy:
                    time.sleep(0.001)
                    continue
                except (NoLiveReplicas, Exception) as exc:  # noqa: BLE001
                    status = f"{type(exc).__name__}: {exc}"
                if status != 429:
                    break
                time.sleep(0.001)
            with lock:
                if status == 200:
                    lat.append((time.perf_counter() - t0) * 1000.0)
                else:
                    failures.append(str(status))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=submitter, args=(i,), daemon=True)
               for i in range(submitters)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(seconds + 120)
    wall = time.perf_counter() - t0
    return {"submitters": submitters, "ok": len(lat),
            "failed": len(failures), "failure_samples": failures[:3],
            "wall_s": wall, "rps": len(lat) / wall,
            "latency_ms": _pcts(np, lat)}


def _replica_healths(fleet_url: str, members: str = "replicas",
                     key: str = "replica") -> dict:
    """``{member id: its own /healthz}`` (with its ``url`` and ``state``)
    for every member the fleet's ``/healthz`` lists (a cell front's:
    ``members="cells", key="cell"``)."""
    status, health = _get(fleet_url + "/healthz")
    check(status == 200, f"{fleet_url}/healthz answered {status}: {health}")
    out = {}
    for row in health[members]:
        s, h = _get(row["url"] + "/healthz")
        check(s == 200, f"{row[key]} /healthz answered {s}")
        out[row[key]] = dict(h, url=row["url"], state=row["state"])
    return out


def _fleet_boot(torch, np, dev, work: Path, env: dict, ckpt: Path,
                x128, y128, trials_path: Path) -> tuple:
    """18a: the fleet CLI over three replicas, its answers against the
    predict CLI's and the plain CPU forward, each replica's K1 count, and
    one sticky live session."""
    metrics = work / "fleet_obs"
    t0 = time.perf_counter()
    predict_cli = _spawn_predict(["--checkpoint", str(ckpt), "--input",
                                  str(trials_path)], env, work, "fleet_predict")
    fleet = _start_fleet(
        ["--checkpoint", str(ckpt), "--replicas", str(FLEET_REPLICAS),
         "--metricsDir", str(metrics), "--sessionsDir", str(work / "sess"),
         "--traceSample", "0", "--startupTimeoutS",
         str(FLEET_START_TIMEOUT_S)], work, env, "fleet")
    proc, lines, stderr, log_path = fleet
    try:
        url, engine, row = _fleet_checks(
            torch, np, dev, work, ckpt, x128, y128, fleet, predict_cli, t0)
    except BaseException:
        _stop_fleet(proc, metrics, stderr)
        raise
    finally:
        if predict_cli.poll() is None:
            predict_cli.kill()
            predict_cli.wait()
    return fleet, url, metrics, engine, row


def _fleet_checks(torch, np, dev, work: Path, ckpt: Path, x128, y128,
                  fleet, predict_cli, t0: float) -> tuple:
    from eegnetreplication_tpu_torch.predict import predict_trials
    from eegnetreplication_tpu_torch.serve.engine import (
        InferenceEngine,
        load_model_from_checkpoint,
    )

    url = _await_url(fleet, "fleet serving at ", FLEET_START_TIMEOUT_S + 60)
    boot_s = time.perf_counter() - t0
    status, health = _get(url + "/healthz")
    model = load_model_from_checkpoint(ckpt, device="cpu")
    with torch.no_grad():
        want_logits = model.eval()(torch.from_numpy(x128)).numpy()
    engine = InferenceEngine.from_checkpoint(ckpt, device=dev)
    check(status == 200 and health["n_live"] == FLEET_REPLICAS
          and health["serving_digests"] == [engine.digest],
          f"fleet /healthz after boot: {health}")
    log(f"phase 18a: fleet of {FLEET_REPLICAS} up at {url} in "
        f"{boot_s:.1f}s, one digest")

    # Answers: the fleet's bytes are a replica's (but latency_ms); the
    # predictions are predict_trials' and the predict CLI's, the argmax of
    # card logits within atol/rtol of the plain CPU forward.
    ref128 = predict_trials(load_model_from_checkpoint(ckpt, device=dev),
                            x128, device=dev)
    replica_url = health["replicas"][0]["url"]
    answers = {}
    for n in (1, 128):
        body = _npz_body(np, x128[:n])
        s_fleet, b_fleet = _post_raw(url + "/predict", body,
                                     "application/octet-stream")
        s_rep, b_rep = _post_raw(replica_url + "/predict", body,
                                 "application/octet-stream")
        check(s_fleet == s_rep == 200, f"/predict {n}: {s_fleet} {s_rep}")
        check(LATENCY_MASK.sub(b"", b_fleet) == LATENCY_MASK.sub(b"", b_rep),
              f"/predict at {n} trials: the fleet's bytes differ from a "
              "replica's beyond latency_ms")
        reply = json.loads(b_fleet)
        check(reply["predictions"] == ref128[:n].tolist(),
              f"/predict at {n} trials differs from predict_trials")
        check(reply["model_digest"] == engine.digest, "digest differs")
        answers[n] = reply["predictions"]
    cli_line = _check_predict_cli(np, predict_cli, work, "fleet_predict",
                                  answers[128], y128,
                                  "predict CLI beside the fleet")
    with torch.inference_mode():
        got_logits = engine.forward(torch.from_numpy(x128).to(dev)).cpu()
    got_logits = got_logits.numpy()
    err = float(np.max(np.abs(got_logits - want_logits)))
    check(np.allclose(got_logits, want_logits, atol=LOGITS_ATOL,
                      rtol=LOGITS_RTOL), f"card logits vs the CPU forward: "
          f"max abs err {err:.3e}")
    check((want_logits.argmax(-1) == np.asarray(answers[128])).all(),
          "the fleet's predictions are not the CPU forward's argmax")
    log(f"phase 18a: /predict at 1 and 128 trials through the fleet "
        f"byte-equal to a replica's (but latency_ms), equal to "
        f"predict_trials and the predict CLI ({cli_line}); card logits vs "
        f"CPU max abs err {err:.3e}")

    # The sticky live session, 20 s of a 250 Hz headset.
    x_s = stream_recording(np, 1801, n=FLEET_SESSION_S * STREAM_HZ)
    before = _replica_healths(url)
    run = _stream_client(np, url, "fleet-s1", x_s)
    during = _replica_healths(url)
    homes = [rid for rid, h in during.items() if h["sessions"] == 1]
    check(len(homes) == 1 and sum(h["sessions"] for h in during.values())
          == 1, f"the session is held by {homes}")
    home = homes[0]
    preds, _, _ = _offline(torch, np, engine, x_s, dev)
    decs = run["decisions"]
    check([d["pred"] for d in decs] == preds.tolist()
          and all(d["status"] == "ok" for d in decs),
          "the fleet session's decisions differ from the offline pipeline")
    ems = (during[home]["kernel_launches"]["ems_stream"]
           - before[home]["kernel_launches"]["ems_stream"])
    check(ems == run["seeded_pushes"], f"ems_stream launched {ems} times "
          f"on {home}; {run['seeded_pushes']} pushes ran the carry")
    status, closed = _post(f"{url}/session/fleet-s1/close", b"{}",
                           "application/json")
    check(status == 200 and closed["preds"] == preds.tolist(),
          f"session close through the fleet: {status}")

    # Every replica's K1 launches: its warm runs plus its graph replays.
    k1 = {}
    for rid, h in _replica_healths(url).items():
        launches = h["kernel_launches"]["block1"]
        want = len(h["buckets"]) + h["graph_replays"]
        check(launches > 0 and launches == want, f"{rid}: K1 launches "
              f"{launches} != {len(h['buckets'])} warm + "
              f"{h['graph_replays']} replays")
        k1[rid] = launches
    log(f"phase 18a: one {FLEET_SESSION_S} s session on {home} "
        f"({len(decs)} windows equal to the offline pipeline, {ems} "
        f"ems_stream launches = pushes from the seed on); K1 launches per "
        f"replica {k1} = warm runs + replays")
    row = {"boot_s": boot_s, "logits_max_abs_err": err,
           "k1_launches": k1, "session": {"replica": home,
                                          "windows": len(decs),
                                          "ems_stream_launches": ems,
                                          "pushes": len(run["push_ms"])}}
    return url, engine, row


def _fleet_scaling(np, url: str, x128, work: Path) -> dict:
    """18b: the saturating load through an in-process FleetRouter over one
    of the fleet's replicas, then over all three; the card's memory per
    replica."""
    from eegnetreplication_tpu_torch.obs import journal as obs_journal
    from eegnetreplication_tpu_torch.serve.fleet import membership as ms
    from eegnetreplication_tpu_torch.serve.fleet.router import FleetRouter

    status, health = _get(url + "/healthz")
    bodies = [_npz_body(np, x128[i:i + 1]) for i in range(16)]
    with obs_journal.run(work / "scaling_obs", config={}) as jr:
        replicas = [ms.Replica(r["replica"], r["url"], journal=jr)
                    for r in health["replicas"]]
        membership = ms.FleetMembership(replicas, journal=jr)
        membership.poll_once()
        router = FleetRouter(membership, journal=jr)
        try:
            for r in replicas[1:]:
                membership.set_state(r, ms.CANARY, "scaling_park")
            _router_load(np, router, bodies, FLEET_SUBMITTERS, 1.0)
            one = _router_load(np, router, bodies, FLEET_SUBMITTERS,
                               FLEET_LOAD_S)
            for r in replicas[1:]:
                membership.set_state(r, ms.LIVE, "scaling_unpark")
            three = _router_load(np, router, bodies,
                                 FLEET_SUBMITTERS * FLEET_REPLICAS,
                                 FLEET_LOAD_S)
        finally:
            membership.close()
            router.close()
    check(one["failed"] == 0 and three["failed"] == 0,
          f"scaling runs failed requests: {one['failure_samples']} "
          f"{three['failure_samples']}")
    linear = three["rps"] / (FLEET_REPLICAS * one["rps"])
    log(f"phase 18b: FleetRouter over 1 replica {one['rps']:.1f} req/s "
        f"(p50/p95/p99 " + "/".join(f"{one['latency_ms'][k]:.2f}" for k in
                                   ("p50", "p95", "p99"))
        + f" ms), over {FLEET_REPLICAS} {three['rps']:.1f} req/s (p50/p95/"
        "p99 " + "/".join(f"{three['latency_ms'][k]:.2f}" for k in
                          ("p50", "p95", "p99"))
        + f" ms): linear_fraction {linear:.3f}")
    return {"one": one, "three": three, "linear_fraction": linear}


def _fleet_kill(np, url: str, metrics: Path, x128) -> dict:
    """18c: SIGKILL one replica under load; no request fails, the member
    goes out, the supervisor relaunches it on its port, it rejoins."""
    victim = "r2"
    run_dir = _fleet_run_dir(metrics)
    pid = _launched_pids(_events_of(run_dir), victim)[-1]
    bodies = [_npz_body(np, x128[i:i + 1]) for i in range(16)]
    load = _HttpLoad(url, bodies, FLEET_CLIENTS).start()
    try:
        time.sleep(1.5)
        t_kill = time.time()
        os.kill(pid, signal.SIGKILL)

        def rejoined():
            evs = _events_of(run_dir)
            return any(e["event"] == "fleet_member"
                       and e.get("replica") == victim
                       and e.get("reason") == "rejoined" for e in evs)

        _wait_for(rejoined, 180, f"{victim} to rejoin after SIGKILL")
        time.sleep(1.0)
    finally:
        result = load.stop(np)
    check(result["failed"] == 0, f"{result['failed']} requests failed "
          f"across the kill: {result['failure_samples']}")
    events = _events_of(run_dir)

    def first(pred):
        return next(i for i, e in enumerate(events) if pred(e))

    i_out = first(lambda e: e["event"] == "fleet_member"
                  and e.get("replica") == victim and e["state"] == "out"
                  and e["t"] >= t_kill)
    i_launch = first(lambda e: e["event"] == "supervisor_launch"
                     and e.get("child") == victim and e["attempt"] == 2)
    i_live = first(lambda e: e["event"] == "fleet_member"
                   and e.get("replica") == victim
                   and e.get("reason") == "rejoined")
    check(i_out < i_launch < i_live, "the journal's order is not out -> "
          f"relaunch -> rejoined ({i_out}, {i_launch}, {i_live})")
    port = urllib.parse.urlsplit(
        [r for r in _get(url + "/healthz")[1]["replicas"]
         if r["replica"] == victim][0]["url"]).port
    cmd = events[i_launch]["cmd"]
    check(cmd[cmd.index("--port") + 1] == str(port),
          f"the relaunch of {victim} is not on its port {port}")
    row = {"victim": victim, "load": result,
           "kill_to_out_s": events[i_out]["t"] - t_kill,
           "kill_to_relaunch_s": events[i_launch]["t"] - t_kill,
           "relaunch_to_live_s": events[i_live]["t"] - events[i_launch]["t"],
           "reason_out": events[i_out]["reason"]}
    log(f"phase 18c: SIGKILL {victim} under {FLEET_CLIENTS} clients: "
        f"{result['ok']} answered, 0 failed; out after "
        f"{row['kill_to_out_s']:.2f}s ({row['reason_out']}), relaunched on "
        f"port {port} after {row['kill_to_relaunch_s']:.2f}s, live "
        f"{row['relaunch_to_live_s']:.2f}s after the relaunch")
    return row


def _fleet_reload(torch, np, dev, url: str, metrics: Path, x128, engine,
                  ckpt_b: Path, work: Path) -> dict:
    """18d: a second checkpoint rolled through the fleet under load (every
    answer the old model's or the new one's), then a corrupt push that
    fails at the canary."""
    from eegnetreplication_tpu_torch.predict import predict_trials
    from eegnetreplication_tpu_torch.serve.engine import (
        InferenceEngine,
        load_model_from_checkpoint,
    )

    digest_b = InferenceEngine.from_checkpoint(ckpt_b, (1,),
                                               device=dev).digest
    result, answers = _reload_under_load(
        np, url, _npz_body(np, x128[:8]), {}, {"checkpoint": str(ckpt_b)},
        "the fleet's rolling reload")
    check(result["status"] == "converged"
          and result["new_digest"] == digest_b,
          f"rolling reload answered {result}")
    new_want = predict_trials(load_model_from_checkpoint(ckpt_b, device=dev),
                              x128, device=dev)
    olds = engine.infer(x128[:8]).tolist()
    check(all(a["predictions"] in (olds, new_want[:8].tolist())
              for _, a in answers), "an answer during the roll is neither "
          "the old model's nor the new one's")
    digests = {rid: h["variables_digest"]
               for rid, h in _replica_healths(url).items()}
    check(set(digests.values()) == {digest_b}, f"digests after the roll: "
          f"{digests}")
    events = _events_of(_fleet_run_dir(metrics))
    kinds = [e["event"] for e in events]
    check("fleet_canary" in kinds and "fleet_shadow" in kinds
          and any(e["event"] == "fleet_reload" and e["status"] == "converged"
                  for e in events), "the journal lacks the canary, the "
          "shadow compare or fleet_reload(converged)")
    status, reply = _post_raw(url + "/predict", _npz_body(np, x128),
                              "application/octet-stream")
    check(status == 200 and json.loads(reply)["predictions"]
          == new_want.tolist(), "after the roll the fleet does not answer "
          "as the new checkpoint")
    corrupt = work / "corrupt.npz"
    corrupt.write_bytes(Path(ckpt_b).read_bytes()[:400])
    status, failed = _post(url + "/reload", json.dumps(
        {"checkpoint": str(corrupt)}).encode(), "application/json",
        timeout=600)
    check(status == 409 and failed["status"] == "failed"
          and failed["stage"] == "canary_reload",
          f"the corrupt push answered {status}: {failed}")
    time.sleep(1.0)
    after = {rid: h["variables_digest"]
             for rid, h in _replica_healths(url).items()}
    check(set(after.values()) == {digest_b}, f"the corrupt push moved a "
          f"digest: {after}")
    log(f"phase 18d: rolled to {digest_b[:12]} under {RELOAD_CLIENTS} "
        f"clients in {result['wall_s']:.2f}s (shadow {result['shadow']}), "
        f"{len(answers)} answered, each the old or the new model's, 0 "
        "failed; the corrupt push failed at the canary and every replica "
        "kept the new digest")
    return {"reload_s": result["wall_s"], "shadow": result["shadow"],
            "answers": len(answers), "corrupt_stage": failed["stage"]}


class _GrayFleet:
    """18e's fleet, in process: ``spawn_replica_fleet(per_replica_args=...)``
    under a ``MultiSupervisor`` thread and a ``FleetApp``; r1 slowed by
    ``serve.degrade`` until the fault runs out, r2 cutting every 6th reply
    with ``replica.network``.  It boots beside 18a's fleet and drills after
    18d."""

    def __init__(self, work: Path, env: dict, ckpt: Path):
        from eegnetreplication_tpu_torch.obs import journal as obs_journal
        from eegnetreplication_tpu_torch.serve.fleet import (
            service as fleet_svc,
        )

        per_replica = {
            f"r{i}": ["--sessionsDir", str(work / "gray_sess" / f"r{i}")]
            for i in range(FLEET_REPLICAS)}
        per_replica["r1"] += ["--chaosTag", "r1", "--chaos", GRAY_SLOW]
        per_replica["r2"] += ["--chaosTag", "r2", "--chaos", GRAY_CUT]
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(_environ(
            PYTHONPATH=env["PYTHONPATH"],
            EEGTPU_DATA_ROOT=env["EEGTPU_DATA_ROOT"]))
        self.jr = self._stack.enter_context(obs_journal.run(
            work / "gray_obs", config={}, role="fleet"))
        self.sup, replicas = fleet_svc.spawn_replica_fleet(
            str(ckpt), FLEET_REPLICAS, run_dir=self.jr.dir,
            serve_args=["--traceSample", "1.0"],
            per_replica_args=per_replica, journal=self.jr)
        self._thread = threading.Thread(target=self.sup.run, daemon=True)
        self._thread.start()
        self.app = fleet_svc.FleetApp(replicas, str(ckpt), trace_sample=1.0,
                                      outlier_k=GRAY_K,
                                      outlier_cooldown_s=GRAY_COOLDOWN_S,
                                      hedge_budget=0.05, journal=self.jr)
        self.app.membership.start()
        self._closed = False

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self.app.stop()
            self.sup.stop()
            self._thread.join(120)
        finally:
            for child in self.sup.children.values():
                if child.pid is not None and _pid_alive(child.pid):
                    os.kill(child.pid, signal.SIGKILL)
            self._stack.close()

    def drill(self, np, x128) -> dict:
        """18e: ejection then readmission of r1, hedges, failovers off r2
        with no failed request, router -> replica trace trees."""
        from eegnetreplication_tpu_torch.obs import trace

        app, jr = self.app, self.jr
        check(app.membership.wait_live(FLEET_REPLICAS,
                                       FLEET_START_TIMEOUT_S),
              "the gray fleet's replicas did not all go live")
        app.start()
        bodies = [_npz_body(np, x128[i:i + 1]) for i in range(16)]
        t0 = time.perf_counter()
        load = _HttpLoad(app.url, bodies, GRAY_CLIENTS).start()
        try:
            _wait_for(lambda: (app.outlier.n_readmitted >= 1
                               and app.router.n_failovers >= 1),
                      GRAY_MAX_S, "r1's ejection and readmission and a "
                      "failover off r2")
        finally:
            result = load.stop(np)
        drill_s = time.perf_counter() - t0
        hedges = (app.router.n_hedges, app.router.n_hedge_wins)
        self.close()
        check(result["failed"] == 0, f"{result['failed']} requests failed "
              f"in the gray drill: {result['failure_samples']}")
        events = _events_of(jr.dir)
        order = [(e["event"], e.get("replica")) for e in events
                 if e["event"] in ("replica_ejected", "replica_readmitted")]
        check(order[:2] == [("replica_ejected", "r1"),
                            ("replica_readmitted", "r1")],
              f"ejection journal: {order}")
        cuts = [e for e in events if e["event"] == "fleet_retry"
                and e["replica"] == "r2"]
        check(cuts and all(e["reason"].startswith("IncompleteRead")
                           for e in cuts),
              f"fleet_retry off r2: {[e['reason'] for e in cuts]}")
        spans = trace.read_spans([jr.dir,
                                  *_run_dirs(jr.dir / "replica_obs")])
        trees = trace.build_traces(spans)
        by_id = {sp["span_id"]: sp for sp in spans}
        replica_reqs = 0
        for tid, tree in trees.items():
            check([r["name"] for r in tree.roots] == ["router.request"],
                  f"trace {tid}: roots {[r['name'] for r in tree.roots]}")
            for sp in tree.spans:
                if sp["name"] == "replica.request":
                    parent = by_id.get(sp.get("parent_span_id"))
                    check(parent is not None
                          and parent["run_id"] == jr.run_id
                          and parent["name"] in ("router.dispatch",
                                                 "router.retry"),
                          f"trace {tid}: replica.request's parent {parent}")
                    replica_reqs += 1
        check(replica_reqs >= result["ok"], f"{replica_reqs} "
              f"replica.request spans for {result['ok']} answers")
        ejected = next(e for e in events if e["event"] == "replica_ejected")
        readmit = next(e for e in events
                       if e["event"] == "replica_readmitted")
        row = {"load": result, "drill_s": drill_s,
               "hedges_fired": hedges[0], "hedges_won": hedges[1],
               "failovers_r2": len(cuts),
               "ejected_to_readmitted_s": readmit["t"] - ejected["t"],
               "ejected_p95_ms": ejected["p95_ms"],
               "fleet_p50_ms": ejected["fleet_p50_ms"],
               "traces": len(trees), "replica_spans": replica_reqs}
        log(f"phase 18e: r1 ejected (p95 {ejected['p95_ms']:.1f} ms vs "
            f"fleet p50 {ejected['fleet_p50_ms']:.2f} ms) and readmitted "
            f"{row['ejected_to_readmitted_s']:.2f}s later; hedges fired "
            f"{hedges[0]}, won {hedges[1]}; {len(cuts)} cut replies off r2 "
            f"failed over; {result['ok']} answered, 0 failed; "
            f"{len(trees)} traces, every one rooted at router.request with "
            f"{replica_reqs} replica.request spans parented in the router")
        return row


def _scale_up(np, url: str, proc, load: "_HttpLoad", t_load: float
              ) -> dict:
    """18f's load step (started before 18c, so that the autoscaler's
    spawn and 18c's relaunch start at once): a scale-up, the new replica
    live, no failed request."""
    try:
        def scaled():
            h = _get(url + "/healthz")[1]
            return h["scale"]["ups"] >= 1 and h["n_live"] == 2

        _wait_for(scaled, SCALE_MAX_S, "a scale-up and the new replica "
                  "live", procs=(proc,))
        up_s = time.perf_counter() - t_load
    finally:
        result = load.stop(np)
    check(result["failed"] == 0, f"{result['failed']} requests failed in "
          f"the load step: {result['failure_samples']}")
    return {"load": result, "load_to_up_live_s": up_s}


def _scale_down(url: str, proc, metrics: Path, rows_base: int,
                row: dict) -> dict:
    """18f with the load off: down -> drained -> the member's out in the
    journal, and the retired child gone from the card (its process ended,
    and once every other fleet of the phase has stopped, the card's
    compute processes are the smoke's own and the one replica left)."""
    t_off = time.perf_counter()
    _wait_for(lambda: _get(url + "/healthz")[1]["n_replicas"] == 1,
              SCALE_MAX_S, "the scale-down to one replica", procs=(proc,))
    down_s = time.perf_counter() - t_off
    events = _events_of(_fleet_run_dir(metrics))
    scales = [e for e in events if e["event"] == "fleet_scale"]
    down = next(e for e in scales if e["action"] == "down")
    victim = down["replica"]
    idx = {id(e): i for i, e in enumerate(events)}
    drained = next(e for e in scales if e["action"] == "drained"
                   and e["replica"] == victim)
    out = next(e for e in events if e["event"] == "fleet_member"
               and e.get("replica") == victim and e["state"] == "out")
    check(idx[id(down)] < idx[id(drained)] < idx[id(out)]
          and out["reason"] == "retired", "the journal's order is not "
          f"down -> drained -> out(retired) for {victim}")
    pids = _launched_pids(events, victim)
    _wait_for(lambda: (len(_gpu_apps()) == rows_base + 1
                       and not any(_pid_alive(p) for p in pids)), 60,
              f"the retired {victim} to leave the card's compute processes")
    up = next(e for e in scales if e["action"] == "up")
    joined = next(e for e in events if e["event"] == "fleet_member"
                  and e.get("replica") == victim and e["state"] == "live")
    row.update({"off_to_one_replica_s": down_s, "up_reason": up["reason"],
                "spawn_to_live_s": joined["t"] - up["t"],
                "down_reason": down["reason"],
                "drained_waited_s": drained["waited_s"]})
    log(f"phase 18f: autoscale up ({up['reason']}) and {victim} live "
        f"{row['spawn_to_live_s']:.2f}s after the decision; with the load "
        f"off, down ({down['reason']}) -> drained -> out(retired); "
        f"{victim}'s process left the card; {row['load']['ok']} answered, "
        "0 failed")
    return row


def _boot_breakdown(run_dir: Path) -> dict:
    """Where a replica's start goes, from the fleet's journal and each
    replica's own: launch -> ``run_start`` (interpreter, imports, device
    selection), -> the first ``compile_begin`` (checkpoint, model on the
    card), -> the last ``compile_end`` (warm runs and graph captures),
    -> ``serve_start``, -> the fleet's ``fleet_member`` joined (the health
    poll).  One row per replica's first launch."""
    events = _events_of(run_dir)
    launch, port = {}, {}
    for e in events:
        if e["event"] == "supervisor_launch" and e["child"] not in launch:
            launch[e["child"]] = e["t"]
            port[str(e["cmd"][e["cmd"].index("--port") + 1])] = e["child"]
    joined = {}
    for e in events:
        if e["event"] == "fleet_member" and e.get("reason") == "joined":
            joined.setdefault(e["replica"], e["t"])
    rows = {}
    for d in _run_dirs(run_dir / "replica_obs"):
        ev = _events_of(d)
        child = port.get(str(ev[0]["config"].get("port")))
        if child is None or child in rows:
            continue
        t = {k: [e["t"] for e in ev if e["event"] == k]
             for k in ("compile_begin", "compile_end", "serve_start")}
        if not all(t.values()):
            continue
        rows[child] = {
            "launch_to_run_start_s": ev[0]["t"] - launch[child],
            "to_first_capture_s": t["compile_begin"][0] - ev[0]["t"],
            "warm_and_capture_s": t["compile_end"][-1]
            - t["compile_begin"][0],
            "to_serve_start_s": t["serve_start"][0] - t["compile_end"][-1],
            "to_joined_s": (joined[child] - t["serve_start"][0]
                            if child in joined else None),
            "total_s": (joined.get(child, t["serve_start"][0])
                        - launch[child])}
    return rows


def phase_fleet(torch, np, dev, work: Path, env: dict) -> dict:
    """Phase 18: the replica fleet on the card (see the module docstring).
    Its three fleets (18a's CLI over three replicas, 18e's in process, 18f's
    autoscaling CLI) boot at once; 18f's load step runs beside 18c and 18d,
    and its scale-down beside 18e."""
    from eegnetreplication_tpu_torch.data.containers import BCICI2ADataset
    from eegnetreplication_tpu_torch.data.io import save_trials

    t_phase = time.perf_counter()
    env = dict(env, EEGTPU_DATA_ROOT=str(work / "root"))
    ckpt_a = _save_seeded(torch, work / "fleet_a.npz", seed=1811)
    ckpt_b = _save_seeded(torch, work / "fleet_b.npz", seed=1812)
    x128 = trials(torch, 128, 22, 257, 1813).numpy()
    y128 = np.random.RandomState(1814).randint(0, 4, size=128).astype(
        np.int64)
    trials_path = save_trials(BCICI2ADataset(X=x128, y=y128),
                              work / "A01E-trials.npz")
    bodies = [_npz_body(np, x128[i:i + 1]) for i in range(16)]
    used_before = _gpu_used_mib()
    rows_base = len(_gpu_apps())
    result: dict = {}
    scale_metrics = work / "scale_obs"
    scale = _start_fleet(
        ["--checkpoint", str(ckpt_a), "--replicas", "1", "--autoscale",
         "--autoscaleMin", "1", "--autoscaleMax", "2",
         "--autoscaleIntervalS", "0.25", "--autoscaleUpCooldownS", "1",
         "--autoscaleDownCooldownS", "2", "--autoscaleDrainTimeoutS", "15",
         "--metricsDir", str(scale_metrics), "--startupTimeoutS",
         str(FLEET_START_TIMEOUT_S)], work, env, "autoscale")
    gray = scale_load = None
    try:
        gray = _GrayFleet(work, env, ckpt_a)
        fleet, url, metrics, engine, result["boot"] = _fleet_boot(
            torch, np, dev, work, env, ckpt_a, x128, y128, trials_path)
        proc, _, stderr, _ = fleet
        try:
            # Every replica of the three fleets live: the card's memory.
            check(gray.app.membership.wait_live(FLEET_REPLICAS,
                                                FLEET_START_TIMEOUT_S),
                  "the gray fleet's replicas did not all go live")
            scale_url = _await_url(scale, "fleet serving at ",
                                   FLEET_START_TIMEOUT_S)
            n_replicas = 2 * FLEET_REPLICAS + 1
            rows = _gpu_apps()
            used = _gpu_used_mib()
            result["memory"] = {
                "used_before_mib": used_before, "used_mib": used,
                "per_replica_mib": (used - used_before) / n_replicas,
                "compute_rows_before": rows_base, "compute_rows": rows,
                "replicas": n_replicas}
            result["boot"]["breakdown"] = _boot_breakdown(
                _fleet_run_dir(metrics))
            log(f"phase 18: {n_replicas} replicas of three fleets live; "
                f"card memory {used_before:.0f} -> {used:.0f} MiB, "
                f"{result['memory']['per_replica_mib']:.0f} MiB a replica; "
                f"nvidia-smi compute rows {rows}; 18a's starts "
                f"{result['boot']['breakdown']}")
            result["scaling"] = _fleet_scaling(np, url, x128, work)
            scale_load = _HttpLoad(scale_url, bodies, SCALE_CLIENTS).start()
            t_load = time.perf_counter()
            result["kill"] = _fleet_kill(np, url, metrics, x128)
            result["reload"] = _fleet_reload(torch, np, dev, url, metrics,
                                             x128, engine, ckpt_b, work)
            result["autoscale"] = _scale_up(np, scale_url, scale[0],
                                            scale_load, t_load)
        finally:
            if scale_load is not None and not scale_load.stop_evt.is_set():
                scale_load.stop(np)
            rc = _stop_fleet(proc, metrics, stderr)
        check(rc == 75, f"the fleet exited {rc} after SIGTERM, want 75")
        events = _events_of(_fleet_run_dir(metrics), complete=True)
        ends = [e for e in events if e["event"] == "supervisor_end"]
        check(ends and ends[-1]["status"] == "stopped",
              f"supervisor_end: {ends}")
        log("phase 18: SIGTERM -> the fleet drained its replicas, exit 75")
        result["gray"] = gray.drill(np, x128)
        result["autoscale"] = _scale_down(scale_url, scale[0], scale_metrics,
                                          rows_base, result["autoscale"])
    finally:
        if gray is not None:
            gray.close()
        rc = _stop_fleet(scale[0], scale_metrics, scale[2])
    check(rc == 75, f"the autoscaling fleet exited {rc}, want 75")
    result["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 18 in {result['wall_s']:.1f} s")
    return result


# Phase 19: the cell tier.  Two cells (each one port serve process on the
# card) behind an HA pair of fronts; a paced 250 Hz session and bulk
# clients through every leg.
CELLS = 2
CELLS_TTL_S = 3.0         # the fencing lease; the active renews every 1 s
CELLS_CLIENTS = 8         # bulk clients under the kill, upgrade, failover
CELLS_SESSION_S = 8       # 19b's and 19c's sessions, paced at 250 Hz
CELLS_ACT_AT = 50         # the push (of 25 samples) at which 19b drains
                          # and 19c kills: 1250 samples, past the seed
CELLS_LONG_S = 150        # 19d-e's session: room to outlast both legs
CELLS_AFTER_PROMOTION_S = 3.0
CELLS_STEADY_S = 3.0      # 19a's load through the front, both cells live
CELLS_SNAPSHOT_EVERY = 8  # windows between a cell's spool snapshots
CELLS_START_TIMEOUT_S = 240.0
CELLS_LIVE_TIMEOUT_S = 240.0
CELLS_BIAS_SHIFT = 1.0    # checkpoint B: A with every classifier bias + 1
CELLS_AGREE_FLOOR = 0.8   # the upgrader's shadow floor (not lowered)


def _save_shifted(torch, path: Path, seed: int, shift: float) -> Path:
    """:func:`_save_seeded`'s model with ``shift`` added to all four
    classifier biases: another digest, the same argmax."""
    from eegnetreplication_tpu_torch.training import checkpoint as ckpt_lib

    model = seeded_model(torch, 22, 257, 8, 2, seed, "cpu")
    with torch.no_grad():
        model.classifier.bias.add_(shift)
    return ckpt_lib.save_checkpoint(
        path, model.state_dict(),
        metadata={"model": "eegnet", "n_channels": 22, "n_times": 257,
                  "F1": 8, "D": 2})


def _reply(url, method="GET", body=None, ctype="application/json",
           headers=None, timeout=30.0) -> tuple[int, dict]:
    """``(status, JSON reply)`` of any answer; a transport error raises
    (``OSError``)."""
    req = urllib.request.Request(url, data=body, method=method, headers={
        "Content-Type": ctype, **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            data = resp.read()
            status = resp.status
    except urllib.error.HTTPError as exc:
        data, status = exc.read(), exc.code
    try:
        return status, json.loads(data.decode() or "{}")
    except ValueError:
        return status, {}


def _active_front(fronts: list, current: str | None = None) -> str | None:
    """The front of the pair whose ``/healthz`` reports the active role
    (``current`` asked first)."""
    for url in ([current] if current else []) + [
            f for f in fronts if f != current]:
        try:
            status, health = _reply(url + "/healthz", timeout=2.0)
        except OSError:
            continue
        if status == 200 and health.get("role") == "active":
            return url
    return None


class _CellSession:
    """One paced 250 Hz session through the cell fronts, the phase-13d
    client grown for the cell tier: every push attempt carries its own
    sampled trace id (``X-Trace-Id: <sid>-<k>``) so each cell's journal
    names the pushes it ran; a 409 ``{"resume": true}``, a dead front or a
    lost session is answered by reading the acked cursor and replaying from
    it (unpaced up to where the stream had been); a 503 from the front for
    a dead cell retries the push; a standby's 503 or a dead front is
    followed to the pair's active front.  Decisions delivered twice must
    agree (a conflict otherwise)."""

    def __init__(self, np, fronts: list, sid: str, x, on_push=None,
                 stop: threading.Event | None = None):
        self.np, self.fronts, self.sid, self.x = np, list(fronts), sid, x
        self.base = fronts[0]
        self.on_push, self.stop = on_push, stop
        self.open_body = json.dumps(dict(STREAM_OPEN, session=sid)).encode()
        self.attempts: dict[str, tuple[int, int]] = {}
        self.by_window: dict[int, dict] = {}
        self.conflicts: list = []
        self.codes: dict[str, int] = {}
        self.switches = 0
        self.pos = self.high = self.pushes = 0
        self._t0 = self._sent0 = None
        self.home = None
        self.error: BaseException | None = None

    def _count(self, key) -> None:
        self.codes[str(key)] = self.codes.get(str(key), 0) + 1

    def _follow_leader(self, deadline: float) -> None:
        while time.monotonic() < deadline:
            url = _active_front(self.fronts, self.base)
            if url is not None:
                if url != self.base:
                    self.base = url
                    self.switches += 1
                return
            time.sleep(0.1)
        raise SmokeFailure(f"session {self.sid}: no active front")

    def _resync(self, deadline: float) -> int:
        """The acked cursor (a state read, which also ends a failed-over
        session's resync latch), re-opening a session the cells lost.

        A push whose reply was lost (its front killed after the cell had
        ingested it) leaves the cursor past ``self.pos``: the windows it
        decided are taken from the state's ``decisions_tail``, the record
        the cell keeps of what it decided, and held to what was already
        delivered like any re-delivery."""
        while time.monotonic() < deadline:
            try:
                status, state = _reply(
                    f"{self.base}/session/{self.sid}/state")
                if status == 404:
                    status, state = _reply(self.base + "/session/open",
                                           "POST", self.open_body)
            except OSError:
                self._follow_leader(deadline)
                continue
            if status == 200:
                self._count(f"resync_{status}")
                self._t0 = None     # pacing restarts where new samples do
                acked = int(state["acked"])
                if acked > self.pos:
                    self._count("resync_ahead")
                self._add(state.get("decisions_tail", []))
                return acked
            if "role" in state:
                self._follow_leader(deadline)
            else:
                time.sleep(0.1)
        raise SmokeFailure(f"session {self.sid}: no acked cursor")

    def open(self) -> "_CellSession":
        status, opened = _reply(self.base + "/session/open", "POST",
                                self.open_body)
        check(status == 200 and opened["acked"] == 0,
              f"/session/open {self.sid} through the front: {status} "
              f"{opened}")
        self.home = opened["cell"]
        return self

    def _add(self, decisions) -> None:
        for d in decisions:
            prev = self.by_window.get(d["window"])
            if prev is not None and prev["status"] == d["status"] == "ok" \
                    and prev["pred"] != d["pred"]:
                self.conflicts.append((d["window"], prev, d))
            self.by_window[d["window"]] = d

    def run(self) -> "_CellSession":
        np, x = self.np, self.x
        while self.pos < x.shape[1] and not (
                self.stop is not None and self.stop.is_set()):
            piece = np.ascontiguousarray(x[:, self.pos:self.pos
                                           + STREAM_CHUNK]).astype("<f4")
            if self.pos >= self.high:       # pace new samples, not replays
                if self._t0 is None:
                    self._t0, self._sent0 = time.perf_counter(), self.pos
                delay = (self._t0 + (self.pos + piece.shape[1]
                                     - self._sent0) / STREAM_HZ
                         - time.perf_counter())
                if delay > 0:
                    time.sleep(delay)
            tid = f"{self.sid}-{len(self.attempts):06d}"
            self.attempts[tid] = (self.pos, piece.shape[1])
            deadline = time.monotonic() + 120.0
            try:
                status, reply = _reply(
                    f"{self.base}/session/{self.sid}/samples", "POST",
                    piece.tobytes(), "application/octet-stream",
                    headers={"X-Trace-Id": tid, "X-Trace-Sampled": "1"})
            except OSError:
                self._count("transport")
                self._follow_leader(deadline)
                self.pos = self._resync(deadline)
                continue
            self._count(status)
            if status == 200:
                self._add(reply["decisions"])
                self.pos += piece.shape[1]
                self.high = max(self.high, self.pos)
                self.pushes += 1
                if self.on_push is not None:
                    self.on_push(self)
            elif status == 409 and reply.get("resume"):
                self.pos = self._resync(deadline)
            elif status == 503 and "role" in reply:
                self._follow_leader(deadline)
                self.pos = self._resync(deadline)
            elif status == 503:
                time.sleep(0.1)              # the front fails the cell over
            elif status == 404:
                self.pos = self._resync(deadline)
            else:
                raise SmokeFailure(f"session {self.sid} push at {self.pos}:"
                                   f" {status} {reply}")
        return self

    def run_in_thread(self) -> threading.Thread:
        def target():
            try:
                self.run()
            except Exception as exc:  # noqa: BLE001 — raised by close()
                self.error = exc

        th = threading.Thread(target=target, daemon=True)
        th.start()
        return th

    def close(self, torch, engine, dev) -> dict:
        """Close through the active front; the stream against the offline
        pipeline over what was pushed."""
        if self.error is not None:
            raise self.error
        deadline = time.monotonic() + 120.0
        while True:
            try:
                status, closed = _reply(
                    f"{self.base}/session/{self.sid}/close", "POST", b"{}")
            except OSError:
                self._follow_leader(deadline)
                continue
            if status == 503 and time.monotonic() < deadline:
                if "role" in closed:
                    self._follow_leader(deadline)
                else:
                    time.sleep(0.1)
                continue
            break
        check(status == 200, f"close of {self.sid}: {status} {closed}")
        preds, _, _ = _offline(torch, self.np, engine, self.x[:, :self.pos],
                               dev)
        n = len(preds)
        got = [self.by_window.get(w, {"pred": None})["pred"]
               for w in range(n)]
        expired = sum(1 for d in self.by_window.values()
                      if d["status"] == "expired")
        check(not self.conflicts, f"{self.sid}: {len(self.conflicts)} "
              f"re-delivered decisions conflict: {self.conflicts[:2]}")
        check(expired == 0, f"{self.sid}: {expired} windows expired")
        want = preds.tolist()
        missing = [w for w in range(n) if got[w] is None]
        wrong = [w for w in range(n)
                 if got[w] is not None and got[w] != want[w]]
        closed_wrong = [w for w, p in enumerate(closed["preds"][:n])
                        if p != want[w]]
        check(got == want and closed["preds"] == want,
              f"{self.sid}: the decision stream differs from the offline "
              f"pipeline: never delivered {missing[:8]}, delivered but "
              f"different {wrong[:8]}; the close's {len(closed['preds'])} "
              f"preds for {n} windows differ at {closed_wrong[:8]}; "
              f"codes {self.codes}")
        return {"pushes": self.pushes, "attempts": len(self.attempts),
                "samples": self.pos, "windows": n, "codes": self.codes,
                "leader_switches": self.switches, "expired": expired}

    def seeded(self, tid: str) -> bool:
        """Whether attempt ``tid`` ran the EMS carry (K2s) on its cell: a
        push launches it once the session has seen the seed block."""
        pos, n = self.attempts[tid]
        return n > 0 and pos + n >= STREAM_BLOCK


class _LeaderLoad(_HttpLoad):
    """:class:`_HttpLoad` across an HA pair: a request that meets a dead
    front, a standby's 503 or any other 503 or 429 is sent again to the
    active front within 60 s (each attempt given 15 s); the most leader
    switches one request needed is ``max_switches``."""

    def __init__(self, fronts: list, bodies: list, clients: int):
        super().__init__(fronts[0], bodies, clients)
        self.fronts = list(fronts)
        self.current = fronts[0]
        self.max_switches = 0
        self.switches = 0

    def _client(self, i: int) -> None:
        k = i
        while not self.stop_evt.is_set():
            body = self.bodies[k % len(self.bodies)]
            k += 1
            t0 = time.perf_counter()
            deadline = time.monotonic() + 60.0
            mine, switched, ok, last = self.current, 0, False, None
            while time.monotonic() < deadline:
                url = self.current
                if url != mine:
                    mine, switched = url, switched + 1
                t_try = time.perf_counter()
                try:
                    status, _ = _post_raw(url + "/predict", body, self.ctype,
                                          timeout=15.0)
                except (OSError, http.client.HTTPException) as exc:
                    status = None
                    last = (f"{type(exc).__name__} after "
                            f"{time.perf_counter() - t_try:.1f}s")
                if status == 200:
                    ok = True
                    break
                if status not in (None, 429, 503):
                    break
                leader = _active_front(self.fronts, url)
                with self.lock:
                    if leader is not None and leader != self.current:
                        self.current = leader
                        self.switches += 1
                time.sleep(0.05)
            dt = (time.perf_counter() - t0) * 1000.0
            with self.lock:
                self.max_switches = max(self.max_switches, switched)
                if ok:
                    self.latencies.append(dt)
                else:
                    self.failures.append(f"{status} ({last}) after "
                                         f"{switched} switches")

    def stop(self, np) -> dict:
        return dict(super().stop(np), leader_switches=self.switches,
                    max_switches=self.max_switches)


def _cells_healthz(front: str) -> dict:
    return _replica_healths(front, members="cells", key="cell")


def _cell_processes(run_dir: Path) -> dict:
    """``{cell id: [its launches' run directories, oldest first]}`` under
    the front's run directory (each cell journals under
    ``<cell>_obs/<run>``)."""
    out = {}
    for i in range(CELLS):
        runs = _run_dirs(run_dir / f"c{i}_obs")
        out[f"c{i}"] = sorted(runs, key=lambda d: _events_of(d)[0]["t"])
    return out


def _pushes_ran(events, sessions: list) -> tuple[int, int]:
    """(pushes, K2s-running pushes) a cell process journaled: its
    ``session.samples`` spans, each named by the trace id of the push
    attempt that sent it."""
    by_tid = {}
    for s in sessions:
        for tid in s.attempts:
            by_tid[tid] = s
    n = seeded = 0
    for e in events:
        if e["event"] == "span" and e.get("name") == "session.samples":
            s = by_tid.get(e["trace_id"])
            check(s is not None, f"a session.samples span of an unknown "
                  f"push {e['trace_id']}")
            n += 1
            seeded += s.seeded(e["trace_id"])
    return n, seeded


def _cells_boot(torch, np, dev, work: Path, env: dict, ckpt: Path, x128,
                y128, trials_path: Path, boot: dict) -> None:
    """19a: f0 over two cells and the HA directory, active; f1 attached as
    the standby; answers byte for byte a cell's, equal to the predict CLI
    and the plain CPU forward's argmax; every cell's K1 count."""
    from eegnetreplication_tpu_torch.predict import predict_trials
    from eegnetreplication_tpu_torch.serve.engine import (
        InferenceEngine,
        load_model_from_checkpoint,
    )

    t0 = time.perf_counter()
    predict_cli = _spawn_predict(["--checkpoint", str(ckpt), "--input",
                                  str(trials_path)], env, work,
                                 "cells_predict")
    ha_dir = work / "ha"
    f0 = _spawn_cli("eegnetreplication_tpu_torch.serve.cells", [
        "--checkpoint", str(ckpt), "--cells", str(CELLS), "--ha",
        str(ha_dir), "--haOwner", "f0", "--haTtlS", str(CELLS_TTL_S),
        "--cellsDir", str(work / "cells"), "--metricsDir",
        str(work / "f0_obs"), "--traceSample", "0",
        "--sessionSnapshotEvery", str(CELLS_SNAPSHOT_EVERY),
        "--startupTimeoutS", str(CELLS_START_TIMEOUT_S)], work, env, "f0",
        new_session=True)
    boot["f0"] = f0
    try:
        url0 = _await_url(f0, "cells serving at ", CELLS_START_TIMEOUT_S
                          + 60)
        boot_s = time.perf_counter() - t0
        status, health = _get(url0 + "/healthz")
        engine = InferenceEngine.from_checkpoint(ckpt, device=dev)
        check(status == 200 and health["role"] == "active"
              and health["n_live"] == CELLS
              and {c["digest"] for c in health["cells"]} == {engine.digest},
              f"f0 /healthz after boot: {health}")
        attach = ",".join(f"{c['cell']}|{c['url']}|{c['spool']}"
                          for c in health["cells"])
        f1 = _spawn_cli("eegnetreplication_tpu_torch.serve.cells", [
            "--attachCells", attach, "--ha", str(ha_dir), "--haOwner", "f1",
            "--haTtlS", str(CELLS_TTL_S), "--metricsDir",
            str(work / "f1_obs"), "--traceSample", "0"], work, env, "f1")
        boot["f1"] = f1
        log(f"phase 19a: f0 at {url0} active over {CELLS} cells in "
            f"{boot_s:.1f}s, one digest; f1 starting beside it")

        ref = predict_trials(load_model_from_checkpoint(ckpt, device=dev),
                             x128, device=dev)
        cells = _cells_healthz(url0)
        cell_url = cells["c0"]["url"]
        answers = {}
        for n in (1, 128):
            body = _npz_body(np, x128[:n])
            s_front, b_front = _post_raw(url0 + "/predict", body,
                                         "application/octet-stream")
            s_cell, b_cell = _post_raw(cell_url + "/predict", body,
                                       "application/octet-stream")
            check(s_front == s_cell == 200, f"/predict {n}: {s_front} "
                  f"{s_cell}")
            check(LATENCY_MASK.sub(b"", b_front)
                  == LATENCY_MASK.sub(b"", b_cell), f"/predict at {n} "
                  "trials: the front's bytes differ from a cell's beyond "
                  "latency_ms")
            reply = json.loads(b_front)
            check(reply["predictions"] == ref[:n].tolist()
                  and reply["model_digest"] == engine.digest,
                  f"/predict at {n} trials differs from predict_trials")
            answers[n] = reply["predictions"]
        cli_line = _check_predict_cli(np, predict_cli, work, "cells_predict",
                                      answers[128], y128,
                                      "predict CLI beside the cells")
        model = load_model_from_checkpoint(ckpt, device="cpu")
        with torch.no_grad():
            want = model.eval()(torch.from_numpy(x128)).numpy()
        with torch.inference_mode():
            got = engine.forward(torch.from_numpy(x128).to(dev)).cpu()
        got = got.numpy()
        err = float(np.max(np.abs(got - want)))
        check(np.allclose(got, want, atol=LOGITS_ATOL, rtol=LOGITS_RTOL)
              and (want.argmax(-1) == np.asarray(answers[128])).all(),
              f"card logits vs the CPU forward: max abs err {err:.3e}")
        # The front's steady rate over two live cells, before any fault.
        load = _HttpLoad(url0, [_npz_body(np, x128[i:i + 1])
                                for i in range(16)], CELLS_CLIENTS).start()
        time.sleep(CELLS_STEADY_S)
        steady = load.stop(np)
        check(steady["failed"] == 0, f"{steady['failed']} requests failed "
              f"through the front: {steady['failure_samples']}")
        k1 = {}
        for cid, h in _cells_healthz(url0).items():
            launches = h["kernel_launches"]["block1"]
            want_k1 = len(h["buckets"]) + h["graph_replays"]
            check(launches > 0 and launches == want_k1, f"{cid}: K1 "
                  f"launches {launches} != {len(h['buckets'])} warm + "
                  f"{h['graph_replays']} replays")
            k1[cid] = launches
        log(f"phase 19a: /predict at 1 and 128 trials through f0 byte-equal"
            f" to a cell's (but latency_ms), equal to predict_trials and "
            f"the predict CLI ({cli_line}); card logits vs CPU max abs err "
            f"{err:.3e}; {CELLS_CLIENTS} clients of 1 trial through f0 over "
            f"both cells {steady['rps']:.1f} req/s (p50/p95/p99 "
            + "/".join(f"{steady['latency_ms'][q]:.2f}"
                       for q in ("p50", "p95", "p99"))
            + f" ms); K1 launches per cell {k1} = warm runs + replays")
        boot.update(url0=url0, engine=engine,
                    result={"boot_s": boot_s, "logits_max_abs_err": err,
                            "steady": steady, "k1_launches": k1})
    finally:
        if predict_cli.poll() is None:
            predict_cli.kill()
            predict_cli.wait()


def _cells_standby(boot: dict) -> None:
    """f1, started in 19a, parks as the standby behind f0 (it boots while
    19a-c run: nothing before 19d needs it)."""
    url1 = _await_url(boot["f1"], "cells serving at ", 120)
    status, h1 = _get(url1 + "/healthz")
    check(status == 200 and h1["role"] == "standby"
          and h1["leader"] == boot["url0"], f"f1 /healthz: {h1}")
    boot["url1"] = url1
    log(f"phase 19a: f1 at {url1} standing by behind f0")


def _cells_migration(torch, np, dev, boot: dict, sessions: list) -> dict:
    """19b: a paced session drained off its home mid-stream."""
    url0, engine = boot["url0"], boot["engine"]
    x = stream_recording(np, 1901, n=CELLS_SESSION_S * STREAM_HZ)
    marks = {}

    def on_push(s):
        if s.pushes == CELLS_ACT_AT:
            marks["tid"] = len(s.attempts)
            t0 = time.perf_counter()
            status, result = _post(f"{url0}/cell/{s.home}/drain", b"{}",
                                   "application/json", timeout=120)
            marks["drain_ms"] = (time.perf_counter() - t0) * 1000.0
            check(status == 200 and result["migrated"] == [s.sid],
                  f"drain of {s.home}: {status} {result}")

    s = _CellSession(np, [url0], "s1", x, on_push=on_push).open()
    sessions.append(s)
    s.run()
    row = s.close(torch, engine, dev)
    home = s.home
    other = next(f"c{i}" for i in range(CELLS) if f"c{i}" != home)
    run_dir = _fleet_run_dir(boot["work"] / "f0_obs")
    events = _events_of(run_dir)
    migrated = [e for e in events if e["event"] == "session_migrate"
                and e["session"] == "s1"]
    check(len(migrated) == 1 and migrated[0]["from_cell"] == home
          and migrated[0]["to_cell"] == other,
          f"session_migrate of s1: {migrated}")
    after = {f"s1-{k:06d}" for k in range(marks["tid"], len(s.attempts))}
    runs = _cell_processes(run_dir)
    on_home = {e["trace_id"] for e in _events_of(runs[home][-1])
               if e["event"] == "span" and e.get("name") == "session.samples"}
    on_other = {e["trace_id"] for e in _events_of(runs[other][-1])
                if e["event"] == "span"
                and e.get("name") == "session.samples"}
    check(after <= on_other and not after & on_home,
          "the pushes after the drain did not all run on the other cell")
    status, undrained = _post(f"{url0}/cell/{home}/undrain", b"{}",
                              "application/json")
    check(status == 200, f"undrain of {home}: {status} {undrained}")
    _wait_for(lambda: _get(url0 + "/healthz")[1]["n_live"] == CELLS, 60,
              f"{home} live again after the undrain")
    row.update(home=home, to=other, drain_ms=marks["drain_ms"],
               pushes_after_drain=len(after))
    log(f"phase 19b: s1 ({row['windows']} windows, paced 250 Hz) drained "
        f"{home} -> {other} at push {CELLS_ACT_AT} in "
        f"{marks['drain_ms']:.1f} ms; session_migrate journaled; 0 "
        f"windows expired; equal to the offline pipeline; the "
        f"{len(after)} later pushes ran on {other}; {home} undrained")
    return row


def _cells_kill(torch, np, dev, boot: dict, sessions: list, bodies,
                kills: dict) -> dict:
    """19c: SIGKILL the cell holding a session under bulk load; failover
    through the spool, 409, replay; the supervisor's relaunch rejoins."""
    url0, engine, work = boot["url0"], boot["engine"], boot["work"]
    run_dir = _fleet_run_dir(work / "f0_obs")
    x = stream_recording(np, 1902, n=CELLS_SESSION_S * STREAM_HZ)
    mark = {}

    def on_push(s):
        if s.pushes == CELLS_ACT_AT:
            victim = s.home
            pid = _launched_pids(_events_of(run_dir), victim)[-1]
            cell_url = _cells_healthz(url0)[victim]["url"]
            for _ in range(50):
                # Under the bulk load a replay can land between the two
                # counters of one /healthz: read until they agree.
                status, health = _get(cell_url + "/healthz")
                if health["kernel_launches"]["block1"] == len(
                        health["buckets"]) + health["graph_replays"]:
                    break
            check(status == 200, f"{victim} /healthz before the kill")
            kills[victim] = {"health": health,
                             "run_dir": _cell_processes(run_dir)[victim][-1]}
            mark.update(victim=victim, pid=pid, t_kill=time.time())
            os.kill(pid, signal.SIGKILL)

    load = _HttpLoad(url0, bodies, CELLS_CLIENTS).start()
    try:
        s = _CellSession(np, [url0], "s2", x, on_push=on_push).open()
        sessions.append(s)
        s.run()
        row = s.close(torch, engine, dev)
        victim, t_kill = mark["victim"], mark["t_kill"]

        def rejoined():
            return any(e["event"] == "cell_member" and e["cell"] == victim
                       and e["reason"] == "rejoined" and e["t"] > t_kill
                       for e in _events_of(run_dir))

        _wait_for(rejoined, 240, f"{victim} to rejoin after SIGKILL")
        # The front's breaker for the victim (not the cell's own): open
        # if the kill failed enough dispatches, and then still in its
        # cooldown, which outlasts the relaunch.  19d's upgrade starts at
        # once; the upgrader waits for a dispatchable cell itself.
        status, health = _get(url0 + "/healthz")
        breaker = next(c["circuit"] for c in health["cells"]
                       if c["cell"] == victim)
    finally:
        bulk = load.stop(np)
    check(bulk["failed"] == 0, f"{bulk['failed']} bulk requests failed "
          f"across the cell kill: {bulk['failure_samples']}")
    check(row["codes"].get("409", 0) >= 1, f"s2 never got the 409 resume "
          f"handshake: {row['codes']}")
    events = _events_of(run_dir)

    def first(pred):
        return next(i for i, e in enumerate(events) if pred(e))

    i_failed = first(lambda e: e["event"] == "cell_member"
                     and e["cell"] == victim and e["state"] == "failed"
                     and e["t"] >= t_kill)
    i_failover = first(lambda e: e["event"] == "session_failover"
                       and e["session"] == "s2")
    i_launch = first(lambda e: e["event"] == "supervisor_launch"
                     and e.get("child") == victim and e["attempt"] == 2)
    i_live = first(lambda e: e["event"] == "cell_member"
                   and e["cell"] == victim and e["reason"] == "rejoined"
                   and e["t"] >= t_kill)
    failover = events[i_failover]
    check(i_failed < i_failover, "the journal has session_failover before "
          "cell_member(failed)")
    check(failover["from_cell"] == victim and failover["restored"],
          f"session_failover: {failover}")
    cmd = events[i_launch]["cmd"]
    port = urllib.parse.urlsplit(
        _cells_healthz(url0)[victim]["url"]).port
    check("--resume" in cmd and cmd[cmd.index("--port") + 1] == str(port),
          f"the relaunch of {victim} is not on its port with --resume")
    row.update(victim=victim, bulk=bulk,
               kill_to_failed_s=events[i_failed]["t"] - t_kill,
               kill_to_failover_s=failover["t"] - t_kill,
               restored_acked=failover.get("acked"),
               kill_to_relaunch_s=events[i_launch]["t"] - t_kill,
               relaunch_to_live_s=events[i_live]["t"]
               - events[i_launch]["t"],
               breaker_at_rejoin=breaker)
    log(f"phase 19c: SIGKILL {victim} (pid {mark['pid']}) holding s2 under "
        f"{CELLS_CLIENTS} clients: {bulk['ok']} answered, 0 failed "
        f"({bulk['rps']:.1f} req/s, p95 {bulk['latency_ms']['p95']:.2f} "
        f"ms); failed after {row['kill_to_failed_s']:.2f}s, "
        f"session_failover (spool, acked {failover.get('acked')}) after "
        f"{row['kill_to_failover_s']:.2f}s; s2 saw {row['codes']} and "
        "replayed to a stream equal to the offline one; relaunched with "
        f"--resume after {row['kill_to_relaunch_s']:.2f}s, live "
        f"{row['relaunch_to_live_s']:.2f}s later; the front's breaker for "
        f"it {breaker} at the rejoin")
    return row


def _cells_upgrade_and_failover(torch, np, dev, boot: dict, sessions: list,
                                bodies, ckpt_b: Path, breaker: str) -> dict:
    """19d-e: under one live session and bulk clients, the rolling upgrade
    to checkpoint B (straight after 19c's rejoin, with the victim's
    breaker ``breaker`` then), then SIGKILL of the active front f0."""
    from eegnetreplication_tpu_torch.serve.engine import InferenceEngine

    url0, url1, engine = boot["url0"], boot["url1"], boot["engine"]
    work = boot["work"]
    digest_b = InferenceEngine.from_checkpoint(ckpt_b, (1,),
                                               device=dev).digest
    run_dir = _fleet_run_dir(work / "f0_obs")
    x = stream_recording(np, 1903, n=CELLS_LONG_S * STREAM_HZ)
    stop = threading.Event()
    s = _CellSession(np, [url0, url1], "s3", x, stop=stop).open()
    sessions.append(s)
    th = s.run_in_thread()
    row: dict = {}
    try:
        # 19d: the rolling upgrade.
        load = _HttpLoad(url0, bodies, CELLS_CLIENTS).start()
        try:
            t0 = time.perf_counter()
            t_request = time.time()
            status, result = _post(url0 + "/cells/upgrade", json.dumps(
                {"checkpoint": str(ckpt_b),
                 "liveTimeoutS": CELLS_LIVE_TIMEOUT_S}).encode(),
                "application/json", timeout=2 * CELLS * CELLS_LIVE_TIMEOUT_S)
            upgrade_s = time.perf_counter() - t0
        finally:
            bulk = load.stop(np)
        check(status == 200 and result["status"] == "ok"
              and result["upgraded"] == [f"c{i}" for i in range(CELLS)],
              f"/cells/upgrade answered {status}: {result}")
        check(bulk["failed"] == 0, f"{bulk['failed']} bulk requests failed "
              f"across the upgrade: {bulk['failure_samples']}")
        events = _events_of(run_dir)
        steps: dict = {}
        for i, e in enumerate(events):
            if e["event"] == "cell_upgrade":
                steps.setdefault(e["cell"], []).append((i, e))
        spans, per_cell = [], {}
        for cid in sorted(steps):
            acts = [e["action"] for _, e in steps[cid]]
            check(acts == ["drain", "relaunch", "live", "shadow",
                           "undrain"], f"{cid}'s cell_upgrade steps: {acts}")
            shadow = next(e for _, e in steps[cid]
                          if e["action"] == "shadow")
            check(shadow["agree"] >= CELLS_AGREE_FLOOR
                  and shadow["floor"] == CELLS_AGREE_FLOOR,
                  f"{cid}'s shadow compare: {shadow}")
            spans.append((steps[cid][0][0], steps[cid][-1][0]))
            per_cell[cid] = {
                "wall_s": steps[cid][-1][1]["t"] - steps[cid][0][1]["t"],
                "agree": shadow["agree"]}
        check(len(spans) == CELLS and all(
            b[0] > a[1] for a, b in zip(sorted(spans), sorted(spans)[1:])),
            "the cells' upgrades interleave")
        # What the upgrader waited for a dispatchable cell: before the
        # first drain (another cell), and from each cell's undrain to the
        # next cell's drain (the cell just upgraded).
        order = sorted(steps)
        waits = {f"request->{order[0]} drain":
                 steps[order[0]][0][1]["t"] - t_request}
        for a, b in zip(order, order[1:]):
            waits[f"{a} undrain->{b} drain"] = (steps[b][0][1]["t"]
                                                - steps[a][-1][1]["t"])
        circuits = [(e.get("site"), e["state"], e["reason"],
                     round(e["t"] - t_request, 2)) for e in events
                    if e["event"] == "circuit_state" and e["t"] >= t_request
                    and e["t"] <= steps[order[-1]][-1][1]["t"]]
        digests = {cid: h["variables_digest"]
                   for cid, h in _cells_healthz(url0).items()}
        check(set(digests.values()) == {digest_b}, f"digests after the "
              f"upgrade: {digests}")
        row["upgrade"] = {"wall_s": upgrade_s, "per_cell": per_cell,
                          "bulk": bulk, "breaker_at_rejoin": breaker,
                          "dispatchable_waits_s": waits,
                          "circuit_events": len(circuits)}
        log(f"phase 19d: /cells/upgrade to {digest_b[:12]} under s3 and "
            f"{CELLS_CLIENTS} clients in {upgrade_s:.1f}s, started at 19c's"
            f" rejoin (the victim's breaker {breaker}), strictly one "
            f"cell at a time (drain, relaunch, live, shadow, undrain): "
            + ", ".join(f"{c} {v['wall_s']:.1f}s agree {v['agree']}"
                        for c, v in per_cell.items())
            + "; waited for a dispatchable cell "
            + ", ".join(f"{k} {v:.2f}s" for k, v in waits.items())
            + f"; front circuit transitions meanwhile {circuits}; "
            f"{bulk['ok']} bulk answered, 0 failed; both cells on B")

        # 19e: SIGKILL the active front.
        status, health = _get(url0 + "/healthz")
        table = health["sessions"]
        load = _LeaderLoad([url0, url1], bodies, CELLS_CLIENTS).start()
        try:
            time.sleep(1.5)
            t_kill = time.time()
            os.kill(boot["f0"][0].pid, signal.SIGKILL)
            boot["f0"][0].wait(timeout=60)
            _wait_for(lambda: _active_front([url1]), 60,
                      "f1 to take over")
            promote_s = time.time() - t_kill
            time.sleep(CELLS_AFTER_PROMOTION_S)
        finally:
            stop.set()
            th.join(120)
            bulk = load.stop(np)
        row["session"] = s.close(torch, engine, dev)
        check(bulk["failed"] == 0 and bulk["max_switches"] <= 1,
              f"bulk across the front kill: {bulk['failed']} failed, at "
              f"most {bulk['max_switches']} leader switches a request: "
              f"{bulk['failure_samples']}")
        ev1 = _events_of(_fleet_run_dir(work / "f1_obs"))
        i_replay = next(i for i, e in enumerate(ev1)
                        if e["event"] == "affinity_replay")
        i_take = next(i for i, e in enumerate(ev1)
                      if e["event"] == "front_lease"
                      and e["action"] == "takeover")
        served = [i for i, e in enumerate(ev1) if e["event"] in (
            "request", "session_failover", "session_migrate", "span")]
        check(i_replay < i_take and served and i_take < served[0],
              "f1's journal: affinity_replay, then front_lease(takeover), "
              "then the first request it serves")
        check(ev1[i_replay]["n_sessions"] == table, f"affinity_replay "
              f"rebuilt {ev1[i_replay]['n_sessions']} sessions, f0 held "
              f"{table}")
        takeover_s = ev1[i_take]["t"] - t_kill
        check(takeover_s <= CELLS_TTL_S + 2.0, f"f1 took over "
              f"{takeover_s:.2f}s after the kill, more than TTL + 2 s")
        row["failover"] = {"takeover_s": takeover_s,
                           "active_seen_s": promote_s,
                           "replayed_sessions": table, "bulk": bulk}
        log(f"phase 19e: SIGKILL f0 under s3 and {CELLS_CLIENTS} clients: "
            f"f1 replayed the affinity WAL ({table} session(s)) and took "
            f"the lease {takeover_s:.2f}s after the kill (TTL "
            f"{CELLS_TTL_S:.0f}s) before serving; {bulk['ok']} bulk "
            f"answered, 0 failed, at most {bulk['max_switches']} leader "
            f"switch a request ({bulk['rps']:.1f} req/s, p95 "
            f"{bulk['latency_ms']['p95']:.2f} ms); s3 "
            f"({row['session']['windows']} windows) equal to the offline "
            "pipeline, 0 expired")
        return row
    finally:
        stop.set()
        th.join(120)


def _cells_counts(np, boot: dict, sessions: list, kills: dict) -> dict:
    """19f: every cell process's K1 launches against its warm runs and
    replays, its K2s launches against the pushes it ran."""
    run_dir = _fleet_run_dir(boot["work"] / "f0_obs")
    alive = _cells_healthz(boot["url1"])
    k1_total = k2s_total = 0
    rows = []
    for cid, runs in _cell_processes(run_dir).items():
        for k, rd in enumerate(runs):
            ev = _events_of(rd)
            if k == len(runs) - 1:
                h = alive[cid]
                counts = (h["kernel_launches"], len(h["buckets"]),
                          h["graph_replays"], "healthz")
            elif rd == kills.get(cid, {}).get("run_dir"):
                h = kills[cid]["health"]
                counts = (h["kernel_launches"], len(h["buckets"]),
                          h["graph_replays"], "healthz before SIGKILL")
            else:
                start = next(e for e in ev if e["event"] == "serve_start")
                end = [e for e in ev if e["event"] == "serve_end"]
                check(len(end) == 1, f"{rd.name}: no serve_end")
                counts = (end[0]["kernel_launches"], len(start["buckets"]),
                          end[0]["graph_replays"], "serve_end")
            launches, warm, replays, source = counts
            pushes, seeded = _pushes_ran(ev, sessions)
            check(launches["block1"] == warm + replays, f"{cid} launch {k}:"
                  f" K1 {launches['block1']} != {warm} warm + {replays} "
                  "replays")
            check(launches["ems_stream"] == seeded, f"{cid} launch {k}: "
                  f"K2s {launches['ems_stream']} != {seeded} pushes that "
                  f"ran the carry ({pushes} pushes)")
            k1_total += launches["block1"]
            k2s_total += launches["ems_stream"]
            rows.append({"cell": cid, "launch": k, "source": source,
                         "block1": launches["block1"], "warm": warm,
                         "replays": replays, "ems_stream":
                         launches["ems_stream"], "pushes": pushes})
    log(f"phase 19f: {len(rows)} cell processes, each K1 = warm + "
        f"replays, each K2s = its pushes from the seed on: {rows}")
    return {"processes": rows, "k1_launches": k1_total,
            "ems_stream_launches": k2s_total}


def _stop_cells(boot: dict) -> dict:
    """SIGTERM f1 (75), then every cell f0 launched by the pids in its
    journal, and f0's process group; nothing of phase 19 left."""
    out = {}
    f1 = boot.get("f1")
    if f1 is not None:
        proc = f1[0]
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            with contextlib.suppress(subprocess.TimeoutExpired):
                proc.wait(timeout=90)
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        out["f1_rc"] = proc.returncode
        f1[2].close()
    f0 = boot["f0"]
    pids = []
    metrics = boot["work"] / "f0_obs"
    for rd in _run_dirs(metrics):
        with contextlib.suppress(Exception):
            pids += _launched_pids(_events_of(rd))
    for pid in pids:
        if _pid_alive(pid):
            os.kill(pid, signal.SIGKILL)
    with contextlib.suppress(ProcessLookupError, PermissionError):
        os.killpg(f0[0].pid, signal.SIGKILL)
    if f0[0].poll() is None:
        f0[0].kill()
        f0[0].wait()
    f0[2].close()
    deadline = time.monotonic() + 30
    while any(_pid_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.2)
    out["left"] = [p for p in pids if _pid_alive(p)]
    return out


def phase_cells(torch, np, dev, work: Path, env: dict) -> dict:
    """Phase 19: the cell tier on the card (see the module docstring)."""
    from eegnetreplication_tpu_torch.data.containers import BCICI2ADataset
    from eegnetreplication_tpu_torch.data.io import save_trials

    t_phase = time.perf_counter()
    env = dict(env, EEGTPU_DATA_ROOT=str(work / "root"))
    ckpt_a = _save_seeded(torch, work / "cells_a.npz", seed=1811)
    ckpt_b = _save_shifted(torch, work / "cells_b.npz", 1811,
                           CELLS_BIAS_SHIFT)
    x128 = trials(torch, 128, 22, 257, 1813).numpy()
    y128 = np.random.RandomState(1814).randint(0, 4, size=128).astype(
        np.int64)
    trials_path = save_trials(BCICI2ADataset(X=x128, y=y128),
                              work / "A01E-trials.npz")
    bodies = [_npz_body(np, x128[i:i + 1]) for i in range(16)]
    torch.zeros(1, device=dev)   # this process's own context, counted
    rows_base = len(_gpu_apps())
    result: dict = {}
    sessions: list = []
    kills: dict = {}
    boot = {"work": work, "f0": None, "f1": None}
    try:
        _cells_boot(torch, np, dev, work, env, ckpt_a, x128, y128,
                    trials_path, boot)
        result["boot"] = boot["result"]
        result["migration"] = _cells_migration(torch, np, dev, boot,
                                               sessions)
        result["kill"] = _cells_kill(torch, np, dev, boot, sessions, bodies,
                                     kills)
        _cells_standby(boot)
        result.update(_cells_upgrade_and_failover(
            torch, np, dev, boot, sessions, bodies, ckpt_b,
            result["kill"]["breaker_at_rejoin"]))
        result["counts"] = _cells_counts(np, boot, sessions, kills)
        for name in ("f0_obs", "f1_obs"):
            events = _events_of(_fleet_run_dir(work / name))
            fenced = [e for e in events if e["event"] == "front_lease"
                      and e["action"] == "fenced"]
            check(not fenced, f"{name}: a front fenced itself: {fenced}")
            result.setdefault("lease_actions", {})[name] = [
                e["action"] for e in events if e["event"] == "front_lease"]
    finally:
        if boot["f0"] is not None:
            result["stop"] = _stop_cells(boot)
    check(result["stop"]["f1_rc"] == 75, f"f1 exited "
          f"{result['stop']['f1_rc']} after SIGTERM, want 75")
    check(not result["stop"]["left"], f"cell processes left: "
          f"{result['stop']['left']}")
    _wait_for(lambda: len(_gpu_apps()) <= rows_base, 60,
              "the card to list no process of phase 19")
    result["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 19 in {result['wall_s']:.1f} s: front_lease actions "
        f"{result['lease_actions']}; f1 -> 75; no cell left on the card")
    return result


TOOLING_BUDGET_S = 20.0


def _keep_training_artifacts(data_root: Path, keep: Path) -> None:
    """Copy phase 10's models and report out of phase 8's tree (later
    phases write models there) for phase 20."""
    import shutil

    for sub, pattern in (("models", "subject_0[12]_best_model.*"),
                         ("reports", "latest_within_subject_report.json")):
        (keep / sub).mkdir(parents=True, exist_ok=True)
        for f in sorted((data_root / sub).glob(pattern)):
            shutil.copy2(f, keep / sub / f.name)


# Phase 20's lint leg: the port's contract linter over the checkout, then
# over a copy with one unknown flag on a spawned cell's command line and
# one log call inside the engine's capture window.
LINT_MUTATIONS = (
    ("serve/cells/service.py", '"--sessionsMirror"', '"--sessionsMirrror"'),
    ("serve/engine.py", "logits = self._graph_forward(*inputs)\n",
     "logits = self._graph_forward(*inputs)\n"
     "                logger.info('captured')\n"),
)
LINT_WANT = [("jit-impure", "_capture:_capture"),
             ("spawn-arg-unknown", "--sessionsMirrror")]


def _lint(root: Path) -> tuple[int, dict]:
    proc = subprocess.run(
        [sys.executable, "-m", "eegnetreplication_tpu_torch.analysis.cli",
         "--root", str(root), "--json"], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True,
        text=True, timeout=300)
    check(proc.stdout.strip().startswith("{"), f"the linter over {root} "
          f"exited {proc.returncode} without a record:\n" + proc.stderr[-2000:])
    return proc.returncode, json.loads(proc.stdout)


def _lint_leg(work: Path) -> dict:
    import shutil

    from eegnetreplication_tpu_torch.analysis.runner import PASSES

    t0 = time.perf_counter()
    rc, record = _lint(ROOT)
    counts = record["counts"]
    check(rc == 0 and counts["new"] == 0 and counts["stale_baseline"] == 0
          and record["passes"] == list(PASSES) and len(PASSES) == 6,
          f"the linter over the checkout exited {rc}: {counts}, passes "
          f"{record['passes']}, new " + json.dumps(
              [f for f in record["findings"] if not f["baselined"]])[:2000])

    copy = work / "lint_mutated"
    pkg = "eegnetreplication_tpu_torch"
    shutil.copytree(ROOT / pkg, copy / pkg, ignore=shutil.ignore_patterns(
        "__pycache__", "_build", "csrc"))
    for name in ("chip_smoke.py", "BENCH_NOTES.md", "pyproject.toml"):
        shutil.copy2(ROOT / name, copy / name)
    for rel, old, new in LINT_MUTATIONS:
        path = copy / pkg / rel
        text = path.read_text()
        check(text.count(old) == 1, f"{rel}: the mutation's anchor moved")
        path.write_text(text.replace(old, new))
    mrc, mutated = _lint(copy)
    new = sorted((f["rule"], f["symbol"]) for f in mutated["findings"]
                 if not f["baselined"])
    check(mrc == 1 and new == LINT_WANT
          and mutated["counts"]["stale_baseline"] == 0,
          f"the linter over the mutated copy exited {mrc} with {new}")
    wall = time.perf_counter() - t0
    log(f"phase 20 lint leg: the checkout exits 0 ({counts['total']} "
        f"findings, {counts['baselined']} baselined, 0 new, 0 stale; "
        f"passes {', '.join(record['passes'])}) in {record['wall_s']} s "
        f"(the linter's wall_s); the mutated copy exits 1 with exactly "
        f"{new} in {mutated['wall_s']} s; leg {wall:.1f} s")
    return {"wall_s": record["wall_s"], "mutated_wall_s": mutated["wall_s"],
            "counts": counts, "mutated_new": new, "leg_s": wall}


def phase_tooling(np, keep: Path, fleet_dir: Path, cells_dir: Path,
                  card: str, train: dict) -> dict:
    """Phase 20: viz, the GUI's helpers, the BENCH envelope and the report
    CLIs over what phases 10, 18 and 19 wrote, in this process; its own
    files go to ``keep``, the smoke's work directory."""
    from eegnetreplication_tpu_torch import predict, ui, viz
    from eegnetreplication_tpu_torch.config import Paths
    from eegnetreplication_tpu_torch.obs import report, schema, trace_report

    t_phase = time.perf_counter()
    paths = Paths.from_root(keep)
    out: dict = {}

    # viz: the filters of the card-trained checkpoints, both formats.
    sets = {}
    for s in (1, 2):
        stem = paths.models / f"subject_{s:02d}_best_model"
        a = viz.load_model_filters(stem.with_suffix(".npz"))
        b = viz.load_model_filters(stem.with_suffix(".pth"))
        check(a.temporal.tobytes() == b.temporal.tobytes()
              and a.spatial.tobytes() == b.spatial.tobytes()
              and a.temporal.shape == (8, 32) and a.spatial.shape == (16, 22),
              f"subject {s}: the .npz and .pth filter sets differ")
        sets[s] = a
    try:
        import matplotlib
    except ImportError:
        matplotlib = None
    figures = {}
    if matplotlib is not None:
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        for name in ("plot_temporal_filters", "plot_spatial_filters",
                     "plot_power_spectra_of_temporal_filters"):
            png = keep / f"{name}.png"
            plt.close(getattr(viz, name)(sets[1], show=False,
                                         save_path=png))
            check(png.stat().st_size > 0, f"{name} wrote no PNG")
            figures[name] = png.stat().st_size
        how = "rendered under Agg to PNG: " + ", ".join(
            f"{k} {v} B" for k, v in figures.items())
    else:
        # No matplotlib on this machine: the data the figures plot.
        grids = [viz.topomap_grid(row) for row in sets[1].spatial]
        spectra = [viz.PS(row, sets[1].sfreq)[1] for row in sets[1].temporal]
        inside = [g[~np.isnan(g)] for g in grids]
        check(all(v.size and np.isfinite(v).all() for v in inside)
              and all(np.isfinite(x).all() for x in spectra),
              "a topomap field or a spectrum is not finite")
        how = (f"matplotlib is not installed here: plotted data only "
               f"({len(grids)} topomap fields of {grids[0].shape}, "
               f"{len(spectra)} spectra)")
    out["figures"] = figures or "data only"

    # The GUI's helpers over phase 10's report and models.
    ws_report = ui.get_report(paths)["within_subject"]
    lines = ui.report_overview_lines(ws_report)
    rows = ui.report_table_rows(ws_report, "subject_id")
    check(lines[0].startswith("Average Test Accuracy: ") and len(lines) == 4
          and [r[0] for r in rows] == ["Subject 1", "Subject 2"],
          f"the report tab reads {lines} {rows}")
    model = ui.get_model_path("Within-Subject", "1", paths)
    cmd = ui.build_predict_cmd(str(model), 1)
    check(model.suffix == ".npz" and cmd[1:3] == [
        "-m", "eegnetreplication_tpu_torch.predict"],
        f"the evaluate command: {cmd}")
    args = predict.build_parser().parse_args(cmd[3:])
    check(args.checkpoint == str(model) and args.subject == 1,
          f"predict's parser read {args}")

    # The BENCH envelope, and the Performance tab over it.
    name, limit = card.rsplit(", ", 1)
    rate = train["times_by_folds"][36]["fold_epochs_per_s"]
    bench = schema.write_json_artifact(keep / "BENCH_ONCHIP_LAST.json", {
        "value": round(rate, 2), "unit": "fold-epochs/s", "folds": 36,
        "platform": "gpu", "device": name, "power_limit": limit})
    schema.validate_bench(json.loads(bench.read_text()))
    perf = ui.performance_overview_lines(keep)
    check(len(perf) == 1 and str(round(rate, 2)) in perf[0]
          and card in perf[0], f"the Performance tab shows {perf}")

    # obs.report over phase 19's fronts and every nested cell journal.
    fronts = [cells_dir / "f0_obs", cells_dir / "f1_obs"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = report.main([str(f) for f in fronts] + ["--json"])
    summaries = [json.loads(line) for line in buf.getvalue().splitlines()]
    got = {Path(r["dir"]) for r in summaries}
    want = {rd for runs in _cell_processes(
        _fleet_run_dir(fronts[0])).values() for rd in runs}
    check(rc == 0 and want and want <= got
          and not any(r.get("error") for r in summaries),
          f"obs.report exited {rc} over phase 19's tree: {len(got)} runs, "
          f"{len(want - got)} cell journals missing")

    # obs.trace_report over phase 18's traced fleet.
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = trace_report.main([str(fleet_dir / "gray_obs"), "--json",
                                "--require-cross-process"])
    traces = [json.loads(line) for line in buf.getvalue().splitlines()
              if line.startswith("{")]
    crossed = sum(t["cross_process"] for t in traces)
    check(rc == 0 and crossed >= 1, f"trace_report exited {rc}: "
          f"{crossed} cross-process traces of {len(traces)}")

    wall = time.perf_counter() - t_phase
    out.update(wall_s=wall, perf_line=perf[0], report_runs=len(summaries),
               cell_journals=len(want), traces=len(traces),
               cross_process_traces=crossed)
    log(f"phase 20: filters of phase 10's models equal from .npz and .pth;"
        f" figures {how}; the report tab {lines[0]!r}, {len(rows)} rows; "
        f"evaluate -> {' '.join(cmd[1:3])}, parsed; Performance tab "
        f"{perf[0]!r}; obs.report: {len(summaries)} runs of phase 19 "
        f"({len(want)} cell journals); obs.trace_report: {crossed} "
        f"cross-process traces of {len(traces)}")
    log(f"phase 20 in {wall:.1f} s (budget {TOOLING_BUDGET_S:.0f} s)")
    check(wall <= TOOLING_BUDGET_S, f"phase 20 took {wall:.1f}s")
    out["lint"] = _lint_leg(keep)
    return out


# --------------------------------------------------------------------------
# Phase 21: the mesh
# --------------------------------------------------------------------------

MESH_EPOCHS = 20          # 21a: --meshFold 2 against --maxFoldsPerProgram 18
MESH_EVERY = 10
MESH_DRILL_EVERY = 5      # 21b: four chunks, so a stop has one to wait for
MESH_KILL_TIMEOUT_S = 30.0  # 21e: the gloo timeout of the killed world
MESH_WAIT_S = 600.0
MESH_DRILL_ARGS: list = []  # e.g. ["--inputs", x] for a small rehearsal


def _mesh_train(name: str, work: Path, env: dict, data_root: Path, args,
                extra_env=None):
    """A train CLI over its own nine-subject tree (phase 8's two subjects
    replicated) with its own journal directory; ``(proc, root, log)``."""
    root = work / name
    if not root.exists():
        _replicated_tree(data_root, root)
    log_path = work / f"{name}.log"
    argv = [sys.executable, "-m", "eegnetreplication_tpu_torch.train",
            "--trainingType", "Within-Subject", "--metricsDir",
            str(root / "obs"), *args]
    proc = _spawn(argv, dict(env, EEGTPU_DATA_ROOT=str(root),
                             **(extra_env or {})), log_path)
    return proc, root, log_path


def _gauge(root: Path, name: str) -> float:
    """A gauge of the one run journal's ``metrics.json`` under ``root``."""
    (run,) = sorted((root / "obs").iterdir())
    gauges = json.loads((run / "metrics.json").read_text())["gauges"]
    return float(gauges[name][0]["value"])


def _same_models(got: Path, want: Path, what: str) -> None:
    names = [f"subject_{s:02d}_best_model.npz" for s in range(1, 10)]
    _same_weights(got / "models", want / "models", names, what)
    for s in range(1, 10):
        pth = f"subject_{s:02d}_best_model.pth"
        check((got / "models" / pth).read_bytes()
              == (want / "models" / pth).read_bytes(),
              f"{what}: {pth} differs")


def _same_reports(got: Path, want: Path, what: str) -> None:
    reports = [json.loads((r / "reports" / "latest_within_subject_report."
                           "json").read_text()) for r in (got, want)]
    for r in reports:
        r.pop("timestamp")
    check(reports[0] == reports[1], f"{what}: the reports differ")


def _mesh_runs(work: Path, env: dict, data_root: Path) -> dict:
    """Start 21a's pair, 21b's three runs and 21e's run at once; SIGTERM
    21b's third run and SIGKILL a rank of 21e's as each writes its first
    snapshot; wait for all.  ``{name: (exit code, stderr, root)}``, and
    21e's rank pids and the seconds from the kill to the launcher's exit
    under ``"kill"``."""
    drill = ["--epochs", str(MESH_EPOCHS), "--checkpointEvery",
             str(MESH_DRILL_EVERY), "--meshFold", "2", "--meshData", "2"]
    pair = ["--epochs", str(MESH_EPOCHS), "--checkpointEvery",
            str(MESH_EVERY)]
    runs = {"mesh": pair + ["--meshFold", "2"],
            "grouped": pair + ["--maxFoldsPerProgram", "18"],
            "u1": drill, "u2": drill, "stopped": drill,
            "killed": ["--epochs", "500", "--checkpointEvery",
                       str(MESH_DRILL_EVERY), "--meshFold", "2",
                       "--meshData", "2"]}
    procs, roots, logs = {}, {}, {}
    for name, args in runs.items():
        extra = ({"EEGTPU_MESH_TIMEOUT_S": str(MESH_KILL_TIMEOUT_S)}
                 if name == "killed" else None)
        procs[name], roots[name], logs[name] = _mesh_train(
            name, work, env, data_root, args, extra)
    snap = {n: roots[n] / "models" / "within_subject_eegnet.run.npz"
            for n in ("stopped", "killed")}
    kill: dict = {}
    deadline = time.monotonic() + MESH_WAIT_S
    try:
        while "term" not in kill or "t0" not in kill:
            check(time.monotonic() < deadline, "21b/21e: no run snapshot")
            if "term" not in kill:
                check(procs["stopped"].poll() is None, "21b stopped ended "
                      f"first: {logs['stopped'].read_text()[-2000:]}")
                if snap["stopped"].exists():
                    procs["stopped"].send_signal(signal.SIGTERM)
                    kill["term"] = True
            if "t0" not in kill:
                check(procs["killed"].poll() is None, "21e ended first: "
                      f"{logs['killed'].read_text()[-2000:]}")
                if snap["killed"].exists():
                    ranks = [int(p) for p in subprocess.run(
                        ["pgrep", "-P", str(procs["killed"].pid)],
                        capture_output=True, text=True).stdout.split()]
                    check(len(ranks) == 4,
                          f"21e: the launcher has children {ranks}")
                    kill["t0"] = time.monotonic()
                    os.kill(ranks[1], signal.SIGKILL)
                    kill["ranks"] = ranks
            time.sleep(0.02)
        rc = procs["killed"].wait(timeout=MESH_KILL_TIMEOUT_S + 10.0)
        kill["fail_s"] = time.monotonic() - kill["t0"]
        kill["exit_code"] = rc
        done = _wait_all(procs, logs, MESH_WAIT_S)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {"done": {n: (*done[n], roots[n]) for n in runs}, "kill": kill}


def _mesh_vs_groups(np, done: dict) -> dict:
    """21a's gates: ``--meshFold 2`` against ``--maxFoldsPerProgram 18``."""
    for name in ("mesh", "grouped"):
        rc, err, _ = done[name]
        check(rc == 0, f"21a {name} exited {rc}: {err[-2000:]}")
    roots = {n: done[n][2] for n in ("mesh", "grouped")}
    _same_models(roots["mesh"], roots["grouped"], "21a")
    _same_reports(roots["mesh"], roots["grouped"], "21a")
    journals = {n: _journal(np, roots[n] / "obs", "ok") for n in roots}
    start = journals["mesh"][0]
    check(start.get("mesh_shape") == {"fold": 2, "data": 1, "model": 1},
          f"21a mesh_shape {start.get('mesh_shape')}")
    check(journals["grouped"][0].get("mesh_shape") is None,
          "21a: the grouped run journals a mesh")
    launches = {n: j[-1]["kernel_launches"]["block1_stacked"]
                for n, j in journals.items()}
    by_rank = journals["mesh"][-1]["kernel_launches_by_rank"][
        "block1_stacked"]
    check(launches["mesh"] == launches["grouped"] and len(by_rank) == 2
          and all(n > 0 and n == by_rank[0] for n in by_rank),
          f"21a K1-stacked launches: mesh {launches['mesh']} by rank "
          f"{by_rank}, grouped {launches['grouped']}")
    rates = {n: _gauge(roots[n], "epoch_throughput") for n in roots}
    log(f"21a: --meshFold 2 {rates['mesh']:.2f} fold-epochs/s vs "
        f"--maxFoldsPerProgram 18 {rates['grouped']:.2f} (36 folds x "
        f"{MESH_EPOCHS} epochs, beside 21b and 21e's runs); ranks joined "
        f"in {start['rank_join_s']:.2f} s, had the card in "
        f"{start['rank_start_s']:.2f} s; best models bitwise, reports "
        f"equal; K1-stacked {launches['mesh']} = {by_rank} by rank")
    return {"fold_epochs_per_s": rates, "k1_stacked_launches": launches,
            "k1_stacked_by_rank": by_rank,
            "rank_join_s": start["rank_join_s"],
            "rank_start_s": start["rank_start_s"],
            "wall_s": {n: j[-1]["wall_s"] for n, j in journals.items()}}


def _mesh_stopped(np, done: dict) -> None:
    """21b's gates before the resume: two unbroken 2x2 runs bitwise; the
    stopped one 75 with its snapshot and a ``preempted`` journal."""
    for name in ("u1", "u2"):
        rc, err, _ = done[name]
        check(rc == 0, f"21b {name} exited {rc}: {err[-2000:]}")
    rc, err, root = done["stopped"]
    check(rc == 75, f"21b: SIGTERM gave {rc}: {err[-2000:]}")
    check((root / "models" / "within_subject_eegnet.run.npz").exists(),
          "21b: no snapshot after the stop")
    _journal(np, root / "obs", "preempted")
    _same_models(done["u1"][2], done["u2"][2], "21b two runs")
    _same_reports(done["u1"][2], done["u2"][2], "21b two runs")


def _mesh_resume(np, work: Path, env: dict, data_root: Path,
                 done: dict) -> dict:
    """21b's ``--resume``: bitwise the unbroken run."""
    root = done["stopped"][2]
    snap = root / "models" / "within_subject_eegnet.run.npz"
    proc, _, log_path = _mesh_train(
        "stopped", work, env, data_root,
        ["--epochs", str(MESH_EPOCHS), "--checkpointEvery",
         str(MESH_DRILL_EVERY), "--meshFold", "2", "--meshData", "2",
         "--resume"])
    rc, err = _wait_all({"r": proc}, {"r": log_path}, MESH_WAIT_S)["r"]
    check(rc == 0, f"21b --resume exited {rc}: {err[-2000:]}")
    check("Resuming from" in err, "21b: the --resume run did not resume")
    check(not snap.exists(), "21b: the snapshot outlived the run")
    _same_models(root, done["u1"][2], "21b resumed")
    _same_reports(root, done["u1"][2], "21b resumed")
    stopped, resumed = (
        [json.loads(line) for line in (run / "events.jsonl").read_text()
         .splitlines()][-1] for run in sorted((root / "obs").iterdir()))
    check(resumed["status"] == "ok", f"21b resumed run_end "
          f"{resumed['status']}")
    ends = [_journal(np, done[n][2] / "obs", "ok")[-1] for n in ("u1", "u2")]
    k1s = ends[0]["kernel_launches_by_rank"]["block1_stacked"]
    check(len(k1s) == 4 and all(n > 0 for n in k1s),
          f"21b: K1-stacked by rank {k1s}")
    log(f"21b: two 2x2 runs bitwise; SIGTERM -> 75 -> --resume bitwise; "
        f"K1-stacked {ends[0]['kernel_launches']['block1_stacked']} = "
        f"{k1s} by rank")
    return {"k1_stacked_launches": sum(
        e["kernel_launches"]["block1_stacked"]
        for e in ends + [stopped, resumed]), "k1_stacked_by_rank": k1s}


def _mesh_killed(kill: dict) -> dict:
    """21e's gates: the run failed within the gloo timeout + 10 s and no
    rank survives."""
    check(kill["exit_code"] != 0, "21e: the run survived a killed rank")
    check(kill["fail_s"] <= MESH_KILL_TIMEOUT_S + 10.0,
          f"21e: the launcher took {kill['fail_s']:.1f} s")
    t0 = time.monotonic()
    while _pids_alive(kill["ranks"]) and time.monotonic() - t0 < 10.0:
        time.sleep(0.05)
    survivors = _pids_alive(kill["ranks"])
    check(not survivors, f"21e: ranks {survivors} outlived the launcher")
    log(f"21e: a SIGKILLed rank failed the run with {kill['exit_code']} in "
        f"{kill['fail_s']:.2f} s (gloo timeout {MESH_KILL_TIMEOUT_S:.0f} "
        f"s); no rank survives")
    return {"exit_code": kill["exit_code"], "fail_s": kill["fail_s"]}


def _pids_alive(pids) -> list:
    return [p for p in pids if _pid_alive(p)]


def _mesh_drill(work: Path, env: dict, card: str) -> dict:
    """21c-d: the DP step, ZeRO and the time-sharded EMS in one world of
    four ranks on the card (``utils/mesh_drill.py``, run alone)."""
    out_json = work / "drill.json"
    argv = [sys.executable, "-m",
            "eegnetreplication_tpu_torch.utils.mesh_drill", "--timing",
            "--out", str(work / "drill.npz"), "--json", str(out_json),
            *MESH_DRILL_ARGS]
    log_path = work / "drill.log"
    proc = _spawn(argv, env, log_path)
    done = _wait_all({"drill": proc}, {"drill": log_path}, MESH_WAIT_S)
    check(done["drill"][0] == 0,
          f"21c-d drill exited {done['drill'][0]}: {done['drill'][1][-3000:]}")
    res = json.loads(out_json.read_text())
    info = res["info"]
    for mode in ("flax", "torch"):
        row = res[f"dp_{mode}"]
        check(row["ok"], f"21c DP step ({mode} BatchNorm) against the "
              f"one-process step: {row}")
    check(res["dp_bf16"]["ok"], f"21c DP step under bf16 against the "
          f"one-process bf16 step: {res['dp_bf16']}")
    check(res["zero"]["ok"], f"21c ZeRO: {res['zero']}")
    for n, want in (("2", [1, 1, 1, 1]), ("4", [1, 2, 2, 1])):
        row = res[f"ems_{n}"]
        check(row["ok_vs_scan"] and row["ok_vs_pallas"],
              f"21d ems_time_sharded over {n} ranks: {row}")
        check(row["launches"] == want, f"21d K2s launches over {n} ranks "
              f"{row['launches']}, designed {want}")
    k1s = info["k1_stacked_launches"]
    check(all(k > 0 for k in k1s), f"21c: K1-stacked by rank {k1s}")
    log(f"21c: DP step {info['dp_step_ms']:.3f} ms (2 data ranks) against "
        f"{info['single_step_ms']:.3f} ms one process; gloo all_reduce of "
        f"the flat gradient ({info['all_reduce_bytes']} B) "
        f"{info['all_reduce_ms']:.3f} ms; DP loss rel err "
        f"{res['dp_flax']['loss_max_rel_err']:.2e} (flax) / "
        f"{res['dp_torch']['loss_max_rel_err']:.2e} (torch), "
        f"{res['dp_bf16']['loss_max_rel_err']:.2e} (bf16, tolerance "
        f"{res['dp_bf16']['rtol']:.2e}); ZeRO bitwise "
        f"over 20 steps; [{card}]")
    log(f"21d: ems_time_sharded (22, 345600) over 2 / 4 ranks: max abs err "
        f"{res['ems_2']['max_abs_err_vs_scan']:.2e} / "
        f"{res['ems_4']['max_abs_err_vs_scan']:.2e} vs the one-shot K2s, "
        f"{res['ems_2']['max_abs_err_vs_pallas']:.2e} / "
        f"{res['ems_4']['max_abs_err_vs_pallas']:.2e} vs K2; K2s launches "
        f"{res['ems_2']['launches']} / {res['ems_4']['launches']}")
    return res


def phase_mesh(np, work: Path, env: dict, data_root: Path,
               card: str) -> dict:
    """Phase 21: the mesh on the card.  21a's pair, 21b's three runs and
    21e's run at once, then 21b's resume, then the drill (21c-d) alone,
    so that its times are its own."""
    t0 = time.perf_counter()
    work.mkdir(parents=True, exist_ok=True)
    runs = _mesh_runs(work, env, data_root)
    out = {"mesh_vs_groups": _mesh_vs_groups(np, runs["done"]),
           "kill": _mesh_killed(runs["kill"])}
    _mesh_stopped(np, runs["done"])
    out["stop_resume"] = _mesh_resume(np, work, env, data_root,
                                      runs["done"])
    out["drill"] = _mesh_drill(work, env, card)
    out["k1_stacked_launches"] = (
        sum(out["mesh_vs_groups"]["k1_stacked_launches"].values())
        + out["stop_resume"]["k1_stacked_launches"]
        + sum(out["drill"]["info"]["k1_stacked_launches"]))
    out["ems_stream_launches"] = sum(
        sum(out["drill"][f"ems_{n}"]["launches"]) for n in ("2", "4"))
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 21: {out['wall_s']:.1f}s")
    return out


# --------------------------------------------------------------------------
# Phase 22: the numerics modes
# --------------------------------------------------------------------------

PREC_MODES = ("highest", "high", "default", "bf16")
PREC_TURNS = PREC_MODES + PREC_MODES[::-1]
PREC_EPOCHS = 4           # 22a: timed 36-fold epochs a run, after a warm-up
PREC_CS_EPOCHS = 1        # 22a: timed 90-fold epochs a run, after a warm-up
# 22a: the modes profiled at 90 folds.  highest's profile there is phase
# 11's (the same group, deterministic, in the same run), and default runs
# high's numerics bit for bit (22b); each profile costs ~8 s (time limit).
PREC_CS_PROFILED = ("high", "bf16")
# 22b: the unit roundoff of each mode's arithmetic (TF32 keeps 10 of f32's
# 23 mantissa bits, bf16 7), and the first-step loss at dropout 0 of each
# mode within PREC_LOSS_UNITS of them of highest's, relative: the forward
# rounds at five conv/matmul stages, with margin.
PREC_UNIT = {"high": 2.0 ** -11, "default": 2.0 ** -11, "bf16": 2.0 ** -8}
PREC_LOSS_UNITS = 8
PREC_CLI_EPOCHS, PREC_CLI_EVERY = 4, 2
# Tensor-core GEMM and convolution kernels of each arithmetic, by the
# names cuBLAS and cuDNN give them (``..._tf32f32_...``, CUTLASS's
# ``tensorop_s1688gemm_<tile>`` for TF32; ``bf16`` in either for BF16,
# whose CUTLASS kernels are also named ``s1688`` and ``s16816``).
PREC_ARITHMETIC = {"highest": None, "high": "TF32", "default": "TF32",
                   "bf16": "BF16"}
TENSOR_CORE = {"TF32": re.compile(r"tf32|tensorop_s1688gemm_(?!bf16|f16)",
                                  re.I),
               "BF16": re.compile(r"bf16", re.I)}
GEMM_OR_CONV = re.compile(r"gemm|fprop|dgrad|wgrad|conv|xmma", re.I)


def _tensor_core_kernels(names) -> dict:
    """The GEMM and convolution kernels among ``names`` that run on the
    tensor cores in TF32 and in BF16."""
    return {arith: sorted(n for n in names
                          if GEMM_OR_CONV.search(n) and rx.search(n))
            for arith, rx in TENSOR_CORE.items()}


def _same_result(a, b) -> bool:
    """Two fold results equal bit for bit: histories, best states, test
    accuracies."""
    return (_same_state(a.best_state, b.best_state)
            and all(bool((getattr(a, f) == getattr(b, f)).all()) for f in (
                "train_losses", "val_losses", "val_accuracies",
                "test_accuracy")))


def _prec_run(torch, dev, build, mode: str, epochs: int, profile: bool
              ) -> dict:
    """One run of ``mode`` in its numerics scope: a fresh trainer from
    ``build(mode)``, one warm-up epoch, ``epochs`` timed (host clock ended
    by a synchronize), one more (under the profiler when ``profile``),
    then the test pass; K1-stacked's launches and the peak memory over
    the run."""
    from eegnetreplication_tpu_torch.ops.fused_eegnet import block1_stacked
    from eegnetreplication_tpu_torch.utils.device import numerics
    from eegnetreplication_tpu_torch.utils.profiling import breakdown

    t_run = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    with numerics(mode):
        trainer = build(mode)
        t_built = time.perf_counter()
        block1_stacked.launches = 0
        trainer.run_epoch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(epochs):
            trainer.run_epoch()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof = None
        t_prof = time.perf_counter()
        if profile:
            prof = breakdown(trainer.run_epoch, n_calls=1, top=5, names=True)
        else:
            trainer.run_epoch()
        t_prof = time.perf_counter() - t_prof
        result = trainer.result()
        torch.cuda.synchronize()
    n = trainer.spec.n_folds
    row = {"mode": mode, "folds": n, "epochs": epochs, "wall_s": wall,
           "fold_epochs_per_s": n * epochs / wall,
           "train_steps": trainer.train_steps, "val_steps": trainer.val_steps,
           "test_steps": trainer.test_steps,
           "k1_stacked_launches": block1_stacked.launches,
           "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           "test_acc": float(result.test_accuracy.mean()),
           "build_s": t_built - t_run, "last_epoch_s": t_prof,
           "run_s": time.perf_counter() - t_run}
    row.update(_mfu_fields(row, mode))
    if prof is not None:
        names = prof.pop("device_names")
        row["epoch_profile"] = prof
        row["tensor_core_kernels"] = _tensor_core_kernels(names)
    return row, result


def _first_step_losses(torch, dev, build, mode: str):
    """Each fold's loss at the first train step of a fresh trainer at
    dropout 0, in ``mode``'s numerics scope: ``(G,)`` on the host."""
    from eegnetreplication_tpu_torch.training import steps
    from eegnetreplication_tpu_torch.utils.device import numerics

    with numerics(mode):
        trainer = build(mode, dropout=0.0)
        gather, weights = trainer.slot_source(0)
        x, y, w = trainer._batch(gather.to(dev, torch.int64),
                                 weights.to(dev, torch.float32), 0)
        _, loss, _ = steps.train_step(trainer.model, trainer.state, x, y, w,
                                      **trainer.step_kw)
        return loss.cpu()


def _prec_rates(torch, np, dev) -> dict:
    """22a-b in process, on the separable pool: the modes in turns at 36
    folds, then one run a mode at 90 folds in one group."""
    from eegnetreplication_tpu_torch.config import DEFAULT_TRAINING
    from eegnetreplication_tpu_torch.training import protocols as pr

    subjects = tuple(range(1, 10))
    sessions = {m: [separable_subject(np, (s - 1) % 2 + 1, m)
                    for s in subjects] for m in ("Train", "Eval")}
    ws_pool = pr.build_pool([t.concat(e) for t, e in zip(
        sessions["Train"], sessions["Eval"])])
    cs_x, cs_y, cs_off = pr.build_pool(sessions["Train"] + sessions["Eval"])

    def config(mode, dropout=None, cross=False):
        cfg = DEFAULT_TRAINING.replace(precision=mode)
        if dropout is not None:
            cfg = cfg.replace(**{("dropout_cross_subject" if cross else
                                  "dropout_within_subject"): dropout})
        return cfg

    def ws(mode, dropout=None):
        return pr.within_subject_trainer(*ws_pool, config=config(
            mode, dropout), seed=3, device=dev)[0]

    def cs(mode):
        cfg = config(mode, cross=True)
        model = pr._protocol_model("eegnet", cs_x,
                                   cfg.dropout_cross_subject, cfg)
        folds = pr.cross_subject_folds(cs_off[:9], cs_off[9:], subjects, cfg)
        setup = pr.FoldSetup.build(model, folds, cs_x, cs_y, config=cfg,
                                   seed=3, device=dev)
        return setup.trainer(0, setup.n_folds)

    log(f"22a: the separable pool built ({len(ws_pool[0])} trials)")
    runs: dict = {m: [] for m in PREC_MODES}
    rows: dict = {m: [] for m in PREC_MODES}
    for mode in PREC_TURNS:
        row, result = _prec_run(torch, dev, ws, mode, PREC_EPOCHS,
                                profile=not rows[mode])
        rows[mode].append(row)
        runs[mode].append(result)
    first = {m: _first_step_losses(torch, dev, ws, m) for m in PREC_MODES}
    cross = {}
    for mode in PREC_MODES:
        cross[mode], _ = _prec_run(torch, dev, cs, mode, PREC_CS_EPOCHS,
                                   profile=mode in PREC_CS_PROFILED)

    # 22b: the gates
    for mode in PREC_MODES:
        a, b = runs[mode]
        check(_same_result(a, b), f"22b {mode}: two runs differ; each mode "
              "must repeat bit for bit")
        for row in rows[mode] + [cross[mode]]:
            launches = row["k1_stacked_launches"]
            if mode == "highest":
                want = ((row["epochs"] + 2) * row["val_steps"]
                        + row["test_steps"])
                check(launches == want, f"22b highest: K1-stacked launched "
                      f"{launches} times at {row['folds']} folds; want "
                      f"{want}")
            else:
                check(launches == 0, f"22b {mode}: K1-stacked launched "
                      f"{launches} times; the fused eval is highest's only")
        for row in (rows[mode][0], cross[mode]):
            if "tensor_core_kernels" not in row:
                continue
            found = row["tensor_core_kernels"]
            arith = PREC_ARITHMETIC[mode]
            if arith is None:
                check(not found["TF32"] and not found["BF16"],
                      f"22b highest at {row['folds']} folds ran tensor-core "
                      f"kernels: {found}")
            else:
                check(bool(found[arith]), f"22b {mode} at {row['folds']} "
                      f"folds ran no {arith} tensor-core GEMM or "
                      f"convolution: {found}")
        check(rows[mode][0]["test_acc"] > 50.0, f"22b {mode}: separable "
              f"pool test accuracy {rows[mode][0]['test_acc']:.2f}% after "
              f"{PREC_EPOCHS + 2} epochs (chance 25%)")
        if mode != "highest":
            tol = PREC_LOSS_UNITS * PREC_UNIT[mode]
            err = float(((first[mode] - first["highest"]).abs()
                         / first["highest"].abs()).max())
            check(err <= tol, f"22b {mode}: first-step losses at dropout 0 "
                  f"within {err:.3e} of highest's, relative; tolerance "
                  f"{tol:.3e}")
            rows[mode][0]["first_step_loss_rel_err"] = err
            rows[mode][0]["first_step_loss_rtol"] = tol
    check(_same_result(runs["high"][0], runs["default"][0]),
          "22b high and default differ; on the card both are TF32")
    check(_same_result(runs["highest"][0], runs["highest"][1]),
          "22b the highest run after the other modes differs from the one "
          "before them: the f32 pins were not restored")
    out = {"ws36": {}, "cs90": {}}
    for mode in PREC_MODES:
        r36, r90 = rows[mode], cross[mode]
        rate = statistics.mean(r["fold_epochs_per_s"] for r in r36)
        row = dict(r36[0], fold_epochs_per_s=rate,
                   turns=[r["fold_epochs_per_s"] for r in r36])
        row.update(_mfu_fields(row, mode))
        out["ws36"][mode] = row
        out["cs90"][mode] = r90
        for n, r in ((36, row), (90, r90)):
            prof = r.get("epoch_profile")
            seen = ("not profiled" if prof is None else
                    f"idle share {prof['device_idle_share']}, top: "
                    + ", ".join(f"{k['name'][:48]} {k['ms']:.1f} ms"
                                for k in prof["top_device_ms_per_call"])
                    + "; tensor cores " + str(
                        {k: len(v) for k, v in
                         r["tensor_core_kernels"].items()}))
            log(f"22a {mode} at {n} folds: {r['fold_epochs_per_s']:.2f} "
                f"fold-epochs/s, {r['gflops_per_s']:.1f} GFLOP/s = "
                f"{100 * (r['mfu'] or 0):.3f}% MFU ({r['peak']}), peak "
                f"{r['peak_memory_gib']:.2f} GiB, test acc "
                f"{r['test_acc']:.1f}%; {seen}; run {r['run_s']:.1f} s "
                f"(build {r['build_s']:.1f}, last epoch "
                f"{r['last_epoch_s']:.1f})")
    out["k1_stacked_launches"] = sum(
        r["k1_stacked_launches"] for m in PREC_MODES
        for r in rows[m] + [cross[m]])
    log("22b: every mode's two runs bitwise equal, high == default, highest "
        "after the other modes == highest before them; K1-stacked only "
        "under highest; first-step loss rel err "
        + ", ".join(f"{m} {rows[m][0]['first_step_loss_rel_err']:.2e}"
                    for m in PREC_MODES[1:]))
    return out


def _prec_tree(np, root: Path, subject: int = 1):
    """A processed tree of one separable subject under ``root``."""
    from eegnetreplication_tpu_torch.config import Paths
    from eegnetreplication_tpu_torch.data.io import save_trials, trials_filename

    paths = Paths.from_root(root)
    for mode in ("Train", "Eval"):
        save_trials(separable_subject(np, subject, mode),
                    paths.data_processed / mode
                    / trials_filename(subject, mode))
    return paths


def _f32_npz(np, path: Path) -> None:
    with np.load(path) as saved:
        kinds = {saved[k].dtype for k in saved.files
                 if saved[k].dtype.kind == "f"}
    check(kinds == {np.dtype("float32")},
          f"{path.name}: floating arrays {kinds}, want f32 only")


def _prec_cli(torch, np, dev, work: Path, env: dict) -> dict:
    """22c-d: a bf16 run stopped after its first chunk in process, its
    resume under highest refused, then ``train --precision bf16 --resume``
    completing beside ``train --meshData 2 --precision bf16``; the bf16
    model served and predicted."""
    import contextlib as ctx
    import io as io_

    from eegnetreplication_tpu_torch import predict
    from eegnetreplication_tpu_torch.config import DEFAULT_TRAINING
    from eegnetreplication_tpu_torch.resil import inject
    from eegnetreplication_tpu_torch.serve.engine import (
        InferenceEngine,
        variables_digest,
    )
    from eegnetreplication_tpu_torch.training.checkpoint import (
        load_checkpoint,
        to_jax_variables,
    )
    from eegnetreplication_tpu_torch.training.protocols import (
        within_subject_training,
    )

    paths = _prec_tree(np, work / "cli")
    mesh_paths = _replicated_tree(paths.project_root, work / "mesh",
                                  subjects=(1,))
    kw = dict(epochs=PREC_CLI_EPOCHS, subjects=(1,), paths=paths, seed=0,
              save_models=False, device=dev, checkpoint_every=PREC_CLI_EVERY)
    with _environ(EEGTPU_DATA_ROOT=str(paths.project_root)):
        try:
            with inject.scoped(inject.FaultSpec("train.chunk", after=0)):
                within_subject_training(
                    config=DEFAULT_TRAINING.replace(precision="bf16"), **kw)
            check(False, "22c: the bf16 run was not stopped after its "
                  "first chunk")
        except RuntimeError as exc:
            check("injected" in str(exc), f"22c: {exc}")
        try:
            within_subject_training(config=DEFAULT_TRAINING, resume=True,
                                    **kw)
            check(False, "22c: a highest --resume of a bf16 snapshot "
                  "trained")
        except ValueError as exc:
            check("different run" in str(exc), f"22c: {exc}")
    train = [sys.executable, "-m", "eegnetreplication_tpu_torch.train",
             "--precision", "bf16", "--subjects", "1", "--epochs"]
    procs = {
        "resume": _spawn(train + [str(PREC_CLI_EPOCHS), "--checkpointEvery",
                                  str(PREC_CLI_EVERY), "--resume",
                                  "--metricsDir", str(work / "obs_cli")],
                         dict(env, EEGTPU_DATA_ROOT=str(paths.project_root)),
                         work / "resume.log"),
        "mesh": _spawn(train + [str(PREC_CLI_EVERY), "--meshData", "2",
                                "--metricsDir", str(work / "obs_mesh")],
                       dict(env, EEGTPU_DATA_ROOT=str(mesh_paths.project_root)),
                       work / "mesh.log")}
    done = _wait_all(procs, {k: work / f"{k}.log" for k in procs},
                     MESH_WAIT_S)
    out = {}
    for name, metrics, root, want_mesh in (
            ("resume", work / "obs_cli", paths, None),
            ("mesh", work / "obs_mesh", mesh_paths, {"data": 2})):
        rc, err = done[name]
        check(rc == 0, f"22c-d {name} exited {rc}: {err[-3000:]}")
        check("not ported" not in err, f"22c-d {name}: {err[-500:]}")
        events = _journal(np, metrics, "ok")
        start, end = events[0], events[-1]
        check(start["config"]["precision"] == "bf16",
              f"22c-d {name}: run_start config {start['config']}")
        if want_mesh:
            check(all(start["mesh_shape"].get(k) == v
                      for k, v in want_mesh.items()),
                  f"22d mesh_shape {start['mesh_shape']}")
        launches = end.get("kernel_launches", {})
        check(launches.get("block1_stacked") == 0,
              f"22c-d {name}: K1-stacked launches {launches} under bf16")
        _check_report(root.reports / "latest_within_subject_report.json",
                      WS_REPORT_KEYS, f"22c-d {name}")
        npz = root.models / "subject_01_best_model.npz"
        _f32_npz(np, npz)
        out[name] = {"npz": str(npz), "wall_s": end.get("wall_s")}
    npz = Path(out["resume"]["npz"])
    digest = variables_digest(*to_jax_variables(load_checkpoint(npz)[0]))
    engine = InferenceEngine.from_checkpoint(npz, device=dev)
    check(engine.digest == digest, f"22c: served digest {engine.digest} != "
          f"the file's {digest}")
    x = separable_subject(np, 1, "Eval")
    served = engine.infer(x.X)
    stdout = io_.StringIO()
    with _environ(EEGTPU_DATA_ROOT=str(paths.project_root)), \
            ctx.redirect_stdout(stdout):
        predict.main(["--checkpoint", str(npz), "--subject", "1"])
    want = f"accuracy: {100.0 * float(np.mean(served == x.y)):.2f}%"
    check(stdout.getvalue().strip().splitlines()[-1] == want,
          f"22c predict printed {stdout.getvalue()!r}, served {want!r}")
    out.update(variables_digest=digest, predict=want)
    log(f"22c: a bf16 snapshot refused under highest ('different run'); "
        f"train --precision bf16 --resume exits 0 (report keys, f32 .npz, "
        f"journal names bf16, 0 K1-stacked launches), served digest "
        f"{digest[:12]}, predict {want}; 22d: train --meshData 2 "
        f"--precision bf16 exits 0 (the DP step's bf16 losses: 21c)")
    return out


def phase_precision(torch, np, dev, work: Path, env: dict) -> dict:
    """Phase 22: the numerics modes (see the module docstring)."""
    t0 = time.perf_counter()
    work.mkdir(parents=True, exist_ok=True)
    out = _prec_rates(torch, np, dev)
    out["cli"] = _prec_cli(torch, np, dev, work, env)
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 22 (the numerics modes): {out['wall_s']:.1f}s")
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None,
                        help="Also write every number as JSON to this file.")
    parser.add_argument("--long", action="store_true",
                        help="Add phase 16d: the 90-fold cross-subject "
                             "protocol at 500 epochs under the supervisor "
                             "(~12 minutes more).")
    args = parser.parse_args(argv)

    os.environ.setdefault("EEGTPU_NO_LOG_FILE", "1")
    os.environ.pop("EEGTPU_PLATFORM", None)   # the port's default: the card
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is false; this "
              "smoke test runs on a CUDA card", file=sys.stderr)
        return 1
    try:
        import numpy as np

        import eegnetreplication_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: FAIL: cannot import the torch port ({exc}); run "
              "from the repository root", file=sys.stderr)
        return 1

    env = dict(os.environ, PYTHONUNBUFFERED="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    from eegnetreplication_tpu_torch.utils.device import select_device

    t_start = time.perf_counter()
    walls: dict[str, float] = {}
    clock = [t_start]

    def mark(phase: str) -> None:
        """The wall of ``phase``: since the previous mark (host clock)."""
        now = time.perf_counter()
        walls[phase] = now - clock[0]
        clock[0] = now
        log(f"wall of phase {phase}: {walls[phase]:.1f} s")

    stack = contextlib.ExitStack()
    try:
        # Phase 10's models and report, kept for phase 20.
        keep = Path(stack.enter_context(tempfile.TemporaryDirectory(
            prefix="chip_smoke_keep_")))
        card = phase_device(torch)
        dev = select_device()
        build_s = phase_build()
        k1_err = phase_k1(torch, dev)
        k1s_err = phase_k1_stacked(torch, dev)
        fwd_err = phase_forward(torch, dev)
        mark("1-4")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            serve = phase_serve(torch, np, dev, Path(tmp), env)
        mark("5")
        timer_floor = phase_timer_floor(torch, dev)
        times = phase_times(torch, np, dev)
        k1s_times = phase_k1_stacked_times(torch, dev)
        mark("6")
        k2_err, k2_vs_methods = phase_k2(torch, np, dev)
        mark("7")
        # Phase 8's tree lives until phase 17, which runs last so that it
        # leaves nothing behind for an earlier path.
        with tempfile.TemporaryDirectory(prefix="chip_smoke_data_") as data:
            dataset = phase_dataset(torch, np, dev, Path(data), env)
            mark("8")
            with tempfile.TemporaryDirectory(
                    prefix="chip_smoke_moabb_") as tmp:
                moabb = phase_moabb(torch, np, dev, Path(tmp), env, card)
            mark("8c")
            k2_times = phase_k2_times(torch, np, dev,
                                      Path(dataset["raw_session"]),
                                      Path(data))
            mark("9")
            train = phase_train(torch, np, dev, Path(data) / "train", env,
                                Path(data) / "cli")
            _keep_training_artifacts(Path(data) / "cli", keep)
            mark("10")
            cs = phase_cross_subject(torch, np, dev, Path(data) / "cs", env,
                                     Path(data) / "cli")
            mark("11")
            supervised = phase_supervised(torch, np, dev, Path(data) / "sup",
                                          env, Path(data) / "cli",
                                          long=args.long)
            mark("16")
            with tempfile.TemporaryDirectory(prefix="chip_smoke_zoo_") as tmp:
                zoo = phase_serving_zoo(torch, np, dev, Path(tmp), env,
                                        card, cs["resume_drill"]["orbax"])
            mark("12")
            with tempfile.TemporaryDirectory(
                    prefix="chip_smoke_streams_") as tmp:
                streams = phase_streams(torch, np, dev, Path(tmp), env)
            mark("13")
            with tempfile.TemporaryDirectory(
                    prefix="chip_smoke_control_") as tmp:
                control = phase_control(torch, np, dev, Path(tmp), env)
            mark("14")
            with tempfile.TemporaryDirectory(
                    prefix="chip_smoke_adapt_") as tmp:
                adapt = phase_adapt(torch, np, dev, Path(tmp), env)
            mark("15")
            model_layer = phase_model_layer(torch, np, dev,
                                            Path(data) / "models", env,
                                            Path(data) / "cli")
            mark("17")
            mesh = phase_mesh(np, Path(data) / "mesh", env,
                              Path(data) / "cli", card)
            mark("21")
            precision = phase_precision(torch, np, dev,
                                        Path(data) / "precision", env)
            mark("22")
        # The fleet runs alone, after every other server has ended; its
        # journals stay for phase 20.
        fleet_dir = Path(stack.enter_context(tempfile.TemporaryDirectory(
            prefix="chip_smoke_fleet_")))
        fleet = phase_fleet(torch, np, dev, fleet_dir, env)
        mark("18")
        # The cell tier runs alone, after the fleet has ended.
        cells_dir = Path(stack.enter_context(tempfile.TemporaryDirectory(
            prefix="chip_smoke_cells_")))
        cells = phase_cells(torch, np, dev, cells_dir, env)
        mark("19")
        tooling = phase_tooling(np, keep, fleet_dir, cells_dir, card, train)
        mark("20")
    except Exception:  # noqa: BLE001 — every failure ends the run
        traceback.print_exc()
        print("chip_smoke: FAIL", file=sys.stderr)
        return 1
    finally:
        stack.close()

    top = times[BUCKETS[-1]]
    kernels = {"kernels": [{
        "name": "block1",
        "route": "cuda",
        "source": "eegnetreplication_tpu_torch/ops/csrc/block1.cu",
        "replaces": "eegnetreplication_tpu/ops/fused_eegnet.py:134",
        # the serve phase's server, the int8 server of phase 12 (a
        # request, and its reload to an Orbax directory), the
        # tuned server of phase 14 (graph replays counted per replay), the
        # adapting server of phase 15 (the shadow's replays, the stack
        # gates' references), phase 16c's supervised server before its
        # hang and after its relaunch, phase 18a's three fleet replicas
        # (each read from its /healthz) and every cell process of phase
        # 19 (its /healthz, or its serve_end once retired)
        "launches": (serve["launches"] + zoo["int8"]["k1_launches"]
                     + zoo["int8"]["orbax_reload"]["k1_launches"]
                     + control["tuned"]["launches"]
                     + adapt["launches"]["got"]["block1"]
                     + supervised["server"]["k1_launches"]
                     + sum(fleet["boot"]["k1_launches"].values())
                     + cells["counts"]["k1_launches"]),
        "max_abs_err": k1_err,
        "ms": top["ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": top["library_ms"],
    }, {
        "name": "block1_stacked",
        "route": "cuda",
        "source": "eegnetreplication_tpu_torch/ops/csrc/block1_stacked.cu",
        "replaces": "eegnetreplication_tpu/ops/fused_eegnet.py:134",
        # the counted runs of the training phases (10 and 11), the zoo
        # server's counted chunks (phase 12), the adapting server of
        # phase 15 (its chunks, fit accuracies and restacks), and phase
        # 16's train CLIs, each counting in its run_end (the unbroken run
        # and the supervised launches that ended; --long's too), phase
        # 17's three counted EEGNet runs (banded, lax, banded), phase
        # 21's mesh runs (their run_end sums over the ranks) and drill,
        # and phase 22's runs (highest's only: the other modes launch
        # none)
        "launches": (train["launches"] + cs["launches_one_group"]
                     + cs["launches_groups"]
                     + zoo["zoo"]["k1_stacked_launches"]
                     + adapt["launches"]["got"]["block1_stacked"]
                     + supervised["training"]["launches_block1_stacked"]
                     + supervised.get("long", {}).get(
                         "launches_block1_stacked", 0)
                     + 3 * model_layer["conv_ab"]["k1_stacked_launches_each"]
                     + mesh["k1_stacked_launches"]
                     + precision["k1_stacked_launches"]),
        "max_abs_err": k1s_err,
        # at the 90-fold cross-subject validation batch, (5760, 22, 257)
        "ms": k1s_times[5760]["ms"],
        "plain_ms": k1s_times[5760]["plain_ms"],
        "bound_ms": k1s_times[5760]["bound_ms"],
        "bound_by": k1s_times[5760]["bound_by"],
        "library_ms": k1s_times[5760]["library_ms"],
        # at the zoo's 128-trial chunk mixed over nine tenants
        "zoo_chunk": {k: zoo["k1_stacked_zoo_chunk"][k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
    }, {
        "name": "ems",
        "route": "cuda",
        "source": "eegnetreplication_tpu_torch/ops/csrc/ems.cu",
        "replaces": "eegnetreplication_tpu/ops/ems_pallas.py:95",
        # phase 8's sessions and phase 8c's moabb runs
        "launches": dataset["launches"] + moabb["launches"],
        "max_abs_err": k2_err,
        "ms": k2_times["ms"],
        "plain_ms": k2_times["plain_ms"],
        "bound_ms": k2_times["bound_ms"],
        "bound_by": k2_times["bound_by"],
        "library_ms": None,   # no single PyTorch call computes EMS
        "associative_ms": k2_times["associative_ms"],
    }, {
        "name": "ems_stream",
        "route": "cuda",
        "source": "eegnetreplication_tpu_torch/ops/csrc/ems_stream.cu",
        "replaces": ("eegnetreplication_tpu/ops/ems.py:244 (_stream_chunk, "
                     "lax.scan, not Pallas)"),
        # the three session servers of phase 13, the drifting session
        # of phase 15, phase 18a's session through the fleet, phase 19's
        # sessions on every cell process and phase 21d's time shards
        "launches": (streams["launches"]
                     + adapt["launches"]["got"]["ems_stream"]
                     + fleet["boot"]["session"]["ems_stream_launches"]
                     + cells["counts"]["ems_stream_launches"]
                     + mesh["ems_stream_launches"]),
        "max_abs_err": streams["k2s"]["max_abs_err"],
        # at a push of 25 samples, (22, 25)
        **{k: streams["times"]["by_n"][STREAM_CHUNK][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,   # no single PyTorch call computes the carry
        "chain_ms": streams["times"]["by_n"][STREAM_CHUNK]["chain_ms"],
        "by_n": {str(n): {k: row[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "chain_ms")}
            for n, row in streams["times"]["by_n"].items()},
    }]}
    record = {
        "card": card, "build_s": build_s, "k1_max_abs_err": k1_err,
        "forward_max_abs_err": fwd_err, "serve": serve,
        "timer_floor": timer_floor,
        "times_by_bucket": times, "k2_max_abs_err": k2_err,
        "k2_vs_methods_max_abs_err": k2_vs_methods, "dataset": dataset,
        "moabb": moabb,
        "k2_times": k2_times, "k1_stacked_max_abs_err": k1s_err,
        "k1_stacked_times": k1s_times, "train": train, "cross_subject": cs,
        "serving_zoo": zoo, "orbax": {
            "trained": cs["resume_drill"]["orbax"],
            "reload": zoo["int8"]["orbax_reload"], **zoo["orbax"]},
        "streams": streams, "control": control,
        "adapt": adapt, "supervised": supervised,
        "model_layer": model_layer, "fleet": fleet, "cells": cells,
        "tooling": tooling, "mesh": mesh, "precision": precision,
        "phase_walls": walls,
        "wall_s": time.perf_counter() - t_start,
    }
    log(f"chip_smoke total {record['wall_s']:.1f} s")
    print(json.dumps({"timings": record}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(record, **kernels),
                                             indent=1))
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
