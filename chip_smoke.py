#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Set-up: the card's name and power limit (nvidia-smi), the torch and
   CUDA versions, and the build of the hand-written kernels from
   ``src/repro_torch/csrc`` (timed).
2. Each kernel against its plain PyTorch twin on the card, with
   ``torch.equal`` on every output (integers: zero tolerance), at the
   main path's shapes — mid-solve ``tent``/``explored`` states recorded
   from a solve of the full-width graph below — and on edge cases: a
   length that is not a multiple of the block size, ``cap`` below the
   frontier population, all-INF input, sentinel ``fidx``, a
   zero-width ELL block, ``bucket_scan`` on int32 input over the whole
   range with negative buckets and buckets past int32, views 4 bytes
   past 16-byte alignment (the scalar paths of ``bucket_scan`` and
   ``ell_relax``) and n = 0; ``frontier_relax`` over the same int32
   range and buckets, on an unaligned view (its scalar scan), with a
   shard's ``base``/``sent``, and in calls of different S and ``cap``
   queued back to back on one stream.
3. The main path at full width: ``watts_strogatz(1_000_000, 20, 1e-2)``
   (20 M directed edges, weights 1..20), Δ = 10, source 0, solved
   through ``Engine(...).plan().solve(SingleSource(0))`` on CUDA with
   ``fused``, ``pallas``, ``ell`` and ``edge`` (pred_mode ``argmin``) and
   ``fused`` with ``packed``. The launch counters are set to 0 just
   before and read just after. All runs must agree bitwise (dist, pred,
   buckets, inner_iters, overflow); ``dist`` must equal scipy's Dijkstra
   on the edge list with duplicate (u, v) pairs reduced to their minimum
   weight, and ``pred`` must be a shortest-path tree.
4. The scale-free family: ``rmat(2**20, 16 * 2**20)`` under ``edge`` with
   the same oracle check (the ELL strategies pad every row to the
   maximum degree, which R-MAT makes huge).
5. The game-map path at full width, the repo's ``sssp-gamemap``
   configuration: ``grid_map(3000, 3000, 0.1, seed=0)`` (9 M cells,
   ~58 M directed edges, costs 10 / 14), Δ = 13, the first free cell as
   source, through ``Engine(..., free_mask=free)`` on CUDA
   (``GridPallasBackend``: the ``grid_relax`` stencil and
   ``bucket_scan``). ``grid_relax`` against its twin on sweep inputs
   recorded from the warm-up solve and on edge cases on both of its
   paths (1 x 1, 1 x W, H x 1, widths a multiple of 4 and not, heights
   no multiple of its row band, a ``tent`` 4 bytes past 16-byte
   alignment, all-blocked, all-INF, values within 14 of INF, a bucket
   past int32, Δ = 5 / 13 / 20); ``bucket_scan`` against its twin on
   scan inputs recorded from the same solve (after light sweeps, after
   heavy passes and before the first sweep). Then the path's main run,
   with the counters set to 0 just before and read just after:
   ``SingleSource`` with ``dist`` equal to scipy's Dijkstra and ``pred``
   a shortest-path tree, and launches equal to ``buckets +
   inner_iters`` (``grid_relax``) and ``2 * buckets + inner_iters``
   (``bucket_scan``). Then ``GridDeltaSolver`` with its default config
   (dist equal, and ``outer_iters + inner_iters`` launches of the
   kernel); ``PointToPoint`` to the last free cell and to a cell near
   the source (distance equal to the single-source ``dist``, a valid
   path of that weight, fewer buckets for the near target);
   ``BoundedRadius(1000)`` (the single-source
   answer filtered at 1000); on a 512 x 512 map the grid plan bitwise
   equal to ``edge`` (dist, pred, buckets, inner_iters); the median of
   ``GRID_REPS`` timed runs of each query after warm-up; one profiled
   solve.
6. Times: per strategy the median solve wall time of three solves after
   the warm-up, with host synchronisations and counters.
7. One profiled solve per strategy (``torch.profiler``): device busy
   time, idle share, the kernels that take the most device time, and
   the profiler's records of each port kernel against its wrapper's
   launches. Per kernel at the main path's shapes: device time per
   wrapper call and its twin's, from CUDA events around back-to-back
   calls that the host queues during a device-side spin (so no host
   time enters the window); ``wrapper_ms``, the same calls back to back
   with the host's launch time in them; ``cold_ms``, CUDA events around
   each call after a 128 MiB write that empties the L2 and a
   device-side spin in which the host queues the call (both outside the
   timed window); the
   profiler's breakdown by kernel where it kept a record of every
   launch (it loses records of windows a few ms long), where a call
   must show only its wrapper's own kernels, one each (one for
   ``bucket_scan`` and ``ell_relax``, two for ``frontier_relax``), or
   the run fails; a yardstick per path (a PyTorch call moving part of
   the kernel's bytes: ``fill_`` of the outputs for ``ell_relax`` and
   ``frontier_relax``); on the game-map path
   ``in_solve_ms``, the profiled solve's device time of the kernel over
   its launches (null where the profiler dropped a record); and its
   bound (the bytes this input needs ÷ 3.35 TB/s, or its integer
   operations ÷ 16.7 T/s, the int32 rate, if larger; the run fails
   where ``ms`` or ``cold_ms`` falls below it),
   at each path's shapes (``bucket_scan`` runs on the small-world and
   the game-map paths: n = 1 M and n = 9 M). ``launches`` in the
   kernels line sums every path's counted runs (phases 3, 5, 8, 9, 11,
   12, 13, 14; phases 15 and 16 launch none);
   ``by_path`` gives each path's launches and numbers, and the entry's
   ``ms``, ``cold_ms``, ``plain_ms`` and ``bound_ms`` are their means
   weighted by those launches, so they move when a path is added.

8. Batched queries and frontier policies, on the graphs above (run
   after phase 4; the game-map part at the end of phase 5). On the
   1 M-vertex small-world graph: ``MultiSource`` of 8 fixed sources (0
   and seven spread ids) on ``edge``, and of the first 2 of them on
   ``ell`` (one ``[B, n]`` loop, fewer host syncs than the lanes' single
   solves together), of 2
   sources on ``pallas`` and ``fused`` (lane by lane through the
   kernels, launches equal to the lanes' per-solve equations); every
   lane bitwise equal to ``edge``'s ``SingleSource`` of its source
   (phase 3 holds every strategy's single solve bitwise equal to
   ``edge``'s), and lane 3 equal to scipy's Dijkstra. ``ManyToMany`` (16
   sources, 1000 targets, tile 8, ``edge``) equal to the ``MultiSource``
   rows. ``frontier_cap=4096`` on ``ell``, ``pallas`` and ``fused``:
   without fallback the solve reports overflow, launches its kernels by
   its own counters' equations and answers bitwise as the same loop on
   the CPU (``ell``'s for ``pallas``; those CPU answers come from a
   process of their own, ``chip_smoke.py --capped-host DIR``, started
   before phase 1 on the same graph made from its seed, its checksum
   compared); with ``fallback=True`` it answers as the uncapped plan of
   phase 3, with ``telemetry.fallback`` and
   ``explain()["fallback_taken"]`` set, and launches what the capped
   solve and the full-width twin's solve launch together. ``rho``
   (default ρ) and ``radius`` (k = 4) on ``edge`` and ``pallas``:
   ``dist`` and argmin ``pred`` equal to the delta answer, two
   ``ell_relax`` launches per policy step on ``pallas`` and no bucket
   scan; ``PointToPoint`` and ``BoundedRadius`` under ``rho``. On the
   game map: ``MultiSource`` of 2 sources on the grid plan, each lane
   equal to its single solve, launches equal to the lanes' equations.
   Wall times (median of 3; one timed run, apart from the counted one,
   for the lane-by-lane batches, ``ell``'s batch, ``ManyToMany``, the
   fallback and, ``POLICY_REPS``, the policies), host syncs and
   launches per path. The counters are
   set to 0 just before each counted run and read just after; each
   path's launches join ``by_path`` in the kernels line
   (``smallworld_multisource``, ``smallworld_policy``,
   ``smallworld_fallback`` for the capped solves,
   ``smallworld_fallback_twin`` for the full-width re-solves,
   ``gamemap_multisource``), and each kernel is timed and held against
   its twin on every path at that path's own recorded input with the
   largest frontier (lane 1 of a batch; the policy solves; the capped
   solves, ``fidx`` of 4096 rows; a re-solve is phase 3's solve, so
   its inputs are phase 2's).

9. Dynamic graphs (run after phase 7; it updates phase 3's plans), on
   the 1 M-vertex small-world graph with the update protocol of
   ``benchmarks/bench_dynamic.py:_batches`` (seeded id sets of k =
   20 000 edges, 0.1 % of |E| (k = 200 000, 1 %, was cut for time in
   PR 25; ``DYN_KS``), each with two
   distinct weight assignments ``clip(w0 + U[-5, 5], 1, 20)``, cycled so
   no batch is a no-op). ``edge``, ``ell``, ``pallas`` and ``fused``
   (argmin) and ``fused`` (packed): ``SingleSource(0)``, then per k the
   counted ``plan.solve(UpdateBatch(...))``: warm with ``repaired >
   0``, ``dist``/``pred`` bitwise equal to the warm answer of every
   other strategy on the same weights, to a fresh ``Engine``'s cold
   solve of the updated graph on ``edge`` and to the plan's own
   ``resolve(warm=False)`` on the others, ``dist`` equal to scipy's
   Dijkstra once per k and ``pred`` a shortest-path tree, and launches
   equal to the warm runs' own equations (``pallas`` on its rebuilt
   backend; the ``fused`` twin by ``fused``'s; a twin overflow's
   full-width re-run adds its own). The strategies ``DYN_TIMED``
   (``edge``) take one warm-up batch (two before PR 25's cut for time;
   its weights end as they did) before the first
   counted one and, after it (the first k only), are timed: ``DYN_REPS``
   more batches (update + warm resolve, split into update, host repair
   planning, warm backend, device loop and the rest, each part checked
   to be timed, with host syncs) and ``DYN_REPS``
   ``resolve(warm=False)``, the first held equal to the warm answer. At the second k only ``edge``
   and ``fused`` (argmin) take a batch, the counted one. The others take
   the counted batches
   only (so after the first k their weights are not ``edge``'s, and
   each is held to its own ``resolve(warm=False)``). ``rho`` and
   ``radius`` (k = 4) on ``edge``: one counted warm batch equal to the
   cold solve of the updated graph. ``square_lattice(400,
   weighted=True)`` under ``edge``, ``pallas`` and ``fused``: the tree
   edge into the vertex farthest from the source raised by 7 and
   restored, each warm answer equal to the cold one with far fewer
   buckets; three more flips timed. One profiled warm ``pallas`` batch.
   The counted runs join
   ``by_path`` as ``smallworld_warm`` and ``lattice_warm``.

10. Landmark point-to-point queries (run after phase 7 and before phase
   9, on plans of their own, so phase 3's scipy distances are the
   oracle). On the 1 M-vertex small-world graph, a fresh ``edge`` plan
   (Δ = 10): ``prepare_landmarks(k=4)`` (farthest, seed 0, tables in a
   temporary store directory), timed and split into ``graph_stats``,
   fingerprint, whash and selection + rows; one landmark's ``d_out`` and
   ``d_in`` rows equal to scipy on the forward and the reversed edge
   list; the all-light ELL blocks' host build, timed. ``early_exit``,
   ``alt``, ``bidirectional`` and ``alt_bidirectional`` from source 0 to
   the farthest vertex (largest finite distance, lowest id; the vertex
   at the median finite distance too before PR 25's cut for time):
   distance equal to
   scipy's, a valid path of that weight, ``host_syncs == 2 * buckets +
   inner_iters + 1``, no overflow; wall times (``LANDMARK_REPS`` runs
   after one warm-up). One profiled
   ``alt`` query: device busy time, idle share and the scatter's share,
   with its records held against ``2 * (buckets + inner_iters) + 1``
   (a compaction and a scatter-min per sweep, one scatter-min in pred
   recovery). A second plan's ``prepare_landmarks`` hits the store
   (timed; tables bitwise equal). Phase 9's update protocol at k =
   20 000: an increase-only batch keeps the tables (``alt`` equal to
   scipy on the updated weights), the raw batch (with decreases) drops
   them under ``recompute`` and the next ``alt`` rebuilds them and
   equals ``early_exit``; under ``on_update="refuse"`` a decreasing
   batch raises ``LandmarkRefused(reason="landmarks_stale")`` with the
   weights bitwise unchanged. On the 512 x 512 game map (Δ = 13) as a
   grid plan, each landmark mode from the first to the last free cell:
   distance equal to the grid plan's ``SingleSource``, a valid path. The
   launch counters are set to 0 after the game map's reference solve
   and read at the end of the phase: all four must read 0 (the landmark
   solves run an all-light ``EllBackend``; no kernel is on their path).

11. The tuner (run after phase 9), on the 1 M-vertex small-world graph.
   ``Engine(g)`` resolves the estimator's Δ without the hop-radius probe
   (checked against ``estimate_delta``; its time printed). The measured
   search ``tune(sources=(0,), strategies=("edge", "fused"),
   policies=("delta",))`` over the estimator's Δ grid and both cap
   fractions (n and n / 4) into a temporary cache, with the launch
   counters set to 0 just before and read just after: ``frontier_relax``
   and ``bucket_scan`` must have launched; every trial and the winner
   are printed, and the candidates rejected on overflow. The tuned plan
   through ``Tuning(measure=True, cache)`` must be a cache hit (its cap
   re-validated on 3 sources), ``tuning=<path>`` must find the measured
   record, and its ``SingleSource(0)`` must equal the explicit winner
   config's bitwise (dist, pred, buckets, inner_iters, overflow),
   scipy's, with a shortest-path tree. The launcher's ``--tune-cache``
   must print the same record. One more solve of the fastest ``fused``
   candidate keeps each kernel's largest input (``smallworld_tune``).
12. The serving tier: ``Server(lane_width=8, max_resident=2)`` on CUDA
   with three tenants — the 1 M graph under ``tuning=<phase 11's
   cache>``, the same graph under ``DeltaConfig(strategy="fused")`` and
   ``grid_map(512, 512, 0.1)`` as a grid plan (Δ = 13) — serves the
   request mix of ``benchmarks/bench_serving.py:_traffic`` (copied; 24
   requests from seed 0, 48 before PR 25's cut for time) and one ``SingleSource`` per tenant, through
   the background batch loop (``with srv:``), with the counters set to
   0 just before and read just after, each launch attributed to its
   tenant's graph (``smallworld_serve``, ``gamemap_serve``). Every
   ticket must be answered, but the grid's updates, which must be shed
   as ``update_refused``; ``stats()`` must count them so and show
   evictions and re-admissions; every answer must equal a serial
   ``plan.solve`` of the same query on a fresh plan (dist and pred,
   the matrix, a p2p distance with a valid path; a single source's
   counters too), and the three appended answers scipy's. The serial
   re-solves keep each kernel's largest input. ``stats()`` is printed:
   p50/p99 latency, occupancy, batches, shed counts, evictions.

13. The multi-GPU path (run after phase 12), on the 1 M-vertex
   small-world graph at Δ = 10. (a) A one-rank NCCL group in this
   process (a ``FileStore`` in a temporary directory): ``sharded_edge``,
   ``sharded_ell``, ``sharded_fused`` (argmin) and ``sharded_fused``
   (packed), each bitwise equal to phase 3's single-device answer of
   its counterpart (dist, pred, buckets, inner_iters, overflow), with
   the counters set to 0 just before the first solve and read just
   after (``frontier_relax`` ``buckets + inner_iters`` times on
   ``sharded_fused``, nothing else), then the median of 3 solves. (b)
   Two gloo ranks sharing the card, each a process of its own with a
   time limit (``chip_smoke.py --sharded-rank R 2 DIR``), on the graph
   written to ``DIR``: ``sharded_edge`` and ``sharded_fused`` at P = 2,
   equal to phase 3 on both ranks, rank ``r`` launching
   ``frontier_relax`` ``buckets + inner_iters`` times at ``base = r *
   500 000``; the distributed engine on the ``(1, 2)`` and ``(2, 1)``
   meshes of ``launch.mesh.make_host_mesh`` under both combines and
   ``local_steps`` 1 and 2, ``dist`` of sources 0 and 131 071 equal to
   scipy's. (c) ``frontier_relax``
   against its twin (``torch.equal`` on all six outputs) on shard 1's
   slice of ``partition_ell(g, 2, 10)`` (S = 500 000, ``base`` = S,
   ``sent`` = n) at three of phase 2's recorded mid-solve states, the
   largest kept as the ``sharded`` path of the kernels line (timed as
   in phase 7); the one-rank solves join it as ``sharded_nccl1`` on
   phase 2's inputs (a one-rank shard is the whole graph at base 0).
   (d) The three example twins (``examples/torch_*.py``) on the card,
   as processes of their own; the quickstart under ``-W
   error::DeprecationWarning``.
14. Sharded serving (run after phase 13, in its one-rank NCCL group), on
   the 1 M-vertex small-world graph at Δ = 10. (a) ``Server(lane_width=2)``
   with a ``sharded_edge`` tenant (``SingleSource(0)``, then a seeded
   slice of phase 12's mix: 8 requests from seed 35) and a
   ``sharded_fused`` tenant (``SingleSource(0)`` and ``PointToPoint(0,
   777 777)``, one lane batch), every request queued before the
   background loop starts, the counters set to 0 just before and read
   just after: ``frontier_relax`` launched ``buckets + inner_iters``
   times per fused lane and nothing else launched (the path
   ``sharded_serve``); the fused answers equal to phase 3's ``fused``
   solve (a valid path of that distance), the edge tenant's
   ``SingleSource(0)`` equal to phase 3's ``edge`` solve and every edge
   ticket equal to a serial solve on a fresh ``sharded_edge`` plan with
   the updates applied in order. (b) Two gloo ranks on the card
   (``chip_smoke.py --serve-rank R 2 DIR``) serving the edge tenant's
   requests: rank 0 submits half, idles ``SSERVE_PAUSE_S`` against a
   control-channel timeout of ``SSERVE_TIMEOUT_S``, submits the rest and
   closes; rank 0's answers equal (a)'s, both ranks' ``stats()`` counts
   are equal, and both exit 0. (c) The serving launcher under
   ``torchrun`` with one NCCL rank, ``--strategy sharded_fused
   --shards 1`` at ``--nodes 1000000 --degree 20``, exits 0 after
   answering its requests. (b) and (c) run beside (a).
15. LM decode serving (run last; the counters set to 0 just before it
   and read just after: it launches none of the four kernels, as the
   reference's LM path reaches no Pallas kernel). (a) gemma2-9b at full
   width and depth (42 layers, 9.24 B parameters, bf16), initialised on
   the card from a seeded ``torch.Generator``: a prefill of
   ``LM_PROMPT`` = 4608 tokens (nine 512-token query chunks, past the
   4096 window of the local layers), then ``LM_STEPS`` teacher-forced
   decode steps; the prefill's last logits and each step's against
   ``apply_lm`` over the whole sequence at the same position, within
   ``LM_BF16_MAX_ABS`` (max abs) and ``LM_BF16_REL`` (relative L2).
   Then the serving launcher's run: ``BatchServer`` with 4 slots and a
   64-token cache, 8 requests of 8 seeded tokens, 16 new tokens each,
   all completed with ids in range; the first 4 (admitted together,
   equal lengths) equal to their slots' steps done by hand (each prompt
   prefilled alone, then 4-slot decode steps at the server's shared
   length, one past the prefill's: the reference leaves a cache slot
   empty there), each up to its first top-2 margin under ``LM_MARGIN``,
   and their first tokens equal to ``generate``'s; then, the model
   freed, ``python -m repro_torch.launch.serve --arch gemma2-9b`` in a
   process of its own exits 0. (b) moonshot-v1-16b-a3b at full width
   (64 experts, top-6, ``d_ff_expert`` 1408, vocab 163 840), 4 of its 48
   layers, and (c) granite-20b at full width (MQA, GELU MLP, untied
   unembedding), 4 of its 52 layers: the same check on a 512-token
   prompt; for the MoE, the positions whose expert picks and capacity
   drops are the same in both runs (a whole-sequence forward gives
   every expert a capacity for 520 tokens, a decode step for 1), and a
   4-slot decode step, where the capacity is 1 an expert, that must
   drop a pick, each slot that kept every pick within the tolerance of
   its one-slot step. (d) The five smoke configs: the card's prefill
   and decode logits against the CPU's on the same seeded weights
   within ``LM_F32_TOL`` (atol = rtol, float32). ``[lm]`` lines give
   each part's time, prefill ms, ms per decode step and tokens/s at 1
   and 4 slots, weight, cache and peak memory
   (``torch.cuda.max_memory_allocated``), the bounds (weights read at
   3.35 TB/s; 2 * parameters * tokens FLOP at 989 TFLOP/s) and the
   card's name and power limit.
16. Training (run after phase 15 has freed its weights; the counters set
   to 0 just before it and read just after: it launches none of the four
   kernels, as the reference's training path reaches no Pallas kernel).
   (a) gemma2-9b at full width (d_model 3584, 16/8 heads of 256, d_ff
   14336 GeGLU, vocab 256 000, softcaps 50/30, tied embeddings, bf16,
   remat) cut to ``TR_LAYERS`` = 4 layers (two local, two global; 1.71 B
   parameters), initialised on the card from a seeded
   ``torch.Generator``, one sequence of ``TR_TOKENS`` = 4608 seeded
   tokens (nine 512-token loss chunks, past the 4096 window): the bf16
   gradient of ``lm_loss`` (timed after a warm-up); the same weights
   cast up to float32 and their gradient; the float32 gradient's
   directional derivative along one random direction (each leaf's part
   normal times the leaf's RMS) against a central difference at
   relative step ``TR_FD_STEP``, within ``TR_FD_REL``; the bf16
   gradient against the float32 one within ``TR_BF16_REL`` (‖Δ‖/‖g₃₂‖
   over all leaves) and ``TR_BF16_LEAF_REL`` (per leaf). Then
   ``TR_STEPS`` AdamW steps (lr ``TR_LR``) through ``make_train_step`` on
   the batch, the update timed on its own, the last step profiled; the
   loss after them below the first. Then one SGD-momentum step with
   ``compression="int8"``: every leaf's residual equal to its fed
   gradient minus its dequantized int8 value, bit for bit. (b) GIN,
   GatedGCN and GAT at their published widths on ``random_graph(2708,
   10556)`` (Cora's size) with ``full_graph_sm``'s 1433 features and 7
   classes, SchNet on ``molecule_batch(128, 30, 64)`` (the ``molecule``
   cell), each ``TR_SMALL_STEPS`` AdamW steps at lr ``TR_GNN_LR``; DLRM
   at its published widths (embed 128, bottom MLP 512-256-128, top MLP
   1024-1024-512-256-1, 26 tables) with each table cut to ``TR_DLRM_CAP``
   = 2**20 rows (7.4 M rows, 3.8 GB; the full Criteo tables, 96 GB, do
   not fit one card), ``TR_SMALL_STEPS`` AdamW steps on
   ``SyntheticClicks`` batches of ``TR_DLRM_BATCH``: every loss finite and
   the last below the first. (c) In a process of its own started with
   ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (``chip_smoke.py --train-restart
   DIR``), under ``torch.use_deterministic_algorithms(True)``: a
   ``Trainer`` of the tests' 2-layer LM, and one of the DLRM smoke config
   with int8 compression, that fails at step 13 and restarts from its
   step-8 checkpoint end bitwise equal to an uninterrupted run of 24
   steps (parameters, optimizer state, residuals). (d) ``python -m
   repro_torch.launch.train --arch gemma2-9b --smoke --steps 20
   --ckpt-dir DIR`` as a process of its own exits 0 with its loss
   fallen. (c) and (d) start first and run beside (a) and (b). ``[train]``
   lines give the times of forward+backward and of the update, the peak
   memory above the phase's start, the bounds, a profiled train step and
   the card's name and power limit.
17. The mesh path (run after phase 16; the counters set to 0 just
   before it and read just after: it launches none of the four kernels,
   as the reference's LM reaches no Pallas kernel under its mesh
   either), moonshot-v1-16b-a3b at full width under ``sharding_rules``
   with the reference EP test's mapping (``MESH_MAPPING``). (a) On a
   one-rank NCCL mesh, ``MESH_LAYERS`` = 4 layers, ``MESH_BATCH`` x
   ``MESH_SEQ`` tokens: float32 logits of ``impl="ep"`` (parameters
   placed by ``lm_param_specs``) against ``impl="dense"`` on plain
   tensors at capacity factor E / k (no pick dropped), within
   ``MESH_TOL``; then in bf16 at the config's capacity factor, the
   forward and the forward+backward of ``lm_loss`` for dense on plain
   tensors and for dense and EP under the rules (medians of 3), each
   path's share of dropped picks and its peak memory. (b) In two
   processes of their own (``chip_smoke.py --mesh-rank RANK 2 DIR``),
   started first, two gloo ranks sharing the card on a ``(1, 2)`` mesh,
   ``MESH_RANK_LAYERS`` = 2 layers, float32, 32 experts a rank: logits
   and the gradient of ``lm_loss`` against the unsharded model's
   (``MESH_TOL``; each leaf within ``MESH_GRAD_REL`` relative L2), then
   one AdamW update of that gradient under the rules and its state
   re-meshed onto
   ``make_mesh_from([0], (1, 1))``, bitwise. ``[mesh]`` lines give each
   part's time, peak memory and the card's name and power limit.
18. The dry run (run after phase 17; the counters set to 0 just before
   it and read just after: it launches none of the four kernels, as the
   reference's dry-run cells reach no Pallas kernel). (a) In one
   process of its own for each entry of ``DRY_PARTS`` (``chip_smoke.py
   --dryrun DIR PART``: each process's default group is a fake one),
   started first:
   ``launch.cells.build_cell`` and ``Cell.trace()`` on fake CUDA tensors
   over fake 256- and 512-rank groups for the ``DRY_CELLS`` (gemma2-9b
   ``train_4k`` and ``decode_32k`` on both production meshes,
   kimi-k2-1t-a32b ``train_4k`` on 2x16x16, dlrm-mlperf ``train_batch``
   and sssp-smallworld ``multi_source`` on both), each LM cut to
   ``DRY_LAYERS`` layers; one ``[dryrun]`` line a cell: the three
   roofline terms on the H100's data sheet, the dominant one, HBM GiB
   per device, ``fits_hbm``, the useful ratio, the collective counts and
   the trace seconds. (b) gemma2-9b at full width, ``DRY_REAL_LAYERS``
   layers, batch ``DRY_REAL_BATCH``, ``train_4k`` (4096 seeded tokens)
   and ``decode_32k`` (a 32 768-slot cache of seeded K/V, the step at
   its last slot), built by ``build_cell(..., real=True)`` and run under
   the rules on a one-rank NCCL mesh; the first child traces both at the
   same sizes on a one-rank fake group. Each gives the real step's FLOPs
   (``FlopCounterMode``) against the trace's (within ``DRY_FLOP_REL``),
   its peak memory above the phase's start against the trace's
   ``arguments + temps + outputs - alias``, its median of 3 against the
   H100 terms' ``max(compute, memory)``; ``decode_32k``'s logits against
   the plain-tensor ``decode_step``'s within ``LM_BF16_*``.

Any failure raises and exits non-zero. The last three lines are the
card's nvidia-smi line, one ``{"kernels": [...]}`` JSON object and
``{"ok": true, "device": {...}}``. Without a CUDA device, or without
the repository around it, the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
# H100 SXM int32 rate: 64 INT32 lanes per SM x 132 SMs x 1.98 GHz (the
# data sheet's 67 T/s is float32 with an FMA counted as two operations)
ALU_OPS_PER_S = 16.7e12
# a write of this many bytes between launches leaves the 50 MB L2 cold
FLUSH_BYTES = 128 * 2**20
# device clock cycles (~0.5 ms) of a spin after the flush, in which the
# host queues the timed call, so host time never enters the window
QUEUE_CYCLES = 1_000_000
# H100 SXM boost clock, to size a spin in which the host queues calls
CLOCK_HZ = 1.98e9
# the CUDA kernel each counted wrapper launches first, once per call
KERNEL_SYMBOL = {"bucket_scan": "bucket_scan_kernel",
                 "ell_relax": "ell_relax_kernel",
                 "frontier_relax": "frontier_scan_kernel",
                 "grid_relax": "grid_relax_kernel"}
# a call's whole device work, per checked wrapper: its own kernels, one
# launch each. A profile that kept every launch's record and shows more
# device operations per call, or another one, fails the run.
OWN_KERNELS = {"bucket_scan": ("bucket_scan_kernel",),
               "ell_relax": ("ell_relax_kernel",),
               "frontier_relax": ("frontier_scan_kernel",
                                  "frontier_gather_kernel")}
INF = 2**31 - 1
N_NODES, DEGREE, P_REWIRE, DELTA = 1_000_000, 20, 1e-2, 10
# the repo's game-map configuration (src/repro/configs/sssp_archs.py:27)
GRID_SIDE, OBSTACLES, GRID_DELTA, SMALL_SIDE = 3000, 0.1, 13, 512
# timed runs of each game-map query after its warm-up (three before the
# mesh phase)
GRID_REPS = 1
# sweeps of the warm-up solve whose inputs are kept (light and heavy)
GRID_PICKS = frozenset({0, 1, 2, 3, 100, 101, 102, 1000, 1001, 1002,
                        3000, 3001, 3002, 6000, 6001, 6002})
# bucket_scan calls of the warm-up solve whose inputs are kept
SCAN_PICKS = frozenset(range(0, 13000, 500)) | {1, 2, 3, 4, 5, 6}
# phase 8: 0 and seven spread sources; 16 sources and 1000 targets for
# ManyToMany (its first tile is BATCH_SOURCES); the capped plans' cap
BATCH_SOURCES = (0, 131_071, 262_147, 393_209, 524_287, 655_357, 786_431,
                 917_503)
M2M_SOURCES = BATCH_SOURCES + (65_537, 196_613, 327_673, 458_747, 589_811,
                               720_887, 851_957, 999_999)
M2M_TARGETS, M2M_TILE, CAP, RADIUS_K = 1000, 8, 4096, 4
# the timed runs of each policy solve (three before the mesh phase); the
# CPU plan whose capped answer each capped strategy's must equal
POLICY_REPS = 1
HOST_KIND = {"ell": "ell", "pallas": "ell", "fused": "fused"}
# the child that computes those CPU answers from the start: its time limit
CAPPED_LIMIT_S = 600
ELL_BATCH = 2                  # ell's MultiSource: the first 2 sources
SW_KERNELS = ("bucket_scan", "ell_relax", "frontier_relax")
# phase 9: 0.1 % of |E| per batch (1 % too before PR 25's depth cut),
# two id sets per k (bench protocol), the strategies timed, the lattice
DYN_KS, DYN_SETS, DYN_SEED = (20_000,), 2, 5
# timed batches and cold re-solves of each DYN_TIMED plan (three before
# the mesh phase)
DYN_REPS = 1
DYN_TIMED = ("edge",)
# the plans that also take the second k (edge: the oracle; fused: the
# kernel path)
DYN_WIDE = (("edge", "argmin"), ("fused", "argmin"))
LATTICE_SIDE, LATTICE_STRATEGIES = 400, ("edge", "pallas", "fused")
# phase 10: landmarks per plan, the update batch size (phase 9's
# protocol), the point-to-point modes
LANDMARK_K, LM_DYN_K = 4, 20_000
# timed queries to the far target, after a warm-up (three before the
# mesh phase)
LANDMARK_REPS = 1
LM_MODES = ("early_exit", "alt", "bidirectional", "alt_bidirectional")
# phase 11: the search's axes (with the estimator's Δ grid and both cap
# fractions); phase 12: lanes, resident plans, the requests of the mix
# and the edges per update (benchmarks/bench_serving.py's)
TUNE_STRATEGIES, TUNE_POLICIES = ("edge", "fused"), ("delta",)
# the estimator's Δ grid searched without this many of its lowest and
# highest values (cut for time in PR 25; 0 searches the whole grid)
TUNE_GRID_TRIM = 1
SERVE_LANES, SERVE_RESIDENT, SERVE_REQUESTS, SERVE_UPDATE_EDGES = 8, 2, 24, 16
# phase 13: gloo ranks on the one card, the distributed engine's sources
# (one per data row on the (2, 1) mesh), each subprocess's time limit
SHARD_RANKS, SHARD_SOURCES, SHARD_LIMIT_S = 2, (0, 131_071), 400
# phase 14: lanes, the slice of phase 12's mix (its seed and length),
# the fused tenant's point-to-point target, the control channel's
# timeout and the idle pause of the gloo ranks' server
SSERVE_LANES, SSERVE_SEED, SSERVE_REQUESTS, SSERVE_TARGET = 2, 35, 8, 777_777
SSERVE_TIMEOUT_S, SSERVE_PAUSE_S = 1.0, 3.0
# phase 15: gemma2-9b at full width and depth, its prompt (nine 512-token
# query chunks, past the 4096 window) and teacher-forced decode steps;
# the configs cut to a few layers and their prompt; the serving
# launcher's defaults (slots, cache, requests, prompt, new tokens); the
# tolerances (PERF.md, PR 22): bf16 logits against the whole-sequence
# forward, the top-2 margin below which greedy picks are not compared,
# float32 logits of the card against the CPU's
LM_FULL, LM_PROMPT, LM_STEPS = "gemma2-9b", 4608, 8
LM_CUT, LM_CUT_LAYERS, LM_CUT_PROMPT = (("moonshot-v1-16b-a3b",
                                         "granite-20b"), 4, 512)
LM_SLOTS, LM_MAX_LEN, LM_REQUESTS, LM_PROMPT_LEN, LM_NEW = 4, 64, 8, 8, 16
LM_BF16_MAX_ABS, LM_BF16_REL, LM_MARGIN, LM_F32_TOL = 0.5, 0.05, 0.0625, 1e-4
LM_LIMIT_S = 600
# H100 SXM dense bf16 tensor-core rate (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12
# phase 16: gemma2-9b at full width cut to TR_LAYERS layers (two local,
# two global), one sequence of TR_TOKENS tokens (nine 512-token loss
# chunks, past the 4096 window); the central difference's relative step
# along its random direction; the tolerances (PERF.md, PR 23): the
# float32 gradient's directional derivative against the central
# difference, the bf16 gradient against the float32 one (overall and
# per leaf); the AdamW steps on one batch and the learning rates (the
# GNNs': their unnormalised sums give losses of 10^2-10^3 at
# initialisation, and larger steps oscillate there); the
# Cora-sized graph of the GNNs, SchNet's molecule batch (the "molecule"
# cell), the DLRM table cap and batch, the steps of each; the children's
# time limit
TR_ARCH, TR_LAYERS, TR_TOKENS, TR_CHUNK = "gemma2-9b", 4, 4608, 512
TR_FD_STEP, TR_FD_REL = 1e-2, 0.02
TR_BF16_REL, TR_BF16_LEAF_REL = 0.05, 0.1
TR_STEPS, TR_LR, TR_GNN_LR = 3, 1e-3, 1e-4
TR_GNN_NODES, TR_GNN_EDGES, TR_MOLECULES = 2708, 10556, (128, 30, 64)
TR_DLRM_CAP, TR_DLRM_BATCH, TR_SMALL_STEPS = 2**20, 2048, 5
TR_LIMIT_S = 300
# H100 SXM float32 rate outside the tensor cores (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12
# phase 17: moonshot-v1-16b-a3b at full width under the reference EP
# test's mapping (tests/test_models_extra.py); (a) MESH_LAYERS layers on
# a one-rank NCCL mesh, MESH_BATCH x MESH_SEQ tokens, 512-token loss
# chunks; (b) MESH_RANK_LAYERS layers on two gloo ranks sharing the card
# (32 experts a rank), MESH_RANK_BATCH x MESH_RANK_SEQ tokens; the
# tolerances (PERF.md §6): float32 logits, EP against dense
# (tests/test_models_extra.py:97), and each gradient leaf's relative L2
# error; the children's time limit
MESH_ARCH, MESH_LAYERS = "moonshot-v1-16b-a3b", 4
MESH_BATCH, MESH_SEQ = 2, 1024
MESH_RANK_LAYERS, MESH_RANK_BATCH, MESH_RANK_SEQ = 2, 2, 256
MESH_CHUNK, MESH_TOL, MESH_GRAD_REL = 512, 2e-3, 1e-3
MESH_MAPPING = {"dp": ("pod", "data"), "fsdp": ("pod", "data"),
                "tp": "model", "sp": "model", "ep_cap": ("pod", "data"),
                "act_seq": "model"}
MESH_LIMIT_S = 300
# phase 18: the dry run. (a) cells traced on fake CUDA tensors over fake
# 256- and 512-rank groups in child processes, each LM cut to DRY_LAYERS
# layers (arch, shape, meshes: False the 16x16, True the 2x16x16); (b)
# gemma2-9b at full width, DRY_REAL_LAYERS layers, batch DRY_REAL_BATCH,
# run for real on a one-rank NCCL mesh and traced on a one-rank fake
# group in the first child; the children that share (a)'s cells; the real
# step's FLOPs (FlopCounterMode) against the trace's (PERF.md §6, PR 25);
# the children's time limit
DRY_CELLS = (("gemma2-9b", "train_4k", (False, True)),
             ("gemma2-9b", "decode_32k", (False, True)),
             ("kimi-k2-1t-a32b", "train_4k", (True,)),
             ("dlrm-mlperf", "train_batch", (False, True)),
             ("sssp-smallworld", "multi_source", (False, True)))
DRY_LAYERS = 1
# the (cell of DRY_CELLS, multi-pod) pairs each child traces (the first
# also traces DRY_REAL)
DRY_PARTS = (((0, False),), ((0, True), (4, False), (4, True)),
             ((1, False), (1, True), (2, True)), ((3, False), (3, True)))
DRY_REAL = (("gemma2-9b", "train_4k"), ("gemma2-9b", "decode_32k"))
DRY_REAL_LAYERS, DRY_REAL_BATCH = 4, 1
DRY_FLOP_REL = 0.01
DRY_LIMIT_S = 300


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def log(*args) -> None:
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def timed_ms(torch, fn, iters: int) -> float:
    """Mean device time per call of ``fn`` from CUDA events, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def synced(torch, ms: dict, part: str, fn):
    """``fn`` wrapped to add its wall time, ended by a synchronize, to
    ``ms[part]``."""
    def wrapped(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        ms[part] += (time.perf_counter() - t0) * 1e3
        return out
    return wrapped


def cold_ms(torch, fn, iters: int, scratch) -> float:
    """Mean device time per call of ``fn`` with the L2 cold: CUDA events
    around each call, after a write of ``scratch`` (larger than the L2)
    and a device-side spin in which the host queues the call, both
    outside the timed window; one warm-up call first."""
    fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for k, (start, end) in enumerate(events):
        scratch.fill_(k)
        torch.cuda._sleep(QUEUE_CYCLES)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def queued_ms(torch, fn, iters: int, per_call_ms: float):
    """Mean device time per call of ``iters`` back-to-back calls of
    ``fn`` from CUDA events, the L2 as the calls leave it. A device-side
    spin, sized from ``per_call_ms`` (the host time of one call at most),
    precedes the start event, and the host queues every call during it,
    so no host time enters the window. Returns ``(ms, ahead)``: ``ahead``
    is false when the spin still ended before the host had queued the
    calls, after two longer tries (``fn`` synchronises, and its host
    gaps are in ``ms``). One warm-up call first."""
    fn()
    torch.cuda.synchronize()
    cycles = QUEUE_CYCLES + int(4 * iters * per_call_ms * 1e-3 * CLOCK_HZ)
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        ahead = not start.query()
        end.record()
        end.synchronize()
        if ahead:
            break
        cycles *= 4
    return start.elapsed_time(end) / iters, ahead


def profiled(torch, fn, iters: int = 1, counters=None):
    """Device time per call of ``fn`` by CUDA kernel name, in ms, from
    ``torch.profiler``, the wall time per call of the profiled calls,
    per counted wrapper ``(records, launches)``: the profiler's records
    of the wrapper's kernel (``KERNEL_SYMBOL``) against the launches its
    counter saw in the window, and the records of every kernel name.
    The profiler loses records of windows a few ms long, so its times
    stand only where the records agree with the launches."""
    from torch.profiler import ProfilerActivity, profile
    counters = counters or {}
    fn()
    torch.cuda.synchronize()
    before = {k: f.launches for k, f in counters.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
    kern, counts, records = {}, {}, dict.fromkeys(counters, 0)
    for e in prof.key_averages():
        dt = e.self_device_time_total
        if e.device_type == torch.autograd.DeviceType.CUDA and dt > 0:
            kern[e.key] = kern.get(e.key, 0.0) + dt / 1e3 / iters
            counts[e.key] = counts.get(e.key, 0) + e.count
            for k in counters:
                if KERNEL_SYMBOL[k] in e.key:
                    records[k] += e.count
    seen = {k: (records[k], f.launches - before[k])
            for k, f in counters.items()}
    return kern, wall, seen, counts


def seen_line(seen) -> str:
    """The profiler's kernel records against the counted launches."""
    return ", ".join(f"{k} {r} of {n}" for k, (r, n) in seen.items() if n)


def same(torch, a, b) -> int:
    """Max |a - b| over two output tuples (integers and flags); fails
    unless they are bitwise equal."""
    check(len(a) == len(b), "output arity")
    err = 0
    for x, y in zip(a, b):
        check(x.shape == y.shape and x.dtype == y.dtype,
              f"shape/dtype {tuple(x.shape)} {x.dtype} vs "
              f"{tuple(y.shape)} {y.dtype}")
        if x.numel():
            diff = (x.to(torch.int64) - y.to(torch.int64)).abs().max()
            err = max(err, int(diff))
        check(torch.equal(x, y), "kernel differs from its twin")
    return err


def dedup_min(src, dst, w, n):
    """Edge list with duplicate (u, v) pairs reduced to their minimum
    weight, sorted by key u * n + v."""
    import numpy as np
    key = src.astype(np.int64) * n + dst.astype(np.int64)
    order = np.lexsort((w, key))
    key, w = key[order], w[order]
    first = np.ones(key.shape[0], bool)
    first[1:] = key[1:] != key[:-1]
    return key[first], w[first].astype(np.int64)


def oracle_dist(g, source: int = 0):
    """scipy Dijkstra on the deduplicated graph, INF32 for unreachable."""
    import numpy as np
    import scipy.sparse as sp
    from scipy.sparse.csgraph import dijkstra
    n = g.n_nodes
    key, w = dedup_min(g.src.cpu().numpy(), g.dst.cpu().numpy(),
                       g.w.cpu().numpy(), n)
    mat = sp.csr_matrix((w.astype(np.float64), (key // n, key % n)),
                        shape=(n, n))
    d = dijkstra(mat, directed=True, indices=source)
    out = np.full(n, INF, np.int64)
    fin = np.isfinite(d)
    out[fin] = d[fin].astype(np.int64)
    return out, (key, w)


def check_tree(dist, pred, source, keyed):
    """Each reachable non-source v has an edge (pred[v], v) with
    dist[pred] + w == dist[v] (vectorised over the deduplicated edges)."""
    import numpy as np
    key, w = keyed
    n = dist.shape[0]
    v = np.flatnonzero(dist < INF)
    v = v[v != source]
    p = pred[v].astype(np.int64)
    check((p >= 0).all(), "reachable vertex without predecessor")
    k = p * n + v
    idx = np.searchsorted(key, k)
    idx = np.minimum(idx, key.shape[0] - 1)
    check((key[idx] == k).all(), "predecessor edge missing from graph")
    check((dist[p] + w[idx] == dist[v]).all(), "predecessor edge not tight")
    check(pred[source] == -1 and (pred[dist >= INF] == -1).all(),
          "pred sentinels")


def check_path(path, source, target, distance, keyed, n):
    """``path`` runs source -> target over edges of the graph whose
    weights sum to ``distance``."""
    import numpy as np
    key, w = keyed
    check(path is not None and path[0] == source and path[-1] == target,
          "path endpoints")
    p = np.asarray(path, np.int64)
    k = p[:-1] * n + p[1:]
    idx = np.minimum(np.searchsorted(key, k), key.shape[0] - 1)
    check((key[idx] == k).all(), "path step is not an edge")
    check(int(w[idx].sum()) == distance, "path weights do not sum to the "
          "distance")


def game_map_path(torch, np, cuda, counters):
    """Phase 5: the game-map path at full width (``grid_map(3000, 3000,
    0.1)``, Δ = 13, the first free cell as source) through
    ``Engine(..., free_mask=free)`` on CUDA, and phase 8's ``MultiSource``
    on it. Returns the path's launch counts, its per-solve counts, the
    recorded ``grid_relax`` and ``bucket_scan`` inputs with the largest
    frontier (of the single solve, and of the batch's lane 1) to time
    the kernels on, each kernel's device time in the solve, and the
    batch's launch counts."""
    import repro_torch.core.backends as backends
    from repro_torch.api import (BoundedRadius, Engine, MultiSource,
                                 PointToPoint, SingleSource)
    from repro_torch.core import DeltaConfig, GridDeltaConfig, GridDeltaSolver
    from repro_torch.graphs import grid_map
    from repro_torch.kernels.bucket_scan import bucket_scan_cuda, \
        bucket_scan_ref
    from repro_torch.kernels.grid_relax import (grid_relax_cuda,
                                                grid_relax_ref, vector_path)

    t0 = time.perf_counter()
    g, free = grid_map(GRID_SIDE, GRID_SIDE, OBSTACLES, seed=0)
    n = g.n_nodes
    src = int(np.flatnonzero(free.ravel())[0])
    log(f"[grid] grid_map {GRID_SIDE}x{GRID_SIDE}, obstacles {OBSTACLES}: "
        f"n={n} |E|={g.n_edges} free={int(free.sum())} source {src}, "
        f"in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ref_dist, keyed = oracle_dist(g, src)
    log(f"[grid] scipy dijkstra in {time.perf_counter() - t0:.1f} s; "
        f"reachable {int((ref_dist < INF).sum())}, max dist "
        f"{int(ref_dist[ref_dist < INF].max())}")
    cfg = DeltaConfig(delta=GRID_DELTA, strategy="pallas", pred_mode="argmin")
    plan = Engine(g, cfg, free_mask=free, device=cuda).plan()
    check(isinstance(plan.backend, backends.GridPallasBackend),
          "the grid plan does not route to the stencil")

    # -- 5a. record mid-solve sweep and scan inputs (the warm-up solve) -----
    rec, calls = [], [0]
    scans, scan_calls, last = [], [0], ["start"]
    real, real_scan = backends.grid_relax, backends.bucket_scan

    def recorder(tent, free_, i, **kw):
        if calls[0] in GRID_PICKS:
            rec.append((tent.clone(), free_, i, kw))
        calls[0] += 1
        last[0] = "light" if kw["light"] else "heavy"
        return real(tent, free_, i, **kw)

    def scan_recorder(dist, explored, i, **kw):
        out = real_scan(dist, explored, i, **kw)
        if scan_calls[0] in SCAN_PICKS:
            scans.append(((dist.clone(), explored.clone(), i), kw, last[0],
                          int(out[0].sum())))
        scan_calls[0] += 1
        return out

    backends.grid_relax, backends.bucket_scan = recorder, scan_recorder
    try:
        plan.solve(SingleSource(src))
    finally:
        backends.grid_relax, backends.bucket_scan = real, real_scan
    torch.cuda.synchronize()
    check({kw["light"] for _, _, _, kw in rec} == {True, False},
          "no light and heavy sweep recorded")
    check({after for _, _, after, _ in scans} == {"start", "light", "heavy"},
          "no scan recorded after a light sweep, a heavy pass and the start")

    # -- 5b. grid_relax against its twin on the card -----------------------
    def frontier_size(t, i):
        return int(((t < INF) & (t // GRID_DELTA == i)).sum())

    for t, f, i, kw in rec:
        same(torch, (grid_relax_cuda(t, f, i, **kw),),
             (grid_relax_ref(t, f, i, **kw),))
        torch.cuda.synchronize()
    lights = [r for r in rec if r[3]["light"]]
    main_case = max(lights, key=lambda r: frontier_size(r[0], r[2]))
    check(vector_path(main_case[0], main_case[1],
                      torch.empty_like(main_case[0])),
          "the full-width sweep does not take the vector path")
    log(f"[kernel] grid_relax: {len(rec)} mid-solve states of {calls[0]} "
        f"sweeps equal to the twin (largest light frontier "
        f"{frontier_size(main_case[0], main_case[2])} cells)")
    rng = np.random.default_rng(1)
    edge_cases, paths = 0, {True: 0, False: 0}
    for shape in ((1, 1), (1, 5000), (5000, 1), (37, 129), (1000, 1000),
                  (37, 4), (45, 128), (33, 132), (70, 3000), (300, 517),
                  (41, 3)):
        t = rng.integers(0, 60, size=shape).astype(np.int64)
        t[rng.random(shape) < 0.3] = INF
        near = rng.random(shape) < 0.15
        t[near] = INF - rng.integers(1, 15, size=int(near.sum()))
        t = torch.from_numpy(t.astype(np.int32)).to(cuda)
        f = torch.from_numpy(rng.random(shape) >= 0.2).to(cuda)
        # a contiguous view 4 bytes past 16-byte alignment: scalar path
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        shifted = flat[1:].view(shape)
        shifted.copy_(t)
        check(not vector_path(shifted, f, torch.empty_like(t)),
              "an unaligned tent took the vector path")
        check(vector_path(t, f, torch.empty_like(t)) == (shape[1] % 4 == 0),
              "the path does not follow the width")
        for tt, ff in ((t, f), (t, torch.zeros_like(f)),
                       (torch.full_like(t, INF), f), (shifted, f)):
            paths[vector_path(tt, ff, torch.empty_like(t))] += 1
            for delta in (5, 13, 20):
                for light in (True, False):
                    for i in (2, (INF - 8) // delta, INF // delta + 1):
                        kw = dict(delta=delta, cost_straight=10,
                                  cost_diag=14, light=light)
                        same(torch, (grid_relax_cuda(tt, ff, i, **kw),),
                             (grid_relax_ref(tt, ff, i, **kw),))
                        edge_cases += 1
    torch.cuda.synchronize()
    log(f"[kernel] grid_relax: {edge_cases} edge cases equal to the twin "
        f"({paths[True]} inputs on the vector path, {paths[False]} on the "
        "scalar path): 1x1, 1xW, Hx1, widths 1 / 3 / 4 / 128 / 129 / 132 / "
        "517 / 1000 / 3000 / 5000 at heights no multiple of 32, a tent 4 "
        "bytes past 16-byte alignment; as drawn, all-blocked and all-INF; "
        "values within 14 of INF in the swept bucket, a bucket past int32 "
        "(i * Δ > INT32_MAX); Δ = 5 / 13 / 20, both phases")

    # -- 5b'. bucket_scan against its twin at n = 9 M -----------------------
    for (t, e, i), kw, _, _ in scans:
        same(torch, bucket_scan_cuda(t, e, i, delta=kw["delta"]),
             bucket_scan_ref(t, e, i, delta=kw["delta"]))
        torch.cuda.synchronize()
    scan_case = max(scans, key=lambda r: r[3])
    log(f"[kernel] bucket_scan at n={n}: {len(scans)} mid-solve states of "
        f"{scan_calls[0]} scans equal to the twin ("
        + ", ".join(f"{sum(r[2] == k for r in scans)} after {k}"
                    for k in ("start", "light", "heavy"))
        + f"; largest frontier {scan_case[3]} cells)")

    # -- 5c. the game-map main path -----------------------------------------
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    r = plan.solve(SingleSource(src))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    tel = r.telemetry
    log(f"[grid] launches over the game-map main path: "
        f"{json.dumps(launches)}")
    check(launches["grid_relax"] == tel.buckets + tel.inner_iters,
          "grid_relax launches != buckets + inner_iters")
    check(launches["bucket_scan"] == 2 * tel.buckets + tel.inner_iters,
          "bucket_scan launches != 2 * buckets + inner_iters")
    dist = r.dist.cpu().numpy()
    pred = r.pred.cpu().numpy()
    check(dist.dtype == np.int32 and pred.dtype == np.int32, "dtypes")
    check(np.array_equal(dist.astype(np.int64), ref_dist),
          "gamemap: dist differs from the scipy oracle")
    check_tree(dist, pred, src, keyed)
    log(f"[grid] SingleSource: dist == oracle, pred tree ok, "
        f"buckets={tel.buckets} inner_iters={tel.inner_iters} "
        f"overflow={tel.overflow} host_syncs={plan.host_syncs} first solve "
        f"{wall * 1e3:.1f} ms")
    per_solve = {("gamemap", "argmin"): launches}

    # -- 5d. the standalone grid driver, default config ---------------------
    solver = GridDeltaSolver(free, GridDeltaConfig(), device=cuda)
    before = grid_relax_cuda.launches
    t0 = time.perf_counter()
    gr = solver.solve((src // GRID_SIDE, src % GRID_SIDE))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    solver_launches = grid_relax_cuda.launches - before
    check(np.array_equal(gr.dist.cpu().numpy().ravel(), dist),
          "GridDeltaSolver dist differs")
    check(solver_launches == gr.outer_iters + gr.inner_iters,
          "GridDeltaSolver did not sweep through the kernel")
    log(f"[grid] GridDeltaSolver (backend {solver.cfg.backend!r}): dist "
        f"equal, outer_iters={gr.outer_iters} inner_iters={gr.inner_iters} "
        f"grid_relax launches {solver_launches}, {wall * 1e3:.1f} ms")

    # -- 5e. point-to-point and bounded-radius queries ----------------------
    reach = np.flatnonzero((dist < INF) & (dist <= 100))
    near_t = int(reach[np.argmax(dist[reach])])
    far_t = int(np.flatnonzero(free.ravel())[-1])
    queries = {"p2p_far": PointToPoint(src, far_t),
               "p2p_near": PointToPoint(src, near_t),
               "bounded_1000": BoundedRadius(src, 1000)}
    answers = {}
    for name, q in queries.items():
        before = {k: fn.launches for k, fn in counters.items()}
        a = plan.solve(q)
        torch.cuda.synchronize()
        answers[name] = a
        per_solve[("gamemap", name)] = {
            k: fn.launches - before[k] for k, fn in counters.items()}
        check(a.telemetry.buckets <= tel.buckets, f"{name}: more buckets")
    for name in ("p2p_far", "p2p_near"):
        a, tgt = answers[name], queries[name].target
        check(a.distance == int(dist[tgt]), f"{name}: distance differs")
        check_path(a.path, src, tgt, a.distance, keyed, n)
        log(f"[grid] {name} {src}->{tgt}: distance {a.distance} == "
            f"SingleSource, path of {len(a.path) - 1} valid steps, "
            f"buckets={a.telemetry.buckets} "
            f"inner_iters={a.telemetry.inner_iters}")
    check(answers["p2p_near"].telemetry.buckets
          < answers["p2p_far"].telemetry.buckets,
          "the near target took no fewer buckets")
    b = answers["bounded_1000"]
    within = dist <= 1000
    check(np.array_equal(b.dist.cpu().numpy(), np.where(within, dist, INF)),
          "bounded dist differs from the filtered SingleSource dist")
    check(np.array_equal(b.pred.cpu().numpy(), np.where(within, pred, -1)),
          "bounded pred differs from the filtered SingleSource pred")
    log(f"[grid] bounded_1000: dist/pred == SingleSource filtered at 1000 "
        f"({int(within.sum())} cells), buckets={b.telemetry.buckets} "
        f"inner_iters={b.telemetry.inner_iters}")

    # -- 5f. the grid plan bitwise equal to edge on a smaller map -----------
    gs, fs = grid_map(SMALL_SIDE, SMALL_SIDE, OBSTACLES, seed=0)
    s_src = int(np.flatnonzero(fs.ravel())[0])
    out = {}
    for strategy, mask in (("pallas", fs), ("edge", None)):
        p = Engine(gs, DeltaConfig(delta=GRID_DELTA, strategy=strategy,
                                   pred_mode="argmin"), free_mask=mask,
                   device=cuda).plan()
        x = p.solve(SingleSource(s_src))
        out[strategy] = (x.dist.cpu().numpy(), x.pred.cpu().numpy(),
                         x.telemetry.buckets, x.telemetry.inner_iters)
    for k, name in enumerate(("dist", "pred", "buckets", "inner_iters")):
        check(np.array_equal(out["pallas"][k], out["edge"][k]),
              f"{SMALL_SIDE}x{SMALL_SIDE}: grid plan {name} differs from edge")
    log(f"[grid] {SMALL_SIDE}x{SMALL_SIDE}: grid plan bitwise equal to edge "
        f"(dist, pred, buckets={out['edge'][2]}, "
        f"inner_iters={out['edge'][3]})")

    # -- 5g. times -----------------------------------------------------------
    for name, q in [("SingleSource", SingleSource(src))] + list(
            queries.items()):
        walls = []
        for _ in range(GRID_REPS):
            t0 = time.perf_counter()
            a = plan.solve(q)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        log(f"[time] gamemap/{name}: median "
            f"{statistics.median(walls) * 1e3:.1f} ms over {GRID_REPS} after "
            "warm-up "
            f"({', '.join(f'{x * 1e3:.1f}' for x in walls)}), host_syncs="
            f"{plan.host_syncs}, buckets={a.telemetry.buckets}, "
            f"inner_iters={a.telemetry.inner_iters}")

    # -- 8 (game map). MultiSource on the grid plan, lane by lane -----------
    free_ids = np.flatnonzero(free.ravel())
    pair = [src, int(free_ids[free_ids.shape[0] // 2])]
    second = plan.solve(SingleSource(pair[1]))
    second_syncs = plan.host_syncs
    # the counted run also keeps each kernel's largest input of lane 1
    lane1 = Largest(backends, frontier_sizes(n, ("bucket_scan",
                                                 "grid_relax")),
                    lane=pair[1])
    for fn in counters.values():
        fn.launches = 0
    with lane1:
        m = plan.solve(MultiSource(pair))
        torch.cuda.synchronize()
    launches_multi = {k: fn.launches for k, fn in counters.items()}
    same_lanes(torch, m, [r, second], "gamemap MultiSource")
    mt = m.telemetry
    b, inner = int(mt.buckets.sum()), int(mt.inner_iters.sum())
    check(launches_multi["grid_relax"] == b + inner,
          "gamemap MultiSource: grid_relax launches != buckets + inner_iters")
    check(launches_multi["bucket_scan"] == 2 * b + inner,
          "gamemap MultiSource: bucket_scan launches != 2 * buckets + "
          "inner_iters")
    check(plan.host_syncs == tel.buckets * 2 + tel.inner_iters + 1
          + second_syncs, "gamemap MultiSource: host syncs != the lanes'")
    check(set(lane1.best) == {"bucket_scan", "grid_relax"},
          "gamemap MultiSource: no lane-1 input recorded")
    _, walls = walls_ms(torch, lambda: plan.solve(MultiSource(pair)), 1)
    log(f"[batch] gamemap MultiSource {pair}: lanes == SingleSource, "
        f"buckets={mt.buckets.tolist()} inner_iters={mt.inner_iters.tolist()}"
        f" host_syncs={plan.host_syncs} launches {json.dumps(launches_multi)}"
        f"; one timed run {walls[0]:.1f} ms = {walls[0] / 2:.1f} ms/source; "
        f"lane 1's largest frontiers: bucket_scan "
        f"{lane1.best['bucket_scan'][2]}, grid_relax "
        f"{lane1.best['grid_relax'][2]} cells")

    # -- 5h. where a grid solve's device time goes --------------------------
    kern, wall, seen, _ = profiled(
        torch, lambda: plan.solve(SingleSource(src)), counters=counters)
    busy = sum(kern.values())
    log(f"[profile] gamemap/argmin: profiled solve {wall:.1f} ms, device "
        f"busy {busy:.1f} ms (idle share {1 - busy / wall:.3f}), "
        f"{len(kern)} kernel names; kernel records {seen_line(seen)}")
    for kname, ms in sorted(kern.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[profile]   {ms:9.3f} ms  {kname[:110]}")
    # each kernel's device time in the solve over its launches in the
    # profiled solve, where the profiler kept a record of every launch
    in_solve = {}
    for name in ("grid_relax", "bucket_scan"):
        total = sum(ms for k, ms in kern.items() if KERNEL_SYMBOL[name] in k)
        got, n_launch = seen[name]
        in_solve[name] = total / n_launch if got == n_launch else None
        log(f"[profile] gamemap/argmin: {name} {total:.1f} ms over "
            f"{n_launch} launches in the solve = "
            + (f"{in_solve[name]:.5f} ms/launch" if got == n_launch else
               f"not measured (the profiler kept {got} records)"))
    t, f, i, kw = main_case
    records = {"gamemap": {"grid_relax": ((t, f, i), kw,
                                          frontier_size(t, i)),
                           "bucket_scan": scan_case[:2] + scan_case[3:]},
               "gamemap_multisource": lane1.best}
    return launches, per_solve, records, in_solve, launches_multi


def same_lanes(torch, multi, singles, tag: str) -> None:
    """Each lane of a ``MultiSource`` answer is bitwise its single solve:
    dist, pred, buckets, inner_iters and overflow."""
    t = multi.telemetry
    check(multi.dist.shape[0] == len(singles), f"{tag}: lane count")
    for b, one in enumerate(singles):
        check(torch.equal(multi.dist[b], one.dist)
              and torch.equal(multi.pred[b], one.pred),
              f"{tag} lane {b}: dist/pred differ from SingleSource")
        check((int(t.buckets[b]), int(t.inner_iters[b]), bool(t.overflow[b]))
              == (one.telemetry.buckets, one.telemetry.inner_iters,
                  one.telemetry.overflow), f"{tag} lane {b}: counters differ")


class Largest:
    """While active, wraps the kernel dispatchers of ``core.backends``
    named in ``sizes`` and keeps, for each, the inputs of the call with
    the largest ``sizes[name](args, kw, out)``: among the calls whose
    distances (``args[DIST[name]]``) are 0 at vertex ``lane`` — the calls
    of the lane that solves from ``lane`` — or among all calls when
    ``lane`` is None. The state arguments are cloned. Sizing and cloning
    are tensor ops, not kernels, so the launch counts of the run it
    watches stay the kernels' own."""

    DIST = {"bucket_scan": 0, "ell_relax": 1, "frontier_relax": 0,
            "grid_relax": 0}
    STATE = {"bucket_scan": (0, 1), "ell_relax": (0, 1),
             "frontier_relax": (0, 1), "grid_relax": (0,)}

    def __init__(self, backends, sizes, lane=None):
        self.backends, self.sizes, self.lane = backends, sizes, lane
        self.best = {}

    def __enter__(self):
        self.real = {name: getattr(self.backends, name) for name in self.sizes}
        for name in self.sizes:
            setattr(self.backends, name, self._wrap(name))
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.backends, name, fn)

    def _wrap(self, name):
        real, dist, state = self.real[name], self.DIST[name], self.STATE[name]

        def wrapped(*args, **kw):
            out = real(*args, **kw)
            if (self.lane is None
                    or int(args[dist].reshape(-1)[self.lane]) == 0):
                size = self.sizes[name](args, kw, out)
                if name not in self.best or size > self.best[name][2]:
                    kept = tuple(a.clone() if k in state else a
                                 for k, a in enumerate(args))
                    self.best[name] = (kept, kw, size)
            return out
        return wrapped


def frontier_sizes(n: int, names):
    """For the kernels ``names``, the frontier size of a call on an
    ``n``-vertex graph: the rows it relaxes or the vertices of its bucket
    (``grid_relax``: light sweeps only, the phase its timing has always
    used)."""
    def grid(args, kw, out):
        t, _, i = args[:3]
        return (int(((t < INF) & (t // kw["delta"] == i)).sum())
                if kw["light"] else -1)
    sizes = {"bucket_scan": lambda a, kw, o: int(o[0].sum()),
             "ell_relax": lambda a, kw, o: int((a[0] < n).sum()),
             "frontier_relax": lambda a, kw, o: int(o[3]),
             "grid_relax": grid}
    return {name: sizes[name] for name in names}


def delta_launches(strategy: str, buckets: int, inner: int) -> dict:
    """The kernel launches of one bucket-loop run of ``buckets`` buckets
    and ``inner`` light iterations on a backend of ``strategy`` (``ell``
    and ``edge`` launch none)."""
    b = buckets
    return {"bucket_scan": {"pallas": 2 * b + inner,
                            "fused": b}.get(strategy, 0),
            "ell_relax": b + inner if strategy == "pallas" else 0,
            "frontier_relax": b + inner if strategy == "fused" else 0,
            "grid_relax": 0}


def walls_ms(torch, fn, reps: int):
    """``reps`` runs of ``fn``, each ended by a synchronize: the last
    result and the wall times in ms."""
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return out, walls


def fmt(walls) -> str:
    return (f"median {statistics.median(walls):.1f} ms of {len(walls)} ("
            + ", ".join(f"{x:.1f}" for x in walls) + ")")


def graph_digest(g) -> str:
    """A checksum of a graph's edge arrays (the capped-answer child makes
    its own copy of the graph from the seed)."""
    import hashlib
    h = hashlib.sha256()
    for t in (g.src, g.dst, g.w):
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def capped_host(work: str) -> int:
    """Phase 8e's CPU answers, in a process of its own started before
    phase 1 (~35 s of the host, overlapped with phases 1 to 7): the
    capped ``SingleSource(0)`` of ``ell`` (also ``pallas``'s loop) and
    ``fused`` on the CPU, on ``watts_strogatz(N_NODES, DEGREE,
    P_REWIRE, seed=0)`` made anew, saved with the graph's checksum to
    ``WORK/capped.pt``."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.api import Engine, SingleSource
    from repro_torch.core import DeltaConfig
    from repro_torch.graphs import watts_strogatz

    torch.set_num_threads(2)
    g = watts_strogatz(N_NODES, DEGREE, P_REWIRE, seed=0)
    out = {"graph": graph_digest(g)}
    for kind in ("ell", "fused"):
        t0 = time.perf_counter()
        cfg = DeltaConfig(delta=DELTA, strategy=kind, pred_mode="argmin",
                          frontier_cap=CAP)
        res = Engine(g, cfg, device="cpu").plan().solve(SingleSource(0))
        t = res.telemetry
        out[kind] = (res.dist, res.pred, t.buckets, t.inner_iters,
                     t.overflow, time.perf_counter() - t0)
    torch.save(out, Path(work) / "capped.pt")
    return 0


def batch_and_policy_path(torch, np, cuda, g, keyed, plans, results,
                          counters, host_capped):
    """Phase 8 on the 1 M-vertex small-world graph: batched queries, the
    overflow fallback and the frontier policies (see the module note).
    Returns the launches of the ``pallas``/``fused`` ``MultiSource``
    path, of the ``pallas`` policy path, of the capped solves (with and
    without the fallback) and of the full-width twins' re-solves, and per
    path each kernel's recorded input with the largest frontier (lane 1
    of the batch; the policy solves; the capped solves)."""
    import repro_torch.core.backends as backends
    from repro_torch.api import (BoundedRadius, Engine, ManyToMany,
                                 MultiSource, PointToPoint, SingleSource)
    from repro_torch.core import DeltaConfig

    t_phase = time.perf_counter()

    def zero():
        for fn in counters.values():
            fn.launches = 0

    def read():
        return {k: fn.launches for k, fn in counters.items()}

    # -- 8a. single solves on edge: the lanes' reference ------------------
    edge = plans[("edge", "argmin")]
    single, single_syncs, single_walls = {}, {}, []
    for s in BATCH_SOURCES:
        one, w = walls_ms(torch, lambda: edge.solve(SingleSource(s)), 1)
        single[s], single_syncs[s] = one, edge.host_syncs
        single_walls += w
    check(torch.equal(single[0].dist, results[("edge", "argmin")][0].dist),
          "edge SingleSource(0) changed since phase 3")
    log(f"[batch] edge SingleSource of the 8 sources: {fmt(single_walls)}, "
        f"host_syncs {sum(single_syncs.values())} together, buckets "
        f"{[single[s].telemetry.buckets for s in BATCH_SOURCES]}")

    # -- 8b. MultiSource on edge and ell: one [B, n] loop -----------------
    batch = {}
    # ell's batch takes ~1.5 s a lane on the H100 (the sentinel-slot
    # scatter, PERF.md §6) and its runs spread by 0.1 %: one timed run
    # of the first ELL_BATCH sources
    for st, reps, srcs in (("edge", 3, BATCH_SOURCES),
                           ("ell", 1, BATCH_SOURCES[:ELL_BATCH])):
        plan = plans[(st, "argmin")]
        zero()
        res, walls = walls_ms(
            torch, lambda: plan.solve(MultiSource(list(srcs))), reps)
        check(all(v == 0 for v in read().values()),
              f"{st} MultiSource launched a kernel")
        same_lanes(torch, res, [single[s] for s in srcs],
                   f"{st} MultiSource")
        alone = sum(single_syncs[s] for s in srcs)
        check(plan.host_syncs < alone,
              f"{st} MultiSource: no fewer host syncs than its lanes")
        batch[st] = res
        log(f"[batch] {st} MultiSource x{len(srcs)} (one [B, n] "
            f"loop): lanes == SingleSource, host_syncs={plan.host_syncs} "
            f"(lanes alone: {alone}); {fmt(walls)} = "
            f"{statistics.median(walls) / len(srcs):.1f} ms/source "
            f"(edge SingleSource median "
            f"{statistics.median(single_walls):.1f} ms)")
    lane = 3
    dref, _ = oracle_dist(g, BATCH_SOURCES[lane])
    check(np.array_equal(batch["edge"].dist[lane].cpu().numpy()
                         .astype(np.int64), dref),
          "edge MultiSource lane 3 differs from the scipy oracle")
    log(f"[batch] lane {lane} (source {BATCH_SOURCES[lane]}) == scipy "
        "dijkstra")

    # -- 8c. MultiSource on pallas and fused: lane by lane ----------------
    # the counted run also keeps each kernel's largest input of lane 1
    pair = [0, BATCH_SOURCES[4]]
    lane1 = Largest(backends, frontier_sizes(g.n_nodes, SW_KERNELS),
                    lane=pair[1])
    launches_multi = dict.fromkeys(counters, 0)
    for st in ("pallas", "fused"):
        plan = plans[(st, "argmin")]
        zero()
        with lane1:
            res = plan.solve(MultiSource(pair))
            torch.cuda.synchronize()
        got = read()
        for k, v in got.items():
            launches_multi[k] += v
        same_lanes(torch, res, [single[s] for s in pair], f"{st} MultiSource")
        t = res.telemetry
        b, inner = int(t.buckets.sum()), int(t.inner_iters.sum())
        if st == "pallas":
            check(got["bucket_scan"] == 2 * b + inner
                  and got["ell_relax"] == b + inner,
                  "pallas MultiSource: launches off the lanes' equations")
        else:
            check(got["frontier_relax"] == b + inner
                  and got["bucket_scan"] == b,
                  "fused MultiSource: launches off the lanes' equations")
        check(plan.host_syncs == sum(single_syncs[s] for s in pair),
              f"{st} MultiSource: host syncs != the lanes'")
        _, walls = walls_ms(torch, lambda: plan.solve(MultiSource(pair)), 1)
        log(f"[batch] {st} MultiSource {pair} (lane by lane): lanes == "
            f"SingleSource, host_syncs={plan.host_syncs}, launches "
            f"{json.dumps(got)}; one timed run {walls[0]:.1f} ms = "
            f"{walls[0] / len(pair):.1f} ms/source")
    check(set(lane1.best) == set(SW_KERNELS),
          "MultiSource: no lane-1 input recorded for a kernel")
    log("[batch] lane 1's largest frontiers: " + ", ".join(
        f"{k} {v[2]}" for k, v in lane1.best.items()))

    # -- 8d. ManyToMany against the MultiSource rows ----------------------
    targets = np.random.default_rng(2).choice(g.n_nodes, size=M2M_TARGETS,
                                              replace=False).tolist()
    m2m, walls = walls_ms(torch, lambda: edge.solve(
        ManyToMany(list(M2M_SOURCES), targets, tile=M2M_TILE)), 1)
    rest = edge.solve(MultiSource(list(M2M_SOURCES[M2M_TILE:])))
    rows = torch.cat([batch["edge"].dist, rest.dist])[:, targets]
    check(m2m.matrix.dtype == torch.int64
          and torch.equal(m2m.matrix, rows.cpu().to(torch.int64)),
          "ManyToMany differs from the MultiSource rows")
    tiles = (batch["edge"].telemetry, rest.telemetry)
    check(m2m.telemetry.buckets == max(int(t.buckets.max()) for t in tiles)
          and m2m.telemetry.inner_iters == sum(int(t.inner_iters.sum())
                                              for t in tiles),
          "ManyToMany telemetry")
    log(f"[batch] ManyToMany {len(M2M_SOURCES)} x {M2M_TARGETS} (tile "
        f"{M2M_TILE}, edge) == MultiSource rows; one timed run "
        f"{walls[0]:.1f} ms, buckets={m2m.telemetry.buckets} "
        f"inner_iters={m2m.telemetry.inner_iters}")

    # -- 8e. a capped frontier, with and without the fallback -------------
    # every capped and every fallback solve is counted on its own and held
    # to its launch equations (the fallback's: the capped solve's plus the
    # full-width twin's); the capped solves keep each kernel's largest
    # input (fidx of CAP rows), and each capped answer on the card must
    # equal the same loop's on the CPU (ell's for pallas)
    capped = Largest(backends, frontier_sizes(g.n_nodes, SW_KERNELS))
    host = host_capped()
    check(host["graph"] == graph_digest(g), "the capped-answer child's "
          "graph differs from this one")
    launches_fb = dict.fromkeys(counters, 0)      # the capped solves
    launches_twin = dict.fromkeys(counters, 0)    # the twins' re-solves
    for st in ("ell", "pallas", "fused"):
        cfg = DeltaConfig(delta=DELTA, strategy=st, pred_mode="argmin",
                          frontier_cap=CAP)
        plan = Engine(g, cfg, device=cuda).plan()
        zero()
        with capped:
            raw = plan.solve(SingleSource(0))
            torch.cuda.synchronize()
        got_raw = read()
        rt = raw.telemetry
        check(rt.overflow and not rt.fallback,
              f"{st} cap {CAP}: no overflow reported")
        check(got_raw == delta_launches(st, rt.buckets, rt.inner_iters),
              f"{st} cap {CAP}: launches {got_raw} off the capped solve's "
              "equations")
        # the CPU's capped answer (from the child started first): ell's
        # and pallas's are one answer (the same loop, buckets and sweeps)
        h_dist, h_pred, h_buckets, h_inner, h_over, cpu_s = \
            host[HOST_KIND[st]]
        check(torch.equal(raw.dist.cpu(), h_dist)
              and torch.equal(raw.pred.cpu(), h_pred)
              and (rt.buckets, rt.inner_iters, rt.overflow)
              == (h_buckets, h_inner, h_over),
              f"{st} cap {CAP}: the capped answer on the card differs from "
              "the CPU's")
        plan = Engine(g, cfg, device=cuda).plan(fallback=True)
        full = results[(st, "argmin")][0]
        zero()
        res, walls = walls_ms(torch, lambda: plan.solve(SingleSource(0)), 1)
        got = read()
        want = delta_launches(st, full.telemetry.buckets,
                              full.telemetry.inner_iters)
        check(got == {k: v + want[k] for k, v in got_raw.items()},
              f"{st} cap {CAP}: fallback launches {got} != the capped "
              "solve's + the full-width twin's")
        for k in counters:
            launches_fb[k] += 2 * got_raw[k]
            launches_twin[k] += got[k] - got_raw[k]
        check(res.telemetry.fallback and plan.explain()["fallback_taken"],
              f"{st} cap {CAP}: the fallback did not answer")
        check(torch.equal(res.dist, full.dist)
              and torch.equal(res.pred, full.pred)
              and (res.telemetry.buckets, res.telemetry.inner_iters,
                   res.telemetry.overflow) == (full.telemetry.buckets,
                                               full.telemetry.inner_iters,
                                               False),
              f"{st} cap {CAP}: the fallback answer differs from phase 3's")
        log(f"[batch] {st} frontier_cap={CAP}: overflow reported without "
            f"fallback (buckets={rt.buckets} inner_iters={rt.inner_iters}, "
            f"launches {json.dumps(got_raw)}; == the CPU's capped answer, "
            f"{cpu_s:.1f} s there); with fallback == the uncapped plan, "
            f"telemetry.fallback set, host_syncs={plan.host_syncs} (capped "
            f"+ full), launches {json.dumps(got)}, {walls[0]:.1f} ms")
    check(set(capped.best) == set(SW_KERNELS),
          "capped solves: no input recorded for a kernel")
    log("[batch] capped solves' largest frontiers: " + ", ".join(
        f"{k} {v[2]}" for k, v in capped.best.items()))

    # -- 8f. frontier policies on edge and pallas -------------------------
    base = results[("edge", "argmin")][0]
    policy_rec = Largest(backends, frontier_sizes(g.n_nodes, ("ell_relax",)))
    launches_policy = dict.fromkeys(counters, 0)
    rho_edge = None
    for policy, extra in (("rho", {}), ("radius", dict(radius_k=RADIUS_K))):
        for st in ("edge", "pallas"):
            cfg = DeltaConfig(delta=DELTA, strategy=st, pred_mode="argmin",
                              policy=policy, **extra)
            plan = Engine(g, cfg, device=cuda).plan()
            zero()
            with policy_rec:
                res = plan.solve(SingleSource(0))
                torch.cuda.synchronize()
            got = read()
            t = res.telemetry
            check(torch.equal(res.dist, base.dist)
                  and torch.equal(res.pred, base.pred),
                  f"{st}/{policy}: dist/pred differ from the delta answer")
            check(got["bucket_scan"] == 0 and got["ell_relax"] == (
                2 * t.inner_iters if st == "pallas" else 0),
                f"{st}/{policy}: ell_relax launches != 2 * steps")
            if st == "pallas":
                for k, v in got.items():
                    launches_policy[k] += v
            syncs = plan.host_syncs
            _, walls = walls_ms(torch, lambda: plan.solve(SingleSource(0)),
                                POLICY_REPS)
            log(f"[policy] {st}/{policy}"
                f"{'' if policy == 'rho' else f' k={RADIUS_K}'}: dist/pred "
                f"== delta, rounds={t.buckets} steps={t.inner_iters} "
                f"overflow={t.overflow} host_syncs={syncs} launches "
                f"{json.dumps(got)}; {fmt(walls)} after the checked run")
            if (policy, st) == ("rho", "edge"):
                rho_edge = plan
    check("ell_relax" in policy_rec.best, "no ell_relax input recorded on "
          "the policy path")
    dist = base.dist.cpu().numpy()
    far = int(np.argmax(dist))
    p2p = rho_edge.solve(PointToPoint(0, far))
    check(p2p.distance == int(dist[far]), "rho PointToPoint distance")
    check_path(p2p.path, 0, far, p2p.distance, keyed, g.n_nodes)
    radius = int(dist.max()) // 2
    bnd = rho_edge.solve(BoundedRadius(0, radius))
    within = base.dist <= radius
    check(torch.equal(bnd.dist, torch.where(within, base.dist, INF))
          and torch.equal(bnd.pred, torch.where(within, base.pred, -1)),
          "rho BoundedRadius differs from the filtered delta answer")
    log(f"[policy] edge/rho PointToPoint 0->{far}: distance {p2p.distance} "
        f"== delta, path valid, rounds={p2p.telemetry.buckets}; "
        f"BoundedRadius({radius}) == delta filtered "
        f"({int(within.sum())} vertices), rounds={bnd.telemetry.buckets}")
    log(f"[batch] phase 8 (small-world) took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches_multi, launches_policy, launches_fb, launches_twin, {
        "smallworld_multisource": lane1.best,
        "smallworld_policy": policy_rec.best,
        "smallworld_fallback": capped.best}


def dyn_batches(rng, n_edges: int, w0, k: int, n_sets: int):
    """The update protocol of ``benchmarks/bench_dynamic.py:_batches``:
    ``n_sets`` seeded id sets of ``k`` edges, each with two distinct
    absolute weight assignments (``clip(w0 + U[-5, 5], 1, 20)``, then an
    elementwise-different one), cycled A1..An, B1..Bn, so re-applying
    the cycle always changes weights."""
    import numpy as np
    sets = []
    for _ in range(n_sets):
        ids = rng.choice(n_edges, size=k, replace=False)
        wa = np.clip(w0[ids] + rng.integers(-5, 6, size=k), 1, 20)
        wb = np.where(wa < 20, wa + 1, wa - 1)
        sets.append((ids, wa, wb))
    return ([(ids, wa) for ids, wa, _ in sets]
            + [(ids, wb) for ids, _, wb in sets])


class Split:
    """While active, times the parts of a plan's ``UpdateBatch`` solves:
    ``update`` (the weight swap and backend rebuild), the host repair
    planning (``plan_repair``, the device-to-host copies of its inputs
    included), the choice (or build) of the warm backend, and each warm
    run of the solve loop, whose ``(kind, cap, buckets, inner_iters,
    overflow)`` it also keeps (``kind``: the backend's launch
    equations). Each part ends in a synchronize."""

    KIND = {"PallasEllBackend": "pallas", "FusedBackend": "fused"}

    def __init__(self, torch, plan, engine_mod):
        self.torch, self.plan, self.engine = torch, plan, engine_mod
        self.ms = {"update": 0.0, "planning": 0.0, "twin": 0.0,
                   "loop": 0.0}
        self.runs = []

    def _timed(self, part, fn):
        return synced(self.torch, self.ms, part, fn)

    def _wrap_warm(self):
        real = self.plan._run_warm
        timed = self._timed("loop", real)

        def warm(backend, tent0, explored0):
            out = timed(backend, tent0, explored0)
            self.runs.append((self.KIND.get(type(backend).__name__, "ell"),
                              getattr(backend, "cap", None), out.outer_iters,
                              out.inner_iters, out.overflow))
            return out
        warm.split = self
        self.plan._run_warm = warm

    def __enter__(self):
        plan = self.plan
        real_update = plan.update
        timed_update = self._timed("update", real_update)

        def update(*args, **kw):
            out = timed_update(*args, **kw)
            if getattr(plan._run_warm, "split", None) is not self:
                self._wrap_warm()       # a radius plan rebinds its drivers
            return out
        plan.update = update
        plan._warm_backend = self._timed("twin", plan._warm_backend)
        self._wrap_warm()
        self.real_pr = self.engine.plan_repair
        self.engine.plan_repair = self._timed("planning", self.real_pr)
        return self

    def __exit__(self, *exc):
        del self.plan.update, self.plan._warm_backend
        self.plan._bind_drivers()
        self.engine.plan_repair = self.real_pr

    def check_parts(self, tag: str) -> None:
        """Every part was timed: a part left at 0 ms means the engine no
        longer calls the name it is timed through."""
        check(all(v > 0 for v in self.ms.values()) and self.runs,
              f"{tag}: a part of the split was not timed ({self.ms})")

    def launches(self) -> dict:
        """The warm runs' launches by their own counters' equations (a
        policy loop: two ``ell_relax`` launches per step on ``pallas``,
        no bucket scan)."""
        want = dict.fromkeys(("bucket_scan", "ell_relax", "frontier_relax",
                              "grid_relax"), 0)
        policy = self.plan.config.policy != "delta"
        for kind, _, b, inner, _ in self.runs:
            got = (dict(want, ell_relax=2 * inner if kind == "pallas" else 0)
                   if policy else delta_launches(kind, b, inner))
            for k, v in got.items():
                want[k] += v
        return want


def dynamic_path(torch, np, cuda, g, plans, counters):
    """Phase 9: warm re-solves at full width (see the module note).
    Returns the launches of the small-world and the lattice warm paths
    and, per path, each kernel's recorded input with the largest
    frontier."""
    import repro_torch.api.engine as engine_mod
    import repro_torch.core.backends as backends
    from repro_torch.api import Engine, SingleSource, UpdateBatch
    from repro_torch.core import DeltaConfig
    from repro_torch.graphs import square_lattice

    t_phase = time.perf_counter()
    n, n_edges = g.n_nodes, g.n_edges

    def zero():
        for fn in counters.values():
            fn.launches = 0

    def read():
        return {k: fn.launches for k, fn in counters.items()}

    def same_answer(a, b):
        return torch.equal(a.dist, b.dist) and torch.equal(a.pred, b.pred)

    def counted(plan, q, rec, total):
        """One counted run of ``q`` on ``plan``: launches (added to
        ``total``) held to the warm runs' equations, inputs kept by
        ``rec`` (its sizing adds one host sync per kernel call), and the
        run's split. Not timed: ``timed_bumps`` gives the times."""
        zero()
        with rec, Split(torch, plan, engine_mod) as split:
            res = plan.solve(q)
            torch.cuda.synchronize()
        got = read()
        split.check_parts("counted run")
        check(got == split.launches(), f"launches {got} off the warm runs' "
              f"equations {split.launches()} ({split.runs})")
        for k, v in got.items():
            total[k] += v
        return res, got, split

    def timed_bumps(plan, batches):
        """One ``UpdateBatch`` solve per batch, each timed whole and
        split: update, planning, warm backend, device loop, the rest;
        host syncs."""
        rows = []
        for ids, w in batches:
            with Split(torch, plan, engine_mod) as split:
                res, walls = walls_ms(
                    torch, lambda: plan.solve(UpdateBatch(ids, w)), 1)
            check(res.telemetry.warm and res.telemetry.repaired > 0,
                  "a timed batch did not repair warm")
            split.check_parts("timed batch")
            rows.append((walls[0], split.ms, plan.host_syncs))
        return rows

    def split_line(rows) -> str:
        walls = [r[0] for r in rows]
        parts = {k: statistics.median(r[1][k] for r in rows)
                 for k in ("update", "planning", "twin", "loop")}
        rest = statistics.median(r[0] - sum(r[1].values()) for r in rows)
        return (f"update + warm resolve {fmt(walls)}: update "
                f"{parts['update']:.1f}, host repair planning "
                f"{parts['planning']:.1f} (share "
                f"{parts['planning'] / statistics.median(walls):.3f}), warm "
                f"backend {parts['twin']:.1f}, device loop "
                f"{parts['loop']:.1f}, rest {rest:.1f} ms (medians); host "
                f"syncs {[r[2] for r in rows]}")

    w0 = g.w.cpu().numpy()
    rng = np.random.default_rng(DYN_SEED)
    cycles = {k: dyn_batches(rng, n_edges, w0, k, DYN_SETS) for k in DYN_KS}
    launches_sw = dict.fromkeys(counters, 0)
    sw_rec = Largest(backends, frontier_sizes(n, SW_KERNELS))
    keys = (("edge", "argmin"), ("ell", "argmin"), ("pallas", "argmin"),
            ("fused", "argmin"), ("fused", "packed"))
    for key in keys:        # phase 6 solved SingleSource(0) on each plan
        check(plans[key].explain()["resident_source"] == 0,
              f"{key}: no resident SingleSource(0)")

    # -- 9a/9b. the strategies at 0.1 % and 1 % of |E| ------------------
    for k in DYN_KS:
        seq = cycles[k]
        first = k == DYN_KS[0]
        # the first k: two warm-up batches, the counted one, then
        # DYN_REPS timed (DYN_TIMED only); the second k: the counted one
        warmups, counted_b = (seq[1:2], seq[2]) if first else ([], seq[0])
        timed_b = [seq[3], seq[0], seq[1]][:DYN_REPS]
        oracle = None
        refs = []       # (weights, warm answer, plan) of this k, per weights
        for key in keys if first else DYN_WIDE:
            st, pm = key
            plan = plans[key]
            timed = first and st in DYN_TIMED
            if timed:                # timing warm-ups
                for ids, w in warmups:
                    plan.solve(UpdateBatch(ids, w))
            res, got, split = counted(plan, UpdateBatch(*counted_b),
                                      sw_rec, launches_sw)
            t = res.telemetry
            check(t.warm and t.repaired > 0 and not t.fallback,
                  f"{st}/{pm} k={k}: no warm repair")
            if oracle is None:
                t0 = time.perf_counter()
                oracle, ok_keyed = oracle_dist(plan.graph)
                check(np.array_equal(res.dist.cpu().numpy().astype(np.int64),
                                     oracle), f"k={k}: warm dist differs "
                      "from the scipy oracle")
                check_tree(res.dist.cpu().numpy(), res.pred.cpu().numpy(), 0,
                           ok_keyed)
                log(f"[dyn] k={k}: {st}/{pm} warm dist == scipy dijkstra on "
                    f"the updated graph, pred tree ok (oracle "
                    f"{time.perf_counter() - t0:.1f} s)")
            ref = next((r for r in refs if torch.equal(r[0], plan.graph.w)),
                       None)
            if ref is None:
                refs.append((plan.graph.w, res, f"{st}/{pm}"))
            else:
                check(same_answer(res, ref[1]), f"{st}/{pm} k={k}: warm "
                      f"answer differs from {ref[2]}'s on the same weights")
            if st == "edge":
                # a fresh Engine of the ELL strategies is a host ELL build
                # (~3 s at 1 M); they are held to edge's warm answer and to
                # their own cold solve of the updated graph
                fresh, walls = walls_ms(torch, lambda: Engine(
                    plan.graph, DeltaConfig(delta=DELTA, strategy=st,
                                            pred_mode=pm),
                    device=cuda).plan().solve(SingleSource(0)), 1)
                check(same_answer(res, fresh),
                      f"{st}/{pm} k={k}: warm != a fresh Engine's cold solve")
                fresh_note = f"== a fresh Engine ({walls[0]:.0f} ms)"
            elif timed:
                fresh_note = "(held to resolve(warm=False) below)"
            else:
                cold, walls = walls_ms(
                    torch, lambda: plan.resolve(warm=False), 1)
                check(same_answer(res, cold) and not cold.telemetry.warm,
                      f"{st}/{pm} k={k}: warm != resolve(warm=False)")
                fresh_note = f"== resolve(warm=False) ({walls[0]:.0f} ms)"
            log(f"[dyn] {st}/{pm} k={k}: warm {fresh_note}"
                + ("" if ref is None else f", == {ref[2]}'s") + "; "
                f"buckets={t.buckets} inner_iters={t.inner_iters} "
                f"repaired={t.repaired} cone={t.cone} "
                f"host_syncs={plan.host_syncs} runs {split.runs} launches "
                f"{json.dumps(got)}; counted run: update "
                f"{split.ms['update']:.1f}, planning "
                f"{split.ms['planning']:.1f}, warm backend "
                f"{split.ms['twin']:.1f}, loop {split.ms['loop']:.1f} ms")
            if timed:
                # timed: DYN_REPS cold re-solves (the first held to the
                # warm answer), then DYN_REPS batches after the counted one
                cold, walls = walls_ms(
                    torch, lambda: plan.resolve(warm=False), DYN_REPS)
                check(same_answer(cold, res) and not cold.telemetry.warm,
                      f"{st}/{pm} k={k}: resolve(warm=False) differs")
                log(f"[time] dyn {st}/{pm} k={k}: "
                    + split_line(timed_bumps(plan, timed_b))
                    + f"; resolve(warm=False) {fmt(walls)}, buckets="
                    f"{cold.telemetry.buckets} host_syncs={plan.host_syncs}")
    check(all(launches_sw[x] > 0 for x in SW_KERNELS),
          f"the small-world warm path missed a kernel: {launches_sw}")

    # -- 9c. frontier policies, warm --------------------------------------
    for policy, extra in (("rho", {}), ("radius", dict(radius_k=RADIUS_K))):
        for st in ("edge",):
            cfg = DeltaConfig(delta=DELTA, strategy=st, pred_mode="argmin",
                              policy=policy, **extra)
            plan = Engine(g, cfg, device=cuda).plan()
            plan.solve(SingleSource(0))
            res, got, split = counted(
                plan, UpdateBatch(*cycles[DYN_KS[0]][0]), sw_rec, launches_sw)
            t = res.telemetry
            check(t.warm and t.repaired > 0, f"{st}/{policy}: no warm repair")
            cold, walls = walls_ms(torch, lambda: plan.resolve(warm=False), 1)
            check(same_answer(res, cold),
                  f"{st}/{policy}: warm != the cold solve of the updated graph")
            log(f"[dyn] {st}/{policy} k={DYN_KS[0]}: warm == cold (rounds="
                f"{t.buckets} steps={t.inner_iters} repaired={t.repaired} "
                f"cone={t.cone}; cold rounds={cold.telemetry.buckets}), "
                f"launches {json.dumps(got)}; counted run: update "
                f"{split.ms['update']:.1f}, planning "
                f"{split.ms['planning']:.1f}, loop {split.ms['loop']:.1f} ms;"
                f" cold {walls[0]:.1f} ms")
            del plan

    # -- 9d. long diameter: one far edge flipped on the lattice -----------
    t0 = time.perf_counter()
    lat = square_lattice(LATTICE_SIDE, weighted=True)
    t_gen = time.perf_counter() - t0
    launches_lat = dict.fromkeys(counters, 0)
    lat_rec = Largest(backends, frontier_sizes(lat.n_nodes, SW_KERNELS))
    edge_id = cold_up = None
    for st in LATTICE_STRATEGIES:
        cfg = DeltaConfig(delta=DELTA, strategy=st, pred_mode="argmin")
        plan = Engine(lat, cfg, device=cuda).plan()
        base, walls = walls_ms(torch, lambda: plan.solve(SingleSource(0)), 1)
        b_cold = base.telemetry.buckets
        if edge_id is None:
            # the tree edge into the vertex farthest from the source
            dist = base.dist.cpu().numpy()
            v = int(np.argmax(np.where(dist < INF, dist, -1)))
            p = int(base.pred[v])
            src, dst = lat.src.numpy(), lat.dst.numpy()
            edge_id = int(np.flatnonzero((src == p) & (dst == v))[0])
            w_e = int(lat.w[edge_id])
            log(f"[dyn] lattice {LATTICE_SIDE}x{LATTICE_SIDE}: n={lat.n_nodes}"
                f" |E|={lat.n_edges}; far vertex {v} at distance "
                f"{int(dist[v])}, its tree edge {edge_id} ({p}->{v}, w={w_e}),"
                f" generated in {t_gen:.1f} s, cold solve {walls[0]:.0f} ms")
        up, got_up, split_up = counted(
            plan, UpdateBatch([edge_id], [w_e + 7]), lat_rec, launches_lat)
        if cold_up is None:
            cold_up = plan.resolve(warm=False)
        check(same_answer(up, cold_up), f"lattice {st}: warm != cold after "
              "the increase")
        back, got_back, split_back = counted(
            plan, UpdateBatch([edge_id], [w_e]), lat_rec, launches_lat)
        check(same_answer(back, base), f"lattice {st}: warm != the cold "
              "solve after the edge is restored")
        for r in (up, back):
            check(r.telemetry.warm and r.telemetry.repaired > 0
                  and 2 * r.telemetry.buckets < b_cold,
                  f"lattice {st}: not far fewer buckets warm than cold")
        rows = timed_bumps(plan, [([edge_id], [w_e + 7]), ([edge_id], [w_e]),
                                  ([edge_id], [w_e + 7])])
        log(f"[dyn] lattice {st}: warm == cold; buckets warm "
            f"{up.telemetry.buckets} / {back.telemetry.buckets} against cold "
            f"{b_cold} (inner_iters {up.telemetry.inner_iters} / "
            f"{back.telemetry.inner_iters} against "
            f"{base.telemetry.inner_iters}), repaired "
            f"{up.telemetry.repaired} / {back.telemetry.repaired}, runs "
            f"{split_up.runs} / {split_back.runs}, launches "
            f"{json.dumps(got_up)} / {json.dumps(got_back)}")
        log(f"[time] dyn lattice {st}: {split_line(rows)}; cold "
            f"SingleSource {walls[0]:.1f} ms")
        del plan
    check(all(launches_lat[x] > 0 for x in SW_KERNELS),
          f"the lattice warm path missed a kernel: {launches_lat}")

    # -- 9e. where a warm solve's device time goes ------------------------
    plan = plans[("pallas", "argmin")]
    # B2, then A2, of the first k: both change weights the plan holds
    flip = iter([cycles[DYN_KS[0]][3], cycles[DYN_KS[0]][1]])
    kern, wall, seen, _ = profiled(torch, lambda: plan.solve(
        UpdateBatch(*next(flip))), counters=counters)
    busy = sum(kern.values())
    log(f"[profile] warm pallas k={DYN_KS[0]}: profiled solve {wall:.1f} ms "
        f"(update included), device busy {busy:.1f} ms (idle share "
        f"{1 - busy / wall:.3f}), {len(kern)} kernel names; kernel records "
        f"{seen_line(seen)}")
    for kname, ms in sorted(kern.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[profile]   {ms:9.3f} ms  {kname[:110]}")
    log(f"[dyn] phase 9 took {time.perf_counter() - t_phase:.1f} s")
    return launches_sw, launches_lat, {"smallworld_warm": sw_rec.best,
                                       "lattice_warm": lat_rec.best}


class Timed:
    """While active, replaces ``obj.name`` for each ``(obj, name)`` in
    ``targets`` by a wrapper that adds its wall time, ended by a
    synchronize, to ``ms[name]``."""

    def __init__(self, torch, targets):
        self.torch, self.targets = torch, targets
        self.ms = {name: 0.0 for _, name in targets}

    def __enter__(self):
        self.real = [(obj, name, getattr(obj, name))
                     for obj, name in self.targets]
        for obj, name, fn in self.real:
            setattr(obj, name, synced(self.torch, self.ms, name, fn))
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self.real:
            setattr(obj, name, fn)


def landmark_path(torch, np, cuda, g, ref_dist, keyed, counters):
    """Phase 10: landmark point-to-point queries at full width (see the
    module note). The launch counters are set to 0 after the game map's
    reference solve and read at the end: every landmark solve runs on an
    all-light ``EllBackend`` and the ``edge`` plan's early exit on
    tensor ops, so all four must read 0."""
    import tempfile

    import repro_torch.landmarks.alt as alt_mod
    import repro_torch.tune.estimator as estimator
    from repro_torch.api import (Engine, LandmarkRefused, PointToPoint,
                                 SingleSource)
    from repro_torch.core import DeltaConfig
    from repro_torch.graphs import grid_map

    t_phase = time.perf_counter()
    n = g.n_nodes
    fin = ref_dist < INF
    far = int(np.flatnonzero(ref_dist == ref_dist[fin].max())[0])
    targets = {"far": far}

    # the game map's reference answer launches the grid kernels: it is
    # solved before the counters are set to 0
    gs, fs = grid_map(SMALL_SIDE, SMALL_SIDE, OBSTACLES, seed=0)
    cells = np.flatnonzero(fs.ravel())
    gsrc, gtgt = int(cells[0]), int(cells[-1])
    gplan = Engine(gs, DeltaConfig(delta=GRID_DELTA, strategy="pallas",
                                   pred_mode="argmin"), free_mask=fs,
                   device=cuda).plan()
    gdist = gplan.solve(SingleSource(gsrc)).dist.cpu().numpy()
    gkeyed = dedup_min(gs.src.cpu().numpy(), gs.dst.cpu().numpy(),
                       gs.w.cpu().numpy(), gs.n_nodes)

    for fn in counters.values():
        fn.launches = 0
    cfg = DeltaConfig(delta=DELTA, strategy="edge", pred_mode="argmin")
    plan = Engine(g, cfg, device=cuda).plan()
    store = tempfile.TemporaryDirectory()

    # -- 10a. tables: prepare_landmarks, split; one landmark's rows --------
    split = Timed(torch, [(estimator, "graph_stats"),
                          (estimator, "fingerprint"),
                          (alt_mod, "graph_whash"),
                          (alt_mod, "build_tables")])
    with split:
        t0 = time.perf_counter()
        plan.prepare_landmarks(k=LANDMARK_K, store=store.name)
        torch.cuda.synchronize()
        t_prep = (time.perf_counter() - t0) * 1e3
    tables = plan.landmark_tables
    ms = split.ms
    check(all(v > 0 for v in ms.values()), f"a part of prepare_landmarks "
          f"was not timed ({ms})")
    log(f"[landmarks] prepare_landmarks(k={LANDMARK_K}, farthest, seed 0) "
        f"on edge: {t_prep:.1f} ms: graph_stats {ms['graph_stats']:.1f} + "
        f"fingerprint {ms['fingerprint']:.1f}, whash "
        f"{ms['graph_whash']:.1f}, selection + rows "
        f"{ms['build_tables']:.1f} ms (the rows' whash inside it once "
        f"more); landmarks {tables.landmarks.tolist()}, fingerprint "
        f"{tables.fingerprint}")
    lm = int(tables.landmarks[0])
    d_out, _ = oracle_dist(g, lm)
    d_in, _ = oracle_dist(g.reversed(), lm)
    check(np.array_equal(tables.d_out[0].astype(np.int64), d_out),
          f"landmark {lm}: d_out differs from scipy")
    check(np.array_equal(tables.d_in[0].astype(np.int64), d_in),
          f"landmark {lm}: d_in differs from scipy on the reversed edges")
    log(f"[landmarks] landmark {lm}: d_out == scipy, d_in == scipy on the "
        f"reversed edge list")
    t0 = time.perf_counter()
    plan._landmarks._ells(plan.graph)
    torch.cuda.synchronize()
    log(f"[landmarks] all-light ELL blocks (union {2 * n} x "
        f"{plan._landmarks._union_ell.max_deg}, forward {n} x "
        f"{plan._landmarks._fwd_ell.max_deg}) built on the host in "
        f"{time.perf_counter() - t0:.1f} s, once per weight version")

    # -- 10b. queries: every mode to the far target ------------------------
    walls = {}
    for mode in LM_MODES:
        for name, t in targets.items():
            q = PointToPoint(0, t, mode=mode)
            if name == "far":
                plan.solve(q)                   # warm-up
            r, w = walls_ms(torch, lambda: plan.solve(q),
                            LANDMARK_REPS if name == "far" else 1)
            tel = r.telemetry
            check(r.distance == int(ref_dist[t]),
                  f"{mode} 0->{t}: distance {r.distance} != scipy")
            check_path(r.path, 0, t, r.distance, keyed, n)
            check(plan.host_syncs == 2 * tel.buckets + tel.inner_iters + 1,
                  f"{mode} 0->{t}: host syncs off the formula")
            check(not tel.overflow, f"{mode}: overflow")
            walls[(mode, name)] = statistics.median(w)
            log(f"[landmarks] {mode} 0->{t} ({name}, dist {r.distance}): "
                f"path of {len(r.path) - 1} valid steps, buckets="
                f"{tel.buckets} inner_iters={tel.inner_iters} host_syncs="
                f"{plan.host_syncs}, {fmt(w)}")

    # -- 10c. one profiled alt query: the scatter's share -----------------
    kern, wall, _, counts = profiled(torch, lambda: plan.solve(
        PointToPoint(0, far, mode="alt")))
    r = plan.solve(PointToPoint(0, far, mode="alt"))
    busy = sum(kern.values())
    scat = [k for k in kern if "scatter" in k]
    got = sum(counts[k] for k in scat)
    # per sweep (light or heavy) one compaction scatter and one
    # scatter-min, and one scatter-min in pred recovery
    want = 2 * (r.telemetry.buckets + r.telemetry.inner_iters) + 1
    if got == want:
        scat_ms = sum(kern[k] for k in scat)
        log(f"[profile] landmarks alt 0->{far}: profiled query {wall:.1f} "
            f"ms, device busy {busy:.1f} ms (idle share "
            f"{1 - busy / wall:.3f}); scatter {scat_ms:.1f} ms (share of "
            f"busy {scat_ms / busy:.3f}) over {got} records, every record "
            f"kept")
        for k, ms_ in sorted(kern.items(), key=lambda kv: -kv[1])[:6]:
            log(f"[profile]   {ms_:9.3f} ms  x{counts[k]}  {k[:100]}")
    else:
        log(f"[profile] landmarks alt 0->{far}: the profiler kept {got} "
            f"scatter records of {want}: records lost, no share and no "
            f"breakdown")

    # -- 10d. the store: a second plan hits it -----------------------------
    second = Engine(g, cfg, device=cuda).plan()
    t0 = time.perf_counter()
    second.prepare_landmarks(k=LANDMARK_K, store=store.name)
    t_hit = (time.perf_counter() - t0) * 1e3
    hit = second.landmark_tables
    check(hit is not tables and all(
        np.array_equal(getattr(hit, f), getattr(tables, f))
        for f in ("landmarks", "d_out", "d_in")) and
        (hit.fingerprint, hit.whash) == (tables.fingerprint, tables.whash),
        "the store's tables differ from the built ones")
    log(f"[landmarks] store hit on a second plan in {t_hit:.1f} ms (the "
        f"fingerprint's graph_stats included), tables bitwise equal")
    del second

    # -- 10e. updates: kept, stale and rebuilt, refused --------------------
    w0 = g.w.cpu().numpy()
    batches = dyn_batches(np.random.default_rng(DYN_SEED), g.n_edges, w0,
                          LM_DYN_K, DYN_SETS)
    (ids1, wa1), (ids2, wa2) = batches[0], batches[1]
    inc = np.maximum(wa1, w0[ids1])
    check((inc > w0[ids1]).any(), "the increase-only batch changes nothing")
    plan.update(ids1, inc)
    check(plan.landmark_tables is tables,
          "an increase-only batch dropped the tables")
    r = plan.solve(PointToPoint(0, far, mode="alt"))
    upd, ukeyed = oracle_dist(plan.graph, 0)
    check(r.distance == int(upd[far]), "alt after an increase-only batch "
          "differs from scipy on the updated weights")
    check_path(r.path, 0, far, r.distance, ukeyed, n)
    log(f"[landmarks] increase-only batch (k={LM_DYN_K}): tables kept, alt "
        f"0->{far} dist {r.distance} == scipy on the updated weights")
    plan.update(ids1, wa1)
    check(plan.landmark_tables is None, "a decreasing batch kept the tables")
    t0 = time.perf_counter()
    r = plan.solve(PointToPoint(0, far, mode="alt"))
    t_rebuild = (time.perf_counter() - t0) * 1e3
    ee = plan.solve(PointToPoint(0, far))
    check(plan.landmark_tables is not None and
          plan.landmark_tables is not tables, "alt did not rebuild the tables")
    check(r.distance == ee.distance, "alt after the rebuild differs from "
          "early_exit on the same plan")
    log(f"[landmarks] decreasing batch under recompute: tables dropped; alt "
        f"rebuilt them and answered in {t_rebuild:.1f} ms, dist "
        f"{r.distance} == early_exit")
    plan.prepare_landmarks(k=LANDMARK_K, store=store.name, on_update="refuse")
    check(plan._landmarks.would_invalidate(ids2, wa2),
          "the refused batch lowers no weight")
    w_before = plan.graph.w.clone()
    try:
        plan.update(ids2, wa2)
        check(False, "the refuse policy applied a decreasing batch")
    except LandmarkRefused as e:
        check(e.reason == "landmarks_stale", f"refusal reason {e.reason}")
    check(torch.equal(plan.graph.w, w_before),
          "a refused batch changed the weights")
    log("[landmarks] on_update='refuse': the decreasing batch raised "
        "LandmarkRefused(reason='landmarks_stale'), weights bitwise "
        "unchanged")
    store.cleanup()

    # -- 10f. the game map: every landmark mode on the grid plan -----------
    for mode in LM_MODES[1:]:
        r, w = walls_ms(torch, lambda: gplan.solve(
            PointToPoint(gsrc, gtgt, mode=mode)), 1)
        tel = r.telemetry
        check(r.distance == int(gdist[gtgt]), f"gamemap {mode}: distance "
              "differs from the grid plan's SingleSource")
        check_path(r.path, gsrc, gtgt, r.distance, gkeyed, gs.n_nodes)
        check(gplan.host_syncs == 2 * tel.buckets + tel.inner_iters + 1,
              f"gamemap {mode}: host syncs off the formula")
        log(f"[landmarks] gamemap {SMALL_SIDE}x{SMALL_SIDE} {mode} "
            f"{gsrc}->{gtgt}: dist {r.distance} == SingleSource, path of "
            f"{len(r.path) - 1} valid steps, buckets={tel.buckets} "
            f"inner_iters={tel.inner_iters}, {fmt(w)}"
            + (" (builds the tables)" if mode == LM_MODES[1] else ""))

    launches = {k: fn.launches for k, fn in counters.items()}
    check(not any(launches.values()),
          f"the landmark solves launched a kernel: {launches}")
    log(f"[landmarks] launches over phase 10: {json.dumps(launches)}")
    log(f"[landmarks] far-target medians (ms): " + ", ".join(
        f"{m} {walls[(m, 'far')]:.1f}" for m in LM_MODES))
    log(f"[landmarks] phase 10 took {time.perf_counter() - t_phase:.1f} s")


# -- phases 11 and 12: the tuner and the serving tier -----------------------

class ByGraph:
    """While active, wraps the kernel dispatchers of ``core.backends``
    named in ``counters`` and adds the launches each call makes (its
    counter's growth over the call) to the path ``path_of(n)`` names for
    the length ``n`` of the call's distance input: the tenants of one
    server run interleaved on one thread, and their graphs' sizes tell
    their launches apart. No tensor is read, so the wrapped run makes no
    extra device work or synchronisation."""

    def __init__(self, backends, counters, path_of):
        self.backends, self.counters = backends, counters
        self.path_of = path_of
        self.launches = {}

    def __enter__(self):
        self.real = {name: getattr(self.backends, name)
                     for name in self.counters}
        for name in self.counters:
            setattr(self.backends, name, self._wrap(name))
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.backends, name, fn)

    def _wrap(self, name):
        real, counter = self.real[name], self.counters[name]
        dist = Largest.DIST[name]

        def wrapped(*args, **kw):
            before = counter.launches
            out = real(*args, **kw)
            path = self.launches.setdefault(
                self.path_of(args[dist].numel()), dict.fromkeys(
                    self.counters, 0))
            path[name] += counter.launches - before
            return out
        return wrapped


def tuning_path(torch, np, cuda, g, ref_dist, keyed, counters):
    """Phase 11: the tuner on the 1 M-vertex small-world graph (see the
    module note). Returns the launches of the measured search, each
    kernel's recorded input with the largest frontier from one more
    solve of the fastest ``fused`` candidate, the tuning cache's path
    and the directory that holds it (kept alive for phase 12)."""
    import contextlib
    import dataclasses
    import io
    import os
    import tempfile

    import repro_torch.core.backends as backends
    from repro_torch.api import Engine, SingleSource, Tuning
    from repro_torch.core import DeltaConfig
    from repro_torch.launch.sssp import main as sssp_main
    from repro_torch.tune import (TuningCache, candidate_configs,
                                  estimate_delta, graph_stats, tune)

    t_phase = time.perf_counter()
    n = g.n_nodes
    gd = g.to(cuda)

    # -- 11a. Engine(g): the estimator, without the hop-radius probe -------
    t0 = time.perf_counter()
    plan = Engine(gd, device=cuda).plan()
    resolve_ms = (time.perf_counter() - t0) * 1e3
    est = estimate_delta(graph_stats(g, probe_ecc=False))
    check(plan.config.delta == est and plan.record.source == "heuristic"
          and plan.record.fingerprint == ""
          and plan.explain()["tuning_source"] == "heuristic",
          "Engine(g): not the estimator's operating point")
    log(f"[tune] Engine(g).plan(): Δ={plan.config.delta} == estimate_delta, "
        f"strategy={plan.config.strategy}, record=heuristic (no hop-radius "
        f"probe), resolved in {resolve_ms:.1f} ms")

    # -- 11b. the measured search ----------------------------------------
    t0 = time.perf_counter()
    stats = graph_stats(gd)
    stats_s = time.perf_counter() - t0
    grid = sorted({c[0] for c in candidate_configs(
        stats, strategies=TUNE_STRATEGIES, policies=TUNE_POLICIES)})
    deltas = grid[TUNE_GRID_TRIM:len(grid) - TUNE_GRID_TRIM]
    cands = candidate_configs(stats, strategies=TUNE_STRATEGIES,
                              deltas=deltas, policies=TUNE_POLICIES)
    n_fused = sum(1 for c in cands if c[1] == "fused")
    check(est in deltas and len(cands) == 3 * len(deltas)
          and n_fused == 2 * len(deltas),
          "the candidate grid is not Δ x (edge, fused at cap n and n/4)")
    log(f"[tune] graph_stats (hop-radius probe included) {stats_s:.2f} s; "
        f"estimate Δ={est}, the estimator's grid Δ={grid} searched without "
        f"its {TUNE_GRID_TRIM} lowest and highest, Δ={deltas}: {len(cands)} "
        f"candidates, {n_fused} fused")
    keep = tempfile.TemporaryDirectory()
    path = os.path.join(keep.name, "tuning.json")
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    rec = tune(gd, sources=(0,), strategies=TUNE_STRATEGIES, deltas=deltas,
               policies=TUNE_POLICIES, cache=TuningCache(path), device=cuda)
    search_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    check(launches["frontier_relax"] > 0 and launches["bucket_scan"] > 0,
          "the search did not launch frontier_relax and bucket_scan")
    check(rec.source == "measured" and 0 < len(rec.trials) <= len(cands),
          "the search returned no measured record")
    measured = {t[:4] for t in rec.trials}
    rejected = [c for c in cands
                if (c[0], c[1], -1 if c[2] is None else c[2], c[3])
                not in measured]
    log(f"[tune] tune(sources=(0,), strategies={TUNE_STRATEGIES}, "
        f"policies={TUNE_POLICIES}) in {search_s:.1f} s; launches "
        f"{json.dumps(launches)}; rejected (overflow) {rejected}")
    for d, s, c, p, us in rec.trials:
        log(f"[tune]   trial Δ={d} {s} cap={c} {p}: {us / 1e3:.1f} ms")
    log(f"[tune] winner: Δ={rec.delta} strategy={rec.strategy} "
        f"cap={rec.frontier_cap} policy={rec.policy}, "
        f"{rec.us_per_solve / 1e3:.1f} ms a solve")

    # -- 11c. the tuned plan: a cache hit, its cap re-validated ------------
    hit_sources = [0, n // 3, n - 1]
    t0 = time.perf_counter()
    tplan = Engine(gd, tuning=Tuning(measure=True, cache=path),
                   device=cuda).plan(sources=hit_sources)
    hit_ms = (time.perf_counter() - t0) * 1e3
    check(tplan.explain()["tuning_source"] == "cache"
          and dataclasses.replace(tplan.record, source="measured") == rec,
          "the tuned plan is not the cached record")
    check(tplan.config.frontier_cap in (rec.frontier_cap, None),
          "the tuned plan's cap is neither the record's nor dropped")
    restart = Engine(gd, tuning=path, device=cuda).plan(sources=hit_sources)
    check(restart.record == rec and restart.config == tplan.config,
          "tuning=<cache path> did not find the measured record")
    r = tplan.solve(SingleSource(0))
    explicit = Engine(gd, DeltaConfig(
        delta=rec.delta, strategy=rec.strategy, frontier_cap=rec.frontier_cap,
        policy=rec.policy), device=cuda).plan().solve(SingleSource(0))
    check(torch.equal(r.dist, explicit.dist)
          and torch.equal(r.pred, explicit.pred)
          and (r.telemetry.buckets, r.telemetry.inner_iters,
               r.telemetry.overflow) ==
          (explicit.telemetry.buckets, explicit.telemetry.inner_iters,
           explicit.telemetry.overflow),
          "the tuned solve differs from the explicit winner config's")
    dist = r.dist.cpu().numpy()
    check(np.array_equal(dist.astype(np.int64), ref_dist),
          "the tuned solve differs from the scipy oracle")
    check_tree(dist, r.pred.cpu().numpy(), 0, keyed)
    cap_note = ("no cap to re-validate" if rec.frontier_cap is None else
                f"cap {rec.frontier_cap} re-validated on {hit_sources}: "
                + ("kept" if tplan.config.frontier_cap else "dropped"))
    log(f"[tune] Engine(g, tuning=Tuning(measure=True, cache)).plan("
        f"sources={hit_sources}): cache hit in {hit_ms:.1f} ms ({cap_note}); "
        f"tuning=<path> finds the measured record; SingleSource(0) == the "
        f"explicit winner config (dist, pred, buckets={r.telemetry.buckets}, "
        f"inner_iters={r.telemetry.inner_iters}) == scipy, pred tree ok")

    # -- 11d. the launcher's --tune-cache finds the same record ------------
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        sssp_main(["--nodes", str(N_NODES), "--degree", str(DEGREE),
                   "--p", str(P_REWIRE), "--tune-cache", path])
    lines = out.getvalue().splitlines()
    for line in lines:
        log(line)
    want = (f"[sssp] tuned config: Δ={rec.delta} strategy={rec.strategy} "
            f"policy={rec.policy} cap={rec.frontier_cap} record=measured")
    check(any(line.startswith(want) for line in lines),
          "the launcher's --tune-cache did not find the measured record")
    log(f"[tune] launcher --tune-cache: same record "
        f"({time.perf_counter() - t0:.1f} s with the graph's generation)")

    # -- 11e. the fastest fused candidate's kernel inputs ------------------
    d, _, c, p, _ = next(t for t in rec.trials if t[1] == "fused")
    cfg = DeltaConfig(delta=d, strategy="fused", policy=p, pred_mode="none",
                      frontier_cap=None if c < 0 else c)
    fplan = Engine(gd, cfg, device=cuda).plan()
    with Largest(backends, frontier_sizes(n, ("bucket_scan",
                                              "frontier_relax"))) as big:
        fr = fplan.solve(SingleSource(0))
        torch.cuda.synchronize()
    check(np.array_equal(fr.dist.cpu().numpy().astype(np.int64), ref_dist),
          "the fastest fused candidate differs from the scipy oracle")
    check(set(big.best) == {"bucket_scan", "frontier_relax"},
          "the fused candidate recorded no kernel input")
    log(f"[tune] fastest fused candidate Δ={d} cap={c}: dist == scipy; "
        "largest frontiers " + ", ".join(
            f"{k} {v[2]}" for k, v in big.best.items()))
    log(f"[tune] phase 11 took {time.perf_counter() - t_phase:.1f} s")
    return launches, big.best, path, keep


def serve_traffic(np, graphs, n_requests: int, seed: int = 0):
    """The request mix of ``benchmarks/bench_serving.py:_traffic``
    (copied): ~55 % single-source, ~25 % point-to-point, ~12 % bounded
    radius with radius U[20, 200), ~4 % many-to-many of LANE x LANE,
    ~4 % updates of 16 edges (weights moved by U[-3, 3], at least 1),
    over the tenants in ``graphs``, from ``seed``."""
    from repro_torch.api import (BoundedRadius, ManyToMany, PointToPoint,
                                 SingleSource, UpdateBatch)

    rng = np.random.default_rng(seed)
    names = sorted(graphs)
    out = []
    for _ in range(n_requests):
        name = names[int(rng.integers(len(names)))]
        g = graphs[name]
        src = int(rng.integers(g.n_nodes))
        kind = rng.random()
        if kind < 0.55:
            q = SingleSource(src)
        elif kind < 0.80:
            q = PointToPoint(src, int(rng.integers(g.n_nodes)))
        elif kind < 0.92:
            q = BoundedRadius(src, int(rng.integers(20, 200)))
        elif kind < 0.96:
            srcs = rng.integers(g.n_nodes, size=SERVE_LANES).tolist()
            tgts = rng.integers(g.n_nodes, size=SERVE_LANES).tolist()
            q = ManyToMany(srcs, tgts, tile=SERVE_LANES)
        else:
            ids = rng.choice(g.n_edges, size=SERVE_UPDATE_EDGES,
                             replace=False)
            neww = np.clip(g.w.cpu().numpy()[ids]
                           + rng.integers(-3, 4, SERVE_UPDATE_EDGES), 1, None)
            q = UpdateBatch(ids, neww)
        out.append((name, q))
    return out


def serving_path(torch, np, cuda, g, ref_dist, keyed, counters, cache_path):
    """Phase 12: the serving tier on the card (see the module note).
    Returns each tenant path's launches (``smallworld_serve``,
    ``gamemap_serve``) and its kernels' recorded inputs with the largest
    frontier, from the serial re-solves of the same queries."""
    import contextlib

    import repro_torch.core.backends as backends
    from repro_torch.api import (BoundedRadius, Engine, ManyToMany,
                                 PointToPoint, SingleSource, UpdateBatch,
                                 UpdateRefused)
    from repro_torch.core import DeltaConfig
    from repro_torch.graphs import grid_map
    from repro_torch.serve import RequestRejected, Server

    t_phase = time.perf_counter()
    gm, free = grid_map(SMALL_SIDE, SMALL_SIDE, OBSTACLES, seed=0)
    gsrc = int(np.flatnonzero(free.ravel())[0])
    gref, gkeyed = oracle_dist(gm, gsrc)
    graphs = {"fused": g, "map": gm, "tuned": g}
    configs = {"fused": DeltaConfig(delta=DELTA, strategy="fused"),
               "map": DeltaConfig(delta=GRID_DELTA, strategy="pallas"),
               "tuned": None}
    masks = {"fused": None, "map": free, "tuned": None}
    # the mix, then one SingleSource per tenant whose answer scipy checks
    stream = serve_traffic(np, graphs, SERVE_REQUESTS) + [
        ("tuned", SingleSource(0)), ("fused", SingleSource(0)),
        ("map", SingleSource(gsrc))]
    kinds = {}
    for name, q in stream:
        key = f"{name}/{type(q).__name__}"
        kinds[key] = kinds.get(key, 0) + 1
    log(f"[serve] {len(stream)} requests: {json.dumps(kinds)}")

    srv = Server(lane_width=SERVE_LANES, max_resident=SERVE_RESIDENT,
                 device=cuda)
    srv.admit("tuned", g, tuning=cache_path)
    srv.admit("fused", g, config=configs["fused"])
    srv.admit("map", gm, config=configs["map"], free_mask=free)

    def path_of(numel):
        return "gamemap_serve" if numel <= gm.n_nodes else "smallworld_serve"

    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with ByGraph(backends, counters, path_of) as split:
        with srv:                               # the background batch loop
            tickets = [srv.submit(q, graph=name) for name, q in stream]
    serve_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    by_path = {p: split.launches.get(p, dict.fromkeys(counters, 0))
               for p in ("smallworld_serve", "gamemap_serve")}
    check(all(sum(v[k] for v in by_path.values()) == launches[k]
              for k in counters), "a launch of phase 12 has no path")
    check(by_path["smallworld_serve"]["frontier_relax"] > 0
          and by_path["gamemap_serve"]["grid_relax"] > 0
          and by_path["gamemap_serve"]["bucket_scan"] > 0,
          "the fused tenant did not launch frontier_relax or the map "
          "tenant grid_relax and bucket_scan")
    stats = srv.stats()
    log(f"[serve] served in {serve_s:.1f} s (the tenants' plan builds "
        f"included); launches {json.dumps(by_path)}")

    # -- 12a. every ticket: an answer, or the grid's refused update -------
    refused = 0
    for (name, q), t in zip(stream, tickets):
        exc = t.exception(0)
        if name == "map" and isinstance(q, UpdateBatch):
            check(isinstance(exc, RequestRejected)
                  and exc.reason == "update_refused",
                  "the grid tenant's update was not shed as update_refused")
            refused += 1
        else:
            check(exc is None, f"{name} {type(q).__name__}: ended in "
                  f"{type(exc).__name__}: {exc}")
    check(stats["shed"] == ({"update_refused": refused} if refused else {})
          and stats["completed"] == len(stream) - refused,
          "stats() counts off the tickets")
    check(stats["evictions"] > 0 and stats["plans_built"] > len(graphs),
          "no tenant was evicted and re-admitted")

    # -- 12b. every answer bitwise a serial plan.solve on a fresh plan -----
    sizes = frontier_sizes(N_NODES, ("bucket_scan", "frontier_relax"))
    records = {}
    for name, graph in graphs.items():
        t0 = time.perf_counter()
        plan = Engine(graph, configs[name], free_mask=masks[name],
                      tuning=cache_path if name == "tuned" else None,
                      device=cuda).plan(fallback=True)
        mine = [(q, t) for (n_, q), t in zip(stream, tickets) if n_ == name]
        watch = (Largest(backends, sizes) if name == "fused" else
                 Largest(backends, frontier_sizes(
                     gm.n_nodes, ("bucket_scan", "grid_relax")))
                 if name == "map" else None)
        with watch if watch is not None else contextlib.nullcontext():
            for q, t in mine:
                if isinstance(q, UpdateBatch):
                    try:
                        plan.update(q.edge_ids, q.new_weights)
                    except UpdateRefused:
                        continue    # shed by the server too: no change
                    continue
                ref, got = plan.solve(q), t.result(0)
                tag = f"{name} {type(q).__name__}"
                if isinstance(q, (SingleSource, BoundedRadius)):
                    check(torch.equal(got.dist, ref.dist)
                          and torch.equal(got.pred, ref.pred),
                          f"{tag}: differs from the serial solve")
                elif isinstance(q, ManyToMany):
                    check(torch.equal(got.matrix, ref.matrix),
                          f"{tag}: differs from the serial solve")
                else:
                    check(got.distance == ref.distance,
                          f"{tag}: distance differs from the serial solve")
                    if got.path is not None:
                        check_path(got.path, q.source, q.target, got.distance,
                                   gkeyed if name == "map" else keyed,
                                   graph.n_nodes)
                if isinstance(q, SingleSource):
                    tel, rtel = got.telemetry, ref.telemetry
                    check((tel.buckets, tel.inner_iters, tel.overflow) ==
                          (rtel.buckets, rtel.inner_iters, rtel.overflow),
                          f"{tag}: counters differ from the serial solve")
            torch.cuda.synchronize()
        if watch is not None:
            records["smallworld_serve" if name == "fused"
                    else "gamemap_serve"] = watch.best
        log(f"[serve] {name}: {len(mine)} tickets == serial solves on a "
            f"fresh plan ({plan.config.strategy}, Δ={plan.config.delta}) "
            f"in {time.perf_counter() - t0:.1f} s")

    # -- 12c. one answer per tenant against scipy --------------------------
    for (name, q), t in zip(stream[-3:], tickets[-3:]):
        want = gref if name == "map" else ref_dist
        check(np.array_equal(t.result(0).dist.cpu().numpy().astype(np.int64),
                             want), f"{name}: SingleSource differs from scipy")
    log("[serve] SingleSource(0) on tuned and fused, and the map's from "
        f"cell {gsrc}: == scipy")
    log("[serve] stats: " + json.dumps(stats))
    log(f"[serve] p50 {stats['latency_p50_ms']:.1f} ms, p99 "
        f"{stats['latency_p99_ms']:.1f} ms, mean occupancy "
        f"{stats['mean_occupancy']:.3f}, batches {stats['batches']}, shed "
        f"{stats['shed']}, evictions {stats['evictions']}, plans built "
        f"{stats['plans_built']}")
    log(f"[serve] phase 12 took {time.perf_counter() - t_phase:.1f} s")
    return by_path, records


# -- phase 13: the multi-GPU path ------------------------------------------

def sharded_rank(rank: int, world: int, work: str) -> int:
    """One rank of phase 13's gloo group on the script's card (run as
    ``chip_smoke.py --sharded-rank RANK WORLD DIR``): loads the graph
    the parent wrote, solves ``SingleSource(0)`` on ``sharded_edge`` and
    ``sharded_fused`` over the 2 ranks, then runs the distributed engine
    on the ``(1, 2)`` and ``(2, 1)`` meshes under both combines and
    ``local_steps`` 1 and 2, and saves what it got (answers, counters,
    launches, the ``base`` of every ``frontier_relax`` call, wall
    times) to ``DIR/rank<RANK>.npz``."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.core.backends as backends
    from repro_torch.api import Engine, SingleSource
    from repro_torch.core import DeltaConfig
    from repro_torch.core.distributed import (DistDeltaConfig,
                                              build_distributed_solver)
    from repro_torch.graphs import coo_from_numpy, partition_edges
    from repro_torch.kernels.frontier_relax import frontier_relax_cuda
    from repro_torch.launch.mesh import make_host_mesh

    work = Path(work)
    cuda = torch.device("cuda", 0)
    torch.cuda.set_device(cuda)
    dist.init_process_group("gloo", init_method=f"file://{work / 'store'}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    data = np.load(work / "graph.npz")
    g = coo_from_numpy(data["src"], data["dst"], data["w"], int(data["n"]),
                       device=cuda)
    out = {}
    bases = []
    real_fr = backends.frontier_relax

    def seen_fr(*args, **kw):
        bases.append(kw["base"])
        return real_fr(*args, **kw)

    backends.frontier_relax = seen_fr
    for st in ("sharded_edge", "sharded_fused"):
        t0 = time.perf_counter()
        plan = Engine(g, DeltaConfig(delta=DELTA, strategy=st,
                                     pred_mode="argmin"), device=cuda).plan()
        build = time.perf_counter() - t0
        frontier_relax_cuda.launches = 0
        bases.clear()
        t0 = time.perf_counter()
        r = plan.solve(SingleSource(0))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t = r.telemetry
        out[f"{st}/dist"] = r.dist.cpu().numpy()
        out[f"{st}/pred"] = r.pred.cpu().numpy()
        out[f"{st}/stats"] = np.array(
            [t.buckets, t.inner_iters, int(t.overflow),
             frontier_relax_cuda.launches, plan.host_syncs])
        out[f"{st}/bases"] = np.array(sorted(set(bases)), np.int64)
        out[f"{st}/ms"] = np.array([build * 1e3, wall * 1e3])
    backends.frontier_relax = real_fr
    for shape in ((1, 2), (2, 1)):
        mesh = make_host_mesh(*shape)      # gloo: a "cpu" mesh
        part = partition_edges(g, shape[1], device="cpu")
        for combine in ("allreduce", "reduce_scatter"):
            for ls in (1, 2):
                solve = build_distributed_solver(
                    part, mesh, DistDeltaConfig(delta=DELTA, combine=combine,
                                                local_steps=ls), device=cuda)
                t0 = time.perf_counter()
                d, outer, inner = solve(list(SHARD_SOURCES))
                torch.cuda.synchronize()
                key = f"dist/{shape[0]}x{shape[1]}/{combine}/{ls}"
                out[f"{key}/dist"] = d.cpu().numpy()
                out[f"{key}/stats"] = np.array(
                    [outer, inner, (time.perf_counter() - t0) * 1e3])
    dist.destroy_process_group()
    np.savez(work / f"rank{rank}.npz", **out)
    return 0


def sharded_path(torch, np, cuda, g, results, ref_dist, fr_records,
                 counters):
    """Phase 13: the multi-GPU path (see the module note), (a) in the
    one-rank NCCL group the caller started. Returns the launches of the
    one-rank NCCL solves (``sharded_nccl1``) and of the two gloo ranks
    (``sharded``), and the ``sharded`` path's recorded
    ``frontier_relax`` input: shard 1's slice at the largest of the
    recorded mid-solve states."""
    import os
    import tempfile

    from repro_torch.api import Engine, SingleSource
    from repro_torch.core import DeltaConfig
    from repro_torch.graphs import partition_ell
    from repro_torch.kernels.frontier_relax import (frontier_relax_cuda,
                                                    frontier_relax_ref)

    t_phase = time.perf_counter()
    n = g.n_nodes
    work = tempfile.TemporaryDirectory()
    wdir = Path(work.name)

    def zero():
        for fn in counters.values():
            fn.launches = 0

    def read():
        return {k: fn.launches for k, fn in counters.items()}

    def same_as(res, key, what):
        """``res`` bitwise phase 3's solve of ``key``: dist, pred,
        buckets, inner_iters, overflow."""
        base = results[key][0]
        check(torch.equal(res.dist, base.dist)
              and torch.equal(res.pred, base.pred)
              and (res.telemetry.buckets, res.telemetry.inner_iters,
                   res.telemetry.overflow)
              == (base.telemetry.buckets, base.telemetry.inner_iters,
                  base.telemetry.overflow),
              f"{what}: differs from phase 3's {key[0]}/{key[1]} solve")

    # (b) is started first: two gloo ranks on this card, in processes of
    # their own, on the graph written here
    np.savez(wdir / "graph.npz", src=g.src.cpu().numpy(),
             dst=g.dst.cpu().numpy(), w=g.w.cpu().numpy(), n=n)
    ranks = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--sharded-rank",
         str(r), str(SHARD_RANKS), str(wdir)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(SHARD_RANKS)]

    # (a) the one-rank NCCL group the caller started in this process
    launches_1 = dict.fromkeys(counters, 0)
    for st, pm, ref_key in (("sharded_edge", "argmin", ("edge", "argmin")),
                            ("sharded_ell", "argmin", ("ell", "argmin")),
                            ("sharded_fused", "argmin", ("fused", "argmin")),
                            ("sharded_fused", "packed", ("fused", "packed"))):
        t0 = time.perf_counter()
        plan = Engine(g, DeltaConfig(delta=DELTA, strategy=st,
                                     pred_mode=pm), device=cuda).plan()
        build = time.perf_counter() - t0
        zero()
        res, first = walls_ms(torch, lambda: plan.solve(SingleSource(0)), 1)
        got = read()
        same_as(res, ref_key, f"{st}/{pm} on a one-rank NCCL group")
        t = res.telemetry
        want = dict.fromkeys(counters, 0)
        if st == "sharded_fused":
            want["frontier_relax"] = t.buckets + t.inner_iters
        check(got == want, f"{st}/{pm}: launches {got}, not {want}")
        for k, v in got.items():
            launches_1[k] += v
        _, walls = walls_ms(torch, lambda: plan.solve(SingleSource(0)), 3)
        base_ms = results[ref_key][2] * 1e3
        log(f"[sharded] nccl x1 {st}/{pm}: == phase 3's "
            f"{ref_key[0]}/{ref_key[1]} (dist, pred, buckets="
            f"{t.buckets}, inner_iters={t.inner_iters}, overflow); "
            f"launches {json.dumps(got)}; plan {build:.1f} s, first "
            f"solve {first[0]:.1f} ms (phase 3's {base_ms:.1f}); "
            f"{fmt(walls)}; host_syncs={plan.host_syncs}")
        del plan
    check(launches_1["frontier_relax"] > 0,
          "sharded_fused did not launch frontier_relax")

    # (b) while the ranks run: scipy for the engine's second source
    t0 = time.perf_counter()
    refs = np.stack([ref_dist, oracle_dist(g, SHARD_SOURCES[1])[0]])
    log(f"[sharded] scipy for source {SHARD_SOURCES[1]} in "
        f"{time.perf_counter() - t0:.1f} s")
    for r, p in enumerate(ranks):
        try:
            text, _ = p.communicate(timeout=SHARD_LIMIT_S)
        except subprocess.TimeoutExpired:
            for q in ranks:
                q.kill()
            raise RuntimeError(f"check failed: gloo rank {r} ran past "
                               f"{SHARD_LIMIT_S} s")
        check(p.returncode == 0, f"gloo rank {r} failed:\n{text[-3000:]}")
    got = [dict(np.load(wdir / f"rank{r}.npz")) for r in range(SHARD_RANKS)]
    launches_2 = dict.fromkeys(counters, 0)
    for r, out in enumerate(got):
        for st, ref_key in (("sharded_edge", ("edge", "argmin")),
                            ("sharded_fused", ("fused", "argmin"))):
            base = results[ref_key][0]
            bt = base.telemetry
            buckets, inner, over, fr, syncs = out[f"{st}/stats"].tolist()
            check(np.array_equal(out[f"{st}/dist"], base.dist.cpu().numpy())
                  and np.array_equal(out[f"{st}/pred"],
                                     base.pred.cpu().numpy())
                  and (buckets, inner, bool(over))
                  == (bt.buckets, bt.inner_iters, bt.overflow),
                  f"gloo rank {r} {st}: differs from phase 3's "
                  f"{ref_key[0]}/{ref_key[1]} solve")
            bases = out[f"{st}/bases"].tolist()
            if st == "sharded_fused":
                check(fr == buckets + inner and bases == [r * (n // 2)],
                      f"gloo rank {r}: frontier_relax launches {fr} at "
                      f"bases {bases}, not {buckets + inner} at "
                      f"{r * (n // 2)}")
                launches_2["frontier_relax"] += fr
            else:
                check(fr == 0 and not bases, f"gloo rank {r}: {st} "
                      "launched frontier_relax")
            build_ms, wall_ms = out[f"{st}/ms"].tolist()
            log(f"[sharded] gloo x{SHARD_RANKS} rank {r} {st}: == phase 3's "
                f"{ref_key[0]}/{ref_key[1]}; frontier_relax launches {fr} "
                f"at base {bases}; plan {build_ms / 1e3:.1f} s, first solve "
                f"{wall_ms:.1f} ms; host_syncs={syncs}")
        for key in sorted(k[:-5] for k in out if k.startswith("dist/")
                          and k.endswith("/dist")):
            check(np.array_equal(out[f"{key}/dist"].astype(np.int64), refs),
                  f"gloo rank {r} {key}: dist differs from scipy's")
            outer, inner, ms = out[f"{key}/stats"].tolist()
            log(f"[sharded] gloo x{SHARD_RANKS} rank {r} engine {key}: "
                f"dist == scipy for sources {list(SHARD_SOURCES)}; "
                f"outer={int(outer)} inner={int(inner)}, {ms:.1f} ms")
    work.cleanup()

    # (c) frontier_relax against its twin on shard 1's slice
    s = -(-n // SHARD_RANKS)
    part = partition_ell(g, SHARD_RANKS, DELTA, device="cpu")
    nbr1 = part.light_nbr[1].to(cuda)
    w1 = part.light_w[1].to(cuda)
    kw = dict(delta=DELTA, cap=s, base=s, sent=n)
    big = max(range(len(fr_records)), key=lambda k: fr_records[k][2])
    chosen = sorted({0, len(fr_records) // 2, big})
    shard = {}
    for k in chosen:
        (d, e, i, _, _), _, _ = fr_records[k]
        args = (d[s:2 * s], e[s:2 * s], i, nbr1, w1)
        out = frontier_relax_cuda(*args, **kw)
        same(torch, out, frontier_relax_ref(*args, **kw))
        torch.cuda.synchronize()
        shard[k] = (args, kw, int(out[3]))
    log(f"[sharded] frontier_relax on shard 1's slice (S={s}, base={s}, "
        f"sent={n}) equal to its twin at {len(chosen)} mid-solve states; "
        f"populations {[shard[k][2] for k in chosen]}")

    # (d) the example twins on the card
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    twins = [(script, subprocess.Popen(
        [sys.executable, *flags, str(ROOT / "examples" / script)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for script, flags in (("torch_quickstart.py",
                               ["-W", "error::DeprecationWarning"]),
                              ("torch_multi_source_sssp.py", []),
                              ("torch_sssp_gamemap.py", []))]
    for script, p in twins:
        text, _ = p.communicate(timeout=SHARD_LIMIT_S)
        check(p.returncode == 0, f"{script} failed on the card:\n"
              f"{text[-3000:]}")
        log(f"[sharded] {script} on the card: "
            + " | ".join(text.strip().splitlines()[:3]))
    log(f"[sharded] launches: nccl x1 {json.dumps(launches_1)}, gloo x"
        f"{SHARD_RANKS} {json.dumps(launches_2)}")
    log(f"[sharded] phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return launches_1, launches_2, shard[big]

# -- phase 14: sharded serving ----------------------------------------------

def serve_rank(rank: int, world: int, work: str) -> int:
    """One rank of phase 14's gloo group on the script's card (run as
    ``chip_smoke.py --serve-rank RANK WORLD DIR``): the ``sharded_edge``
    tenant of phase 14 over the 2 ranks. Rank 0 submits the first half
    of the tenant's requests, starts the background loop, waits for
    their answers, idles ``SSERVE_PAUSE_S`` (the control channel's
    timeout is ``SSERVE_TIMEOUT_S`` here), submits the rest and closes;
    rank 1 runs rank 0's batch plan in ``close()``. Saves the answers
    (rank 0), ``stats()`` and wall times to ``DIR/serve<RANK>.npz``."""
    import datetime
    import pickle

    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.serve.server as server_mod
    from repro_torch.core import DeltaConfig
    from repro_torch.graphs import coo_from_numpy

    work = Path(work)
    cuda = torch.device("cuda", 0)
    torch.cuda.set_device(cuda)
    dist.init_process_group("gloo", init_method=f"file://{work / 'store'}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    server_mod._CONTROL_TIMEOUT = datetime.timedelta(
        seconds=SSERVE_TIMEOUT_S)
    data = np.load(work / "graph.npz")
    g = coo_from_numpy(data["src"], data["dst"], data["w"], int(data["n"]),
                       device=cuda)
    with open(work / "stream.pkl", "rb") as f:   # the parent's queries
        stream = pickle.load(f)
    t0 = time.perf_counter()
    srv = server_mod.Server(lane_width=SSERVE_LANES, device=cuda)
    srv.admit("edge", g, config=DeltaConfig(delta=DELTA,
                                            strategy="sharded_edge"))
    tickets = []
    if rank == 0:
        half = len(stream) // 2
        tickets = [srv.submit(q, graph="edge") for q in stream[:half]]
        srv.start()
        for t in tickets:
            t.result(timeout=SHARD_LIMIT_S)
        time.sleep(SSERVE_PAUSE_S)      # rank 1 waits on the channel
        tickets += [srv.submit(q, graph="edge") for q in stream[half:]]
        for t in tickets:
            t.result(timeout=SHARD_LIMIT_S)
    srv.close()
    wall = time.perf_counter() - t0
    stats = srv.stats()
    out = {"stats": np.array([json.dumps(
        {k: stats[k] for k in ("batches", "mean_occupancy", "resident",
                               "plans_built", "evictions", "completed")})]),
        "wall_s": np.array([wall])}
    for k, t in enumerate(tickets):
        for field, v in answer_fields(t.result(0)).items():
            out[f"{k}/{field}"] = v
    dist.destroy_process_group()
    np.savez(work / f"serve{rank}.npz", **out)
    return 0


def answer_fields(res) -> dict:
    """A served answer as host arrays: ``dist``/``pred``, a matrix, a
    distance and path, or an update's edge count."""
    import numpy as np
    out = {"type": np.array([type(res).__name__])}
    for field in ("dist", "pred", "matrix"):
        if hasattr(res, field):
            v = getattr(res, field)
            out[field] = v.cpu().numpy() if hasattr(v, "cpu") else \
                np.asarray(v)
    if hasattr(res, "distance"):
        out["distance"] = np.array([res.distance])
        out["path"] = np.array(res.path if res.path is not None else [],
                               np.int64)
    if hasattr(res, "n_edges"):
        out["n_edges"] = np.array([res.n_edges])
    return out


def sharded_serving_path(torch, np, cuda, g, results, keyed, counters):
    """Phase 14: sharded serving (see the module note), (a) in the
    one-rank NCCL group the caller started. Returns the launches of the
    served ``sharded_fused`` tenant (``sharded_serve``)."""
    import os
    import pickle
    import tempfile

    from repro_torch.api import (BoundedRadius, Engine, ManyToMany,
                                 PointToPoint, SingleSource, UpdateBatch)
    from repro_torch.core import DeltaConfig
    from repro_torch.serve import Server

    t_phase = time.perf_counter()
    work = tempfile.TemporaryDirectory()
    wdir = Path(work.name)
    # the sharded_edge tenant's requests: SingleSource(0), then a seeded
    # slice of phase 12's mix; the sharded_fused tenant's: two lanes from
    # source 0, both checked against phase 3's answer
    edge_qs = [SingleSource(0)] + [q for _, q in serve_traffic(
        np, {"edge": g}, SSERVE_REQUESTS, seed=SSERVE_SEED)]
    fused_qs = [SingleSource(0), PointToPoint(0, SSERVE_TARGET)]
    log("[sserve] requests: edge " + ", ".join(
        type(q).__name__ for q in edge_qs) + "; fused " + ", ".join(
        type(q).__name__ for q in fused_qs))

    # (b) and (c) are started first: two gloo ranks on this card, and the
    # launcher under torchrun, in processes of their own
    np.savez(wdir / "graph.npz", src=g.src.cpu().numpy(),
             dst=g.dst.cpu().numpy(), w=g.w.cpu().numpy(), n=g.n_nodes)
    with open(wdir / "stream.pkl", "wb") as f:
        pickle.dump(edge_qs, f)
    ranks = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--serve-rank",
         str(r), str(SHARD_RANKS), str(wdir)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(SHARD_RANKS)]
    launcher = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "1", "-m", "repro_torch.launch.serve", "--sssp",
         "--nodes", str(N_NODES), "--degree", str(DEGREE), "--strategy",
         "sharded_fused", "--shards", "1", "--requests", "2", "--batch", "2"],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    # (a) both tenants through the background loop: every request is
    # queued before the loop starts, so the batches are the same on
    # every run (the fused tenant's two lanes are one batch)
    srv = Server(lane_width=SSERVE_LANES, device=cuda)
    builds = {}
    for name, st in (("edge", "sharded_edge"), ("fused", "sharded_fused")):
        srv.admit(name, g, config=DeltaConfig(delta=DELTA, strategy=st))
        t0 = time.perf_counter()
        srv.plan(name)                  # built before serving
        builds[name] = time.perf_counter() - t0
    tickets = {"fused": [srv.submit(q, graph="fused") for q in fused_qs],
               "edge": [srv.submit(q, graph="edge") for q in edge_qs]}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with srv:
        pass
    serve_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    stats = srv.stats()
    # each batch's time (t_done - t_batch: the solve and the answers'
    # split), from its first ticket
    batches = {}
    for name, ts in tickets.items():
        for t in ts:
            tr = t.trace
            key = (name, tr.t_batch)
            if key not in batches:
                lanes = (SSERVE_LANES if tr.kind in (
                    "SingleSource", "PointToPoint", "BoundedRadius") else 1)
                batches[key] = (tr.kind, lanes,
                                (tr.t_done - tr.t_batch) * 1e3)
    for name, ts in tickets.items():
        for q, t in zip(edge_qs if name == "edge" else fused_qs, ts):
            exc = t.exception(0)
            check(exc is None, f"{name} {type(q).__name__}: ended in "
                  f"{type(exc).__name__}: {exc}")
    fused = [t.result(0) for t in tickets["fused"]]
    per_lane = sum(r.telemetry.buckets + r.telemetry.inner_iters
                   for r in fused)
    want = dict.fromkeys(counters, 0)
    want["frontier_relax"] = per_lane
    check(launches == want, f"served launches {launches}, not {want} (the "
          "fused tenant's lanes alone launch, frontier_relax)")
    log(f"[sserve] nccl x1: plans built in "
        f"{', '.join(f'{k} {v:.1f} s' for k, v in builds.items())}; "
        f"{len(edge_qs) + len(fused_qs)} requests served in {serve_s:.1f} "
        f"s; launches {json.dumps(launches)}; stats " + json.dumps(stats))
    log("[sserve] nccl x1 batches (tenant, first kind, lanes: ms, ms a "
        "lane): " + "; ".join(
            f"{name} {kind} x{lanes}: {ms:.1f}, {ms / lanes:.1f}"
            for (name, _), (kind, lanes, ms) in batches.items()))

    # the fused tenant against phase 3's fused solve of source 0
    base = results[("fused", "argmin")][0]
    ss, p2p = fused
    check(torch.equal(ss.dist, base.dist) and torch.equal(ss.pred, base.pred)
          and (ss.telemetry.buckets, ss.telemetry.inner_iters,
               ss.telemetry.overflow) == (base.telemetry.buckets,
                                          base.telemetry.inner_iters,
                                          base.telemetry.overflow),
          "served sharded_fused SingleSource(0) differs from phase 3's")
    check(p2p.distance == int(base.dist[SSERVE_TARGET]),
          "served sharded_fused PointToPoint: distance differs")
    check_path(p2p.path, 0, SSERVE_TARGET, p2p.distance, keyed, g.n_nodes)
    log(f"[sserve] fused tenant: SingleSource(0) == phase 3's fused solve "
        f"(dist, pred, buckets, inner_iters, overflow); PointToPoint(0, "
        f"{SSERVE_TARGET}) distance {p2p.distance} == phase 3's, path valid")

    # the edge tenant against serial solves on a fresh plan, the updates
    # applied in the same order; SingleSource(0) against phase 3's edge
    base = results[("edge", "argmin")][0]
    got0 = tickets["edge"][0].result(0)
    check(torch.equal(got0.dist, base.dist)
          and torch.equal(got0.pred, base.pred),
          "served sharded_edge SingleSource(0) differs from phase 3's")
    t0 = time.perf_counter()
    plan = Engine(g, DeltaConfig(delta=DELTA, strategy="sharded_edge"),
                  device=cuda).plan(fallback=True)
    updated = False
    for q, t in zip(edge_qs, tickets["edge"]):
        got = t.result(0)
        if isinstance(q, UpdateBatch):
            plan.update(q.edge_ids, q.new_weights)
            updated = True
            continue
        ref = plan.solve(q)
        tag = f"edge {type(q).__name__}"
        if isinstance(q, (SingleSource, BoundedRadius)):
            check(torch.equal(got.dist, ref.dist)
                  and torch.equal(got.pred, ref.pred),
                  f"{tag}: differs from the serial solve")
        elif isinstance(q, ManyToMany):
            check(torch.equal(got.matrix, ref.matrix),
                  f"{tag}: differs from the serial solve")
        else:
            check(got.distance == ref.distance,
                  f"{tag}: distance differs from the serial solve")
            if got.path is not None and not updated:
                check_path(got.path, q.source, q.target, got.distance, keyed,
                           g.n_nodes)
            elif got.path is not None:
                check(got.path[0] == q.source and got.path[-1] == q.target,
                      f"{tag}: path endpoints")
    torch.cuda.synchronize()
    log(f"[sserve] edge tenant: {len(edge_qs)} tickets == serial solves on "
        f"a fresh sharded_edge plan in {time.perf_counter() - t0:.1f} s; "
        "SingleSource(0) == phase 3's edge solve")

    # (b) the gloo ranks: rank 0's answers are (a)'s, the counts agree
    for r, p in enumerate(ranks):
        try:
            text, _ = p.communicate(timeout=SHARD_LIMIT_S)
        except subprocess.TimeoutExpired:
            for q in ranks + [launcher]:
                q.kill()
            raise RuntimeError(f"check failed: serving gloo rank {r} ran "
                               f"past {SHARD_LIMIT_S} s")
        check(p.returncode == 0,
              f"serving gloo rank {r} failed:\n{text[-3000:]}")
    got = [dict(np.load(wdir / f"serve{r}.npz")) for r in range(SHARD_RANKS)]
    counts = [json.loads(str(o["stats"][0])) for o in got]
    check(counts[0] == dict(counts[1], completed=counts[0]["completed"])
          and counts[0]["completed"] == len(edge_qs)
          and counts[1]["completed"] == 0,
          f"gloo ranks' stats() counts differ: {counts}")
    for k, (q, t) in enumerate(zip(edge_qs, tickets["edge"])):
        mine = answer_fields(t.result(0))
        for field, v in mine.items():
            check(np.array_equal(got[0][f"{k}/{field}"], v),
                  f"gloo rank 0 request {k} ({type(q).__name__}): {field} "
                  "differs from the one-rank server's")
    log(f"[sserve] gloo x{SHARD_RANKS}: rank 0's {len(edge_qs)} answers == "
        f"the one-rank server's; both ranks' counts {json.dumps(counts[1])}"
        f" (rank 0 completed {counts[0]['completed']}); an idle pause of "
        f"{SSERVE_PAUSE_S} s against a {SSERVE_TIMEOUT_S} s channel "
        f"timeout; rank 1 exited 0; walls "
        f"{[round(float(o['wall_s'][0]), 1) for o in got]} s")
    work.cleanup()

    # (c) the launcher under torchrun, one NCCL rank
    try:
        text, _ = launcher.communicate(timeout=SHARD_LIMIT_S)
    except subprocess.TimeoutExpired:
        launcher.kill()
        raise RuntimeError("check failed: the serving launcher ran past "
                           f"{SHARD_LIMIT_S} s")
    lines = [ln for ln in text.splitlines() if ln.startswith("[serve]")]
    check(launcher.returncode == 0
          and "[serve] mesh-sharded relaxation over 1 rank(s)" in lines
          and any(ln.startswith("[serve] answered 2 SSSP queries")
                  for ln in lines),
          f"the serving launcher under torchrun failed:\n{text[-3000:]}")
    log("[sserve] launcher (torchrun, 1 NCCL rank, sharded_fused, "
        f"|V|={N_NODES}): " + " | ".join(lines))
    log(f"[sserve] phase 14 took {time.perf_counter() - t_phase:.1f} s")
    return launches


# -- phase 15: LM decode serving -------------------------------------------

def route_log(moe_lib, routes: list):
    """``moe_lib.moe_apply`` and a wrapper of it that appends, per call,
    each token's expert picks and whether each pick fit in its expert's
    capacity (``(ids, kept)``, both (T, k), on the host) to ``routes``."""
    real = moe_lib.moe_apply

    def wrapped(p, cfg, x):
        k = cfg.moe.top_k
        _, _, ids, _, _, _, cap, slot = moe_lib.route(
            p, cfg, x.reshape(-1, x.shape[-1]))
        routes.append((ids.view(-1, k).cpu(), (slot < cap).view(-1, k).cpu()))
        return real(p, cfg, x)
    return real, wrapped


def logit_err(out, ref) -> tuple:
    """(max |out - ref|, ||out - ref|| / ||ref||) of two logit rows, in
    float32."""
    d = out.float() - ref.float()
    return float(d.abs().max()), float(d.norm() / ref.float().norm())


def within_bf16(err) -> bool:
    return err[0] <= LM_BF16_MAX_ABS and err[1] <= LM_BF16_REL


def lm_consistency(torch, tf, cfg, model, toks, n_prompt, cuda,
                   routes=None, profile=False):
    """Prefill ``toks[:, :n_prompt]``, then one teacher-forced decode step
    per further token; the prefill's last logits and each step's against
    ``apply_lm``'s over the whole sequence at the same position. Returns
    a dict: the prefill's ms, each step's ms, the whole forward's ms,
    ``(max_abs, rel_l2)`` per position, and where ``routes`` (filled by
    ``route_log``'s wrapper) is given, per position whether its expert
    picks and drops are the same in both runs in every layer
    (``same``), how many prompt tokens' are not and the share of the
    decode tokens' picks that the whole forward dropped; with
    ``profile``, ``torch.profiler``'s view of one more decode step."""
    sync = torch.cuda.synchronize
    n_layers, total = cfg.n_layers, toks.shape[1]
    out = {}
    cache = tf.init_cache(cfg, 1, total + 1, device=cuda)
    if routes is not None:
        routes.clear()
    sync()
    t0 = time.perf_counter()
    logits, cache = tf.prefill(model, cfg, toks[:, :n_prompt], cache)
    sync()
    out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    rows, out["steps_ms"] = [logits[0, -1]], []
    for j in range(n_prompt, total):
        t0 = time.perf_counter()
        logits, cache = tf.decode_step(model, cfg, cache, toks[:, j:j + 1])
        sync()
        out["steps_ms"].append((time.perf_counter() - t0) * 1e3)
        rows.append(logits[0, -1])
    path = list(routes or ())
    if profile:         # the next position, written to the spare slot
        kern, wall, _, counts = profiled(torch, lambda: tf.decode_step(
            model, cfg, cache, toks[:, -1:]))
        busy = sum(kern.values())
        out["profile"] = (wall, busy, sum(counts.values()), sorted(
            kern.items(), key=lambda kv: -kv[1])[:5])
    del cache
    if routes is not None:
        routes.clear()
    t0 = time.perf_counter()
    full, _ = tf.apply_lm(model, cfg, toks)
    sync()
    out["full_ms"] = (time.perf_counter() - t0) * 1e3
    out["errs"] = [logit_err(r, full[0, n_prompt - 1 + i])
                   for i, r in enumerate(rows)]
    del full
    if routes is not None:
        whole = list(routes)
        check(len(whole) == n_layers
              and len(path) == n_layers * (1 + total - n_prompt),
              "MoE calls: one a layer a forward")

        def picks(entries, row):
            return [(ids[row], kept[row]) for ids, kept in entries]

        def equal(a, b):
            return all(torch.equal(x, y) and torch.equal(u, v)
                       for (x, u), (y, v) in zip(a, b))

        out["same"] = [
            equal(picks(whole, n_prompt - 1 + i),
                  picks(path[:n_layers], n_prompt - 1) if i == 0 else
                  picks(path[n_layers * i:n_layers * (i + 1)], 0))
            for i in range(len(rows))]
        out["prompt_diff"] = sum(
            not equal(picks(whole, r), picks(path[:n_layers], r))
            for r in range(n_prompt))
        out["decode_dropped"] = float(torch.stack(
            [~kept[n_prompt:] for _, kept in whole]).float().mean())
    return out


def moe_slots_check(torch, tf, cfg, model, toks, n_prompt, cuda, routes,
                    gen):
    """One decode step of ``LM_SLOTS`` slots that hold the same prompt's
    cache, each with its own next token: a step's capacity is
    ``max(1, int(slots * k / E * capacity_factor))`` = 1 an expert, so a
    pick that two slots share is dropped for the later slot. Each slot's
    logits against a one-slot step of its token (where nothing drops):
    within the bf16 tolerance where none of the slot's picks dropped in
    any layer. Returns the dropped picks and each slot's error."""
    one = tf.init_cache(cfg, 1, n_prompt + 1, device=cuda)
    _, one = tf.prefill(model, cfg, toks[:, :n_prompt], one)
    nxt = torch.randint(0, cfg.vocab, (LM_SLOTS, 1), generator=gen,
                        device=cuda)
    slots = {"k": one["k"].repeat(1, LM_SLOTS, 1, 1, 1),
             "v": one["v"].repeat(1, LM_SLOTS, 1, 1, 1), "len": n_prompt}
    routes.clear()
    out, _ = tf.decode_step(model, cfg, slots, nxt)
    kept = torch.stack([k for _, k in routes])          # (L, slots, k)
    dropped = int((~kept).sum())
    errs = []
    for r in range(LM_SLOTS):
        alone = {"k": one["k"].clone(), "v": one["v"].clone(),
                 "len": n_prompt}
        ref, _ = tf.decode_step(model, cfg, alone, nxt[r:r + 1])
        errs.append(logit_err(out[r, -1], ref[0, -1]))
    clean = kept.all(-1).all(0).tolist()
    check(dropped > 0, f"{cfg.name}: no pick dropped in a {LM_SLOTS}-slot "
          "decode step")
    for r, (ok, err) in enumerate(zip(clean, errs)):
        check(not ok or within_bf16(err),
              f"{cfg.name}: slot {r} kept every pick but its logits differ "
              f"from a one-slot step by {err}")
    return dropped, clean, errs


def held_to(cfg, res) -> None:
    """Every position of an ``lm_consistency`` result within the bf16
    tolerance; for an MoE, every position routed alike in both runs, and
    at least one."""
    same = res.get("same") or [True] * len(res["errs"])
    check(any(same), f"{cfg.name}: no position routed alike in both runs")
    for i, (ok, err) in enumerate(zip(same, res["errs"])):
        check(not ok or within_bf16(err),
              f"{cfg.name}: the {i}-th compared position's logits {err} "
              "against the whole-sequence forward, past "
              f"({LM_BF16_MAX_ABS}, {LM_BF16_REL})")


def lm_serving_path(torch, np, cuda, counters, smi) -> None:
    """Phase 15: the LM decode serving path on the card (module note)."""
    import copy
    import dataclasses
    import gc
    import os

    from repro_torch import configs
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as tf
    from repro_torch.serve import BatchServer, Request, generate

    t_phase = time.perf_counter()
    for fn in counters.values():
        fn.launches = 0
    sync = torch.cuda.synchronize
    gen = torch.Generator(device=cuda)
    # memory is reported above what the earlier phases still hold
    base = torch.cuda.memory_allocated()

    def nbytes(m):
        return sum(p.numel() * p.element_size() for p in m.parameters())

    def fmt_errs(errs):
        return ", ".join(f"{a:.4f}/{r:.5f}" for a, r in errs)

    def ms_line(ms):
        return (f"median {statistics.median(ms):.2f} ms "
                f"({min(ms):.2f}-{max(ms):.2f})")

    # -- (a) gemma2-9b at full width and depth ------------------------------
    t_part = time.perf_counter()
    cfg = configs.get_config(LM_FULL)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = tf.init_lm(cfg, gen.manual_seed(0), device=cuda)
    sync()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    # the config's count leaves out gemma2's two post-block norms a layer
    post_norms = 2 * cfg.d_model * cfg.n_layers
    check(n_params == cfg.n_params() + post_norms,
          f"{cfg.name}: {n_params} parameters, not the config's "
          f"{cfg.n_params()} and {post_norms} of post-block norms")
    wbytes = nbytes(model)
    total = LM_PROMPT + LM_STEPS
    cbytes = 2 * cfg.n_layers * total * cfg.n_kv_heads * cfg.head_dim_ * 2
    log(f"[lm] {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
        f"{n_params} parameters, weights {wbytes / 1e9:.3f} GB (bf16), "
        f"initialised on the card from torch.Generator seed 0 in "
        f"{init_s:.1f} s; memory after init (above the phase's start) "
        f"{(torch.cuda.max_memory_allocated() - base) / 1e9:.3f} GB")
    toks = torch.randint(0, cfg.vocab, (1, total),
                         generator=gen.manual_seed(1), device=cuda)
    # warm-up (first launches, cuBLAS handles): a 512-token prefill and
    # one decode step
    warm = tf.init_cache(cfg, 1, 513, device=cuda)
    _, warm = tf.prefill(model, cfg, toks[:, :512], warm)
    tf.decode_step(model, cfg, warm, toks[:, 512:513])
    del warm
    sync()
    torch.cuda.reset_peak_memory_stats()
    res = lm_consistency(torch, tf, cfg, model, toks, LM_PROMPT, cuda,
                         profile=True)
    pf_ms, st_ms, full_ms, errs = (res["prefill_ms"], res["steps_ms"],
                                   res["full_ms"], res["errs"])
    peak = torch.cuda.max_memory_allocated() - base
    held_to(cfg, res)
    flops = 2 * n_params * LM_PROMPT
    attn_flops = 4 * cfg.n_layers * LM_PROMPT * total * cfg.n_heads \
        * cfg.head_dim_
    log(f"[lm] {cfg.name}: prefill of {LM_PROMPT} tokens "
        f"({LM_PROMPT // cfg.attention_chunk} query chunks of "
        f"{cfg.attention_chunk}; local layers' window {cfg.window}) "
        f"{pf_ms:.1f} ms, bound {flops / BF16_FLOPS_PER_S * 1e3:.1f} ms "
        f"(2 * {n_params} * {LM_PROMPT} FLOP at 989 TFLOP/s bf16; the f32 "
        f"attention's {attn_flops / 1e12:.2f} TFLOP at 67 TFLOP/s: "
        f"{attn_flops / 67e12 * 1e3:.1f} ms more); {LM_STEPS} "
        f"teacher-forced decode steps {ms_line(st_ms)}, "
        f"{1e3 / statistics.median(st_ms):.1f} tokens/s at 1 slot, bound "
        f"{wbytes / HBM_BYTES_PER_S * 1e3:.2f} ms (weights at 3.35 TB/s; "
        f"{(wbytes + cbytes) / HBM_BYTES_PER_S * 1e3:.2f} ms with the "
        f"{cbytes / 1e9:.3f} GB cache of {total}); whole-sequence forward "
        f"{full_ms:.1f} ms; peak memory {peak / 1e9:.3f} GB; {smi}")
    log(f"[lm] {cfg.name}: logits (max abs/rel L2) against apply_lm over "
        f"the {total} tokens at positions {LM_PROMPT - 1}..{total - 1}: "
        f"{fmt_errs(errs)} (tolerance {LM_BF16_MAX_ABS}/{LM_BF16_REL})")
    wall, busy, n_kern, top = res["profile"]
    log(f"[profile] {cfg.name} decode step at position {total} "
        f"(torch.profiler): {wall:.2f} ms, device busy {busy:.2f} ms (idle "
        f"share {1 - busy / wall:.3f}), {n_kern} kernel records; top: "
        + "; ".join(f"{ms:.3f} ms {name[:60]}" for name, ms in top))

    # the serving launcher's run: BatchServer with its defaults
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, LM_PROMPT_LEN, dtype=np.int32)
               for _ in range(LM_REQUESTS)]
    torch.cuda.reset_peak_memory_stats()
    srv = BatchServer(model, cfg, n_slots=LM_SLOTS, max_len=LM_MAX_LEN,
                      eos_id=-1)
    for i, p in enumerate(prompts):
        srv.submit(Request(rid=i, prompt=p, max_new=LM_NEW))
    n_steps = 0
    t0 = time.perf_counter()
    done = []
    while srv.queue or any(s is not None for s in srv.slots):
        done += srv.step()
        n_steps += 1
    sync()
    serve_s = time.perf_counter() - t0
    served = {r.rid: list(r.generated) for r in done}
    check(sorted(served) == list(range(LM_REQUESTS)) and all(
        r.done and len(r.generated) == LM_NEW
        and all(0 <= t < cfg.vocab for t in r.generated) for r in done),
        "BatchServer: a request did not complete with in-range ids")
    log(f"[lm] {cfg.name}: BatchServer({LM_SLOTS} slots, cache "
        f"{LM_MAX_LEN}): {LM_REQUESTS} requests of {LM_PROMPT_LEN} tokens, "
        f"{LM_NEW} new each, {n_steps} steps in {serve_s * 1e3:.1f} ms "
        f"({LM_REQUESTS * LM_NEW / serve_s:.1f} tokens/s at {LM_SLOTS} "
        f"slots, prefills included); peak memory "
        f"{(torch.cuda.max_memory_allocated() - base) / 1e9:.3f} GB; {smi}")
    # the first LM_SLOTS requests are admitted together with equal
    # lengths: each prompt prefilled alone into its slot, then decode
    # steps of every slot at the server's shared length, the prompt plus
    # the tokens picked (one past the cache's contents after a prefill:
    # the reference's BatchServer leaves position LM_PROMPT_LEN empty)
    cache = tf.init_cache(cfg, LM_SLOTS, LM_MAX_LEN, device=cuda)
    firsts = []
    for i in range(LM_SLOTS):
        one = tf.init_cache(cfg, 1, LM_MAX_LEN, device=cuda)
        lg, one = tf.prefill(model, cfg, torch.as_tensor(
            prompts[i][None], device=cuda), one)
        for kk in ("k", "v"):
            cache[kk][:, i:i + 1] = one[kk]
        firsts.append(lg[0, -1])
    del one
    cache["len"] = LM_PROMPT_LEN + 1
    lg, picks, margins, loop_ms = torch.stack(firsts), [], [], []
    for step in range(LM_NEW):
        top = torch.topk(lg.float(), 2, dim=-1).values
        margins.append((top[:, 0] - top[:, 1]).cpu())
        picks.append(torch.argmax(lg, dim=-1))
        if step + 1 < LM_NEW:
            t0 = time.perf_counter()
            out, cache = tf.decode_step(model, cfg, cache, picks[-1][:, None])
            sync()
            loop_ms.append((time.perf_counter() - t0) * 1e3)
            lg = out[:, -1]
    del cache
    picks = torch.stack(picks, 1).cpu().numpy()
    margins = torch.stack(margins, 1).numpy()
    t0 = time.perf_counter()
    alone = generate(model, cfg, np.stack(prompts[:LM_SLOTS]),
                     LM_NEW).cpu().numpy()
    sync()
    gen_ms = (time.perf_counter() - t0) * 1e3
    compared, agree = [], []
    for i in range(LM_SLOTS):
        low = np.nonzero(margins[i] < LM_MARGIN)[0]
        n = int(low[0]) if low.size else LM_NEW
        check(served[i][:n] == picks[i, :n].tolist(),
              f"BatchServer request {i}: {served[i]} differs from its "
              f"slot's steps {picks[i].tolist()} before step {n}")
        check(margins[i, 0] < LM_MARGIN or served[i][0] == alone[i, 0],
              f"BatchServer request {i}: its prefill's pick differs from "
              "generate's")
        compared.append(n)
        agree.append(int(np.argmin(np.append(
            np.asarray(served[i]) == alone[i], False))))
    whole = [served[i] == picks[i].tolist() for i in range(LM_SLOTS)]
    log(f"[lm] {cfg.name}: the first {LM_SLOTS} served requests == their "
        f"slots' steps (one prefill each, then {LM_SLOTS}-slot decode steps "
        f"at the shared length) over {compared} of {LM_NEW} tokens (each up "
        f"to its first top-2 margin under {LM_MARGIN}; margins at step 0 "
        f"{np.round(margins[:, 0], 4).tolist()}; all {LM_NEW} equal: "
        f"{whole}); {LM_SLOTS}-slot decode "
        f"steps {ms_line(loop_ms)}, "
        f"{LM_SLOTS * 1e3 / statistics.median(loop_ms):.1f} tokens/s at "
        f"{LM_SLOTS} slots; generate on the same prompts ({gen_ms:.1f} ms) "
        f"agrees with the served tokens over the first {agree} tokens (the "
        f"server's empty cache slot at position {LM_PROMPT_LEN})")
    del model, srv, lg, out, firsts
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[lm] part (a) took {time.perf_counter() - t_part:.1f} s")

    # the launcher, in a process of its own
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", LM_FULL],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), cwd=ROOT,
        capture_output=True, text=True, timeout=LM_LIMIT_S)
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("[serve]")]
    check(res.returncode == 0 and any(ln.startswith(
        f"[serve] completed {LM_REQUESTS} requests, "
        f"{LM_REQUESTS * LM_NEW} tokens") for ln in lines),
        f"the serving launcher --arch {LM_FULL} failed:\n"
        f"{res.stdout[-2000:]}\n{res.stderr[-3000:]}")
    log(f"[lm] launcher --arch {LM_FULL}: exit 0 in "
        f"{time.perf_counter() - t0:.1f} s: " + " | ".join(lines))

    # -- (b, c) the MoE and the MQA/GELU/untied configs, full width ---------
    for arch in LM_CUT:
        t_part = time.perf_counter()
        cfg = dataclasses.replace(configs.get_config(arch),
                                  n_layers=LM_CUT_LAYERS)
        torch.cuda.reset_peak_memory_stats()
        model = tf.init_lm(cfg, gen.manual_seed(0), device=cuda)
        wbytes = nbytes(model)
        total = LM_CUT_PROMPT + LM_STEPS
        toks = torch.randint(0, cfg.vocab, (1, total),
                             generator=gen.manual_seed(1), device=cuda)
        routes = [] if cfg.moe is not None else None
        if routes is not None:
            real, moe_lib.moe_apply = route_log(moe_lib, routes)
        try:
            n_warm = LM_CUT_PROMPT // 8             # warm-up: a short prompt
            warm = tf.init_cache(cfg, 1, n_warm + 1, device=cuda)
            _, warm = tf.prefill(model, cfg, toks[:, :n_warm], warm)
            tf.decode_step(model, cfg, warm, toks[:, n_warm:n_warm + 1])
            del warm
            res = lm_consistency(torch, tf, cfg, model, toks, LM_CUT_PROMPT,
                                 cuda, routes)
            pf_ms, st_ms, full_ms, errs = (res["prefill_ms"],
                                           res["steps_ms"], res["full_ms"],
                                           res["errs"])
            held_to(cfg, res)
            what = ""
            if routes is not None:
                m = cfg.moe
                cap = max(1, int(total * m.top_k / m.n_experts
                                 * m.capacity_factor))
                dropped, clean, slot_errs = moe_slots_check(
                    torch, tf, cfg, model, toks, LM_CUT_PROMPT, cuda, routes,
                    gen.manual_seed(2))
                # with a capacity factor of E / k no pick is ever dropped,
                # so the whole forward routes every token as a step does
                open_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                    m, capacity_factor=m.n_experts / m.top_k))
                opened = lm_consistency(torch, tf, open_cfg, model, toks,
                                        LM_CUT_PROMPT, cuda, routes)
                held_to(open_cfg, opened)
                check(opened["decode_dropped"] == 0, "capacity E / k dropped")
                what = (f"; routed alike in both runs at {sum(res['same'])} "
                        f"of {len(errs)} positions {res['same']} (the whole "
                        f"forward gives an expert a capacity of {cap} for "
                        f"{total} tokens and dropped "
                        f"{res['decode_dropped']:.3f} of the decode tokens' "
                        f"picks, a decode step drops none; "
                        f"{res['prompt_diff']} prompt tokens routed "
                        f"otherwise in the prefill); a {LM_SLOTS}-slot "
                        f"decode step dropped {dropped} picks, slots with "
                        f"every pick kept {clean}, logits against one-slot "
                        f"steps {fmt_errs(slot_errs)}; at capacity factor "
                        f"E/k = {m.n_experts / m.top_k:.3f} (nothing "
                        f"dropped) routed alike at {sum(opened['same'])} of "
                        f"{len(errs)}, logits {fmt_errs(opened['errs'])}")
        finally:
            if routes is not None:
                moe_lib.moe_apply = real
        log(f"[lm] {cfg.name} ({cfg.n_layers} of "
            f"{configs.get_config(arch).n_layers} layers, full width: "
            f"d={cfg.d_model}, kv heads {cfg.n_kv_heads}, mlp {cfg.mlp}, "
            f"vocab {cfg.vocab}"
            + (f", {cfg.moe.n_experts} experts top-{cfg.moe.top_k} "
               f"d_ff {cfg.moe.d_ff_expert}" if cfg.moe else "")
            + f"; weights {wbytes / 1e9:.3f} GB): prefill of "
            f"{LM_CUT_PROMPT} tokens {pf_ms:.1f} ms, {LM_STEPS} decode steps "
            f"{ms_line(st_ms)}, whole-sequence forward {full_ms:.1f} ms; "
            f"logits (max abs/rel L2) {fmt_errs(errs)}{what}; peak memory "
            f"{(torch.cuda.max_memory_allocated() - base) / 1e9:.3f} GB; "
            f"{smi}")
        del model, toks
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[lm] part {cfg.name} took {time.perf_counter() - t_part:.1f} s")

    # -- (d) the smoke configs: the card against the CPU, float32 ----------
    t_part = time.perf_counter()
    worst = {}
    for arch in configs.ARCH_IDS:
        if configs.family_of(arch) != "lm":
            continue
        cfg = configs.get_config(arch, smoke=True)
        on_cpu = tf.init_lm(cfg, torch.Generator().manual_seed(2),
                            device="cpu")
        models = {"cpu": on_cpu, "cuda": copy.deepcopy(on_cpu).to(cuda)}
        toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 19))
        outs = {}
        for where, m in models.items():
            dev = next(m.parameters()).device
            t = torch.as_tensor(toks, device=dev)
            cache = tf.init_cache(cfg, 2, 32, device=dev)
            lg, cache = tf.prefill(m, cfg, t[:, :16], cache)
            seq = [lg[:, -1]]
            for j in range(16, 19):
                lg, cache = tf.decode_step(m, cfg, cache, t[:, j:j + 1])
                seq.append(lg[:, -1])
            outs[where] = torch.stack(seq).cpu()
        err = (outs["cuda"] - outs["cpu"]).abs()
        check(bool((err <= LM_F32_TOL * (1 + outs["cpu"].abs())).all()),
              f"{cfg.name}: card and CPU logits differ by {float(err.max())}")
        worst[cfg.name] = float(err.max())
    log(f"[lm] smoke configs, prefill of 16 tokens and 3 decode steps, the "
        f"card's float32 logits against the CPU's (atol = rtol = "
        f"{LM_F32_TOL}): max abs {json.dumps(worst)} "
        f"({time.perf_counter() - t_part:.1f} s)")

    launches = {k: fn.launches for k, fn in counters.items()}
    check(not any(launches.values()),
          f"the LM path launched an SSSP kernel: {launches}")
    log(f"[lm] launches over phase 15: {json.dumps(launches)} (the LM path "
        "reaches no Pallas kernel in the reference and none here)")
    log(f"[lm] phase 15 took {time.perf_counter() - t_phase:.1f} s")


# -- phase 16: training ----------------------------------------------------

def train_restart(work: str) -> int:
    """Phase 16(c) in a process of its own (``chip_smoke.py
    --train-restart DIR``), started with ``CUBLAS_WORKSPACE_CONFIG`` set
    so that cuBLAS is deterministic from its first call: under
    ``torch.use_deterministic_algorithms(True)``, a ``Trainer`` run that
    fails at step 13 and restarts from its step-8 checkpoint ends
    bitwise equal to an uninterrupted run (parameters, optimizer state,
    residuals), for the tests' 2-layer LM and for the DLRM smoke config
    with int8 compression."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.configs.base import LMConfig
    from repro_torch.data import SyntheticClicks, SyntheticTokens
    from repro_torch.models import dlrm
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import Trainer, TrainerConfig, run_with_restarts

    torch.use_deterministic_algorithms(True)
    cuda = torch.device("cuda", 0)
    torch.cuda.set_device(cuda)
    lm = LMConfig(name="t", n_layers=2, d_model=32, n_heads=2, n_kv_heads=1,
                  d_ff=64, vocab=64)
    rec = configs.get_config("dlrm-mlperf", smoke=True)
    cases = {
        "lm": (lambda: tf.init_lm(lm, torch.Generator(cuda).manual_seed(0),
                                  cuda),
               lambda p, b: tf.lm_loss(p, lm, b["tokens"], b["labels"],
                                       loss_chunk=16),
               SyntheticTokens(vocab=64, batch=4, seq_len=16, device=cuda),
               "none"),
        "dlrm": (lambda: dlrm.init_dlrm(
                     rec, torch.Generator(cuda).manual_seed(0), cuda),
                 lambda p, b: dlrm.dlrm_loss(p, rec, b["dense"], b["sparse"],
                                             b["labels"]),
                 SyntheticClicks(rec.vocab_sizes, rec.n_dense, batch=64,
                                 device=cuda),
                 "int8")}
    for name, (init, loss_fn, data, comp) in cases.items():
        t0 = time.perf_counter()
        tcfg = dict(total_steps=24, ckpt_interval=8, log_interval=100,
                    compression=comp)
        ref = Trainer(loss_fn, adamw(warmup_cosine(3e-3, 5, 30)), init(),
                      data, TrainerConfig(ckpt_dir=f"{work}/{name}_ref",
                                          **tcfg))
        p_ref = ref.run()
        fails = [13]

        def make():
            return Trainer(loss_fn, adamw(warmup_cosine(3e-3, 5, 30)),
                           init(), data,
                           TrainerConfig(ckpt_dir=f"{work}/{name}", **tcfg),
                           failure_at_step=fails.pop(0) if fails else None)

        p_new, trainer = run_with_restarts(make)
        check(trainer.start_step == 8, f"{name}: resumed at "
              f"{trainer.start_step}, not at the step-8 checkpoint")
        new = dict(p_new.named_parameters())
        for k, p in p_ref.named_parameters():
            check(torch.equal(p, new[k]), f"{name}: {k} differs after the "
                  "restart")
        for key, tree in ref.opt_state.items():
            for k, t in (tree.items() if isinstance(tree, dict)
                         else [(key, tree)]):
                other = trainer.opt_state[key]
                check(torch.equal(t, other[k] if isinstance(tree, dict)
                                  else other),
                      f"{name}: optimizer state {key} {k} differs")
        for k, r in (ref.residuals or {}).items():
            check(torch.equal(r, trainer.residuals[k]),
                  f"{name}: residual {k} differs")
        log(f"[train] restart {name} (compression {comp}): failure at step "
            f"13, resumed from step 8, parameters, optimizer state and "
            f"residuals bitwise equal to the uninterrupted run after 24 "
            f"steps ({sum(p.numel() for p in new.values())} parameters, "
            f"deterministic algorithms on; {time.perf_counter() - t0:.1f} s)")
    return 0


def training_path(torch, np, cuda, counters, smi) -> None:
    """Phase 16: training on the card (module note)."""
    import os
    import tempfile

    t_phase = time.perf_counter()
    for fn in counters.values():
        fn.launches = 0
    sync = torch.cuda.synchronize
    gen = torch.Generator(device=cuda)
    base = torch.cuda.memory_allocated()

    def peak_gb():
        return (torch.cuda.max_memory_allocated() - base) / 1e9

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    # (c) and (d) in processes of their own, started first: their start-up
    # (imports, the CUDA context) overlaps parts (a) and (b)
    work = tempfile.TemporaryDirectory()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    children = {
        "restart": subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--train-restart",
             work.name], env=dict(env, CUBLAS_WORKSPACE_CONFIG=":4096:8"),
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True),
        "launcher": subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             TR_ARCH, "--smoke", "--steps", "20", "--ckpt-dir",
             f"{work.name}/launcher"], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)}
    try:
        train_gemma(torch, np, cuda, gen, smi, timed, peak_gb)
        train_small_models(torch, np, cuda, gen, smi, timed, peak_gb)
        # -- (c, d) ---------------------------------------------------------
        outs = {}
        for name, proc in children.items():
            out, _ = proc.communicate(timeout=max(
                1.0, TR_LIMIT_S - (time.perf_counter() - t_phase)))
            outs[name] = out
            check(proc.returncode == 0, f"the {name} child failed:\n"
                  f"{out[-4000:]}")
    finally:
        for proc in children.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        work.cleanup()
    for line in outs["restart"].splitlines():
        if line.startswith("[train] restart"):
            log(line)
    check(sum(ln.startswith("[train] restart")
              for ln in outs["restart"].splitlines()) == 2,
          f"the restart child printed no result:\n{outs['restart'][-2000:]}")
    lines = [ln for ln in outs["launcher"].splitlines()
             if ln.startswith("[train] loss")]
    check(len(lines) == 1, f"the training launcher printed no loss:\n"
          f"{outs['launcher'][-2000:]}")
    first, last = (float(x) for x in lines[0].split()[2:5:2])
    check(np.isfinite(last) and last < first,
          f"the training launcher's loss did not fall: {lines[0]}")
    log(f"[train] launcher --arch {TR_ARCH} --smoke --steps 20 (its own "
        f"process, beside parts (a) and (b)): {lines[0]}; the children were "
        f"done {time.perf_counter() - t_phase:.1f} s into the phase")

    launches = {k: fn.launches for k, fn in counters.items()}
    check(not any(launches.values()),
          f"the training path launched an SSSP kernel: {launches}")
    log(f"[train] launches over phase 16: {json.dumps(launches)} (the "
        "training path reaches no Pallas kernel in the reference and none "
        "here)")
    log(f"[train] phase 16 took {time.perf_counter() - t_phase:.1f} s")




def train_gemma(torch, np, cuda, gen, smi, timed, peak_gb) -> None:
    """Phase 16(a): gemma2-9b at full width, ``TR_LAYERS`` layers
    (module note)."""
    import dataclasses
    import gc

    from repro_torch import configs
    from repro_torch.distributed import dequantize_int8, quantize_int8
    from repro_torch.models import transformer as tf
    from repro_torch.optim import Optimizer, adamw, sgdm
    from repro_torch.train import init_residuals, make_train_step, steps

    sync = torch.cuda.synchronize
    # -- (a) gemma2-9b at full width, TR_LAYERS layers ----------------------
    t_part = time.perf_counter()
    full = configs.get_config(TR_ARCH)
    cfg = dataclasses.replace(full, n_layers=TR_LAYERS)
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    check(cfg.remat and [cfg.layer_is_local(i) for i in range(TR_LAYERS)]
          == [True, False] * (TR_LAYERS // 2),
          f"{cfg.name}: not remat with two local and two global layers")
    torch.cuda.reset_peak_memory_stats()
    model = tf.init_lm(cfg, gen.manual_seed(0), device=cuda)
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == cfg.n_params() + 2 * cfg.d_model * TR_LAYERS,
          f"{cfg.name}: {n_params} parameters")
    toks = torch.randint(0, cfg.vocab, (1, TR_TOKENS + 1),
                         generator=gen.manual_seed(1), device=cuda)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def lm_loss_fn(c):
        return lambda m, b=batch: tf.lm_loss(m, c, b["tokens"], b["labels"],
                                             loss_chunk=TR_CHUNK)

    def grads(m, c):
        """(loss, {name: gradient}): the train step's autograd pass."""
        loss, _, g = steps._grads(lm_loss_fn(c), m,
                                  dict(m.named_parameters()), batch)
        return float(loss), g

    grads(model, cfg)                                # warm-up
    (l16, g16), fb16_ms = timed(lambda: grads(model, cfg))
    peak16 = peak_gb()
    # the same weights cast up to float32
    model32 = tf.LM(cfg32, None, "meta")
    model32.load_state_dict({k: v.float() for k, v in
                             model.state_dict().items()}, assign=True)
    model32.requires_grad_(False)
    (l32, g32), fb32_ms = timed(lambda: grads(model32, cfg32))
    num = den = 0.0
    leaf_err = {}
    for k, g in g32.items():
        d2 = float((g16[k].float() - g).double().square().sum())
        n2 = float(g.double().square().sum())
        num, den = num + d2, den + n2
        leaf_err[k] = (d2 / n2) ** 0.5 if n2 > 0 else float(d2 > 0)
    rel16 = (num / den) ** 0.5
    worst = sorted(leaf_err.items(), key=lambda kv: -kv[1])[:4]
    del g16
    # a central difference along one random direction: each leaf's part
    # normal, scaled by the leaf's RMS (norm gains start at 0: by 1e-3)
    p32 = dict(model32.named_parameters())
    p16 = dict(model.named_parameters())
    gen.manual_seed(3)
    direction = {}
    for k, p in p32.items():
        rms = float(torch.linalg.vector_norm(p)) / p.numel() ** 0.5
        direction[k] = torch.randn(p.shape, generator=gen, device=cuda) \
            * max(rms, 1e-3)
    gdot = sum(float(torch.dot(g32[k].flatten().double(),
                               direction[k].flatten().double()))
               for k in p32)
    del g32
    loss32 = lm_loss_fn(cfg32)
    sides = []
    t0 = time.perf_counter()
    with torch.no_grad():
        for sign in (1.0, -1.0):
            for k, p in p32.items():
                p.copy_(p16[k]).add_(direction[k], alpha=sign * TR_FD_STEP)
            sides.append(float(loss32(model32)[0]))
        sync()
    fd_ms = (time.perf_counter() - t0) * 1e3
    fd = (sides[0] - sides[1]) / (2 * TR_FD_STEP)
    fd_rel = abs(fd - gdot) / abs(gdot)
    del model32, p32, direction
    gc.collect()
    torch.cuda.empty_cache()
    flops = 6 * n_params * TR_TOKENS
    log(f"[train] {cfg.name} ({TR_LAYERS} of {full.n_layers} layers, full "
        f"width: d={cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} of "
        f"{cfg.head_dim_}, d_ff {cfg.d_ff} {cfg.mlp}, vocab {cfg.vocab}, "
        f"softcaps {cfg.attn_softcap}/{cfg.logit_softcap}, tied, remat; "
        f"{n_params} parameters): one sequence of {TR_TOKENS} tokens, "
        f"{TR_TOKENS // TR_CHUNK} loss chunks of {TR_CHUNK}; loss bf16 "
        f"{l16:.5f}, float32 {l32:.5f}; forward+backward bf16 "
        f"{fb16_ms:.1f} ms (peak {peak16:.3f} GB above the phase's start; "
        f"bound {flops / BF16_FLOPS_PER_S * 1e3:.1f} ms: 6 * parameters * "
        f"tokens FLOP at 989 TFLOP/s, the block recompute not counted), "
        f"float32 {fb32_ms:.1f} ms (first float32 call; bound "
        f"{flops / F32_FLOPS_PER_S * 1e3:.1f} ms at 67 TFLOP/s); {smi}")
    log(f"[train] {cfg.name} gradients: float32 directional derivative "
        f"along a random direction {gdot:.6e} against the central "
        f"difference {fd:.6e} (relative step {TR_FD_STEP}; losses "
        f"{sides[0]:.6f} / {sides[1]:.6f}, {fd_ms:.1f} ms): relative error "
        f"{fd_rel:.3e} (tolerance {TR_FD_REL}); bf16 against float32 "
        f"||g16 - g32|| / ||g32|| {rel16:.4f} (tolerance {TR_BF16_REL}), "
        f"worst leaves " + ", ".join(f"{k} {v:.4f}" for k, v in worst)
        + f" (tolerance {TR_BF16_LEAF_REL})")
    check(fd_rel <= TR_FD_REL, f"{cfg.name}: float32 gradient against the "
          f"central difference: relative error {fd_rel}")
    check(rel16 <= TR_BF16_REL and worst[0][1] <= TR_BF16_LEAF_REL,
          f"{cfg.name}: bf16 gradient against float32: {rel16}, {worst}")

    # AdamW steps on the one batch, the update timed on its own
    opt = adamw(TR_LR)
    update_ms = []

    def timed_update(g, st, p):
        out, ms = timed(lambda: opt.update(g, st, p))
        update_ms.append(ms)
        return out

    step = make_train_step(lm_loss_fn(cfg), Optimizer(opt.init, timed_update))
    state = opt.init(dict(model.named_parameters()))
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []

    def one_step():
        nonlocal state
        _, state, _, metrics = step(model, state, None, batch)
        losses.append(float(metrics["loss"]))

    for _ in range(TR_STEPS - 1):
        _, ms = timed(one_step)
        step_ms.append(ms)
    kern, ops, wall = profiled_ops(torch, one_step)     # the last step
    busy = sum(kern.values())
    with torch.no_grad():
        after = float(lm_loss_fn(cfg)(model)[0])
    peak_step = peak_gb()
    check(len(losses) == TR_STEPS and all(np.isfinite(losses + [after]))
          and after < losses[0],
          f"{cfg.name}: AdamW losses {losses} then {after}: not falling")
    log(f"[train] {cfg.name}: {TR_STEPS} AdamW steps (lr {TR_LR}) on the "
        f"batch: loss {' -> '.join(f'{v:.4f}' for v in losses + [after])}; "
        f"steps " + ", ".join(f"{v:.1f}" for v in step_ms) + " ms (the "
        "last profiled), of which the update (AdamW over "
        f"{n_params} parameters, float32 m and v) "
        + ", ".join(f"{v:.1f}" for v in update_ms) + f" ms; peak "
        f"{peak_step:.3f} GB above the phase's start; {smi}")
    log(f"[profile] {cfg.name} train step (torch.profiler): {wall:.1f} ms, "
        f"device busy {busy:.1f} ms (idle share {1 - busy / wall:.3f}); "
        "by operator (device time of the kernels it launched): "
        + "; ".join(f"{v:.1f} ms {k}" for k, v in ops[:12]) + "; by kernel: "
        + "; ".join(f"{v:.1f} ms {k[:70]}" for k, v in sorted(
            kern.items(), key=lambda kv: -kv[1])[:6]))
    del state
    gc.collect()
    torch.cuda.empty_cache()

    # one step with int8 compression (SGD-momentum: a smaller state);
    # every leaf's residual must be its fed gradient minus the dequantized
    # int8 value, bit for bit
    real = steps.compress_grads
    seen = []

    def checked(grads, residuals, **kw):
        comp, res = real(grads, residuals, **kw)
        for k, g in grads.items():
            fed = g + residuals[k]
            dq = dequantize_int8(*quantize_int8(fed))
            check(torch.equal(comp[k], dq) and torch.equal(res[k], fed - dq),
                  f"{cfg.name}: int8 compression of {k}: the residual is "
                  "not g - dq")
            seen.append(float(res[k].abs().max()))
        return comp, res

    steps.compress_grads = checked
    try:
        sgd = sgdm(TR_LR, clip_norm=1.0)
        step8 = make_train_step(lm_loss_fn(cfg), sgd, compression="int8")
        torch.cuda.reset_peak_memory_stats()
        (_, _, residuals, metrics), int8_ms = timed(lambda: step8(
            model, sgd.init(dict(model.named_parameters())),
            init_residuals(model, "int8"), batch))
    finally:
        steps.compress_grads = real
    check(len(seen) == len(p16) and np.isfinite(float(metrics["loss"])),
          f"{cfg.name}: the int8 step compressed {len(seen)} leaves")
    log(f"[train] {cfg.name}: one SGD-momentum step with int8 compression "
        f"({int8_ms:.1f} ms, loss {float(metrics['loss']):.4f}): every "
        f"leaf's residual == g - dequantize(quantize(g)) bitwise ({len(seen)}"
        f" leaves, largest |residual| {max(seen):.3e}); peak "
        f"{peak_gb():.3f} GB above the phase's start")
    del model, residuals, metrics, p16, step8
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[train] part (a) took {time.perf_counter() - t_part:.1f} s")


def train_small_models(torch, np, cuda, gen, smi, timed,
                       peak_gb) -> None:
    """Phase 16(b): the GNNs and DLRM at their published widths (module
    note)."""
    import dataclasses
    import gc

    from repro_torch import configs
    from repro_torch.configs.gnn_archs import with_shape_dims
    from repro_torch.data import (SyntheticClicks, gnn_full_batch,
                                  molecule_batch)
    from repro_torch.graphs import random_graph
    from repro_torch.models import dlrm, gnn

    # -- (b) the GNNs and DLRM at their published widths ----------------
    t_part = time.perf_counter()
    g = random_graph(TR_GNN_NODES, TR_GNN_EDGES, seed=0, device=cuda)
    for arch in ("gin-tu", "gatedgcn", "gat-cora", "schnet"):
        gcfg = with_shape_dims(configs.get_config(arch), "full_graph_sm")
        if arch == "schnet":
            mb = molecule_batch(*TR_MOLECULES, seed=0, device=cuda)
            inputs = {k: mb[k] for k in ("pos", "atom_z", "src", "dst",
                                         "mol_id")}
            labels, mask = mb["energy"], None
        else:
            fb = gnn_full_batch(TR_GNN_NODES, gcfg.d_in, gcfg.n_classes,
                                seed=0, device=cuda)
            inputs = {"x": fb["x"], "src": g.src, "dst": g.dst}
            labels, mask = fb["labels"], fb["label_mask"]
        small_run(torch, np, gnn.init_gnn(gcfg, gen.manual_seed(0), cuda),
                  lambda p, b, c=gcfg, i=inputs, y=labels, m=mask:
                  gnn.gnn_loss(p, c, i, y, m),
                  lambda _: None, TR_GNN_LR, arch, smi, timed)
    rec = configs.get_config("dlrm-mlperf")
    rcfg = dataclasses.replace(rec, vocab_sizes=tuple(
        min(v, TR_DLRM_CAP) for v in rec.vocab_sizes))
    clicks = SyntheticClicks(rcfg.vocab_sizes, rcfg.n_dense,
                             batch=TR_DLRM_BATCH, device=cuda)
    torch.cuda.reset_peak_memory_stats()
    model = dlrm.init_dlrm(rcfg, gen.manual_seed(0), cuda)
    rows = sum(t.shape[0] for t in model.tables)
    capped = sum(v > TR_DLRM_CAP for v in rec.vocab_sizes)
    small_run(torch, np, model,
              lambda p, b: dlrm.dlrm_loss(p, rcfg, b["dense"],
                                          b["sparse"], b["labels"]),
              clicks.batch_at, TR_LR, f"dlrm ({rows} table rows: "
              f"{capped} of {rcfg.n_sparse} tables capped at "
              f"{TR_DLRM_CAP} rows; "
              f"batch {TR_DLRM_BATCH}; peak then "
              f"{{peak:.3f}} GB)", smi, timed, peak_gb)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[train] part (b) took {time.perf_counter() - t_part:.1f} s")


def profiled_ops(torch, fn):
    """One profiled call of ``fn`` (``torch.profiler``): device time by
    CUDA kernel name, in ms; the operators (aten ops) by the device time
    of the kernels each launched itself, largest first; the wall time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern, ops = {}, {}
    for e in prof.key_averages():
        dt = e.self_device_time_total / 1e3
        if dt <= 0:
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kern[e.key] = kern.get(e.key, 0.0) + dt
        else:
            ops[e.key] = ops.get(e.key, 0.0) + dt
    return kern, sorted(ops.items(), key=lambda kv: -kv[1]), wall


def small_run(torch, np, model, loss_fn, batch_at, lr, what, smi, timed,
              peak_gb=None):
    """``TR_SMALL_STEPS`` AdamW steps of ``model`` at learning rate ``lr``
    (the batch of step i is ``batch_at(i)``, or none); the loss must be
    finite and fall."""
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step

    opt = adamw(lr)
    step = make_train_step(loss_fn, opt)
    state = opt.init(dict(model.named_parameters()))
    losses, ms = [], []
    for i in range(TR_SMALL_STEPS):
        (_, state, _, metrics), t = timed(
            lambda: step(model, state, None, batch_at(i)))
        losses.append(float(metrics["loss"]))
        ms.append(t)
    n_params = sum(p.numel() for p in model.parameters())
    if peak_gb is not None:
        what = what.format(peak=peak_gb())
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{what}: losses {losses} not falling")
    log(f"[train] {what}: {n_params} parameters, {TR_SMALL_STEPS} AdamW "
        f"steps (lr {lr}), loss "
        f"{' -> '.join(f'{v:.4f}' for v in losses)}; steps "
        f"{', '.join(f'{v:.1f}' for v in ms)} ms; {smi}")


# -- phase 17: the mesh path -------------------------------------------------

def mesh_variant(dataclasses, cfg, layers: int, impl: str, cf: float,
                 dtype: str):
    """``cfg`` cut to ``layers`` layers, its MoE at ``impl`` and capacity
    factor ``cf``, parameters and activations in ``dtype``."""
    return dataclasses.replace(
        cfg, n_layers=layers, dtype=dtype, param_dtype=dtype,
        moe=dataclasses.replace(cfg.moe, impl=impl, capacity_factor=cf))


def drop_log(moe_lib, shares: list):
    """``moe_lib.moe_apply`` and a wrapper of it that appends, per call,
    the share of (token, choice) picks past their expert's capacity over
    the call's whole token block (the expert-parallel region's block on
    a mesh whose data dim is 1) to ``shares``."""
    from repro_torch.models.sharding import full
    real = moe_lib.moe_apply

    def wrapped(p, cfg, x):
        xt = full(x).detach()
        *_, cap, slot = moe_lib.route(p, cfg, xt.reshape(-1, xt.shape[-1]))
        shares.append(float((slot >= cap).float().mean()))
        return real(p, cfg, x)
    return real, wrapped


def gloo_cuda_all_gather(torch, tdist):
    """On the card's torch (2.11, CUDA 12.8) the functional all-gather
    that DTensor's redistributions call dies (SIGSEGV) on a gloo group
    with CUDA tensors, where the c10d call does not (PERF.md §6):
    in this process the CUDA kernel of
    ``_c10d_functional::all_gather_into_tensor`` is the c10d call. The
    returned library must stay alive."""
    from torch.distributed import distributed_c10d as c10d
    lib = torch.library.Library("_c10d_functional", "IMPL")

    def all_gather(inp, group_size, group_name):
        out = inp.new_empty((group_size * inp.shape[0],)
                            + tuple(inp.shape[1:]))
        tdist.all_gather_into_tensor(
            out, inp.contiguous(),
            group=c10d._resolve_process_group(group_name))
        return out
    lib.impl("all_gather_into_tensor", all_gather, "CUDA")
    return lib


def bits_checksum(torch, t):
    """A 64-bit checksum of a float32 tensor's bits: each element's bits
    times an odd weight of its position, summed mod 2**64, so that any
    one flipped bit changes it."""
    bits = t.contiguous().view(torch.int32).reshape(-1)
    total = torch.zeros((), dtype=torch.int64, device=t.device)
    step = 1 << 24
    for i in range(0, bits.numel(), step):
        part = bits[i:i + step].long()
        weight = torch.arange(2 * i + 1, 2 * (i + part.numel()), 2,
                              dtype=torch.int64, device=t.device)
        total += (part * weight).sum()
    return total


def mesh_rank(rank: int, world: int, work: str, device=None) -> int:
    """Phase 17(b): one of two gloo ranks sharing the card (``chip_smoke.py
    --mesh-rank RANK WORLD DIR``). moonshot-v1-16b-a3b at full width,
    ``MESH_RANK_LAYERS`` layers, float32, seeded on the card (the same
    weights on both ranks), its MoE layers at capacity factor E / k (no
    pick dropped): rank 0 computes the unsharded model's logits and the
    gradient of ``lm_loss``; then both place the parameters by
    ``lm_param_specs`` on a ``(1, world)`` mesh and run the same under
    ``sharding_rules`` (``impl="ep"``, E / world experts a rank); rank 0
    holds them to the unsharded ones (``MESH_TOL``, ``MESH_GRAD_REL``).
    Then one AdamW update of those gradients under the rules, its state
    re-meshed onto ``make_mesh_from([0], (1, 1))``, bitwise."""
    import dataclasses
    import datetime

    import torch
    import torch.distributed as tdist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.distributed import make_mesh_from, remesh
    from repro_torch.models import transformer as tf
    from repro_torch.models.param_sharding import (distribute, lm_param_specs,
                                                   state_specs_like,
                                                   tree_to_mesh)
    from repro_torch.models.sharding import full, sharding_rules
    from repro_torch.optim import adamw

    cuda = torch.device("cuda", 0) if device is None else device
    on_card = cuda.type == "cuda"
    if on_card:
        torch.cuda.set_device(cuda)
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    tdist.init_process_group(
        "gloo", init_method=f"file://{work}/mesh_store", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=MESH_LIMIT_S))
    lib = gloo_cuda_all_gather(torch, tdist) if on_card else None
    times = {}

    def timed(part, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        times[part] = (time.perf_counter() - t0) * 1e3
        return out

    def say(*args):
        if rank == 0:
            log("[mesh] (b)", *args)

    try:
        base = configs.get_config(MESH_ARCH)
        e, k = base.moe.n_experts, base.moe.top_k
        cfg_d = mesh_variant(dataclasses, base, MESH_RANK_LAYERS, "dense",
                             e / k, "float32")
        cfg_e = dataclasses.replace(cfg_d, moe=dataclasses.replace(
            cfg_d.moe, impl="ep"))
        gen = torch.Generator(device=cuda)
        model = tf.init_lm(cfg_d, gen.manual_seed(0), cuda)
        toks = torch.randint(0, base.vocab, (MESH_RANK_BATCH, MESH_RANK_SEQ),
                             generator=gen.manual_seed(1), device=cuda)
        params = dict(model.named_parameters())

        def loss_grads(cfg):
            for p in params.values():
                p.requires_grad_(True)
            loss, _ = tf.lm_loss(model, cfg, toks, toks,
                                 loss_chunk=MESH_CHUNK)
            grads = torch.autograd.grad(loss, list(params.values()))
            for p in params.values():
                p.requires_grad_(False)
            return loss.detach(), dict(zip(params, grads))

        if rank == 0:
            with torch.no_grad():
                ref_logits = timed("unsharded forward",
                                   lambda: tf.apply_lm(model, cfg_d, toks)[0])
            ref_loss, ref = timed("unsharded forward+backward",
                                  lambda: loss_grads(cfg_d))
            ref = {n: g.cpu() for n, g in ref.items()}
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        mesh = make_mesh_from(list(range(world)), (1, world),
                              device_type=cuda.type)
        distribute(model, lm_param_specs(model), mesh, MESH_MAPPING)
        params = dict(model.named_parameters())
        with sharding_rules(mesh, MESH_MAPPING):
            with torch.no_grad():
                logits = timed("forward", lambda: full(
                    tf.apply_lm(model, cfg_e, toks)[0]))
            loss, grads = timed("forward+backward", lambda: loss_grads(cfg_e))
            whole = {n: full(g) for n, g in grads.items()}
        if rank == 0:
            err = float((logits - ref_logits).abs().max())
            check(err <= MESH_TOL, f"(b) logits {err} from the unsharded "
                  f"model's, past {MESH_TOL}")
            def rel_err(g, r):
                r = r.to(cuda)
                return float((g - r).norm() / r.norm())

            rel = {n: rel_err(g, ref[n]) for n, g in whole.items()}
            worst = max(rel, key=rel.get)
            check(rel[worst] <= MESH_GRAD_REL, f"(b) gradient {worst} "
                  f"{rel[worst]} from the unsharded one, past "
                  f"{MESH_GRAD_REL}")
            say(f"{MESH_ARCH} at full width, {MESH_RANK_LAYERS} layers, "
                f"float32, {MESH_RANK_BATCH}x{MESH_RANK_SEQ} tokens on a "
                f"(1, {world}) gloo mesh ({e // world} experts a rank): "
                f"logits within {err:.3e} of the unsharded model's (tolerance"
                f" {MESH_TOL}); loss {float(full(loss)):.6f} against "
                f"{float(ref_loss):.6f}; gradient worst leaf {worst} "
                f"{rel[worst]:.3e} relative L2 (tolerance {MESH_GRAD_REL}),"
                f" median {statistics.median(rel.values()):.3e}")
        del whole, logits
        opt = adamw(1e-3)
        with sharding_rules(mesh, MESH_MAPPING):
            _, state = timed("AdamW update", lambda: opt.update(
                grads, opt.init(params), params))
        del grads
        # the old blocks stay where they lie: rank 0 holds its own to the
        # re-meshed tensors element by element, the others' reach it as
        # checksums of their bits
        old = [(key, n, v) for key in ("m", "v")
               for n, v in state[key].items()]
        sums = torch.stack([bits_checksum(torch, v.to_local())
                            for _, _, v in old])
        all_sums = [torch.empty_like(sums) for _ in range(world)]
        tdist.all_gather(all_sums, sums)
        new_mesh = make_mesh_from([0], (1, 1), device_type=cuda.type)
        specs = tree_to_mesh(state_specs_like(lm_param_specs(model), state),
                             new_mesh, MESH_MAPPING)
        moved = timed("remesh", lambda: remesh(state, specs, new_mesh))
        if rank == 0:
            n_el = 0
            for i, (key, n, v) in enumerate(old):
                new = moved[key][n].to_local()
                split = v.placements[-1]
                parts = (torch.chunk(new, world, dim=split.dim)
                         if split.is_shard() else [new] * world)
                check(torch.equal(parts[0], v.to_local()),
                      f"(b) remesh changed {key} {n} (rank 0's block)")
                for r in range(1, world):
                    check(int(bits_checksum(torch, parts[r]))
                          == int(all_sums[r][i]),
                          f"(b) remesh changed {key} {n} (rank {r}'s block)")
                n_el += new.numel()
            check(int(full(moved["step"])) == 1, "(b) remesh: step")
            say(f"AdamW state ({n_el} float32 moment values) re-meshed from "
                f"(1, {world}) onto make_mesh_from([0], (1, 1)): bitwise "
                f"equal (rank 0's blocks element by element, rank 1's by a "
                f"position-weighted 64-bit checksum of their bits)")
        else:
            check(all(v is None for v in moved["m"].values()),
                  "(b) remesh: a rank outside the new mesh holds state")
        peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0
        say("times: " + ", ".join(f"{k} {v:.1f} ms" for k, v in times.items())
            + f"; rank 0's peak {peak:.2f} GB after the unsharded part")
        tdist.barrier()
    finally:
        tdist.destroy_process_group()
        del lib
    return 0


def mesh_path(torch, np, cuda, counters, smi) -> None:
    """Phase 17: the mesh path on the card (module note)."""
    import os
    import tempfile

    t_phase = time.perf_counter()
    for fn in counters.values():
        fn.launches = 0
    # (b) in processes of their own, started first: their start-up overlaps
    # part (a)
    work = tempfile.TemporaryDirectory()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    ranks = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-rank", str(r),
         "2", work.name], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        mesh_one_rank(torch, np, cuda, smi)
        outs = []
        for proc in ranks:
            out, _ = proc.communicate(timeout=max(
                1.0, MESH_LIMIT_S - (time.perf_counter() - t_phase)))
            outs.append(out)
            check(proc.returncode == 0, f"a mesh rank failed (exit "
                  f"{proc.returncode}):\n{out[-4000:]}")
    finally:
        for proc in ranks:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        work.cleanup()
    lines = [ln for ln in outs[0].splitlines() if ln.startswith("[mesh]")]
    check(len(lines) == 3, f"rank 0 printed no result:\n{outs[0][-2000:]}")
    for line in lines:
        log(line)
    log(f"[mesh] (b) the two ranks were done "
        f"{time.perf_counter() - t_phase:.1f} s into the phase; {smi}")
    launches = {k: fn.launches for k, fn in counters.items()}
    check(not any(launches.values()),
          f"the mesh path launched an SSSP kernel: {launches}")
    log(f"[mesh] launches over phase 17: {json.dumps(launches)} (the mesh "
        "path reaches no Pallas kernel in the reference and none here)")
    log(f"[mesh] phase 17 took {time.perf_counter() - t_phase:.1f} s")


def mesh_one_rank(torch, np, cuda, smi) -> None:
    """Phase 17(a): moonshot-v1-16b-a3b at full width, ``MESH_LAYERS``
    layers, on a one-rank NCCL mesh (module note)."""
    import dataclasses
    import gc
    import tempfile

    import torch.distributed as tdist

    from repro_torch import configs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as tf
    from repro_torch.models.param_sharding import distribute, lm_param_specs
    from repro_torch.models.sharding import full, sharding_rules

    sync = torch.cuda.synchronize
    gen = torch.Generator(device=cuda)
    base = configs.get_config(MESH_ARCH)
    e, k = base.moe.n_experts, base.moe.top_k
    toks = torch.randint(0, base.vocab, (MESH_BATCH, MESH_SEQ),
                         generator=gen.manual_seed(1), device=cuda)
    group_dir = tempfile.TemporaryDirectory()
    tdist.init_process_group("nccl", store=tdist.FileStore(
        str(Path(group_dir.name) / "store"), 1), rank=0, world_size=1,
        device_id=cuda)
    try:
        mesh = make_host_mesh(1, 1)
        # float32, capacity factor E / k: neither path drops a pick
        t0 = time.perf_counter()
        cfg_d = mesh_variant(dataclasses, base, MESH_LAYERS, "dense", e / k,
                             "float32")
        cfg_e = mesh_variant(dataclasses, base, MESH_LAYERS, "ep", e / k,
                             "float32")
        model = tf.init_lm(cfg_d, gen.manual_seed(0), cuda)
        with torch.no_grad():
            dense = tf.apply_lm(model, cfg_d, toks)[0]
            distribute(model, lm_param_specs(model), mesh, MESH_MAPPING)
            with sharding_rules(mesh, MESH_MAPPING):
                ep = full(tf.apply_lm(model, cfg_e, toks)[0])
        err = float((ep - dense).abs().max())
        check(bool(torch.isfinite(ep).all()) and ep.shape == dense.shape,
              "(a) EP logits")
        check(err <= MESH_TOL, f"(a) EP logits {err} from dense, past "
              f"{MESH_TOL}")
        n_params = sum(p.numel() for p in model.parameters())
        log(f"[mesh] (a) {MESH_ARCH} at full width ({e} experts, top-{k}, "
            f"d_ff_expert {base.moe.d_ff_expert}, d {base.d_model}, vocab "
            f"{base.vocab}), {MESH_LAYERS} of {base.n_layers} layers "
            f"({n_params} parameters), float32, {MESH_BATCH}x{MESH_SEQ} "
            f"tokens, capacity factor E/k = {e / k:.3f}: impl=\"ep\" under "
            f"sharding_rules on a one-rank NCCL mesh within {err:.3e} max abs"
            f" of impl=\"dense\" (tolerance {MESH_TOL}); "
            f"{time.perf_counter() - t0:.1f} s")
        del model, ep, dense
        gc.collect()
        torch.cuda.empty_cache()

        # bf16 at the config's capacity factor: times and dropped picks
        cfgs = {impl: mesh_variant(dataclasses, base, MESH_LAYERS, impl,
                                   base.moe.capacity_factor, "bfloat16")
                for impl in ("ep", "dense")}
        model = tf.init_lm(cfgs["dense"], gen.manual_seed(0), cuda)
        params = dict(model.named_parameters())

        def forward(cfg):
            with torch.no_grad():
                return tf.lm_loss(model, cfg, toks, toks,
                                  loss_chunk=MESH_CHUNK)[0]

        def fwd_bwd(cfg):
            for p in params.values():
                p.requires_grad_(True)
            loss, _ = tf.lm_loss(model, cfg, toks, toks,
                                 loss_chunk=MESH_CHUNK)
            grads = torch.autograd.grad(loss, list(params.values()))
            for p in params.values():
                p.requires_grad_(False)
            return loss, grads

        def ms3(fn):
            fn()
            walls = []
            for _ in range(3):
                sync()
                t0 = time.perf_counter()
                fn()
                sync()
                walls.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(walls)

        def drops(cfg):
            shares = []
            real, wrapped = drop_log(moe_lib, shares)
            moe_lib.moe_apply = wrapped
            try:
                forward(cfg)
            finally:
                moe_lib.moe_apply = real
            return sum(shares) / len(shares)

        rows = {}
        torch.cuda.reset_peak_memory_stats()
        rows["dense, plain tensors"] = (
            ms3(lambda: forward(cfgs["dense"])),
            ms3(lambda: fwd_bwd(cfgs["dense"])), drops(cfgs["dense"]),
            torch.cuda.max_memory_allocated() / 1e9)
        distribute(model, lm_param_specs(model), mesh, MESH_MAPPING)
        params = dict(model.named_parameters())
        with sharding_rules(mesh, MESH_MAPPING):
            for impl in ("dense", "ep"):
                torch.cuda.reset_peak_memory_stats()
                rows[f"{impl} under the rules"] = (
                    ms3(lambda: forward(cfgs[impl])),
                    ms3(lambda: fwd_bwd(cfgs[impl])), drops(cfgs[impl]),
                    torch.cuda.max_memory_allocated() / 1e9)
        for name, (f_ms, fb_ms, share, peak) in rows.items():
            log(f"[mesh] (a) bf16, capacity factor "
                f"{base.moe.capacity_factor}, lm_loss, {name}: forward "
                f"{f_ms:.1f} ms, forward+backward {fb_ms:.1f} ms (medians of"
                f" 3 after a warm-up), dropped picks {share:.4f} of the "
                f"layers' (token, choice) pairs, peak {peak:.2f} GB; {smi}")
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        tdist.destroy_process_group()
        group_dir.cleanup()


# -- phase 18: the dry run ----------------------------------------------------

def dry_line(d: dict, cut: str) -> str:
    """One ``[dryrun]`` line of a traced cell's report."""
    counts = {op: s["count"] for op, s in d["collectives"]["by_op"].items()}
    return (f"[dryrun] {d['arch']} {d['shape']} {d['mesh']} ({cut}): C "
            f"{d['compute_s']:.3e} s, M {d['memory_s']:.3e} s, X "
            f"{d['collective_s']:.3e} s -> {d['dominant']}; HBM "
            f"{d['hbm_bytes_per_dev'] / 2**30:.2f} GiB/dev (fits_hbm="
            f"{d['fits_hbm']}); useful {d['useful_ratio']:.1%}; collectives "
            f"{json.dumps(counts)}; traced in {d['lower_s']} s")


def dryrun_child(work: str, part: int) -> int:
    """Phase 18(a), in a process of its own (its default group is a fake
    one): the cells and meshes of ``DRY_CELLS`` that ``DRY_PARTS[part]``
    names, traced on fake CUDA tensors over fake 256- and 512-rank groups, each
    LM cut to ``DRY_LAYERS`` layers; in part 0 also the ``DRY_REAL``
    cells at (b)'s sizes on a one-rank fake group, their reports written
    to ``WORK/real.json``."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import family_of
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.dryrun import fake_group, report
    from repro_torch.launch.mesh import make_production_mesh

    cuda = torch.device("cuda", 0)
    torch.cuda.set_device(cuda)
    import traceback

    failed = 0
    for i, multi in DRY_PARTS[part]:
        arch, shape, _ = DRY_CELLS[i]
        lm = family_of(arch) == "lm"
        fake_group(512 if multi else 256)
        mesh = make_production_mesh(multi_pod=multi)
        t0 = time.perf_counter()
        try:
            cell = build_cell(arch, shape, mesh, device=cuda,
                              layers=DRY_LAYERS if lm else None)
            d = report(cell, cell.trace(), mesh, time.perf_counter() - t0)
        except Exception as e:         # listed, and the child fails at its end
            failed += 1
            traceback.print_exc()
            log(f"[dryrun] FAILED {arch} {shape} "
                f"{'2x16x16' if multi else '16x16'}: {e!r}"[:600])
            continue
        log(dry_line(d, f"{DRY_LAYERS} layers" if lm else "full size"))
    if part:
        return int(failed > 0)
    fake_group(1)
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data",
                                                            "model"))
    out = {}
    for arch, shape in DRY_REAL:
        t0 = time.perf_counter()
        cell = build_cell(arch, shape, mesh, device=cuda,
                          layers=DRY_REAL_LAYERS, batch=DRY_REAL_BATCH)
        trace = cell.trace()
        d = report(cell, trace, mesh, time.perf_counter() - t0)
        log(dry_line(d, f"one rank, {DRY_REAL_LAYERS} layers, batch "
                        f"{DRY_REAL_BATCH}"))
        out[shape] = d
    with open(Path(work) / "real.json", "w") as f:
        json.dump(out, f)
    return int(failed > 0)


def dryrun_path(torch, np, cuda, counters, smi) -> None:
    """Phase 18: the dry run (module note)."""
    import os
    import tempfile

    t_phase = time.perf_counter()
    for fn in counters.values():
        fn.launches = 0
    check(sorted(x for part in DRY_PARTS for x in part) == sorted(
        (i, m) for i, (*_, meshes) in enumerate(DRY_CELLS) for m in meshes),
        "DRY_PARTS does not cover each cell and mesh of DRY_CELLS once")
    work = tempfile.TemporaryDirectory()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    # (a) in processes of their own, started first: they trace on the
    # host beside (b)'s runs on the card
    children = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--dryrun", work.name,
         str(part)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for part in range(len(DRY_PARTS))]
    try:
        real = dry_real_runs(torch, np, cuda)
        log(f"[dryrun] (b) ran {time.perf_counter() - t_phase:.1f} s into "
            "the phase")
        outs = [child.communicate(timeout=max(
            1.0, DRY_LIMIT_S - (time.perf_counter() - t_phase)))[0]
            for child in children]
        lines = [ln for out in outs for ln in out.splitlines()
                 if ln.startswith("[dryrun]")]
        for line in lines:
            log(line)
        for child, out in zip(children, outs):
            check(child.returncode == 0, f"a dry-run child failed (exit "
                  f"{child.returncode}):\n{out[-4000:]}")
        with open(Path(work.name) / "real.json") as f:
            traced = json.load(f)
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
                child.wait()
        work.cleanup()
    check(len(lines) == sum(map(len, DRY_PARTS)) + len(DRY_REAL),
          f"the dry-run children printed too few lines:\n{outs[0][-3000:]}"
          f"\n{outs[-1][-3000:]}")
    log(f"[dryrun] (a) the children were done "
        f"{time.perf_counter() - t_phase:.1f} s into the phase; {smi}")
    for shape, got in real.items():
        d = traced[shape]
        rel = abs(got["flops"] - d["flops_per_dev"]) / d["flops_per_dev"]
        bound_ms = max(d["compute_s"], d["memory_s"]) * 1e3
        ratio = got["peak_bytes"] / d["hbm_bytes_per_dev"]
        log(f"[dryrun] (b) {DRY_REAL[0][0]} {shape} at full width on a "
            f"one-rank NCCL mesh, {DRY_REAL_LAYERS} layers, batch "
            f"{DRY_REAL_BATCH}{got['cut']}: FLOPs {got['flops']:.6e} (FlopCounterMode "
            f"around the real step) against {d['flops_per_dev']:.6e} traced"
            f" ({rel:.3%} apart, limit {DRY_FLOP_REL:.0%}); peak "
            f"{got['peak_bytes'] / 1e9:.3f} GB above the phase's start "
            f"against {d['hbm_bytes_per_dev'] / 1e9:.3f} GB traced "
            f"(arguments + temps + outputs - alias; ratio {ratio:.3f}); "
            f"{got['ms']:.1f} ms a step (median of 3) against the H100 "
            f"terms' max(C, M) {bound_ms:.2f} ms{got['extra']}; {smi}")
        check(rel <= DRY_FLOP_REL, f"(b) {shape}: the real step's FLOPs are "
              f"{rel:.3%} from the trace's")
    launches = {k: fn.launches for k, fn in counters.items()}
    check(not any(launches.values()),
          f"the dry-run path launched an SSSP kernel: {launches}")
    log(f"[dryrun] launches over phase 18: {json.dumps(launches)} (the "
        "dry-run path reaches no Pallas kernel in the reference and none "
        "here)")
    log(f"[dryrun] phase 18 took {time.perf_counter() - t_phase:.1f} s")


def dry_real_runs(torch, np, cuda) -> dict:
    """Phase 18(b): the ``DRY_REAL`` cells run for real under the rules on
    a one-rank NCCL mesh: FLOPs, peak memory and time of the step; for
    ``decode_32k`` its logits against the plain-tensor ``decode_step``."""
    import dataclasses
    import gc
    import tempfile

    import torch.distributed as tdist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import configs
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.models.sharding import full

    sync = torch.cuda.synchronize
    gen = torch.Generator(device=cuda)
    group_dir = tempfile.TemporaryDirectory()
    tdist.init_process_group("nccl", store=tdist.FileStore(
        str(Path(group_dir.name) / "store"), 1), rank=0, world_size=1,
        device_id=cuda)
    out = {}
    try:
        mesh = make_host_mesh(1, 1)
        for arch, shape in DRY_REAL:
            gc.collect()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            cell = build_cell(arch, shape, mesh, device=cuda,
                              layers=DRY_REAL_LAYERS, batch=DRY_REAL_BATCH,
                              real=True)
            whole = configs.get_config(arch)
            cfg = dataclasses.replace(whole, n_layers=DRY_REAL_LAYERS)
            cut = (f" (cut from {whole.n_layers} layers and batch "
                   f"{configs.get_shape(arch, shape).global_batch}")
            if shape == "train_4k":
                batch = cell.args[2]
                for key in ("tokens", "labels"):
                    batch[key].to_local().copy_(torch.randint(
                        0, cfg.vocab, batch[key].shape, generator=gen
                        .manual_seed(1), device=cuda, dtype=torch.int32))
                cut += ")"
            else:
                model, cache, tokens = cell.args
                for key in ("k", "v"):
                    cache[key].to_local().copy_(torch.randn(
                        cache[key].shape, generator=gen.manual_seed(2),
                        device=cuda, dtype=torch.float32).to(
                            cache[key].dtype))
                # the last slot: the step attends over the whole cache
                cache["len"] = cache["k"].shape[2] - 1
                tokens.to_local().copy_(torch.randint(
                    0, cfg.vocab, tokens.shape, generator=gen.manual_seed(3),
                    device=cuda, dtype=torch.int32))
                cut += f"; a {cache['k'].shape[2]}-slot cache)"
            torch.cuda.reset_peak_memory_stats()
            sync()
            first = cell.fn(*cell.args)
            sync()
            peak = torch.cuda.max_memory_allocated() - base
            counter = FlopCounterMode(display=False)
            with counter:
                cell.fn(*cell.args)
            sync()
            walls = []
            for _ in range(3):
                sync()
                t0 = time.perf_counter()
                cell.fn(*cell.args)
                sync()
                walls.append((time.perf_counter() - t0) * 1e3)
            if shape == "decode_32k":
                # the same step on plain tensors: the same seeded weights
                # (cells draw them from a generator seeded 0), cache, token
                plain_cfg = dataclasses.replace(cfg, remat=False)
                plain = tf.init_lm(plain_cfg, torch.Generator(
                    device=cuda).manual_seed(0), cuda)
                pc = {"k": full(cache["k"]).clone(),
                      "v": full(cache["v"]).clone(), "len": cache["len"]}
                with torch.no_grad():
                    ref = tf.decode_step(plain, plain_cfg, pc,
                                         full(tokens))[0]
                got = full(first[0])
                check(bool(torch.isfinite(got).all())
                      and got.shape == ref.shape, "(b) decode logits")
                err = logit_err(got, ref)
                check(within_bf16(err), f"(b) decode logits under the rules "
                      f"{err} from the plain decode_step's, past "
                      f"({LM_BF16_MAX_ABS}, {LM_BF16_REL})")
                extra = (f"; logits within {err[0]:.4f} max abs, {err[1]:.2e}"
                         f" relative of the plain-tensor decode_step's "
                         f"(tolerance {LM_BF16_MAX_ABS}, {LM_BF16_REL})")
                del plain, pc, ref, got
            else:
                loss = float(first[3]["loss"])
                check(np.isfinite(loss), f"(b) train loss {loss}")
                extra = f"; loss {loss:.4f}"
            out[shape] = {"flops": float(counter.get_total_flops()),
                          "peak_bytes": int(peak),
                          "ms": statistics.median(walls), "cut": cut,
                          "extra": extra}
            log(f"[dryrun] (b) {arch} {shape} ran: {json.dumps(out[shape])}")
            del cell, first
    finally:
        tdist.destroy_process_group()
        group_dir.cleanup()
        gc.collect()
        torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    import repro_torch.core.backends as backends
    from repro_torch.api import Engine, SingleSource
    from repro_torch.core import DeltaConfig
    from repro_torch.graphs import (coo_to_csr, csr_to_ell, random_graph,
                                    rmat, watts_strogatz)
    from repro_torch.kernels import _build
    from repro_torch.kernels.bucket_scan import bucket_scan_cuda, \
        bucket_scan_ref
    from repro_torch.kernels.ell_relax import ell_relax_cuda, ell_relax_ref
    from repro_torch.kernels.frontier_relax import (frontier_relax,
                                                    frontier_relax_cuda,
                                                    frontier_relax_ref)
    from repro_torch.kernels.grid_relax import grid_relax_cuda, grid_relax_ref

    cuda = torch.device("cuda", 0)
    torch.cuda.set_device(cuda)
    smi = nvidia_smi_line()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    # phase 8e's CPU answers, in a process of their own from the start
    import os
    import tempfile
    capped_dir = tempfile.TemporaryDirectory()
    capped_proc = subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--capped-host",
         capped_dir.name], env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def host_capped():
        try:
            out, _ = capped_proc.communicate(timeout=CAPPED_LIMIT_S)
        finally:
            if capped_proc.poll() is None:
                capped_proc.kill()
                capped_proc.wait()
        check(capped_proc.returncode == 0, f"the capped-answer child "
              f"failed (exit {capped_proc.returncode}):\n{out[-4000:]}")
        got = torch.load(Path(capped_dir.name) / "capped.pt")
        capped_dir.cleanup()
        return got

    # -- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    build = _build.load()
    log(f"[build] {build.path.name} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.seconds:.2f} s)")
    for line in build.log.splitlines():
        if "registers" in line or line.startswith("---"):
            log("[build] " + line.strip())

    # -- graph --------------------------------------------------------------
    t0 = time.perf_counter()
    g = watts_strogatz(N_NODES, DEGREE, P_REWIRE, seed=0)
    log(f"[graph] watts_strogatz n={g.n_nodes} |E|={g.n_edges} "
        f"in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ref_dist, keyed = oracle_dist(g)
    log(f"[oracle] scipy dijkstra on {keyed[0].shape[0]} deduplicated edges "
        f"in {time.perf_counter() - t0:.1f} s")

    plans = {}
    for strategy, pred_mode in (("fused", "argmin"), ("pallas", "argmin"),
                                ("ell", "argmin"), ("edge", "argmin"),
                                ("fused", "packed")):
        t0 = time.perf_counter()
        cfg = DeltaConfig(delta=DELTA, strategy=strategy, pred_mode=pred_mode)
        plans[(strategy, pred_mode)] = Engine(g, cfg, device=cuda).plan()
        log(f"[plan] {strategy}/{pred_mode} built in "
            f"{time.perf_counter() - t0:.1f} s")

    # -- 2a. record mid-solve kernel inputs (also the warm-up solves) -------
    rec = {"bucket_scan": [], "ell_relax": [], "frontier_relax": []}
    real = {name: getattr(backends, name) for name in rec}

    def recorder(name, size_of):
        def wrapped(*args, **kw):
            out = real[name](*args, **kw)
            stored = tuple(a.clone() if isinstance(a, torch.Tensor) and
                           a.shape[0] == N_NODES else a for a in args)
            rec[name].append((stored, kw, size_of(args, out)))
            return out
        return wrapped

    setattr(backends, "frontier_relax", recorder(
        "frontier_relax", lambda a, o: int(o[3])))
    setattr(backends, "bucket_scan", recorder(
        "bucket_scan", lambda a, o: int(o[0].sum())))
    setattr(backends, "ell_relax", recorder(
        "ell_relax", lambda a, o: int((a[0] < N_NODES).sum())))
    try:
        plans[("fused", "argmin")].solve(SingleSource(0))
        plans[("pallas", "argmin")].solve(SingleSource(0))
    finally:
        for name, fn in real.items():
            setattr(backends, name, fn)
    torch.cuda.synchronize()

    def picks(records):
        big = max(range(len(records)), key=lambda k: records[k][2])
        return big, sorted({0, len(records) // 2, big})

    # -- 2b. kernels against twins on the card -----------------------------
    def run_bs(args, kw, fn):
        t, e, i = args
        return fn(t, e, i, delta=kw["delta"])

    def run_er(args, kw, fn):
        return (fn(*args),)

    def run_fr(args, kw, fn, **over):
        return fn(*args, **(kw | over))

    runners = {"bucket_scan": (run_bs, bucket_scan_cuda, bucket_scan_ref),
               "ell_relax": (run_er, ell_relax_cuda, ell_relax_ref),
               "frontier_relax": (run_fr, frontier_relax_cuda,
                                  frontier_relax_ref)}
    main_case = {}
    for name, records in rec.items():
        check(len(records) > 0, f"no {name} call recorded")
        big, chosen = picks(records)
        main_case[name] = records[big]
        run, kern, twin = runners[name]
        for k in chosen:
            args, kw, size = records[k]
            same(torch, run(args, kw, kern), run(args, kw, twin))
            torch.cuda.synchronize()
        log(f"[kernel] {name}: {len(chosen)} mid-solve states of "
            f"{len(records)} equal to the twin (largest frontier {size})")

    # edge cases
    rng = np.random.default_rng(0)

    def rand_tent(n, hi):
        t = rng.integers(0, hi, size=n).astype(np.int32)
        t[rng.random(n) < 0.3] = INF
        return torch.from_numpy(t).to(cuda)

    ragged = 1_000_003                           # not a multiple of 1024
    tr, er = rand_tent(ragged, 400), rand_tent(ragged, 400)
    allinf = torch.full((ragged,), INF, dtype=torch.int32, device=cuda)
    for a, b, i in ((tr, er, 3), (allinf, allinf, 0)):
        same(torch, bucket_scan_cuda(a, b, i, delta=DELTA),
             bucket_scan_ref(a, b, i, delta=DELTA))
        torch.cuda.synchronize()
    (fidx, dist, w_ell), _, _ = main_case["ell_relax"]
    sentinel = torch.full_like(fidx, N_NODES)
    same(torch, (ell_relax_cuda(sentinel, dist, w_ell),),
         (ell_relax_ref(sentinel, dist, w_ell),))
    torch.cuda.synchronize()
    (d, e, i, nbr, w), kw, pop = main_case["frontier_relax"]
    capped = dict(cap=max(1, pop // 3))
    out = run_fr((d, e, i, nbr, w), kw, frontier_relax_cuda, **capped)
    check(int(out[3]) == pop and pop > capped["cap"], "overflow count")
    same(torch, out, run_fr((d, e, i, nbr, w), kw, frontier_relax_ref,
                            **capped))
    torch.cuda.synchronize()
    same(torch, run_fr((allinf[:N_NODES], allinf[:N_NODES], 0, nbr, w), kw,
                       frontier_relax_cuda),
         run_fr((allinf[:N_NODES], allinf[:N_NODES], 0, nbr, w), kw,
                frontier_relax_ref))
    torch.cuda.synchronize()
    rg = csr_to_ell(coo_to_csr(random_graph(ragged, 4 * ragged, seed=1)))
    rg = rg.to(cuda)
    for cap in (ragged, 5000):
        kw_r = dict(delta=DELTA, cap=cap)
        same(torch, frontier_relax_cuda(tr, er, 3, rg.nbr, rg.w, **kw_r),
             frontier_relax_ref(tr, er, 3, rg.nbr, rg.w, **kw_r))
        torch.cuda.synchronize()
    nbr0 = torch.full((ragged + 1, 0), ragged, dtype=torch.int32, device=cuda)
    w0 = torch.full((ragged + 1, 0), INF, dtype=torch.int32, device=cuda)
    kw0 = dict(delta=DELTA, cap=4096)
    twin0 = frontier_relax_ref(tr, er, 3, nbr0, w0, **kw0)
    same(torch, frontier_relax_cuda(tr, er, 3, nbr0, w0, **kw0), twin0)
    same(torch, frontier_relax(tr, er, 3, nbr0, w0, **kw0), twin0)
    torch.cuda.synchronize()
    # the range form of bucket_scan: int32 tent over the whole range,
    # negative buckets and buckets whose range passes int32, a view 4
    # bytes past 16-byte alignment (scalar path), n = 0; ell_relax on a
    # w_ell view 4 bytes past 16-byte alignment (scalar walk)
    full = torch.from_numpy(rng.integers(
        -2**31, 2**31, size=ragged + 1, dtype=np.int64).astype(np.int32)
    ).to(cuda)
    full[::7] = INF
    for delta in (1, 7, 2**30):
        for i in (-3, 0, INF // delta, -(2**31) // delta):
            for a, b in ((full[:-1], er), (full[1:], tr), (tr, full[1:])):
                same(torch, bucket_scan_cuda(a, b, i, delta=delta),
                     bucket_scan_ref(a, b, i, delta=delta))
    torch.cuda.synchronize()
    empty = bucket_scan_cuda(tr[:0], er[:0], 0, delta=DELTA)
    check(empty[0].shape == (0,) and not bool(empty[1])
          and int(empty[2]) == INF, "bucket_scan on n = 0")
    shifted = torch.empty(w_ell.numel() + 1, dtype=torch.int32,
                          device=cuda)[1:].view(w_ell.shape)
    shifted.copy_(w_ell)
    same(torch, (ell_relax_cuda(fidx, dist, shifted),),
         (ell_relax_ref(fidx, dist, shifted),))
    torch.cuda.synchronize()
    # the range form of frontier_relax: the same int32 range and
    # buckets, the scalar scan of a view 4 bytes past 16-byte alignment,
    # a shard's base and sentinel; then calls of different S and cap
    # queued back to back on one stream (its scratch grows between
    # them), each held against the twin after they all ran
    for delta in (1, 7, 2**30):
        for i in (-3, 0, INF // delta, -(2**31) // delta):
            for a, b in ((full[:-1], er), (full[1:], tr)):
                for cap in (4096, ragged):
                    kw_f = dict(delta=delta, cap=cap, base=3 * ragged,
                                sent=4 * ragged)
                    same(torch,
                         frontier_relax_cuda(a, b, i, rg.nbr, rg.w, **kw_f),
                         frontier_relax_ref(a, b, i, rg.nbr, rg.w, **kw_f))
    torch.cuda.synchronize()
    queued = []
    for s_, cap in ((ragged, 4096), (5, 5), (300_001, 300_001), (1025, 1),
                    (70_001, 64), (ragged, ragged)):
        args_f = (full[1:s_ + 1], tr[:s_], 3, rg.nbr[:s_ + 1], rg.w[:s_ + 1])
        queued.append((args_f, cap, frontier_relax_cuda(
            *args_f, delta=7, cap=cap)))
    torch.cuda.synchronize()
    for args_f, cap, out in queued:
        same(torch, out, frontier_relax_ref(*args_f, delta=7, cap=cap))
    del full, shifted, queued
    torch.cuda.synchronize()
    log("[kernel] edge cases equal to the twins: ragged length, cap < "
        "population, all-INF, sentinel fidx, zero-width ELL block, full "
        "int32 range with negative and past-int32 buckets (bucket_scan, "
        "frontier_relax), unaligned views, n = 0, a shard's base and "
        "sentinel, frontier_relax calls of different S and cap back to "
        "back")

    # -- 3. main path -------------------------------------------------------
    counters = {"bucket_scan": bucket_scan_cuda, "ell_relax": ell_relax_cuda,
                "frontier_relax": frontier_relax_cuda,
                "grid_relax": grid_relax_cuda}
    for fn in counters.values():
        fn.launches = 0
    results, per_solve = {}, {}
    for key, plan in plans.items():
        before = {k: fn.launches for k, fn in counters.items()}
        t0 = time.perf_counter()
        r = plan.solve(SingleSource(0))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        per_solve[key] = {k: fn.launches - before[k]
                          for k, fn in counters.items()}
        results[key] = (r, plan.host_syncs, wall)
    launches_sw = {k: fn.launches for k, fn in counters.items()}
    log(f"[main] launches over the main path: {json.dumps(launches_sw)}")
    check(per_solve[("fused", "argmin")]["frontier_relax"] > 0,
          "fused solve did not launch frontier_relax")
    check(per_solve[("fused", "argmin")]["bucket_scan"] > 0,
          "fused solve did not launch bucket_scan")
    check(per_solve[("pallas", "argmin")]["bucket_scan"] > 0,
          "pallas solve did not launch bucket_scan")
    check(per_solve[("pallas", "argmin")]["ell_relax"] > 0,
          "pallas solve did not launch ell_relax")
    check(all(launches_sw[k] > 0 for k in
              ("bucket_scan", "ell_relax", "frontier_relax")),
          "a kernel of the small-world path never launched")

    base = results[("edge", "argmin")][0]
    base_pred = base.pred.cpu().numpy()
    for key, (r, syncs, wall) in results.items():
        tel = r.telemetry
        dist = r.dist.cpu().numpy()
        pred = r.pred.cpu().numpy()
        check(dist.dtype == np.int32 and pred.dtype == np.int32, "dtypes")
        check(np.array_equal(dist.astype(np.int64), ref_dist),
              f"{key}: dist differs from the scipy oracle")
        check_tree(dist, pred, 0, keyed)
        check((tel.buckets, tel.inner_iters, tel.overflow) ==
              (base.telemetry.buckets, base.telemetry.inner_iters,
               base.telemetry.overflow), f"{key}: telemetry differs")
        if key[1] == "argmin":
            check(np.array_equal(pred, base_pred), f"{key}: pred differs")
        log(f"[main] {key[0]}/{key[1]}: dist == oracle, pred tree ok, "
            f"buckets={tel.buckets} inner_iters={tel.inner_iters} "
            f"overflow={tel.overflow} host_syncs={syncs} "
            f"launches/solve={json.dumps(per_solve[key])} "
            f"first solve {wall * 1e3:.1f} ms"
            + ("" if key[1] == "argmin" else
               f" pred==argmin pred: {np.array_equal(pred, base_pred)}"))
    reach = int((ref_dist < INF).sum())
    log(f"[main] all strategies bitwise equal; reachable {reach}, "
        f"max dist {int(ref_dist[ref_dist < INF].max())}")

    # -- 4. scale-free family under edge ------------------------------------
    t0 = time.perf_counter()
    gr = rmat(2**20, 16 * 2**20, seed=0)
    rref, rkeyed = oracle_dist(gr)
    rplan = Engine(gr, DeltaConfig(delta=DELTA, strategy="edge",
                                   pred_mode="argmin"), device=cuda).plan()
    log(f"[rmat] n={gr.n_nodes} |E|={gr.n_edges} generated + oracle + plan "
        f"in {time.perf_counter() - t0:.1f} s")
    rr = rplan.solve(SingleSource(0))
    rdist, rpred = rr.dist.cpu().numpy(), rr.pred.cpu().numpy()
    check(np.array_equal(rdist.astype(np.int64), rref),
          "rmat: dist differs from the scipy oracle")
    check_tree(rdist, rpred, 0, rkeyed)
    rwalls = []
    for _ in range(3):
        t0 = time.perf_counter()
        rplan.solve(SingleSource(0))
        torch.cuda.synchronize()
        rwalls.append(time.perf_counter() - t0)
    log(f"[rmat] edge: dist == oracle, pred tree ok, buckets="
        f"{rr.telemetry.buckets} inner_iters={rr.telemetry.inner_iters} "
        f"host_syncs={rplan.host_syncs} median solve "
        f"{statistics.median(rwalls) * 1e3:.1f} ms over 3")

    # -- 8. batched queries and frontier policies (small-world part) -------
    launches_bm, launches_pol, launches_fb, launches_twin, records = \
        batch_and_policy_path(torch, np, cuda, g, keyed, plans, results,
                              counters, host_capped)
    check(launches_bm["bucket_scan"] > 0 and launches_bm["ell_relax"] > 0
          and launches_bm["frontier_relax"] > 0,
          "the batched path did not launch bucket_scan, ell_relax and "
          "frontier_relax")
    check(launches_pol["ell_relax"] > 0,
          "the policy path did not launch ell_relax")
    check(launches_fb["bucket_scan"] > 0 and launches_fb["ell_relax"] > 0
          and launches_fb["frontier_relax"] > 0,
          "the capped and fallback solves did not launch bucket_scan, "
          "ell_relax and frontier_relax")

    # -- 5. the game-map path ----------------------------------------------
    launches_gm, per_grid, gm_records, in_solve, launches_gm_multi = \
        game_map_path(torch, np, cuda, counters)
    check(launches_gm["grid_relax"] > 0 and launches_gm["bucket_scan"] > 0,
          "the game-map path did not launch grid_relax and bucket_scan")
    check(launches_gm_multi["grid_relax"] > 0
          and launches_gm_multi["bucket_scan"] > 0,
          "the game-map MultiSource did not launch grid_relax and "
          "bucket_scan")
    per_solve.update(per_grid)
    by_path = {"smallworld": launches_sw, "gamemap": launches_gm,
               "smallworld_multisource": launches_bm,
               "smallworld_policy": launches_pol,
               "smallworld_fallback": launches_fb,
               "smallworld_fallback_twin": launches_twin,
               "gamemap_multisource": launches_gm_multi}
    # a full-width twin's re-solve is phase 3's solve of its strategy
    # (checked bitwise): its kernels are timed on that solve's inputs
    records = {"smallworld": main_case, **records,
               "smallworld_fallback_twin": main_case, **gm_records}
    launches = {k: sum(p[k] for p in by_path.values()) for k in counters}

    # -- 6. times -----------------------------------------------------------
    for key, plan in plans.items():
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            plan.solve(SingleSource(0))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        r, syncs, _ = results[key]
        log(f"[time] {key[0]}/{key[1]}: median solve "
            f"{statistics.median(walls) * 1e3:.1f} ms over 3 after warm-up "
            f"({', '.join(f'{x * 1e3:.1f}' for x in walls)}), host_syncs="
            f"{syncs}, buckets={r.telemetry.buckets}, "
            f"inner_iters={r.telemetry.inner_iters}")

    # -- 7. where a solve's device time goes (one profiled solve each) ------
    for key in (("fused", "argmin"), ("pallas", "argmin"), ("ell", "argmin"),
                ("edge", "argmin")):
        kern, wall, seen, _ = profiled(torch, lambda: plans[key].solve(
            SingleSource(0)), counters=counters)
        busy = sum(kern.values())
        top = sorted(kern.items(), key=lambda kv: -kv[1])[:6]
        log(f"[profile] {key[0]}/{key[1]}: profiled solve {wall:.1f} ms, "
            f"device busy {busy:.1f} ms (idle share "
            f"{1 - busy / wall:.3f}), {len(kern)} kernel names; kernel "
            f"records {seen_line(seen)}")
        for name, ms in top:
            log(f"[profile]   {ms:9.3f} ms  {name[:110]}")

    # -- 10. landmark point-to-point queries (before phase 9's updates) ----
    landmark_path(torch, np, cuda, g, ref_dist, keyed, counters)

    # -- 9. dynamic graphs: warm re-solves (updates phase 3's plans) -------
    launches_dyn, launches_lat, dyn_records = dynamic_path(
        torch, np, cuda, g, plans, counters)
    by_path.update(smallworld_warm=launches_dyn, lattice_warm=launches_lat)
    records.update(dyn_records)

    # -- 11. the tuner: estimator, measured search, cache, launcher --------
    launches_tune, tune_records, cache_path, cache_dir = tuning_path(
        torch, np, cuda, g, ref_dist, keyed, counters)
    by_path["smallworld_tune"] = launches_tune
    records["smallworld_tune"] = tune_records

    # -- 12. the serving tier: three tenants, the bench's traffic mix ------
    serve_launches, serve_records = serving_path(
        torch, np, cuda, g, ref_dist, keyed, counters, cache_path)
    cache_dir.cleanup()
    by_path.update(serve_launches)
    records.update(serve_records)

    # -- 13/14. the multi-GPU path and sharded serving, in one one-rank
    # NCCL group of this process (a FileStore in a temporary directory)
    import tempfile

    import torch.distributed as tdist
    group_dir = tempfile.TemporaryDirectory()
    tdist.init_process_group("nccl", store=tdist.FileStore(
        str(Path(group_dir.name) / "store"), 1), rank=0, world_size=1,
        device_id=cuda)
    try:
        # -- 13. sharded strategies, distributed engine ------------------
        launches_nccl1, launches_gloo, shard_record = sharded_path(
            torch, np, cuda, g, results, ref_dist, rec["frontier_relax"],
            counters)
        # -- 14. sharded serving ------------------------------------------
        launches_sserve = sharded_serving_path(
            torch, np, cuda, g, results, keyed, counters)
    finally:
        tdist.destroy_process_group()
        group_dir.cleanup()
    # a one-rank shard is the whole graph at base 0: phase 3's fused
    # solve's inputs (checked bitwise above), in both phases
    by_path.update(sharded_nccl1=launches_nccl1, sharded=launches_gloo,
                   sharded_serve=launches_sserve)
    records.update(
        sharded_nccl1={"frontier_relax": main_case["frontier_relax"]},
        sharded={"frontier_relax": shard_record},
        sharded_serve={"frontier_relax": main_case["frontier_relax"]})
    launches = {k: sum(p[k] for p in by_path.values()) for k in counters}

    # -- 15. LM decode serving (launches no SSSP kernel) --------------------
    lm_serving_path(torch, np, cuda, counters, smi)

    # -- 16. training (launches no SSSP kernel) -----------------------------
    training_path(torch, np, cuda, counters, smi)

    # -- 17. the mesh path (launches no SSSP kernel) ------------------------
    mesh_path(torch, np, cuda, counters, smi)

    # -- 18. the dry run (launches no SSSP kernel) --------------------------
    dryrun_path(torch, np, cuda, counters, smi)

    kernels = []
    scratch = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=cuda)

    def entry(name, source, replaces, make):
        """One kernels-line entry. ``make(args, kw, size)`` turns a
        recorded input into ``(kernel_fn, twin_fn, nbytes, ops, err,
        iters, yardstick)``; every path with a recorded input of the
        kernel is timed on it (its largest frontier in that path's run).
        ``yardstick`` is None or ``(what, fn)``: a PyTorch call that moves
        part of the kernel's bytes without computing its function, timed
        as ``ms`` is (``yardstick_ms``), to show what the card does with
        those bytes alone. ``ms`` and
        ``plain_ms`` are CUDA-event device times of back-to-back calls
        queued during a spin (``queued_ms``); ``wrapper_ms`` the same
        calls without the spin (host launch time included); ``cold_ms``
        one call at a time with the L2 emptied. The profiler only breaks
        a call's device time down by kernel, where it kept a record of
        every launch."""
        paths = {}
        counter = {name: counters[name]}
        for path, recs in records.items():
            if name not in recs:
                continue
            kernel_fn, twin_fn, nbytes, ops, err, iters, yard = make(
                *recs[name])
            twin_iters = max(1, iters // 4)
            wrapper_ms = timed_ms(torch, kernel_fn, iters)
            ms, ahead = queued_ms(torch, kernel_fn, iters, wrapper_ms)
            check(ahead, f"{name} ({path}): the host did not queue the "
                  "timed calls within the spin")
            plain_ms, plain_ahead = queued_ms(
                torch, twin_fn, twin_iters,
                timed_ms(torch, twin_fn, twin_iters))
            cold = cold_ms(torch, kernel_fn, iters, scratch)
            yard_ms = None
            if yard is not None:
                yard_ms, _ = queued_ms(torch, yard[1], iters,
                                       timed_ms(torch, yard[1], iters))
            kern, _, seen, _ = profiled(torch, kernel_fn, iters, counter)
            kept, n_launch = seen[name]
            own = OWN_KERNELS.get(name)
            check(own is None or kept < n_launch or (
                kept == n_launch and len(kern) <= len(own)
                and all(any(k in kname for k in own) for kname in kern)),
                f"{name} ({path}): a call runs {len(kern)} device "
                f"operations ({kept} records of {n_launch} launches), not "
                f"at most {len(own or ())} of its own: {', '.join(kern)}")
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / ALU_OPS_PER_S * 1e3
            bound = max(t_bytes, t_ops)
            check(ms >= bound and cold >= bound,
                  f"{name} ({path}): {ms:.4f} ms (L2 cold {cold:.4f} ms) "
                  f"is below the {bound:.4f} ms bound")
            paths[path] = {
                "launches": by_path[path][name], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "max_abs_err": err, "wrapper_ms": wrapper_ms,
                "cold_ms": cold, "bytes": nbytes, "ops": ops}
            if yard is not None:
                paths[path]["yardstick_ms"] = yard_ms
            if path == "gamemap":     # None: the profiler dropped records
                paths[path]["in_solve_ms"] = in_solve[name]
            log(f"[time] kernel {name} ({path}): {ms:.4f} ms/launch (CUDA "
                f"events, calls queued; wrapper_ms {wrapper_ms:.4f}, back "
                f"to back with the host's launch time; "
                f"L2 cold {cold:.4f} ms"
                + (f"; in the solve {in_solve[name]:.4f} ms"
                   if paths[path].get("in_solve_ms") is not None else "")
                + f"), twin {plain_ms:.4f} ms"
                + ("" if plain_ahead else " (it synchronises: host gaps "
                   "included)")
                + f", bound {bound:.4f} ms ({nbytes} bytes, {ops} ops), "
                f"launches {by_path[path][name]}; the profiler kept "
                f"{kept} records of {n_launch} launches"
                + ("" if kept == n_launch else ": no breakdown")
                + ("" if yard is None else
                   f"; yardstick {yard[0]}: {yard_ms:.4f} ms"))
            for kname, kms in (sorted(kern.items(), key=lambda kv: -kv[1])
                               if kept == n_launch else ()):
                log(f"[time]   {kms:.4f} ms  {kname[:100]}")
        total = sum(p["launches"] for p in paths.values())
        check(total == launches[name], f"{name}: a launching path is not "
              "timed")

        def mean(key):
            return sum(p["launches"] * p[key] for p in paths.values()) / total

        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(p["max_abs_err"] for p in paths.values()),
            "ms": mean("ms"), "cold_ms": mean("cold_ms"),
            "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"),
            "bound_by": ("bytes" if all(p["bound_by"] == "bytes"
                                        for p in paths.values())
                         else "operations"),
            "library_ms": None, "by_path": paths})
        log(f"[time] kernel {name}: launch-weighted {mean('ms'):.4f} "
            f"ms/launch, bound {mean('bound_ms'):.4f} ms; launches/solve "
            f"{ {k[0] + '/' + k[1]: v[name] for k, v in per_solve.items()} }")

    def scan_case(t_, e_, i_, delta):
        n = t_.shape[0]
        return (lambda: bucket_scan_cuda(t_, e_, i_, delta=delta),
                lambda: bucket_scan_ref(t_, e_, i_, delta=delta),
                9 * n + 8, 8 * n,
                same(torch, bucket_scan_cuda(t_, e_, i_, delta=delta),
                     bucket_scan_ref(t_, e_, i_, delta=delta)), 40,
                ("torch.lt(tent, explored), its bytes without the "
                 "reduction", lambda: torch.lt(t_, e_)))

    entry("bucket_scan", "src/repro_torch/csrc/bucket_scan.cu",
          "src/repro/kernels/bucket_scan/bucket_scan.py:36",
          lambda args, kw, size: scan_case(*args, kw["delta"]))

    def relax_case(fidx, dist, w_ell, m):
        cap, dd = fidx.shape[0], w_ell.shape[1]
        filled = torch.empty((cap, dd), dtype=torch.int32, device=cuda)
        return (lambda: ell_relax_cuda(fidx, dist, w_ell),
                lambda: ell_relax_ref(fidx, dist, w_ell),
                4 * cap + 4 * m + 4 * dd * (m + int(m < cap)) + 4 * cap * dd,
                4 * cap * dd,
                same(torch, (ell_relax_cuda(fidx, dist, w_ell),),
                     (ell_relax_ref(fidx, dist, w_ell),)), 20,
                ("fill_ of the [cap, D] output, its writes alone",
                 lambda: filled.fill_(INF)))

    entry("ell_relax", "src/repro_torch/csrc/ell_relax.cu",
          "src/repro/kernels/ell_relax/ell_relax.py:29",
          lambda args, kw, m: relax_case(*args, m))

    def fr_case(args, kw, pop):
        d, w = args[0], args[4]
        cap, dd = kw["cap"], w.shape[1]
        filled = min(pop, cap)
        out_n = torch.empty((cap, dd), dtype=torch.int32, device=cuda)
        out_w = torch.empty_like(out_n)
        return (lambda: run_fr(args, kw, frontier_relax_cuda),
                lambda: run_fr(args, kw, frontier_relax_ref),
                8 * d.shape[0] + 4 * cap + 8 * cap * dd
                + 8 * dd * (filled + int(filled < cap)) + 12,
                8 * d.shape[0] + 2 * cap * dd,
                same(torch, run_fr(args, kw, frontier_relax_cuda),
                     run_fr(args, kw, frontier_relax_ref)), 20,
                ("fill_ of the two [cap, D] outputs, their writes alone",
                 lambda: (out_n.fill_(INF), out_w.fill_(INF))))

    entry("frontier_relax", "src/repro_torch/csrc/frontier_relax.cu",
          "src/repro/kernels/frontier_relax/frontier_relax.py:57", fr_case)

    def grid_case(args, kw, size):
        t_, f_, i_ = args
        hw = t_.numel()
        moves = 4   # one move class per phase at Δ = 13: 4 straight or
        #             4 diagonal
        return (lambda: grid_relax_cuda(t_, f_, i_, **kw),
                lambda: grid_relax_ref(t_, f_, i_, **kw),
                9 * hw, hw * (3 + 3 * moves + 2),
                same(torch, (grid_relax_cuda(t_, f_, i_, **kw),),
                     (grid_relax_ref(t_, f_, i_, **kw),)), 40, None)

    entry("grid_relax", "src/repro_torch/csrc/grid_relax.cu",
          "src/repro/kernels/grid_relax/grid_relax.py:45", grid_case)
    torch.cuda.synchronize()

    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    child = {"--sharded-rank": sharded_rank, "--serve-rank": serve_rank}
    if sys.argv[1:2] and sys.argv[1] in child:
        sys.exit(child[sys.argv[1]](int(sys.argv[2]), int(sys.argv[3]),
                                    sys.argv[4]))
    if sys.argv[1:2] == ["--train-restart"]:
        sys.exit(train_restart(sys.argv[2]))
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    if sys.argv[1:2] == ["--capped-host"]:
        sys.exit(capped_host(sys.argv[2]))
    if sys.argv[1:2] == ["--dryrun"]:
        sys.exit(dryrun_child(sys.argv[2], int(sys.argv[3])))
    sys.exit(main())
