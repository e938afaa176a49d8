"""Smoke run of the PyTorch + CUDA port (sdpcutsel_tpu_torch) on one GPU.

    python3 chip_smoke.py [--parent DIR] [--phases GROUPS]

--phases runs some of the groups 3, 4, 5-13, 15-17, 18-21, 22, 23, 24, 25,
26 and 27 (comma-separated; the default runs every one, and only then prints
the kernels line; the build and phase 1 always run).

Phases, each printed on its own lines; any failure exits non-zero:
  1. environment: the card (nvidia-smi name and power limit), CUDA, nvcc,
     triton; no CUDA device -> exit 2 before any result is printed;
  2. build the kernels from csrc/ (thirteen sources), one nvcc each, in
     parallel (timed as set-up), and beside them a variant of the scoring
     kernels without the Jacobi's overflow guard
     (scoring_variants.UNGUARDED); print ptxas's registers and spills, and for the scoring kernels (K1, K3, K4
     at k = 2..5) their persistent grid, their dynamic shared memory and
     the tensor-core (HMMA) instructions that cuobjdump finds in each (no
     TF32 HMMA, or a spill, fails);
  3. check each kernel against its plain PyTorch twin on the card at the
     main paths' shapes, and time both with CUDA events (the scoring
     kernels also on the device, with the profiler):
       pair_score   n = 125, all 317,750 candidates of spar125-100-1, and
                    the 1,140 of spar020-100-1 with 6 sweeps (checked only);
       pair_packed  n = 125, the 507,904 slots of the packed layout on
                    spar125-100-1's Q: the 317,750 valid ones against the
                    twin, and bit for bit against pair_score on the same
                    triples; the rest -inf;
       pdhg_block   n = 125, M = 1024 with 400 active unit k = 3 cuts, and
                    n = 100 with the 25 dense rows of qcqpband100-5-25-1 and
                    400 active k = 5 cuts (some supports repeat an index);
                    blocks of 7 and 100 iterations, two runs bit for bit, the
                    inputs unchanged; its cluster plan and ptxas report, and
                    the portable cluster of 8 checked and timed in turns
                    with the plan's;
       pdhg_check   (K5, the checked block's control, in K2's launch: the
                    checked form of csrc/pdhg_block.cu) at K2's two shapes:
                    the checked launch (100 iterations, then the control)
                    against K2's unchecked launch followed by the twin check
                    with restart_period 10^9 and 100 (err, p, d, omega,
                    tau, sigma, the distances at rtol 1e-5, the record's
                    ints equal, the state, sums and anchor bit for bit),
                    twice bit for bit, a stopped record left as it is; its
                    time on the device in turns with the unchecked launch;
       pdhg_norm    (K6, 30 power iterations in one launch, the iterate and
                    the dense rows' slice in shared memory) at K2's two
                    shapes against its twin at rtol 1e-5, twice bit for bit,
                    from the start vector kept on the device; ptxas without
                    a spill;
       pdhg_dense   (K7, csrc/pdhg_dense.cu: the certifier's LP, a pool
                    without cuts and m dense rows) at n = 10 with m = 368
                    and at n = 125 with m = 368 and 2048 (the full buffer),
                    its block and norm also at n = 64 over 2048 rows, on
                    normalised rank-1 rows and a random state: the block
                    (its launch plan by shape: one CTA, or every SM, the
                    CTAs printed) against pdhg_block_plain after 100
                    iterations at rtol = atol = 2e-5, twice bit for bit,
                    the in-place block with the record's steps bit for bit,
                    at the one-CTA shapes the grid plan too, checked and
                    timed in turns; its checked launch (K7c, the check as
                    the epilogue of K7's block) against the unchecked block
                    followed by pdhg_check_plain as K5 is held (rtol 1e-5,
                    restart periods 10^9 and 100, the states bit for bit, a
                    stopped record), K7c's time the checked launch's less
                    the block's, in turns; its norm (K7n, on the block's
                    launch plan, the plan and CTAs printed) against
                    estimate_norm_plain as K6 is held, its C entry alone bit
                    for bit with the wrapper, ptxas without a spill or a
                    stack; each timed by events back to back and on the
                    device (events around one launch queued behind a sleep
                    kernel) beside its bound and the figure for G streamed
                    (twice an iteration, or once where it stays resident);
       with --parent DIR (a checkout of the parent commit): K2's bits on
                    these inputs equal to the parent build's, 7 and 100
                    iterations, both timed in turns; the checked launch's
                    bits equal to the parent build's checked launch at both
                    shapes and at the B = 12 batch, restart_period 10^9 and
                    100, timed in turns; K6's
                    bits (m = 0, m = 25, B = 12) equal to the parent
                    build's, both C entries timed on the device in turns;
                    K7's block and its checked launch bit for bit equal to
                    the parent build's, each timed on the device in turns
                    with the parent's, and K7n through each tree's own
                    wrapper, in turns (and
                    after phase 15 the certifier's LP timed in both trees,
                    see there);
     each kernel's time stands beside its bound (the largest of its
     operations over 67 TFLOP/s fp32, those it runs on the tensor cores over
     495 TFLOP/s dense TF32, and its bytes, each input read and each output
     written once, over 3.35 TB/s) and its roofline share;
       pdhg_block   batched: the twelve n = 125 instances of the suite bucket
                    (below), each with its own pool of 400 random active cuts,
                    one instance left out of the launch: against the twin, the
                    one left out unchanged bit for bit, every other one bit for
                    bit equal to a batch of one and to the single wrapper; the
                    clusters of 16 and of 8 the card runs at once; the batch
                    timed at a cluster of 16 and of 8, in turns; then K5 and
                    K6 on the same batch after one batched K2 block, one
                    instance's record stopped: against their twins, the
                    stopped one unchanged, each instance equal to its
                    single launch, timed;
       fused_score  k = 2 over C(125, 2) and k = 3 over C(30, 3) (5 sweeps);
                    k = 4 and 5 over the clique tables of qcqp025-25-4-2
                    and qcqpband100-5-25-1 (6 sweeps); with its launch grid;
     and the guard (at the end of the run, once the variant's
     build, which runs beside the phases, is done): K1 on all of C(125, 3)
     and K4 at k = 5 on both clique tables give the unguarded variant's bits
     (torch.equal), timed in turns (the variant's entry points called
     directly, outside the wrappers);
  4. the rounds on the card against the CPU port (whose rounds run in the
     host references' processes, compared at the end of the run), 3 rounds
     each:
     spar020-100-1 at k = 3 and at k = 2, qcqp015-30-3-1 at k = 5; 2
     rounds of the packed route (generate_spar(70, 100, 1), feasibility);
     spar020-100-1 with strategies triangle, optimality and random, and
     neural with vertex steering (the random draws come from a CPU
     generator, so both devices see the same numbers);
     spar150-100-1 with CutConfig(capacity=81920),
     past every shared layout: one round by default, taken by the grid
     route's far form; generate_spar(300, 100, 1), past K2's cluster: 2 rounds by
     default on K1 and the grid route's kernels (no K2, no plain block, twin
     check or norm), each round within rtol 2e-3 of one CPU run of the port;
     and spar150-100-1 (generated, the kernels' 256-column
     form), 2 rounds by default on K1, K2, K5 and K6 (no plain block, twin
     check or norm) and 2 with LPConfig(use_kernel="off") on the plain loop,
     K2 not launched, each against the CPU port's 2 rounds;
 18. the wide phase (run after phase 4): K2 (7 and 100 iterations, its
     plan and both widths' ptxas), its checked launch (K5) and K6 against
     their twins at phase 3's tolerances, twice bit for bit, each timed
     beside its bound, at n = 150 and 256 with M = 1024 and 400 active unit
     k = 3 cuts and at n = 150 with k = 5 cuts and generate_qcqp(150, 30,
     16, 1)'s 16 dense rows; 4 x generate_spar(150, 100, s + 1) in one
     launch (K2, then K5 and K6), each instance bit for bit with its batch
     of one; K7, K7c and K7n at n = 150 with m = 368 and n = 256 with
     m = 368 and 2048, as phase 3 holds them; K1 over all 2,763,520
     candidates of C(256, 3); CutSolver on generate_spar(256, 100, 1)
     (default cuts, neural, LPConfig(20000, 2e-6), "auto"), 5 rounds twice
     bit for bit, on K1, K2, K5 and K6 alone, every certificate at least a
     feasible point's objective, its rounds/s and synchronised stage split
     (profile_round.stage_split); the certifier at n = 150 (phase 15 (c)'s
     settings on generate_spar(150, 100, 1)), twice bit for bit, on the
     dense route alone, every certificate at least the BM lb; with --parent
     DIR, K2 (7 and 100 iterations), its checked launch, K6, K7, K7c and K7n
     at these shapes bit for bit equal to the parent build's;
 19. the grid route (run after phase 18; csrc/pdhg_grid.cu, the shapes K2's
     cluster refuses): its block, checked launch and norm against their
     twins (pdhg_block_plain at 7 and 100 iterations; the block then
     pdhg_check_plain at restart periods 10^9 and 100, a stopped record;
     estimate_norm_plain at rtol 1e-5), twice bit for bit, each timed on the
     device beside its bound, at n = 300 and 512 with M = 1024 and 400
     active k = 3 cuts, at n = 200 with k = 5 cuts and 25 dense rows and at
     n = 150 with 64, and in its form without cuts (the dense route's past
     n = 256) at n = 300 over 368 certifier rows; ptxas without a spill or
     a stack; K1 over all 22,238,720 triples of C(512, 3); CutSolver on
     spar512-100-1 (generate_spar(512, 100, 1)) with the defaults, 3 rounds
     with "auto" twice bit for bit, on K1 and the grid route alone (no K2,
     no plain block or twin); CutSolverQCQP on generate_qcqp_band(200, 5,
     25, 1) (k = 5, sel_size 16, LPConfig(3000, 1e-5)), 2 rounds within
     rtol 2e-3 a round of the CPU port, on K4 and the grid route; the
     certifier at n = 300 (3 plain eigencut rounds of phase 15 (c)'s LP),
     twice bit for bit, on the grid route's form without cuts; its time
     printed;
 20. grid batches (run after phase 19; the grid route's instance walk, one
     cooperative launch running a batch's instances one after another): (a)
     the batched block, checked launch and norm at B = 4 on phase 3's pool
     and random state style at n = 512 (k = 3), n = 200 (k = 5, 25 dense
     rows) and n = 201 (the same, G's instance stride not a multiple of 4
     floats): against the batched twins at phase 19's tolerances, an
     instance left out of ids or stopped in its record unchanged bit for
     bit, every other instance bit for bit the single entry's, twice bit
     for bit, ptxas without a spill; each batched launch timed on the
     device in turns with the four single launches, beside the batch's
     bound; (b) 4 x generate_spar(512, 100, s + 1) in BATCH_KNOBS, 5
     per-round steps twice bit for bit, then the 5-round scan equal to
     them: every certificate at least its instance's feasible objective,
     the running bounds monotone, instance-rounds/s; one batched grid
     checked launch a checked block, one batched norm a solve, K1 once an
     instance a round, no K2 and no plain block, twin check or twin-scored
     call; (c) 4 x generate_qcqp_band(200, 5, 25, s) (k = 5 over the band
     graph's clique table, sel_size 16, LPConfig(3000, 1e-5)), 2 rounds
     twice bit for bit, the first within rtol 2e-3 of the CPU port's
     batched round (run in the host references' process, compared at the
     end of the run), K4 once an instance a round and (b)'s launch checks;
     (d) python3 -m sdpcutsel_tpu_torch.bench_batched --n 300 --batch 4
     --rounds 3 in a subprocess runs to its end; with --parent DIR, the
     single-instance grid entries at phase 19's shapes bit for bit the
     parent build's, the block timed in turns with it;
 21. the grid route's 1024-column form (run after phase 20; 512 < n <= 1024,
     the owned state in global memory): its block, checked launch and norm
     against their twins at phase 19's tolerances, twice bit for bit, each
     timed on the device beside its bound, at n = 600 and 1024 with
     M = 1024 and 400 active k = 3 cuts, at n = 700 with k = 5 cuts and 25
     dense rows, in its form without cuts at n = 600 over 368 certifier
     rows, and the walk at B = 2, n = 1024 (each instance bit for bit its
     single entry's); ptxas without a spill or a stack; K1 over all
     178,433,024 triples of C(1024, 3) (2.1 GB of table on the card), held
     to its twin in 8M-row chunks; CutSolver on generate_spar(1024, 100, 1)
     with the defaults, 3 rounds with "auto" twice bit for bit, on K1 and
     the grid route alone, every certificate at least a feasible point's
     objective, its rounds/s and synchronised stage split;
     CutSolverQCQP on generate_qcqp_band(600, 5, 25, 1) at phase 19's
     settings, 2 rounds twice bit for bit on K4 and the grid route, the
     first within rtol 2e-3 of the CPU port; the certifier at n = 600 (3
     plain eigencut rounds), twice bit for bit, on the form without cuts,
     every certificate at least the Burer-Monteiro lb.  The host's part
     (the BM lb and the CPU port's band round, minutes at n = 600; phases 4
     and 19's CPU rounds, phases 22-24's references) runs in subprocesses
     of their own (--host-references, HOST_PROCESSES of them) from the end
     of the build, and those comparisons close the run, after phase 17;
 22. any pool and any number of dense rows (run after phase 21; the grid
     route's far form, csrc/pdhg_grid.cuh kFar: no replica of the cut
     weights or of yD in shared memory, a CTA's slots past 512 walked in
     place in the outputs): (a) its block (7 and 100 iterations), checked
     launch (restart periods 10^9 and 100, a stopped record) and norm
     against their twins at phase 19's tolerances, twice bit for bit, each
     timed on the device beside its bound, at n = 125 with M = 81,920 and
     2,000 active k = 3 cuts, n = 300 with M = 32,768, n = 300 with k = 5
     cuts and 6,000 dense rows (2.16 GB of G, made on the card), n = 600
     with M = 49,152, and in its form without cuts (the certifier's pool
     past the rows K7 and the shared layout hold) at n = 300 over 7,000 rows
     and n = 64 over 23,000; the walk at B = 2 at the second shape (each
     instance its single entry's bits); ptxas without a spill or a stack in
     any grid kernel; (b) the far form forced (the wrappers' private _far)
     at phase 19's shapes n = 512 and n = 200 with 25 rows gives the shared
     form's bits (block, checked launch, norm), both timed in turns; (c)
     CutSolver on generate_spar(300, 100, 1) with the defaults but
     CutConfig(capacity=81920), 2 rounds with "auto" twice bit for bit, on K1
     and the far form alone, every certificate at least a feasible point's
     objective, rounds/s and the synchronised stage split; its round 0
     within rtol 2e-3 of the CPU port's, computed in the host references'
     process and compared at the end of the run;
 23. past n = 1024 (run after phase 22; the grid route's 2048-column form,
     GridForm<kVast>: 1024 < n <= 2048, the owned state in global memory,
     the dense rows read in place): (a) its block, checked launch and norm
     against their twins at phase 19's tolerances, twice bit for bit, each
     timed on the device beside its bound, at n = 1100 and 2048 with
     M = 1024 and 400 active k = 3 cuts, at n = 1500 with k = 5 cuts and
     generate_qcqp(1500, 30, 25, 1)'s 25 dense rows, in the far form at
     n = 2048 with M = 65,536, without cuts at n = 1500 over 64 certifier
     rows, and the walk at B = 2, n = 2048; ptxas of the 12 new kernels
     without a spill or a stack; (b) K1 over all 1,429,559,296 triples of
     C(2048, 3) (17.2 GB of table written on the card) in its two launches,
     the first and last 8M rows and 8M rows around the launch boundary
     against the twin, two calls bit for bit, and at n = 1024 a forced split
     with the one launch's bits; (c) CutSolver on generate_spar(2048, 100, 1)
     with the defaults, 1 round (cut from 3 for phase 24) with "auto" twice bit for
     bit on K1 (two launches a round) and the 2048-column form alone, every
     certificate at
     least a feasible point's objective, round 0 within 1e-2 of the
     McCormick bound the plain loop certifies on the card, rounds/s, the
     card's peak memory (no third run for the stage split);
     at n = 1100 round
     0 within rtol 2e-3 of the same round with use_kernel="off" and K1's
     twin as the scores on the card; (d) CutSolverQCQP on
     generate_qcqp_band(1500, 5, 25, 1) at phase 19's settings, 1 round (cut
     from 2 for phase 24) twice bit for bit, round 0 within rtol 2e-3 of
     "off" on the card; (e) the certifier at n = 1100, capacity 64, 1
     eigencut round (cut from 2) twice bit for bit on the form without cuts, every
     certificate at least the
     Burer-Monteiro lb (a run cut to 400 iterations, in the host
     references' process, compared at the end of the run);
 24. past n = 2048 (run after phase 23; the grid route's open form,
     GridForm<kOpen>: no cap on what a CTA owns, its owned entries' buffer
     and x entries in global memory; k = 3 rounds scored and selected a
     piece of the table at a time): (a) its block, checked launch and norm
     against their twins at phase 19's tolerances, twice bit for bit, each
     timed on the device beside its bound, at n = 2049, 4096 and 6000 with
     M = 1024 and 400 active k = 3 cuts, at n = 3000 with k = 5 cuts and
     generate_qcqp(3000, 30, 25, 1)'s 25 dense rows, in the far form at
     n = 4096 with M = 65,536, without cuts at n = 3000 over 64 certifier
     rows, and the walk at B = 2, n = 4096; ptxas of the 12 new kernels
     without a spill or a stack; the open form forced at n = 2048 and at
     n = 1500 with 25 rows against the 2048-column form (block, checked
     launch, norm: bit for bit, or within the twins' tolerances), the block
     timed in turns with it; (b) K1 over the first piece of C(4096, 3) (its
     rows written on the card) against the twin on its first and last 8M
     rows, twice bit for bit; (c) CutSolver on generate_spar(4096, 100, 1)
     with the defaults but LPConfig(3000, 1e-5) (cut from LPConfig() for
     phase 25), 1 round (cut from 2 for phase 25) by pieces (K1
     over all 11,444,858,880 triples a round, a launch a piece; the open
     form for every LP and norm), every certificate at least a feasible
     point's objective, a fresh solver's round 0 bit for bit, rounds/s,
     the card's peak memory and the survivors' largest count; at n = 2100
     round 0 by pieces and on the whole table (18.5 GB) at
     LPConfig(3000, 1e-5) (cut from LPConfig() for phase 25), the picks and
     the cut rows bit for bit; (d) CutSolverQCQP on generate_qcqp_band(3000, 5,
     25, 1) at phase 19's settings, 1 round (cut from 2 for phase 25)
     twice bit for bit; (e) the
     certifier at n = 2100, capacity 64, one eigencut round on the open
     form without cuts, every certificate at least the Burer-Monteiro lb
     (host references, compared at the end of the run); (f) n = 46,341,
     past the open form's 32-bit bound, refused by the solve's set-up with
     the route's reason for a pool of cuts and for the certifier's pool;
 25. random, triangle and optimality at k = 3 by pieces of the table (run
     after phase 24; loop/solver.py's piecewise route past each strategy's
     n, every round at LPConfig(3000, 1e-5), counters reset before each and
     read after: the grid route's kernels, or K2, K5 and K6 at n = 125; no
     plain block or twin): (a) generate_spar(1024, 100, 1), round 0 of
     random and of triangle by forced pieces (2^25 rows at most) and on the
     whole table: the picks, the cut rows, the pool, the outcome and the
     generator's state bit for bit, each route's peak on the card a table
     row; (b) optimality on spar125-100-1, round 0 by 8 forced pieces of
     whole eigh chunks against the whole table: the ADMM's scores, picks,
     cut rows and round bit for bit; one default-size piece of C(1024, 3)
     through the ADMM, its time by events and the card's peak a row; (c) the
     default route past n = 2048, twice from a fresh solver bit for bit:
     triangle and random on generate_spar(2100, 100, 1) (the host draw's
     seconds printed), each
     certificate at least a feasible point's objective, the card's peak and
     the survivors' largest count printed;
 26. BoxQP at k = 4 and 5 by pieces of the table (run after phase 25;
     loop/solver.py's piecewise route past PIECE_N_OF[strategy, k]: each
     piece's rows written on the card from the pair table, its features
     and K4 each round; every round at LPConfig(3000, 1e-5), counters reset
     before each and read after; no plain block or twin): (a) round 0 by
     forced pieces (2^24 rows) and on the whole table, bit for bit (picks,
     cut rows, pool, outcome, generator's state), K4 once a piece, each
     route's peak on the card a table row: k = 4 neural and random on
     generate_spar(200, 100, 1), k = 5 neural on generate_spar(80, 100, 1);
     k = 4 optimality on spar020-100-1 by pieces of whole eigh chunks (the
     ADMM's scores too), and the ADMM's peak a row at k = 4 and 5; (b) the
     default route, neural, twice from a fresh solver bit for bit: k = 4 on
     generate_spar(512, 100, 1) (past 2^31 rows), k = 5 (sel_size 10) on
     generate_spar(200, 100, 1); each certificate at least a feasible
     point's objective, the survivors' largest count under a cap, the
     card's peak (under 10 GB at k = 4); K4 over the piece at row 2^31
     against its twin at both ends, timed by events beside its bound, with
     the rows' and the features' times; (c) spar125-100-1 at k = 5,
     sel_size 10, by the route its threshold picks, at phase 5's LP: round
     0 within 1e-2 of McCormick, the certificate at least the best known
     objective;
 27. the batched round by pieces of the table (run after phase 26;
     parallel/round.py with BATCH_KNOBS at kmax k, capacity 1024, 4 x
     generate_spar(n, 100, s + 1), round 0 from a fresh state, counters
     reset before and read after; no plain block or twin): (a) by forced
     pieces (BPIECES_FORCED rows, shard edges inside them) and on the whole
     batched route, bit for bit (picks, cut rows, pools, PDHG states, f32
     bounds, generators' states), at mesh cand 1 and 3, neural and random:
     n = 512 at k = 3 (a padded row in the last of 3 shards), n = 80 at
     k = 4, n = 40 at k = 5; K1 or K4 once an instance a piece; each route's
     peak on the card an instance-row; (b) n = 2100 at k = 3 on the default
     route (shard_combinations writes no table, the LP on the grid route's
     open form) and (c) n = 200 at k = 4 (the written table by pieces),
     neural, twice bit for bit, each certify_batched_f64 at least a
     feasible point's objective, the card's peak and one piece's split
     (its rows, the scores, the merge); (d) K4 against its twin at the
     shapes of every path that launches it (the band100 clique table at
     k = 5, a piece of C(125, 5), phase 26's and this phase's pieces,
     131,072 random rows of C(200, k) at k = 2..5): nn within the north
     star's rtol = atol = 2e-4, its share of the reference kernel's rtol
     2e-4 / atol 2e-5 printed beside;
  5. the BoxQP main path: CutSolver on spar125-100-1, strategy neural,
     default cuts, LPConfig(max_iters=20000, tol=2e-6), 10 rounds, with the
     launch counters reset before and read after; the bounds are held to
     the instance registry (data/boxqp/bounds.json, optima.json), and a
     second run from a fresh solver must repeat the first bit for bit;
  6. the QCQP main path: CutSolverQCQP on qcqpband100-5-25-1 in the
     configuration of scripts/run_qcqp_suite.py (k = 5, sel_size 16,
     capacity 1024, LPConfig(max_iters=20000, tol=2e-6), polish 60,000
     iterations), 8 rounds, counters reset before and read after; the
     bounds are held to data/qcqp/bounds.json and to the JAX package's
     recorded round 0 (results/qcqp.jsonl), and a second run, round by
     round, must repeat the first bit for bit, polish included, while K4 is
     held to its twin at every round's LP point;
  7. the packed scan path: CutSolver on spar125-100-1 with
     CutConfig(pair_layout="packed"), strategy neural, the same LP,
     LoopConfig(use_scan=True), 10 rounds after a one-round warm-up, counters
     reset before and read after (pair_packed and pdhg_block launched,
     pair_score not); the same bound checks as phase 5, and a second scan
     run and a per-round run of the same configuration must both repeat
     every round bit for bit;
  8. the steered QCQP scan: phase 6's configuration with use_scan and
     steer_eps 1e-3 (4,000 steering iterations a round), 8 rounds and the
     polish, twice, bit for bit; K2 launched exactly once a round for
     steering beside the solves' blocks; every certificate >= sdp_lower;
     steering's time a round; a per-round run writing a snapshot every
     round repeats the scan bit for bit, and a fresh solver restored from
     round 4's snapshot repeats rounds 5-8 and the polish, gate state
     included;
  9. resume on the BoxQP main path: a run with a snapshot every round, and
     a fresh solver restored from round 5's, both repeat phase 5's rounds
     bit for bit;
 10. the strategies at full width, each run twice, bit for bit, every
     certificate valid: spar125-100-1 with triangle and random (5 rounds)
     and optimality (2 rounds, with the ADMM's time a round and its
     repeatability); qcqpband100-5-25-1 at k = 4 with feasibility, random
     and optimality (8 rounds and the polish); gap closed printed beside the
     JAX package's records (results/suite.jsonl, results/qcqp.jsonl);
 11. the batched suite bucket (parallel/round.py): the twelve
     spar125-{25,50,75,100}-{1,2,3} of data/boxqp as one batch in
     scripts/bench_batched.py --suite's configuration (capacity 1024, k = 3,
     lp_iters 400, sel_size 16, neural, Mesh(1, 1)), 10 per-round steps,
     certify_batched_f64: every certificate finite and >= the instance's
     best known (optima.json), the running bounds monotone, a second run
     bit for bit, instances 0 and 7 as batches of one within rtol 2e-3 (bit
     equality printed), gap closed printed; the batched K2 launches cover
     the batch's checked blocks, pair_score once an instance a round;
 12. bench.py:188-223's batched configuration: 8 x generate_spar(30, 100,
     s + 1), scan mode, 10 rounds, certify_scan_f64; the scan repeats its
     per-round run bit for bit; instance-rounds/s, the median of 3 after a
     warm-up, beside the card's name and power limit (not a benchmark line);
 13. scripts/bench_batched.py --qcqp at its defaults: generate_qcqp_family(30,
     30, 2, 1, 8), the chordal clique table at k = 4, 2 dense rows, 6
     per-round steps (K4 once an instance a round, the batched K2 with the
     dense rows), the first 2 rounds within rtol 2e-3 of the CPU port;
 15. the certifiers and the CLI (run after phase 13; registries read
     from the repository and written only in a temporary directory):
     (a) ensure_certified_bounds misses on generate_spar(12, 100, 3) at
     tests/test_sdp_bound.py's sandwich settings (LPConfig(8000, 2e-6), 40
     rounds): sdp_ok, sdp_lower <= sdp, sdp_rel_width <= 1e-3, the LP on
     the dense route (dense_route_checks: K7's checked launches, each
     carrying K7c, and its norm; no standalone check, no plain block or
     twin on the card), within rtol 2e-3 of the CPU port; a
     second call hits and runs no LP block;
     (b) validate_sdp_bound on generate_qcqp(10, 40, 2, 1) (LPConfig(6000,
     2e-6), 8 rounds, cut from the test's 40): lb <= ub, rel <= 5e-3, the
     dense route's checks; (c) spar125-100-1 at full
     width: the Burer-Monteiro point on the host (lb <= the registry's
     sdp), then 3 in-out eigencut rounds of LPConfig(2000, 2e-6) on the card
     over a 2048-row dense buffer (128 MB) seeded with its null directions,
     purge_at one past the seed rows: every certificate >= the registry's
     sdp_lower and >= the BM lb, the purge run, the dense route's checks, a
     second run bit for bit; each round's seconds split into LP,
     dual_bound_f64, host eigh, uploads and purge, and the microseconds of a
     certifier LP iteration beside the card's name and power limit (with
     --parent DIR, then (c) and (b) through the parent checkout's package,
     imported under another name, and through this tree's, in turns: parent,
     this, this, parent after a warm-up, each run's microseconds a certifier
     LP iteration and round split); (d) the CLI
     on the card: solve spar020-100-1 (5 rounds, a registry hit) equal bit
     for bit to CutSolver on the CLI's own configuration, gap closed > 0,
     every certificate >= the best known; solve qcqp015-30-3-1 at k = 5 (K4
     and K2) with --trace (a torch.profiler trace holding device kernels);
     suite over spar020-100-1 with neural and feasibility (3
     rounds): 2 records and a summary, platform "cuda"; the repository's
     bounds.json files unchanged (sha256);
 16. training (run after phase 15; weights written only in a temporary
     directory): (a) ``cli train --k 3`` in-process at the reference's
     full defaults (200,000 ADMM-labelled samples, the harvest of 8 BoxQP
     instances x 4 feasibility rounds through K1 and K2, 4,000 Adam steps
     of batch 4,096): the split (labelling, harvest, steps/s), the launches
     (K1 and K2, no plain block, no twin), the metrics line, holdout
     Spearman and top-decile precision each >= the JAX package's CPU run
     minus 0.05, the datasets, the MLP and Adam's moments on the card;
     (b) ``cli train --k 4``, uncut (K4 and K2 with dense rows in the QCQP
     harvest), the same split and launches;
     (c) 10 rounds of spar125-100-1, strategy neural, with the weights of
     (a): K1 with them held to its twin, phase 5's checks, gap closed > 0
     printed beside phase 5's; (d) train_scorer twice from one seed at
     TRAIN_REPEAT's reduced setting: the weights and the metrics (but the
     time) repeat bit for bit; (e) the shipped weights and the
     registries keep their sha256;
 17. multi-process parallel/ (run after phase 16): every rank a subprocess of
     python3 -m with a time limit, two ranks sharing the card over gloo:
     (a) multichip_dryrun at 2 x 1 and 1 x 2 (its BoxQP and QCQP scans
     within 1e-5 of Mesh(1, 1), and bit for bit against each 'data' shard's
     batch at Mesh(1, cand)); (b) run_multihost with spar125-100-1 alone at
     1 x 2 in the suite bucket's knobs (capacity 1024, lp_iters 400,
     sel_size 16, neural, 10 steps), each rank scoring 158,875 of the
     317,750 candidates through K1: bit for bit against the in-process
     Mesh(1, 2) run, within rtol 2e-5 of Mesh(1, 1); (c) run_multihost with
     bench.py's batched scan (8 x generate_spar(30, 100, s + 1), 10 rounds)
     at 2 x 1: bit for bit against the two 4-instance batches run here; (d)
     run_multihost at world size 1 over NCCL; (e) run_suite_incremental on
     one cell (spar020-100-1, feasibility, 2 rounds) into a temporary file,
     and a second call skips it; every rank's launches (the plain PDHG
     blocks and the twin-scored calls 0 on each) join the kernels line;
 14. one JSON line of kernel results (twenty-one entries), each kernel's
     launches summed over the main paths 5-13, 15-17 and the wide, grid,
     1024-, 2048-column, open and pieces paths of phases 4, 18-27 (each
     counted from 0;
     the sums over the paths at n <= 128 alone are printed before the line);
     the grid route's entries hold spar512's shape, every shape under
     "shapes", phase 20's batched launches under "batched"; its 1024-column
     form's three entries n = 1024's shape and phase 21's launches, its
     2048-column form's three n = 2048's and phase 23's, its open form's
     three n = 4096's and phase 24's (the forced comparison under "forced");
     K1's the n = 512, n = 1024 and n = 2048 numbers ("n512", "n1024",
     "n2048") and a piece of C(4096, 3)'s ("n4096 piece"); K1's and K4's
     phase 27's launches and split of a piece under "batched pieces", K4's
     largest shares of its two nn tolerances over every path's shape under
     "every path's shape"; the grid entries
     also hold phase 22's shapes of the far form under "far" (with its
     launches on phase 22's solve and, in the block's, the forced form
     against the shared one); K2's entry also holds the
     batched launch's time, bound and the clusters the card runs at once,
     and K1, K2, K5, K6 and K7's entries the wide shapes' numbers ("n256",
     "wide", "shapes"); the total seconds beside a 900 s budget, then the
     last line {"ok": true, "device": {...}}.
Every path's launch counts include the solve's plain PDHG blocks on the
card ("pdhg_block plain"), its twin checks and norms there ("check/norm
plain") and the scoring twins called on the card ("twin-scored"), which must
be 0 on every main path, the certifier's runs (a)-(c) of phase 15 included:
their LP takes the dense route.  Every main path that runs K2 also holds the
solves' control to the reference's structure (control_checks): K5 once a
solve block, in K2's launch (the checked launches, counted under
"pdhg_check": every K2 launch but steering's), K6 once a solve, at most
one host read of the control record a group of GROUP_BLOCKS blocks plus
one a solve ("solve reads", "solves").

TF32 is turned off for the whole process at its start: the scoring twin's
MLP runs as cuBLAS matrix products, and it agrees with the kernel to 2e-4
only in full float32.  The solver itself does no cuBLAS product on CUDA.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import dataclasses
import gc
import glob
import hashlib
import importlib
import importlib.util
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from sdpcutsel_tpu_torch import _build, cli
from sdpcutsel_tpu_torch.config import CutConfig, LoopConfig, LPConfig, RunConfig, ScorerConfig
from sdpcutsel_tpu_torch.cuts import triangle as triangle_mod
from sdpcutsel_tpu_torch.cuts.enumerate import (combinations_range_on, combinations_rows_on,
                                                combinations_table, combinations_table_on,
                                                first_index_pieces, range_pieces)
from sdpcutsel_tpu_torch.instances import (generate_qcqp_family, generate_spar,
                                           load_or_generate, load_or_generate_qcqp, parse_boxqp)
from sdpcutsel_tpu_torch.instances.qcqp import generate_qcqp, generate_qcqp_band
from sdpcutsel_tpu_torch.loop import CutSolver
from sdpcutsel_tpu_torch.loop import solver as solver_mod
from sdpcutsel_tpu_torch import config as config_mod
from sdpcutsel_tpu_torch.loop import sdp_bound as sdp_bound_mod
from sdpcutsel_tpu_torch.loop.sdp_bound import (_seed_rows, bm_null_directions,
                                                sdp_relaxation_bound)
from sdpcutsel_tpu_torch.loop.sdp_primal import bm_feasible_point
from sdpcutsel_tpu_torch.lp import pdhg as pdhg_mod
from sdpcutsel_tpu_torch.lp.pdhg import (REC_D, REC_DD, REC_DP, REC_ERR, REC_IT, REC_OMEGA,
                                         REC_P, REC_RESTART, REC_SIGMA, REC_STOP, REC_TAU,
                                         REC_USE_AVG, REC_WLEN, estimate_norm_batched_plain,
                                         estimate_norm_plain, init_state, new_record, norm_start,
                                         pdhg_check_batched_plain, pdhg_check_plain,
                                         record_floats, solve_setup, steer_to_vertex)
from sdpcutsel_tpu_torch.lp import pdhg_dense
from sdpcutsel_tpu_torch.lp.pdhg_check import pdhg_block_checked, pdhg_block_checked_batched
from sdpcutsel_tpu_torch.lp.pdhg_dense import (pdhg_dense_block, pdhg_dense_block_checked,
                                               pdhg_dense_block_steps, pdhg_dense_norm)
from sdpcutsel_tpu_torch.lp import pdhg_grid
from sdpcutsel_tpu_torch.lp.pdhg_grid import (pdhg_grid_block, pdhg_grid_block_batched,
                                              pdhg_grid_block_checked,
                                              pdhg_grid_block_checked_batched,
                                              pdhg_grid_block_steps,
                                              pdhg_grid_block_steps_batched, pdhg_grid_norm,
                                              pdhg_grid_norm_batched)
from sdpcutsel_tpu_torch.lp import pdhg_norm as pdhg_norm_mod
from sdpcutsel_tpu_torch.lp.pdhg_norm import pdhg_norm, pdhg_norm_batched
from sdpcutsel_tpu_torch.lp import pdhg_kernel
from sdpcutsel_tpu_torch.lp.pdhg_kernel import (launch_plan, max_active_clusters, pdhg_block,
                                                pdhg_block_batched, pdhg_block_batched_plain,
                                                pdhg_block_plain, plan_refusal)
from sdpcutsel_tpu_torch.models import labels as labels_mod
from sdpcutsel_tpu_torch.models import train as train_mod
from sdpcutsel_tpu_torch.models.features import candidate_q_features
from sdpcutsel_tpu_torch.models.labels import EIGH_CHUNK, exact_score_fn
from sdpcutsel_tpu_torch.models.scorer import MLPScorer, load_params
from sdpcutsel_tpu_torch.multichip_dryrun import dryrun_multichip
from sdpcutsel_tpu_torch.ops.fused_score import fused_score, fused_score_plain, launch_ranges
from sdpcutsel_tpu_torch.ops.launches import (PLAIN_BLOCKS, PLAIN_CONTROL, READS, SOLVES,
                                              TWIN_SCORED, WRAPPERS, launch_counts,
                                              reset_launches)
from sdpcutsel_tpu_torch.ops.pair_packed import packed_layout, packed_score, packed_score_plain
from sdpcutsel_tpu_torch.ops.pair_score import SWEEPS, pair_score, pair_score_plain
from sdpcutsel_tpu_torch.ops.topk import RunningTopk, StreamedTopk, diverse_topk
from sdpcutsel_tpu_torch.parallel import Mesh, distributed, make_mesh, shard_candidates
from sdpcutsel_tpu_torch.parallel import round as round_mod
from sdpcutsel_tpu_torch.parallel.sharding import shard_combinations
from sdpcutsel_tpu_torch.parallel.round import (certify_batched_f64, certify_scan_f64,
                                                init_batched_state, instances_of,
                                                make_sharded_round_step, make_sharded_scan_step)
from sdpcutsel_tpu_torch.qcqp import CutSolverQCQP
from sdpcutsel_tpu_torch.qcqp.chordal import chordal_decomposition, clique_candidates
from sdpcutsel_tpu_torch.qcqp.solver import SWEEPS as QCQP_SWEEPS
from sdpcutsel_tpu_torch.relax import batched as rb
from sdpcutsel_tpu_torch.relax.cutbuffer import append_cuts, build_cut_index, empty_pool
from sdpcutsel_tpu_torch.relax.denserows import (DenseRows, batched_dense_from_qcqp,
                                                 dense_from_qcqp)
from sdpcutsel_tpu_torch.utils.registry import ensure_certified_bounds, load_registry
from sdpcutsel_tpu_torch.scoring_variants import (UNGUARDED, clique_table, device_ms,
                                                  fused_args, k1_call, k4_call, scoring_point,
                                                  start_variants)

REPO = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(REPO, "data", "boxqp")
INSTANCE = "spar125-100-1"
ROUNDS = 10
QCQP_INSTANCE = "qcqpband100-5-25-1"
QCQP_ROUNDS = 8
BOXQP_LP = LPConfig(max_iters=20000, tol=2e-6)      # bench.py's suite LP config
QCQP_CFG = RunConfig(lp=LPConfig(max_iters=20000, tol=2e-6),
                     cuts=CutConfig(k=5, sel_size=16, capacity=1024),
                     loop=LoopConfig(polish_iters=60000))
# the steered QCQP scan: results/qcqp_parity.jsonl:28's steer_eps, the
# default 4,000 steering iterations a round
QCQP_STEER_CFG = dataclasses.replace(QCQP_CFG, loop=dataclasses.replace(
    QCQP_CFG.loop, use_scan=True, steer_eps=1e-3))
RESUME_AT = {"qcqp": 4, "boxqp": 5}          # rounds before the snapshot a run resumes from
BOXQP_STRATEGY_ROUNDS = {"triangle": 5, "random": 5, "optimality": 2}
QCQP_STRATEGIES = ("feasibility", "random", "optimality")     # at k = 4, QCQP_ROUNDS each
SNAPSHOTS = os.path.join(REPO, "build", "chip_smoke_snapshots")
# the batched paths (parallel/round.py): scripts/bench_batched.py's defaults
# (lp_iters 400, sel_size 16, neural; capacity 1024) on a 1 x 1 mesh
SUITE_BUCKET = [f"spar125-{d}-{s}" for d in (25, 50, 75, 100) for s in (1, 2, 3)]
SUITE_ALONE = (0, 7)                  # bucket instances also run as batches of one
BATCH_ROUNDS = 10
BATCH_KNOBS = dict(lp_iters=400, sel_size=16, strategy="neural")
BENCH_BATCH = (30, 8)                 # bench.py:188-223: 8 x generate_spar(30, 100, s + 1)
QCQP_FAMILY = (30, 30, 2, 1, 8)       # generate_qcqp_family(n, density, m, seed, B), --qcqp
QCQP_FAMILY_ROUNDS, QCQP_FAMILY_CPU_ROUNDS = 6, 2
# phase 15, the certifiers: tests/test_sdp_bound.py's sandwich settings
# (generator, arguments, LP, rounds, rel width limit), and the full-width
# eigencut rounds (validate_sdp_bound's defaults, cut to 3 rounds of
# LPConfig(2000, 2e-6)).  The QCQP sandwich is cut from the test's 40 rounds
# to 8: its best certificate is round 3's, and the stall test ends the
# 40-round run at round 17 after 78,000 more iterations that lower nothing.
SANDWICH = {"boxqp": (generate_spar, (12, 100, 3), LPConfig(max_iters=8000, tol=2e-6), 40, 1e-3),
            "qcqp": (generate_qcqp, (10, 40, 2, 1), LPConfig(max_iters=6000, tol=2e-6), 8, 5e-3)}
FULL_LP = LPConfig(max_iters=2000, tol=2e-6)
FULL_ROUNDS = 3
FULL_CAPACITY = 2048
CLI_QCQP = ("qcqp015-30-3-1", ["--k", "5", "--sel-size", "16", "--capacity", "1024"])
# phase 16, training: the quality of the JAX package's models/train.py at its
# defaults, k = 3, run once with JAX on the CPU (PERF.md section 2); the
# port's run on the card must reach each figure less TRAIN_SLACK
TRAIN_REF_K3 = {"holdout_spearman": 0.4651269628043434,
                "precision_at_top10pct": 0.8905367231638418}
TRAIN_SLACK = 0.05
# (a) and (b) run at the reference's defaults, uncut: phase 16 took 76.1-99.9 s
# and the whole script 444.5-542.4 s on one H100 80GB HBM3 at 700 W
# (PERF.md section 6); with phase 17 the script took 580.1-673.2 s, so a
# later phase has ~200 s of the 900 s left
TRAIN_REPEAT = dict(k=3, samples=20_000, steps=500, harvest_rounds=1)   # (d)
# phase 17, multi-process parallel/: every rank a subprocess (python3 -m ...)
# with this time limit; two ranks share the one card over gloo
RANK_TIMEOUT = 300
# what gloo's two gathers of a round cost at 1 x 2 on one card: the round's
# shapes (B = 1, sel_size 16, k = 3), 500 times after a warm-up, on the card
# (through the host) and, for gloo's own share, on the host
GATHER_TIMING = r"""
import argparse, json, time, torch
from sdpcutsel_tpu_torch.parallel import distributed as D
from sdpcutsel_tpu_torch.parallel.mesh import make_mesh
from sdpcutsel_tpu_torch.parallel.sharding import gather_cand
ap = argparse.ArgumentParser()
for a in ("--coordinator", "--num-processes", "--process-id"):
    ap.add_argument(a)
a = ap.parse_args()
dev = D.initialize(a.coordinator, int(a.num_processes), int(a.process_id))
mesh = make_mesh(1, 2)
us = {}
for where in (dev, torch.device("cpu")):
    vals = torch.zeros((1, 16), device=where)
    rows = torch.zeros((1, 16, 3), dtype=torch.int64, device=where)
    def both():
        gather_cand([vals], 1, mesh)
        gather_cand([rows], 1, mesh)
        torch.cuda.synchronize(dev)
    for _ in range(20):
        both()
    D.sync("timed")
    t0 = time.perf_counter()
    for _ in range(500):
        both()
    us[where.type] = (time.perf_counter() - t0) / 500 * 1e6
print(json.dumps({"rank": a.process_id, "backend": torch.distributed.get_backend(),
                  "us_per_round": us}), flush=True)
torch.distributed.destroy_process_group()
"""
MULTI_FULL_KNOBS = dict(lp_iters=400, sel_size=16, strategy="neural")   # the suite bucket's
SEED = 0
# H100 SXM peaks (NVIDIA's data sheet): fp32 outside the tensor cores, dense
# TF32 on the tensor cores, HBM3
PEAK_FLOPS = 67e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
# K2's microseconds an iteration before the cluster design (PERF.md, PR 3)
K2_SINGLE_CTA_US = {(125, 0): 35.11, (100, 25): 72.39}
# the main paths' final bounds as PERF.md records them, printed beside this run's
BOXQP_RECORDED_FINAL = 46173.94073905878
QCQP_RECORDED_FINAL = 2996.008999203225
PATH_LAUNCHES: dict = {}              # main path -> its launch counts (launch_counts())
SMI = ""                              # the card's nvidia-smi name and power limit
SCORING_KERNELS = ("pair_score_kernel", "pair_packed_kernel",
                   *(f"fused_score_kernelILi{k}E" for k in (2, 3, 4, 5)))


def log(*args):
    print(*args, flush=True)


def environment() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    nvcc_v = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                            timeout=60).stdout.strip().splitlines()
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = "absent"
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} triton {triton_v}")
    log(f"[env] nvcc: {nvcc_v[-1] if nvcc_v else 'absent'}")
    log(f"[env] device 0: {torch.cuda.get_device_name(0)}; count "
        f"{torch.cuda.device_count()}")
    return smi


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call from CUDA events after warm-up."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def excess(got, want, rtol: float, atol: float):
    """(max |got - want|, max |got - want| / (atol + rtol |want|)); the
    second is <= 1 exactly when allclose(got, want, rtol, atol) holds."""
    d = (got - want).abs()
    return float(d.max()), float((d / (atol + rtol * want.abs())).max())


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(flops: float, moved: int, tc_flops: float = 0.0) -> dict:
    """The least time the card could take: the largest of the operations
    outside the tensor cores over the fp32 peak, those on the tensor cores
    over the dense TF32 peak, and the bytes (each input read once, each
    output written once) over the memory rate."""
    t_ops = max(flops / PEAK_FLOPS, tc_flops / PEAK_TF32) * 1e3
    t_bytes = moved / PEAK_BYTES * 1e3
    return ({"bound_ms": t_ops, "bound_by": "operations"} if t_ops >= t_bytes
            else {"bound_ms": t_bytes, "bound_by": "bytes"})


def score_ops(k: int, sweeps: int) -> int:
    """Operations to score one candidate of width k: the features, `sweeps`
    cyclic Jacobi sweeps on the (k + 1) x (k + 1) Z(rho) (about 18 + 6 (M - 2)
    per rotation), and the F-64-64-1 relu MLP (csrc/score_common.cuh)."""
    M, F = k + 1, k * (k + 1) + k
    jacobi = sweeps * M * (M - 1) // 2 * (18 + 6 * (M - 2)) + M - 1
    mlp = 2 * 64 * F + 2 * 64 * 64 + 2 * 64 + 4 * 64 + 3
    return jacobi + mlp + 3 * (k * (k + 1) // 2)


def mlp_product_ops(k: int) -> int:
    """The MLP's products F -> 64 and 64 -> 64 a candidate of width k, which
    the scoring kernels run on the tensor cores (the three passes of split
    TF32 are the kernels' own cost, not more work)."""
    return 2 * 64 * (k * (k + 1) + k) + 2 * 64 * 64


def scoring_bound(T: int, moved: int, ms: float, k: int = 3,
                  sweeps: int = 5) -> tuple[dict, str]:
    """A scoring kernel's bound for T candidates of width k: the MLP's
    products on the tensor cores, the rest of score_ops(k, sweeps) at fp32,
    the bytes; and the three times, with the earlier bound (every operation
    at fp32) beside."""
    tc = T * mlp_product_ops(k)
    rest = T * score_ops(k, sweeps) - tc
    fp32_only = bound(T * score_ops(k, sweeps), moved)["bound_ms"]
    return bound(rest, moved, tc), (
        f"TF32 products {tc / PEAK_TF32 * 1e3:.5f} ms, the rest at fp32 "
        f"{rest / PEAK_FLOPS * 1e3:.5f} ms, bytes {moved / PEAK_BYTES * 1e3:.5f} ms; "
        f"every operation at fp32 (the earlier count) {fp32_only:.5f} ms, share "
        f"{fp32_only / ms:.4%}")


def mlp_bytes(mlp) -> int:
    return nbytes(*mlp.parameters())


def share(ms: float, b: dict) -> str:
    return (f"bound {b['bound_ms']:.5f} ms ({b['bound_by']}); roofline share "
            f"{b['bound_ms'] / ms:.4%}")


def k1_twin_check(label: str, inst, sweeps: int, dev, weights_path=None):
    """K1 against its twin on all C(n, 3) triples of ``inst`` at the
    scoring point, with the shipped weights or those at ``weights_path``:
    feas atol 5e-5, nn rtol/atol 2e-4 (tests/test_pair_score.py)."""
    x, X, Q = scoring_point(inst, dev)
    table = torch.as_tensor(combinations_table(inst.n, 3), device=dev)
    mlp = MLPScorer(load_params(3, weights_path), dev)
    nn_k, feas_k = pair_score(x, X, Q, table, mlp, sweeps)
    nn_p, feas_p = pair_score_plain(x, X, Q, table, mlp, sweeps)
    torch.cuda.synchronize()
    err_f, r_f = excess(feas_k, feas_p, 0.0, 5e-5)
    err_n, r_n = excess(nn_k, nn_p, 2e-4, 2e-4)
    log(f"[pair_score {label}] T={table.shape[0]} sweeps={sweeps} feas max|err| {err_f:.3e} "
        f"(atol 5e-5: {r_f:.3f} of limit); nn max|err| {err_n:.3e} (rtol/atol 2e-4: "
        f"{r_n:.3f} of limit)")
    if not (r_f <= 1.0 and r_n <= 1.0):
        raise AssertionError(f"pair_score kernel disagrees with its twin ({label})")
    return (x, X, Q, table, mlp), max(err_f, err_n), nbytes(x, X, Q, table, nn_k, feas_k)


def check_pair_score(inst, small, dev) -> dict:
    """K1 at n = 125 (checked and timed) and on the small instance of the
    card-against-CPU phase with 6 sweeps (checked)."""
    args, err, moved = k1_twin_check(inst.name, inst, 5, dev)
    _, err_small, _ = k1_twin_check(small.name, small, 6, dev)
    x, X, Q, table, mlp = args
    ms = cuda_ms(lambda: pair_score(*args), reps=50)
    dev_ms = device_ms(lambda: pair_score(*args), "pair_score_kernel")
    plain_ms = cuda_ms(lambda: pair_score_plain(*args), reps=5)
    T = table.shape[0]
    b, parts = scoring_bound(T, moved + mlp_bytes(mlp), ms)
    log(f"[pair_score] kernel {ms:.4f} ms by events ({T / ms / 1e3:.1f} M cand/s), "
        f"{dev_ms:.4f} ms on the device (profiler); twin {plain_ms:.4f} ms "
        f"({T / plain_ms / 1e3:.1f} M cand/s); {share(ms, b)}; {parts}")
    return {"max_abs_err": max(err, err_small), "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, **b}


def check_pair_packed(inst, dev) -> dict:
    """K3 against its twin on every valid slot (the K1 tolerances), -inf at
    every other slot, and bit for bit against K1 on the same triples."""
    x, X, Q = scoring_point(inst, dev)
    lay = packed_layout(inst.n, dev)
    mlp = MLPScorer(load_params(3), dev)
    nn_k, feas_k = packed_score(x, X, Q, lay, mlp)
    nn_p, feas_p = packed_score_plain(x, X, Q, lay, mlp)
    triples = lay.table[lay.valid]
    nn_1, feas_1 = pair_score(x, X, Q, triples, mlp)
    torch.cuda.synchronize()
    v = lay.valid
    err_f, r_f = excess(feas_k[v], feas_p[v], 0.0, 5e-5)
    err_n, r_n = excess(nn_k[v], nn_p[v], 2e-4, 2e-4)
    inf_ok = bool((nn_k[~v] == -torch.inf).all() and (feas_k[~v] == -torch.inf).all())
    vs_k1 = max(float((nn_k[v] - nn_1).abs().max()), float((feas_k[v] - feas_1).abs().max()))
    log(f"[pair_packed] slots {lay.slots} (tiers of {lay.R} rows), valid {int(v.sum())}: "
        f"feas max|err| {err_f:.3e} (atol 5e-5: {r_f:.3f} of limit); nn max|err| "
        f"{err_n:.3e} (rtol/atol 2e-4: {r_n:.3f} of limit); invalid slots all -inf: "
        f"{inf_ok}; largest difference from pair_score on the same triples {vs_k1!r}")
    n = inst.n
    if not (r_f <= 1.0 and r_n <= 1.0 and inf_ok and triples.shape[0] == n * (n - 1) * (n - 2) // 6):
        raise AssertionError("pair_packed kernel disagrees with its twin")
    if vs_k1 != 0.0:      # both kernels run score_mma.cuh::score_warp
        raise AssertionError("pair_packed kernel does not give pair_score's bits")
    # in turns: K3, K1 on the same triples, K1, K3
    k3_ms, k1_ms = [], []
    for runs, fn in ((k3_ms, lambda: packed_score(x, X, Q, lay, mlp)),
                     (k1_ms, lambda: pair_score(x, X, Q, triples, mlp)),
                     (k1_ms, lambda: pair_score(x, X, Q, triples, mlp)),
                     (k3_ms, lambda: packed_score(x, X, Q, lay, mlp))):
        runs.append(cuda_ms(fn, reps=50))
    ms = sum(k3_ms) / 2
    dev_ms = device_ms(lambda: packed_score(x, X, Q, lay, mlp), "pair_packed_kernel")
    plain_ms = cuda_ms(lambda: packed_score_plain(x, X, Q, lay, mlp), reps=5)
    # the valid slots' work; every slot writes its two scores
    b, parts = scoring_bound(triples.shape[0], nbytes(
        x, X, Q, lay.valid_slots, lay.rows, lay.iu, lay.ju, nn_k, feas_k) + mlp_bytes(mlp), ms)
    log(f"[pair_packed] kernel {ms:.4f} ms by events ({triples.shape[0] / ms / 1e3:.1f} M "
        f"valid cand/s), {dev_ms:.4f} ms on the device (profiler); in turns K3 {k3_ms!r} ms, "
        f"pair_score on the same triples {k1_ms!r} ms (K3 / K1 "
        f"{sum(k3_ms) / sum(k1_ms):.4f}); twin {plain_ms:.4f} ms; {share(ms, b)}; {parts}")
    return {"max_abs_err": max(err_f, err_n), "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, **b}


def random_pool(table: np.ndarray, M: int, active: int, rng, dev):
    """``active`` random unit-norm cuts on distinct rows of ``table`` (the
    candidate supports) in a pool of M."""
    k = table.shape[1]
    idx = table[rng.choice(table.shape[0], active, replace=False)]
    lin = rng.standard_normal((active, k))
    quad = rng.standard_normal((active, k, k))
    quad = 0.5 * (quad + quad.transpose(0, 2, 1))
    nrm = np.sqrt((lin ** 2).sum(1) + (quad ** 2).sum((1, 2)))
    cuts = (idx, lin / nrm[:, None], quad / nrm[:, None, None],
            -0.1 * rng.random(active) / nrm, np.ones(active))
    return append_cuts(empty_pool(M, k, dev), *(
        torch.as_tensor(a, dtype=torch.int64 if a.dtype.kind == "i" else torch.float32,
                        device=dev) for a in cuts))


def random_state(n: int, M: int, m: int, pool, rng, dev):
    """A random PDHG state for K2's checks: x, X in [0, 1], small duals,
    yC on the pool's active slots."""
    st = init_state(n, M, dev, m)
    X = rng.random((n, n))
    f32 = dict(dtype=torch.float32, device=dev)
    st.x = torch.as_tensor(rng.random(n), **f32)
    st.X = torch.as_tensor(0.5 * (X + X.T), **f32)
    st.yA = torch.as_tensor(0.1 * rng.random((n, n)), **f32)
    st.yB = torch.as_tensor(0.1 * rng.random((n, n)), **f32)
    st.yC = torch.as_tensor(0.05 * rng.random(M), **f32) * pool.active
    st.yD = torch.as_tensor(0.2 * rng.random(m), **f32)
    return st


def pdhg_ops(n: int, k: int, m: int, active: int, terms: int, iters: int) -> int:
    """Operations of `iters` iterations of lp/pdhg.py::_one_iter: about 31
    an (n, n) entry (adjoint, pre-step, projection, extrapolation, dual
    ascent, sums) and 4 m more for the dense adjoint and residuals, 2 a
    cut-index term, 2 k + 2 k^2 + 6 an active cut, 10 + 2 m an x entry."""
    return iters * (n * n * (31 + 4 * m) + 2 * terms + active * (2 * k + 2 * k * k + 6)
                    + n * (10 + 2 * m) + 4 * m)


def sass_mma(kernels) -> dict:
    """The tensor-core instructions (HMMA, HGMMA) of each kernel in the built
    library, from cuobjdump -sass: {kernel: {opcode: count}}."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", _build.library_path()], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, current = {k: {} for k in kernels}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = next((k for k in kernels if k in line), None)
        elif current is not None:
            for word in line.replace(";", " ").split():
                if word.startswith(("HMMA", "HGMMA")):
                    counts[current][word] = counts[current].get(word, 0) + 1
    return counts


def scoring_grid(kernel: str) -> tuple:
    """(CTAs the card holds, threads a CTA, dynamic shared bytes a CTA) of a
    scoring kernel's persistent launch (SCORING_KERNELS names)."""
    out = (ctypes.c_int * 3)()
    lib = _build.lib()
    if kernel.startswith("fused_score"):
        err = lib.fused_score_grid(int(kernel[-2]), out)
    else:
        err = getattr(lib, kernel.replace("_kernel", "_grid"))(out)
    _build.check(err, f"{kernel} grid")
    return tuple(out)


def tensor_core_kernels():
    """ptxas's registers and spills, the persistent grid and the dynamic
    shared memory of K1, K3 and K4 at k = 2..5, and the tensor-core
    instructions in each; fails unless every one runs its products on the
    tensor cores without spilling."""
    sass = sass_mma(SCORING_KERNELS)
    for name in SCORING_KERNELS:
        ctas, threads, smem = scoring_grid(name)
        ptxas = ptxas_report(name)
        log(f"[build] {name}: {ptxas}; persistent grid {ctas} CTAs x {threads} threads, "
            f"{smem} bytes of dynamic shared memory a CTA; tensor-core instructions "
            f"{sass[name]}")
        if not any(op.startswith("HMMA") and "TF32" in op for op in sass[name]):
            raise AssertionError(f"{name} has no TF32 HMMA instruction")
        if "spill" in ptxas and "0 bytes spill stores" not in ptxas:
            raise AssertionError(f"{name} spills registers: {ptxas}")


def ptxas_report(kernel: str) -> str:
    """Registers, stack and spills of one kernel from the nvcc -Xptxas -v log."""
    lines, on = [], False
    for line in _build.build_log.splitlines():
        if "Compiling entry function" in line:
            on = kernel in line
        elif on and ("registers" in line or "spill" in line):
            lines.append(line.split(":", 1)[-1].strip())
    return "; ".join(lines) or "not in this process's build log"


def pdhg_inputs(Q, c, table, dense, dev):
    """Phase 3's inputs at a main path's shape: (cx, cX, pool, index,
    state), M = 1024 with 400 active random cuts on rows of ``table`` and a
    random state (``random_state``), dense rows ``dense`` or none."""
    n, M = c.shape[0], 1024
    rng = np.random.default_rng(SEED + 1)
    pool = random_pool(table, M, 400, rng, dev)
    st = random_state(n, M, 0 if dense is None else dense.m, pool, rng, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    return (torch.as_tensor(-c, **f32), torch.as_tensor(-0.5 * Q, **f32), pool,
            build_cut_index(pool, n), st)


def check_pdhg_block(label: str, Q, c, table, dense, dev) -> dict:
    """K2 against its twin from a random state, M = 1024 with 400 active
    cuts on rows of ``table``, and the dense rows ``dense`` (or none); then
    the cluster launch's plan, its time beside the bound and PR 3's, and the
    portable cluster of 8 timed in turns with the plan's."""
    cx, cX, pool, index, st = pdhg_inputs(Q, c, table, dense, dev)
    n, M, k = c.shape[0], *pool.idx.shape
    m = 0 if dense is None else dense.m
    eta = 0.95 / estimate_norm_plain(pool, n, 30, torch.Generator().manual_seed(0), index,
                                     dense).item()
    zero = st.map(torch.zeros_like)
    args = (cx, cX, pool, index, st, zero, eta, eta)
    inputs = [t.clone() for t in (*st.fields(), *zero.fields())]
    # 7 iterations: the reference's own kernel tolerance (tests/test_pdhg_kernel.py).
    # 100 iterations (one checked block of the solve): PDHG is nonexpansive, so
    # f32 rounding differences add up rather than multiply; the 7-iteration
    # tolerance scaled linearly to 100 iterations is 3e-4, and the ergodic sums
    # of 100 iterates take 100 x that as atol.
    nf = len(st.fields())

    def compare(got, want, tol_st, tol_acc):
        errs, ratio = [], 0.0
        for (g, w), (rtol, atol) in zip([*zip(got[0].fields(), want[0].fields()),
                                         *zip(got[1].fields(), want[1].fields())],
                                        [tol_st] * nf + [tol_acc] * nf):
            if g.numel():
                e, r = excess(g, w, rtol, atol)
                errs.append(e)
                ratio = max(ratio, r)
        return errs, ratio

    worst = 0.0
    for iters, tol_st, tol_acc in [(7, (2e-5, 2e-5), (2e-5, 2e-5)),
                                   (100, (3e-4, 3e-4), (3e-4, 3e-2))]:
        got = pdhg_block(*args, iters, dense)
        want = pdhg_block_plain(*args, iters, dense)
        torch.cuda.synchronize()
        errs, ratio = compare(got, want, tol_st, tol_acc)
        log(f"[pdhg_block {label}] {iters} iterations: max|err| state "
            f"{max(errs[:len(errs) // 2]):.3e} sums {max(errs[len(errs) // 2:]):.3e}; "
            f"{ratio:.3f} of the limit (state rtol/atol {tol_st}, sums {tol_acc})")
        if ratio > 1.0:
            raise AssertionError(f"pdhg_block kernel disagrees with its twin at {iters} "
                                 f"iterations ({label})")
        worst = max(worst, *errs)
    unchanged = all(torch.equal(a, b) for a, b in zip(
        [*st.fields(), *zero.fields()], inputs))
    first = pdhg_block(*args, 100, dense)
    again = pdhg_block(*args, 100, dense)
    same = all(torch.equal(a, b) for a, b in zip([*first[0].fields(), *first[1].fields()],
                                                 [*again[0].fields(), *again[1].fields()]))
    log(f"[pdhg_block {label}] two 100-iteration runs bit-identical: {same}; inputs "
        f"unchanged: {unchanged}")
    if not (same and unchanged):
        raise AssertionError(f"pdhg_block kernel is not deterministic or wrote its "
                             f"inputs ({label})")

    plan = launch_plan(n, M, k, m)
    log(f"[pdhg_block {label}] cluster of {plan.cluster} CTAs x 512 threads at column width "
        f"{plan.cols}: {plan.rows} rows and {plan.slots} pool slots a CTA, {plan.smem_bytes} "
        f"bytes of shared memory a CTA ({plan.term_cap} cut-index terms); ptxas (both widths): "
        f"{spill_free('pdhg_cluster_kernel')}")
    ms = cuda_ms(lambda: pdhg_block(*args, 100, dense), reps=20)
    plain_ms = cuda_ms(lambda: pdhg_block_plain(*args, 100, dense), reps=3, warmup=1)
    b = bound(pdhg_ops(n, k, m, int(pool.active.sum()),
                       index.Xcut.numel() + index.xcut.numel(), 100),
              nbytes(cx, cX, index.idx, pool.lin, pool.quad, pool.rhs, pool.active,
                     index.xoff, index.xcut, index.xcoef, index.Xoff, index.Xcut,
                     index.Xcoef, *inputs, *first[0].fields(), *first[1].fields(),
                     *([] if dense is None else [dense.G, dense.g, dense.h])))
    single = K2_SINGLE_CTA_US.get((n, m), "not run")
    log(f"[pdhg_block {label}] 100-iteration block: kernel {ms:.4f} ms ({ms * 10:.3f} "
        f"us/iter; the single CTA before the cluster design: {single} us/iter); twin "
        f"{plain_ms:.4f} ms ({plain_ms * 10:.2f} us/iter); {share(ms, b)} "
        f"({b['bound_ms'] * 10:.5f} us/iter; {SMI})")
    out = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, **b}
    why8 = plan_refusal(n, M, k, m, 8)
    if why8 is not None:
        log(f"[pdhg_block {label}] the portable cluster of 8 does not take this shape: {why8}")
        return out
    # the portable cluster of 8 against the plan's, held to the same tolerance,
    # then both timed in turns (plan, 8, 8, plan)
    portable = pdhg_kernel._launch(*args, 100, dense, cluster=8)
    errs8, ratio8 = compare(portable, want, (3e-4, 3e-4), (3e-4, 3e-2))
    log(f"[pdhg_block {label}] cluster of 8 ({launch_plan(n, M, k, m, 8).smem_bytes} "
        f"bytes a CTA), 100 iterations: max|err| {max(errs8):.3e}; {ratio8:.3f} of the limit")
    if ratio8 > 1.0:
        raise AssertionError(f"pdhg_block with a cluster of 8 disagrees with its twin ({label})")
    t_plan, t_8 = [], []
    for order in ((t_plan, plan.cluster), (t_8, 8), (t_8, 8), (t_plan, plan.cluster)):
        order[0].append(cuda_ms(lambda: pdhg_kernel._launch(*args, 100, dense,
                                                            cluster=order[1]), reps=20))
    log(f"[pdhg_block {label}] in turns: cluster of {plan.cluster} {t_plan!r} ms, "
        f"cluster of 8 {t_8!r} ms")
    return out


def batched_inputs(insts, dev):
    """The batched phase-3 inputs at the suite bucket's shape: (cx, cX,
    pool, index, state, the single pools), each instance with its own pool
    of M = 1024 and 400 active random k = 3 cuts and a random state."""
    n, M = insts[0].n, 1024
    rng = np.random.default_rng(SEED + 2)
    table = combinations_table(n, 3)
    pools = [random_pool(table, M, 400, rng, dev) for _ in insts]
    P = rb.stack(pools)
    st = rb.stack([random_state(n, M, 0, p, rng, dev) for p in pools])
    f32 = dict(dtype=torch.float32, device=dev)
    cx = torch.as_tensor(np.stack([-i.c for i in insts]), **f32)
    cX = torch.as_tensor(np.stack([-0.5 * i.Q for i in insts]), **f32)
    return cx, cX, P, rb.build_cut_index(P, n), st, pools


def check_pdhg_block_batched(insts, single: dict, dev) -> dict:
    """K2's instance axis at the suite bucket's shape: the B = 12 instances'
    Q and c, each with its own pool of M = 1024 and 400 active random k = 3
    cuts and a random state, one instance left out of ``ids``.  Against the
    twin (pdhg_block_plain on each listed instance) at the single phase's
    tolerances, 7 and 100 iterations; the instance left out unchanged bit for
    bit; every listed instance bit for bit equal to a B = 1 launch of it and
    to the single wrapper on its own cut index; how many clusters of 16 and
    of 8 the card runs at once; 100-iteration launches of all 12 at the
    plan's cluster and at 8, in turns, beside B x the single launch's time
    and bound."""
    cx, cX, P, index, st, pools = batched_inputs(insts, dev)
    (B, n), M = cx.shape, P.idx.shape[1]
    acc = st.map(torch.zeros_like)
    eta = (np.float32(0.95) / estimate_norm_batched_plain(
        P, n, 30, torch.Generator().manual_seed(0), index).cpu().numpy()).astype(np.float32)
    frozen = B // 2 - 1
    ids = [b for b in range(B) if b != frozen]
    inputs = [t.clone() for t in (*st.fields(), *acc.fields())]
    args = (cx, cX, P, index, st, acc, eta, eta)
    worst = 0.0
    for iters, tol_st, tol_acc in [(7, (2e-5, 2e-5), (2e-5, 2e-5)),
                                   (100, (3e-4, 3e-4), (3e-4, 3e-2))]:
        got = pdhg_block_batched(*args, iters, ids)
        want = pdhg_block_batched_plain(*args, iters, ids)
        torch.cuda.synchronize()
        ratio, errs = 0.0, []
        for g, w, tol in zip([*got[0].fields(), *got[1].fields()],
                             [*want[0].fields(), *want[1].fields()], [tol_st] * 6 + [tol_acc] * 6):
            if g.numel():
                e, r = excess(g[ids], w[ids], *tol)
                errs.append(e)
                ratio = max(ratio, r)
        frozen_same = all(torch.equal(g[frozen], w[frozen]) for g, w in zip(
            [*got[0].fields(), *got[1].fields()], inputs))
        alone = single_too = True
        for b in ids:
            one = pdhg_kernel._launch_batched(*(t[b:b + 1] for t in (cx, cX)),
                                              *(rb.instance(o, slice(b, b + 1))
                                                for o in (P, index, st, acc)),
                                              eta[b:b + 1], eta[b:b + 1], iters, [0], None)
            ref = pdhg_block(cx[b], cX[b], pools[b], build_cut_index(pools[b], n),
                             rb.instance(st, b), rb.instance(acc, b), float(eta[b]),
                             float(eta[b]), iters)
            outs = [t[b] for t in (*got[0].fields(), *got[1].fields())]
            alone &= all(torch.equal(u[0], v) for u, v in zip((*one[0].fields(),
                                                               *one[1].fields()), outs))
            single_too &= all(torch.equal(u, v) for u, v in zip((*ref[0].fields(),
                                                                 *ref[1].fields()), outs))
        log(f"[pdhg_block batched] B={B}, n={n}, M={M}, {iters} iterations, instance {frozen} "
            f"left out: max|err| {max(errs):.3e}, {ratio:.3f} of the limit (state {tol_st}, "
            f"sums {tol_acc}); the instance left out unchanged bit for bit: {frozen_same}; "
            f"each listed instance equal to a B = 1 launch of it: {alone}, and to the single "
            f"wrapper on its own cut index: {single_too}")
        if not (ratio <= 1.0 and frozen_same and alone and single_too):
            raise AssertionError(f"the batched pdhg_block fails its checks at {iters} iterations")
        worst = max(worst, *errs)
    unchanged = all(torch.equal(a, b) for a, b in zip([*st.fields(), *acc.fields()], inputs))
    clusters = {c: max_active_clusters(n, M, 3, 0, B, c) for c in (16, 8)}
    everyone = list(range(B))
    t16, t8 = [], []
    for runs, c in ((t16, 16), (t8, 8), (t8, 8), (t16, 16)):
        runs.append(cuda_ms(lambda: pdhg_kernel._launch_batched(*args, 100, everyone, None, c),
                            reps=20))
    ms, ms8 = sum(t16) / 2, sum(t8) / 2
    out = pdhg_block_batched(*args, 100, everyone)
    b = bound(sum(pdhg_ops(n, 3, 0, int(p.active.sum()), int(i.xoff[-1] + i.Xoff[-1]), 100)
                  for p, i in ((p, build_cut_index(p, n)) for p in pools)),
              nbytes(cx, cX, index.idx, P.lin, P.quad, P.rhs, P.active, index.xoff,
                     index.xcut, index.xcoef, index.Xoff, index.Xcut, index.Xcoef, *inputs,
                     *out[0].fields(), *out[1].fields()))
    log(f"[pdhg_block batched] inputs unchanged: {unchanged}; clusters the card runs at once "
        f"(cudaOccupancyMaxActiveClusters, a grid of {B}): {clusters[16]} of 16 CTAs, "
        f"{clusters[8]} of 8")
    log(f"[pdhg_block batched] 100-iteration launch of all {B}: cluster of 16 {ms:.4f} ms = "
        f"{ms * 10:.3f} us a batched iteration, {ms * 10 / B:.4f} us an instance-iteration; "
        f"cluster of 8 {ms8:.4f} ms = {ms8 * 10:.3f} us, {ms8 * 10 / B:.4f} us an "
        f"instance-iteration (in turns: 16 {t16!r} ms, 8 {t8!r} ms); B x the single launch "
        f"{B * single['ms']:.4f} ms ({B * single['ms'] * 10:.3f} us a batched iteration); "
        f"bound {b['bound_ms']:.5f} ms ({b['bound_by']}; B x the single bound "
        f"{B * single['bound_ms']:.5f}); roofline share {b['bound_ms'] / ms:.4%}")
    if not unchanged:
        raise AssertionError("the batched pdhg_block wrote its inputs")
    return {"batch": B, "batched_ms": ms, "batched_cluster8_ms": ms8,
            "batched_bound_ms": b["bound_ms"], "batched_bound_by": b["bound_by"],
            "max_active_clusters": clusters[16], "max_active_clusters_8": clusters[8],
            "batched_max_abs_err": worst}


# phase 3's K5 and K6: their twins' tolerance, the record words compared
CONTROL_RTOL = 1e-5
REC_INTS = {"it": REC_IT, "wlen": REC_WLEN, "stop": REC_STOP, "restart": REC_RESTART,
            "use_avg": REC_USE_AVG}
REC_FLOATS = {"err": REC_ERR, "p": REC_P, "d": REC_D, "omega": REC_OMEGA, "tau": REC_TAU,
              "sigma": REC_SIGMA}
CHECK_ARGS = dict(check_every=100, max_iters=20000, tol=2e-6)    # the main paths' LP


def check_ops(n: int, k: int, m: int, active: int, terms: int, restart: bool) -> int:
    """Operations of one K5 launch for one instance: two KKT evaluations,
    about 26 an (n, n) entry (K^T y, M = cX - gX and M + M^T, the objective,
    kA, kB and their squares) and 4 m more (the dense adjoint and residual),
    2 a cut-index term, 2 k + 2 k^2 + 8 an active cut, 14 + 2 m an x entry;
    on a restart 9 an (n, n) entry more (the distances, the copies)."""
    one = n * n * (26 + 4 * m) + 2 * terms + active * (2 * k + 2 * k * k + 8) + n * (14 + 2 * m)
    return 2 * one + (9 * n * n if restart else 0)


def norm_ops(n: int, k: int, m: int, active: int, terms: int, iters: int) -> int:
    """Operations of K6 for one instance: per iteration about 30 an (n, n)
    entry (K, K^T, the symmetrisation, the norm) and 4 m more for the dense
    rows, 2 a cut-index term, 2 k + 2 k^2 + 6 an active cut; K once more at
    the end."""
    per = n * n * (30 + 4 * m) + 2 * terms + active * (2 * k + 2 * k * k + 6) + n * (12 + 2 * m)
    return iters * per + n * n * (8 + 2 * m) + active * (2 * k + 2 * k * k + 4)


def check_bytes(cx, cX, pool, index, dense, st, acc, anchor, rec) -> int:
    """Bytes a K5 launch that restarts must move for one instance: the
    problem's arrays, each read once, and the state, sums, anchor and
    control record, each read once and written once."""
    return nbytes(cx, cX, index.idx, pool.lin, pool.quad, pool.rhs, pool.active, index.xoff,
                  index.xcut, index.xcoef, index.Xoff, index.Xcut, index.Xcoef,
                  *([] if dense is None else [dense.G, dense.g, dense.h])) + 2 * nbytes(
        *st.fields(), *acc.fields(), *anchor.fields(), rec)


def record_diff(got, want, rows) -> tuple:
    """(the record words' names whose int words differ, the largest relative
    difference of the float words, the largest absolute difference of err,
    p, d, omega) over the records' ``rows``."""
    gi, wi = got.cpu().numpy().reshape(-1, pdhg_mod.REC_WORDS), want.cpu().numpy().reshape(
        -1, pdhg_mod.REC_WORDS)
    gf, wf = record_floats(gi), record_floats(wi)
    bad = [name for name, j in REC_INTS.items() if not np.array_equal(gi[rows, j], wi[rows, j])]
    cols = list(REC_FLOATS.values()) + ([REC_DP, REC_DD] if wi[rows, REC_RESTART].any() else [])
    rel = float(np.max(np.abs(gf[rows][:, cols] - wf[rows][:, cols])
                       / np.maximum(np.abs(wf[rows][:, cols]), 1e-30)))
    absd = float(np.max(np.abs(gf[rows][:, [REC_ERR, REC_P, REC_D, REC_OMEGA]]
                               - wf[rows][:, [REC_ERR, REC_P, REC_D, REC_OMEGA]])))
    return bad, rel, absd


def states_equal(a: list, b: list) -> bool:
    return all(torch.equal(u, v) for x, y in zip(a, b) for u, v in zip(x.fields(), y.fields()))


def check_pdhg_check(label: str, inputs, dense, dev) -> dict:
    """K5, in K2's launch: the checked block (pdhg_block_checked: 100
    iterations of K2, then K5's control on the bands in shared memory) from
    phase 3's random state (also the anchor) on a fresh control record of
    the main paths' LP, against K2's unchecked launch (pdhg_block_steps)
    followed by K5's twin (pdhg_check_plain): restart_period 10^9 (a restart
    only when the average wins) and 100 (always); err, p, d, omega, tau,
    sigma and the distances at rtol 1e-5, the record's ints (it, wlen, stop,
    restart, use_avg) equal, the state, sums and anchor equal bit for bit;
    each case twice bit for bit; a stopped record leaves everything as it
    is.  Timed on the device (queued events) in turns with the unchecked
    launch, whose difference is K5's time in the launch, beside its bound."""
    cx, cX, pool, index, st0 = inputs
    n, (M, k), m = cx.shape[0], pool.idx.shape, 0 if dense is None else dense.m
    normK = estimate_norm_plain(pool, n, 30, torch.Generator().manual_seed(0), index, dense)
    every = CHECK_ARGS["check_every"]
    worst = 0.0
    for rp in (10 ** 9, 100):
        def prepare():
            return [st0.map(torch.clone), st0.map(torch.zeros_like), st0.map(torch.clone),
                    new_record(normK, 1.0, 0.95, CHECK_ARGS["max_iters"], CHECK_ARGS["tol"], dev)]

        def checked(st, acc, anc, rec):
            pdhg_block_checked(cx, cX, pool, index, st, acc, anc, rec, every, rp,
                               CHECK_ARGS["max_iters"], CHECK_ARGS["tol"], dense)
            return [st, acc, anc, rec]

        def twin(st, acc, anc, rec):
            pdhg_kernel.pdhg_block_steps(cx, cX, pool, index, st, acc, rec, every, dense)
            pdhg_check_plain(cx, cX, pool, index, st, acc, anc, rec, every, rp,
                             CHECK_ARGS["max_iters"], CHECK_ARGS["tol"], dense)
            return [st, acc, anc, rec]

        ka, kb = checked(*prepare()), checked(*prepare())
        tw = twin(*prepare())
        torch.cuda.synchronize()
        bad, rel, absd = record_diff(ka[3], tw[3], slice(None))
        same = states_equal(ka[:3], tw[:3])
        repeat = states_equal(ka[:3], kb[:3]) and torch.equal(ka[3], kb[3])
        r = ka[3].cpu().numpy()
        log(f"[pdhg_check {label}] restart_period {rp}: restart {bool(r[REC_RESTART])}, "
            f"use_avg {bool(r[REC_USE_AVG])}, omega {float(record_floats(r)[REC_OMEGA])!r}; "
            f"the checked launch against K2 then the twin check: int words differing {bad}, "
            f"largest rel diff of the float words {rel:.3e} (rtol {CONTROL_RTOL}), max|err| of "
            f"err/p/d/omega {absd:.3e}; state, sums and anchor bit for bit: {same}; two "
            f"launches bit for bit: {repeat}")
        if bad or rel > CONTROL_RTOL or not (same and repeat):
            raise AssertionError(f"the checked block disagrees with K2 and the twin check or "
                                 f"does not repeat ({label})")
        worst = max(worst, absd)
    args = prepare()
    args[3][REC_STOP] = 1
    before = [t.clone() for t in (*[u for x in args[:3] for u in x.fields()], args[3])]
    checked(*args)
    frozen = all(torch.equal(a, b) for a, b in zip(
        before, (*[u for x in args[:3] for u in x.fields()], args[3])))
    log(f"[pdhg_check {label}] a stopped record leaves the state, sums, anchor and record bit "
        f"for bit: {frozen}")
    if not frozen:
        raise AssertionError(f"the checked block wrote a stopped instance ({label})")
    # timed at restart_period 100 (every launch restarts: the most work), in
    # turns with K2's unchecked launch on the same buffers
    args = prepare()
    rec = args[3]

    def unchecked():
        pdhg_kernel.pdhg_block_steps(cx, cX, pool, index, args[0], args[1], rec, every, dense)

    t_k2, t_both = [], []
    for runs, fn in ((t_k2, unchecked), (t_both, lambda: checked(*args)),
                     (t_both, lambda: checked(*args)), (t_k2, unchecked)):
        runs.append(queued_ms(fn, reps=10))
    both, k2_ms = sum(t_both) / 2, sum(t_k2) / 2
    ms = cuda_ms(lambda: checked(*args), reps=20)
    twin_args = prepare()
    plain_ms = cuda_ms(lambda: pdhg_check_plain(cx, cX, pool, index, *twin_args, every, 100,
                                                CHECK_ARGS["max_iters"], CHECK_ARGS["tol"],
                                                dense), reps=5)
    terms = index.Xcut.numel() + index.xcut.numel()
    b = bound(check_ops(n, k, m, int(pool.active.sum()), terms, True),
              check_bytes(cx, cX, pool, index, dense, *args))
    dev_ms = both - k2_ms
    log(f"[pdhg_check {label}] on the device (queued events, in turns): the checked launch "
        f"{t_both!r} ms, K2 alone {t_k2!r} ms: K5 in K2's launch {dev_ms:.4f} ms; the checked "
        f"launch by events back to back {ms:.4f} ms (host included); twin check "
        f"{plain_ms:.4f} ms (reads to the host included); K5 {share(max(dev_ms, 1e-9), b)} (of "
        f"its device time); ptxas (checked form): {ptxas_report('pdhg_cluster_kernelILb1')}")
    return {"max_abs_err": worst, "ms": dev_ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "checked_launch_ms": both, "unchecked_launch_ms": k2_ms,
            "checked_launch_events_ms": ms, **b}


def spill_free(kernel: str, log_text: str | None = None) -> str:
    """ptxas's lines for ``kernel`` (every instantiation; of this build, or of
    ``log_text``, another build's log); fails if one of this build's spills
    registers."""
    if log_text is None:
        rep = ptxas_report(kernel)
    else:
        saved = _build.build_log
        _build.build_log = log_text
        try:
            rep = ptxas_report(kernel)
        finally:
            _build.build_log = saved
    if log_text is None and any(int(v) for v in re.findall(r"(\d+) bytes spill stores", rep)):
        raise AssertionError(f"{kernel} spills registers: {rep}")
    return rep


def norm_entry(lib, pool, n: int, index, dense, dev, parent: bool):
    """K6's C entry alone, on a batch's prepared arguments (the instance
    axis first): a function of no arguments that launches it once (not
    counted), for timing without the wrapper's host work.  This build reads
    the kept start vector; the parent build's overwrites its (B, n), (B, n,
    n) copies of it (the same work on every launch: 30 iterations)."""
    B, M, k = pool.idx.shape
    m = 0 if dense is None else dense.G.shape[1]
    x, X = pdhg_mod.start_vector(n, None, dev)
    if parent:       # copies (expand of one instance would be the kept vector itself)
        x = x.expand(B, n).clone(memory_format=torch.contiguous_format)
        X = X.expand(B, n, n).clone(memory_format=torch.contiguous_format)
    out = torch.empty((B,), dtype=torch.float32, device=dev)
    args = [t.contiguous() for t in (index.idx, pool.lin, pool.quad, pool.active, index.xoff,
                                     index.xcut, index.xcoef, index.Xoff, index.Xcut,
                                     index.Xcoef)]
    dptr = [None] * 2 if dense is None else [dense.G.data_ptr(), dense.g.data_ptr()]

    def launch():
        err = lib.pdhg_norm_launch(n, M, k, m, B, pdhg_kernel.CLUSTER, index.xcut.shape[-1],
                                   index.Xcut.shape[-1], 30, *(t.data_ptr() for t in args),
                                   *dptr, x.data_ptr(), X.data_ptr(), out.data_ptr(),
                                   torch.cuda.current_stream().cuda_stream)
        _build.check(err, "pdhg_norm_launch")

    launch.keep = (args, x, X, out)
    return launch


def norm_against_parent(pkg, label: str, this_fn, parent_fn, entries) -> dict:
    """K6 of this build (``this_fn()``) and the parent build's (``parent_fn()``,
    its wrapper drawing the seed-0 start vector afresh) bit for bit; then
    both C entries (``entries``: this, parent) alone on the device in turns
    (parent, this, this, parent; queued events), and the parent's ptxas."""
    mine, theirs = this_fn(), parent_fn()
    torch.cuda.synchronize()
    same = torch.equal(mine, theirs)
    turns = {"parent": [], "this": []}
    for tree in ("parent", "this", "this", "parent"):
        turns[tree].append(queued_ms(entries[tree], reps=10))
    log(f"[pdhg_norm {label}] this build's K6 and the parent build's bit for bit: {same}; on "
        f"the device in turns (the C entries alone): parent {turns['parent']!r} ms, this build "
        f"{turns['this']!r} ms; the parent's ptxas: "
        f"{spill_free('pdhg_norm_kernel', parent_build(pkg).build_log)} ({SMI})")
    if not same:
        raise AssertionError(f"K6 does not give the parent build's bits ({label})")
    return {"parent_bits": same, "parent_device_ms": sum(turns["parent"]) / 2,
            "parent_device_ms_turns": turns["parent"], "device_ms_turns": turns["this"]}


def check_pdhg_norm(label: str, inputs, dense, dev, parent=None) -> dict:
    """K6 against its twin (estimate_norm_plain, 30 iterations, the seeded
    start vector) at rtol 1e-5, twice bit for bit; its time by events and on
    the device beside its bound; ptxas without a spill.  ``parent``: the
    parent checkout's package, whose K6 must give these bits and is timed
    in turns with this one."""
    cx, cX, pool, index, _ = inputs
    n, (M, k), m = cx.shape[0], pool.idx.shape, 0 if dense is None else dense.m

    def norm(fn):
        return fn(pool, n, 30, None, index, dense)

    a, b2 = norm(pdhg_norm), norm(pdhg_norm)
    t = estimate_norm_plain(pool, n, 30, torch.Generator().manual_seed(0), index, dense)
    torch.cuda.synchronize()
    rel = abs(a.item() - t.item()) / abs(t.item())
    log(f"[pdhg_norm {label}] ||K|| kernel {a.item()!r}, twin {t.item()!r}: rel diff {rel:.3e} "
        f"(rtol {CONTROL_RTOL}); two launches bit for bit: {torch.equal(a, b2)}; the dense "
        f"rows' slice resident in shared memory, the cut data staged there: "
        f"{pdhg_norm_mod.smem_words(n, M, k, m)[1:]}")
    if rel > CONTROL_RTOL or not torch.equal(a, b2):
        raise AssertionError(f"pdhg_norm disagrees with its twin or does not repeat ({label})")
    ms = cuda_ms(lambda: norm(pdhg_norm), reps=20)
    dev_ms = device_ms(lambda: norm(pdhg_norm), "pdhg_norm_kernel", reps=20)
    plain_ms = cuda_ms(lambda: norm(estimate_norm_plain), reps=3, warmup=1)
    bb = bound(norm_ops(n, k, m, int(pool.active.sum()), index.Xcut.numel() + index.xcut.numel(),
                        30),
               nbytes(index.idx, pool.lin, pool.quad, pool.active, index.xoff, index.xcut,
                      index.xcoef, index.Xoff, index.Xcut, index.Xcoef, a,
                      *([] if dense is None else [dense.G, dense.g])) + 4 * (n + n * n))
    log(f"[pdhg_norm {label}] 30 iterations in one launch: kernel {ms:.4f} ms by events (the "
        f"start vector kept on the device), {dev_ms:.4f} ms on the device; twin "
        f"{plain_ms:.4f} ms; {share(dev_ms, bb)} (of the device time); ptxas: "
        f"{spill_free('pdhg_norm_kernel')}")
    out = {"max_abs_err": abs(a.item() - t.item()), "ms": ms, "device_ms": dev_ms,
           "plain_ms": plain_ms, **bb}
    if parent is not None:
        p_norm = importlib.import_module(f"{parent.__name__}.lp.pdhg_norm")
        B1 = rb.batch_of_one
        D1 = None if dense is None else B1(dense)
        entries = {"this": norm_entry(_build.lib(), B1(pool), n, B1(index), D1, dev, False),
                   "parent": norm_entry(parent_build(parent).lib(), B1(pool), n, B1(index),
                                        D1, dev, True)}
        out.update(norm_against_parent(
            parent, label, lambda: norm(pdhg_norm),
            lambda: p_norm.pdhg_norm(pool, n, 30, torch.Generator().manual_seed(0), index,
                                     dense), entries))
    return out


def check_control_batched(insts, dev, parent=None) -> dict:
    """K5 in the batched K2 launch and K6 at the suite bucket's batch (B =
    12, n = 125, phase 3's batched inputs), one instance's record stopped:
    the checked batched launch (100 iterations, then the control) against
    K2's unchecked batched launch followed by the batched twin check (the
    K5 words at rtol 1e-5, the ints equal, the states bit for bit), K6
    against its twin (||K|| at rtol 1e-5); the stopped instance unchanged
    bit for bit; every other one bit for bit equal to the single wrappers'
    launch of it; each batched launch timed.  ``parent``: the parent
    checkout's package, whose batched K6 must give these bits and is timed in
    turns with this one."""
    cx, cX, P, index, st0, pools = batched_inputs(insts, dev)
    (B, n), M = cx.shape, P.idx.shape[1]
    gen = lambda: torch.Generator().manual_seed(0)     # noqa: E731
    normK = estimate_norm_batched_plain(P, n, 30, gen(), index)
    frozen = B // 2 - 1
    ids = [b for b in range(B) if b != frozen]
    rp = 100
    every = CHECK_ARGS["check_every"]

    def prepare():
        rec = new_record(normK, 1.0, 0.95, CHECK_ARGS["max_iters"], CHECK_ARGS["tol"], dev,
                         batch=B)
        rec[frozen, REC_STOP] = 1
        return [st0.map(torch.clone), st0.map(torch.zeros_like), st0.map(torch.clone), rec]

    def run(fn, st, acc, anc, rec):
        fn(cx, cX, P, index, st, acc, anc, rec, every, rp, CHECK_ARGS["max_iters"],
           CHECK_ARGS["tol"])
        return [st, acc, anc, rec]

    def twin(st, acc, anc, rec):
        pdhg_kernel.pdhg_block_steps_batched(cx, cX, P, index, st, acc, rec, every)
        return run(pdhg_check_batched_plain, st, acc, anc, rec)

    ka, kb = run(pdhg_block_checked_batched, *prepare()), run(pdhg_block_checked_batched,
                                                              *prepare())
    tw = twin(*prepare())
    ref = prepare()
    torch.cuda.synchronize()
    bad, rel, absd = record_diff(ka[3], tw[3], ids)
    same = states_equal(ka[:3], tw[:3])
    repeat = states_equal(ka[:3], kb[:3]) and torch.equal(ka[3], kb[3])
    frozen_same = all(torch.equal(u[frozen], v[frozen]) for x, y in zip(ka[:3], ref[:3])
                      for u, v in zip(x.fields(), y.fields())) and torch.equal(ka[3][frozen],
                                                                                ref[3][frozen])
    alone = True
    for b in ids:
        one = [rb.instance(x, b).map(torch.clone) for x in ref[:3]] + [ref[3][b].clone()]
        pdhg_block_checked(cx[b], cX[b], pools[b], build_cut_index(pools[b], n), *one, every,
                           rp, CHECK_ARGS["max_iters"], CHECK_ARGS["tol"])
        alone &= torch.equal(one[3], ka[3][b]) and all(
            torch.equal(u, v[b]) for x, y in zip(one[:3], ka[:3])
            for u, v in zip(x.fields(), y.fields()))
    log(f"[pdhg_check batched] B={B}, n={n}, M={M}, instance {frozen} stopped: the checked "
        f"launch against K2 then the twin check: int words "
        f"differing {bad}, largest rel diff of the float words {rel:.3e} (rtol {CONTROL_RTOL}), "
        f"max|err| {absd:.3e}; states bit for bit: {same}; twice bit for bit: "
        f"{repeat}; the stopped instance unchanged: {frozen_same}; each instance equal to the "
        f"single wrapper's launch on its own cut index: {alone}")
    if bad or rel > CONTROL_RTOL or not (same and repeat and frozen_same and alone):
        raise AssertionError("the batched checked block fails its checks")
    nk, nk2 = pdhg_norm_batched(P, n, 30, None, index), pdhg_norm_batched(P, n, 30, None, index)
    nrel = float(((nk - normK).abs() / normK.abs()).max())
    n_alone = all(torch.equal(pdhg_norm(pools[b], n, 30, None, build_cut_index(pools[b], n)),
                              nk[b]) for b in range(B))
    log(f"[pdhg_norm batched] B={B}: largest rel diff from the twin {nrel:.3e} (rtol "
        f"{CONTROL_RTOL}); twice bit for bit: {torch.equal(nk, nk2)}; each instance equal to the "
        f"single launch: {n_alone}")
    if nrel > CONTROL_RTOL or not (torch.equal(nk, nk2) and n_alone):
        raise AssertionError("the batched pdhg_norm fails its checks")
    args = prepare()

    def unchecked():
        pdhg_kernel.pdhg_block_steps_batched(cx, cX, P, index, args[0], args[1], args[3], every)

    t_k2, t_both = [], []
    for runs, fn in ((t_k2, unchecked), (t_both, lambda: run(pdhg_block_checked_batched, *args)),
                     (t_both, lambda: run(pdhg_block_checked_batched, *args)), (t_k2, unchecked)):
        runs.append(queued_ms(fn, reps=10))
    dev_ms = (sum(t_both) - sum(t_k2)) / 2
    ms = cuda_ms(lambda: run(pdhg_block_checked_batched, *args), reps=20)
    norm_ms = cuda_ms(lambda: pdhg_norm_batched(P, n, 30, None, index), reps=20)
    norm_dev = device_ms(lambda: pdhg_norm_batched(P, n, 30, None, index), "pdhg_norm_kernel",
                         reps=20)
    norm_parent = {}
    if parent is not None:
        p_norm = importlib.import_module(f"{parent.__name__}.lp.pdhg_norm")
        entries = {"this": norm_entry(_build.lib(), P, n, index, None, dev, False),
                   "parent": norm_entry(parent_build(parent).lib(), P, n, index, None, dev,
                                        True)}
        norm_parent = norm_against_parent(
            parent, f"batched B={B}", lambda: pdhg_norm_batched(P, n, 30, None, index),
            lambda: p_norm.pdhg_norm_batched(P, n, 30, gen(), index), entries)
    terms = [int(i.xoff[-1] + i.Xoff[-1]) for i in (build_cut_index(p, n) for p in pools)]
    active = [int(p.active.sum()) for p in pools]
    # the stopped instance's cluster leaves at entry: only the running ones count
    b5 = bound(sum(check_ops(n, 3, 0, active[b], terms[b], True) for b in ids),
               sum(check_bytes(cx[b], cX[b], pools[b], build_cut_index(pools[b], n), None,
                               *(rb.instance(x, b) for x in args[:3]), args[3][b])
                   for b in ids))
    b6 = bound(sum(norm_ops(n, 3, 0, a, t, 30) for a, t in zip(active, terms)),
               nbytes(index.idx, P.lin, P.quad, P.active, index.xoff, index.xcut, index.xcoef,
                      index.Xoff, index.Xcut, index.Xcoef, nk) + 4 * B * (n + n * n))
    log(f"[pdhg_check batched] {B - 1} running instances, on the device (queued events, in "
        f"turns): the checked launch {t_both!r} ms, K2 alone {t_k2!r} ms: K5 in K2's launch "
        f"{dev_ms:.4f} ms; the checked launch by events back to back {ms:.4f} ms; K5 "
        f"{share(max(dev_ms, 1e-9), b5)}")
    log(f"[pdhg_norm batched] {B} instances, 30 iterations: {norm_ms:.4f} ms by events, "
        f"{norm_dev:.4f} ms on the device; {share(norm_dev, b6)}")
    return {"check": {"batched_ms": dev_ms, "batched_device_ms": dev_ms,
                      "batched_checked_launch_ms": sum(t_both) / 2,
                      "batched_unchecked_launch_ms": sum(t_k2) / 2,
                      "batched_checked_launch_events_ms": ms,
                      "batched_bound_ms": b5["bound_ms"], "batched_max_abs_err": absd},
            "norm": {"batched_ms": norm_ms, "batched_device_ms": norm_dev,
                     "batched_bound_ms": b6["bound_ms"],
                     "batched_max_abs_err": float((nk - normK).abs().max()),
                     **{f"batched_{key}": v for key, v in norm_parent.items()}}}


# phase 3's dense route (K7, csrc/pdhg_dense.cu): the certifier's shapes,
# (n, m dense rows): spar125-100-1 with the 368 rows phase 15 (c) solves over
# and with the full buffer, and n = 10 with 368
DENSE_SHAPES = ((10, 368), (125, 368), (125, FULL_CAPACITY))
DENSE_BLOCK_EXTRA = (64, 2048)    # the block alone: a middle n over the full buffer
DENSE_RTOL = 2e-5            # the block against its twin, state and sums, 100 iterations
BACKLOG_CYCLES = 4_000_000   # a sleep kernel of ~2 ms at the H100's clocks


def queued_ms(fn, reps: int) -> float:
    """Mean device milliseconds of one call of ``fn`` (one kernel launch and
    nothing else on the stream): CUDA events right around each call, each
    queued behind a sleep kernel that outlasts the host's launch, so the
    events bracket the kernel's run on the device and not the host.  No
    profiler session: a session on the card's machine now and then records
    no kernel at all (scoring_variants.device_ms)."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(BACKLOG_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def dense_inputs(n: int, m: int, dev):
    """The certifier's LP at (n, m): an instance's Q and c (spar125-100-1 at
    n = 125, generate_spar(n, 100, 1) otherwise), the certifier's pool
    without cuts, m normalised rank-1 rows v v' >= 0 of random unit
    directions (the seed rows' form, loop/sdp_bound.py::_seed_rows), and a
    random state whose yD is positive on about a third of the rows.
    Returns (cx, cX, pool, index, dense, state)."""
    inst = (parse_boxqp(os.path.join(DATA, f"{INSTANCE}.in"), name=INSTANCE) if n == 125
            else generate_spar(n, 100, 1))
    rng = np.random.default_rng(SEED + 3)
    V = rng.standard_normal((m, n + 1))
    G, g, h = _seed_rows(V / np.linalg.norm(V, axis=1, keepdims=True))
    f32 = dict(dtype=torch.float32, device=dev)
    dense = DenseRows(*(torch.as_tensor(a, **f32) for a in (G, g, h)))
    pool = empty_pool(1, 1, dev)
    st = random_state(n, 1, m, pool, rng, dev)
    st.yD = torch.as_tensor(0.2 * rng.random(m) * (rng.random(m) < 0.3), **f32)
    return (torch.as_tensor(-inst.c, **f32), torch.as_tensor(-0.5 * inst.Q, **f32), pool,
            build_cut_index(pool, n), dense, st)


def dense_bytes(cx, cX, dense, *states) -> int:
    """Each input of a dense-route launch read once, each output written once:
    the problem's arrays and the given states (inputs and outputs)."""
    return nbytes(cx, cX, dense.G, dense.g, dense.h, *(t for s in states for t in s.fields()))


def check_dense_block(label: str, inputs, parent=None) -> dict:
    """K7's block against its twin (pdhg_block_plain on the certifier's
    pool) after 100 iterations at rtol = atol = 2e-5, state and sums; two
    launches bit for bit, the inputs unchanged; the solve's in-place block
    (steps from the record) bit for bit equal to the host-step launch; its
    plan (block_plan) and the CTAs it took; its time by events and on the
    device beside the bound and the streaming figure (G read twice an
    iteration); at the "cta" plan's shapes also the "grid" plan, checked and
    timed in turns.  ``parent``: the parent checkout's package, whose block
    must give these bits and is then timed on the device in turns with this
    one (parent, this, this, parent)."""
    cx, cX, pool, index, dense, st = inputs
    n, m = cx.shape[0], dense.m
    normK = estimate_norm_plain(pool, n, 30, torch.Generator().manual_seed(0), index, dense)
    eta = 0.95 / normK.item()
    zero = st.map(torch.zeros_like)
    args = (cx, cX, pool, index, st, zero, eta, eta, 100, dense)
    inputs_before = [t.clone() for t in (*st.fields(), *zero.fields())]
    got, again = pdhg_dense_block(*args), pdhg_dense_block(*args)
    want = pdhg_block_plain(*args)
    torch.cuda.synchronize()

    def against_twin(out):
        errs, ratio = [], 0.0
        for g_, w_ in zip((*out[0].fields(), *out[1].fields()),
                          (*want[0].fields(), *want[1].fields())):
            if g_.numel():
                e, r = excess(g_, w_, DENSE_RTOL, DENSE_RTOL)
                errs.append(e)
                ratio = max(ratio, r)
        return errs, ratio

    errs, ratio = against_twin(got)
    same = states_equal(list(got), list(again))
    unchanged = all(torch.equal(a, b) for a, b in zip((*st.fields(), *zero.fields()),
                                                      inputs_before))
    # the solve's block: in place, tau and sigma from a control record
    ip = [st.map(torch.clone), zero.map(torch.clone)]
    rec = pdhg_kernel.steps_record([eta], [eta], cx.device)[0]
    plan = pdhg_dense.block_plan(n, m)
    grid = pdhg_dense._launch_block(cx, cX, pool, ip, ip, rec, 100, dense)
    in_place = states_equal(ip, list(got))
    log(f"[pdhg_dense {label}] plan {plan!r}, {grid} CTA(s) x 512 threads, "
        f"{pdhg_dense.smem_bytes(n, m)} bytes of shared memory a CTA; 100 iterations: "
        f"max|err| state {max(errs[:5]):.3e} sums {max(errs[5:]):.3e}; {ratio:.3f} of the "
        f"limit (rtol = atol = {DENSE_RTOL}); two launches bit for bit: {same}; inputs "
        f"unchanged: {unchanged}; the in-place block with the record's steps bit for bit: "
        f"{in_place}")
    if ratio > 1.0 or not (same and unchanged and in_place):
        raise AssertionError(f"the dense-route block fails its checks ({label})")
    ms = cuda_ms(lambda: pdhg_dense_block(*args), reps=10)
    dev_ms = queued_ms(lambda: pdhg_dense_block_steps(cx, cX, pool, index, *ip, rec, 100, dense),
                       reps=10)
    plain_ms = cuda_ms(lambda: pdhg_block_plain(*args), reps=2, warmup=1)
    b = bound(pdhg_ops(n, 1, m, 0, 0, 100), dense_bytes(cx, cX, dense, st, zero, *got))
    stream_ms = 100 * 2 * nbytes(dense.G, dense.g) / PEAK_BYTES * 1e3
    kernel = {"cta": "pdhg_dense_cta_kernelILb0", "grid": "pdhg_dense_grid_kernelILb0"}[plan]
    log(f"[pdhg_dense {label}] 100-iteration block: {ms:.4f} ms by events back to back, "
        f"{dev_ms:.4f} ms on the device (queued events) = {dev_ms * 10:.3f} us an iteration; "
        f"twin {plain_ms:.4f} ms ({plain_ms * 10:.2f} us an iteration); {share(dev_ms, b)} (of "
        f"the device time); G and g read twice an iteration at {PEAK_BYTES / 1e12} TB/s: "
        f"{stream_ms:.4f} ms, {stream_ms / dev_ms:.2%} of the device time "
        f"({2 * nbytes(dense.G, dense.g) * 100 / (dev_ms * 1e-3) / 1e12:.3f} TB/s); "
        f"{nbytes(dense.G) / 2 ** 20:.1f} MiB of G ({SMI}); ptxas: {ptxas_report(kernel)}")
    out = {"max_abs_err": max(errs), "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, **b,
           "streaming_bound_ms": stream_ms, "share": b["bound_ms"] / dev_ms,
           "us_per_iteration": dev_ms * 10, "plan": plan, "grid": grid}
    if plan == "cta":
        # the "grid" plan at the same shape, held to the twin and timed in turns
        outs = [s_.map(torch.empty_like) for s_ in (st, zero)]
        for o, s_ in zip(outs, (st, zero)):
            o.yC = s_.yC.clone()             # the kernels leave yC as it is
        ggrid = pdhg_dense._launch_block(cx, cX, pool, [st, zero], outs, rec, 100, dense,
                                         plan="grid")
        torch.cuda.synchronize()
        gratio = against_twin(outs)[1]
        t_cta, t_grid = [], []
        for runs, p_ in ((t_cta, "cta"), (t_grid, "grid"), (t_grid, "grid"), (t_cta, "cta")):
            runs.append(queued_ms(lambda: pdhg_dense._launch_block(
                cx, cX, pool, ip, ip, rec, 100, dense, plan=p_), reps=5))
        log(f"[pdhg_dense {label}] the 'grid' plan here: {ggrid} CTAs, {gratio:.3f} of the "
            f"limit against the twin; on the device in turns: 'cta' {t_cta!r} ms, 'grid' "
            f"{t_grid!r} ms ({SMI})")
        if gratio > 1.0:
            raise AssertionError(f"the dense block's grid plan disagrees with its twin ({label})")
        out["grid_plan_device_ms"] = sum(t_grid) / 2
    if parent is not None:
        p_dense = importlib.import_module(f"{parent.__name__}.lp.pdhg_dense")
        theirs = p_dense.pdhg_dense_block(*args)
        torch.cuda.synchronize()
        p_same = states_equal(list(got), list(theirs))
        log(f"[pdhg_dense {label}] this build's block and the parent build's bit for bit: "
            f"{p_same}")
        if not p_same:
            raise AssertionError(f"the dense block does not give the parent build's bits "
                                 f"({label})")
        out["parent_bits"] = p_same
        p_ip = [st.map(torch.clone), zero.map(torch.clone)]
        t_parent, t_this = [], []
        for runs, fn in ((t_parent, p_dense.pdhg_dense_block_steps),
                         (t_this, pdhg_dense_block_steps), (t_this, pdhg_dense_block_steps),
                         (t_parent, p_dense.pdhg_dense_block_steps)):
            bufs = p_ip if runs is t_parent else ip
            runs.append(queued_ms(lambda: fn(cx, cX, pool, index, *bufs, rec, 100, dense),
                                  reps=5))
        log(f"[pdhg_dense {label}] on the device in turns: parent build {t_parent!r} ms, this "
            f"build {t_this!r} ms (100 iterations; {SMI})")
        out["parent_device_ms"] = sum(t_parent) / 2
        out["parent_device_ms_turns"] = t_parent
        out["device_ms_turns"] = t_this
    return out


def check_dense_check(label: str, inputs, parent=None) -> dict:
    """K7c, the check in the dense route's checked launch
    (pdhg_dense_block_checked: a 100-iteration K7 block, then the checked
    block's control on the slices each CTA owns), from the state and sums
    after one K7 block, against K7's unchecked block (pdhg_dense_block_steps)
    followed by the twin check (pdhg_check_plain), as check_pdhg_check holds
    K5: restart_period 10^9 and 100, the record's float words at rtol 1e-5
    and its ints equal, the state, sums and anchor bit for bit; twice bit for
    bit; a stopped record leaves everything as it is.  Timed at
    restart_period 100 on the device (queued events) in turns with the
    unchecked block, whose difference is K7c's time in the launch, on a
    record and a stop test that never stop (every launch does the work).
    ``parent``: the parent checkout's package, whose checked launch must give
    these bits and is timed in turns with this build's, each beside its
    unchecked block."""
    cx, cX, pool, index, dense, st0 = inputs
    n, m = cx.shape[0], dense.m
    normK = estimate_norm_plain(pool, n, 30, torch.Generator().manual_seed(0), index, dense)
    eta = 0.95 / normK.item()
    st1, acc1 = pdhg_dense_block(cx, cX, pool, index, st0, st0.map(torch.zeros_like), eta, eta,
                                 100, dense)
    every, top, tol = CHECK_ARGS["check_every"], CHECK_ARGS["max_iters"], CHECK_ARGS["tol"]

    def prepare(stops: bool = True):
        """State, sums, anchor and a fresh record; stops False: a record that
        never stops (timing: many launches on one set of buffers)."""
        rec = (new_record(normK, 1.0, 0.95, top, tol, cx.device) if stops
               else new_record(normK, 1.0, 0.95, 10 ** 9, 0.0, cx.device))
        return [st1.map(torch.clone), acc1.map(torch.clone), st0.map(torch.clone), rec]

    never = (10 ** 9, -1.0)         # a stop test that never stops (the timed launches)

    def checked(bufs, rp, stop=(top, tol)):
        pdhg_dense_block_checked(cx, cX, pool, index, *bufs, every, rp, *stop, dense)
        return bufs

    def twin(bufs, rp):
        pdhg_dense_block_steps(cx, cX, pool, index, bufs[0], bufs[1], bufs[3], every, dense)
        pdhg_check_plain(cx, cX, pool, index, *bufs, every, rp, top, tol, dense)
        return bufs

    worst = 0.0
    for rp in (10 ** 9, 100):
        ka, kb, tw = checked(prepare(), rp), checked(prepare(), rp), twin(prepare(), rp)
        torch.cuda.synchronize()
        bad, rel, absd = record_diff(ka[3], tw[3], slice(None))
        same = states_equal(ka[:3], tw[:3])
        repeat = states_equal(ka[:3], kb[:3]) and torch.equal(ka[3], kb[3])
        r = ka[3].cpu().numpy()
        log(f"[pdhg_dense_check {label}] restart_period {rp}: restart {bool(r[REC_RESTART])}, "
            f"use_avg {bool(r[REC_USE_AVG])}, omega {float(record_floats(r)[REC_OMEGA])!r}; "
            f"the checked launch against K7's block then the twin check: int words differing "
            f"{bad}, largest rel diff of the float words {rel:.3e} (rtol {CONTROL_RTOL}), max|err| "
            f"of err/p/d/omega {absd:.3e}; state, sums and anchor bit for bit: {same}; two "
            f"launches bit for bit: {repeat}")
        if bad or rel > CONTROL_RTOL or not (same and repeat):
            raise AssertionError(f"the dense route's checked launch disagrees with K7's block "
                                 f"and the twin check or does not repeat ({label})")
        worst = max(worst, absd)
    args = prepare()
    args[3][REC_STOP] = 1
    before = [t.clone() for t in (*[u for x in args[:3] for u in x.fields()], args[3])]
    checked(args, 100)
    frozen = all(torch.equal(a, b) for a, b in zip(
        before, (*[u for x in args[:3] for u in x.fields()], args[3])))
    log(f"[pdhg_dense_check {label}] a stopped record leaves everything bit for bit: {frozen}")
    if not frozen:
        raise AssertionError(f"the dense route's checked launch wrote a stopped instance ({label})")
    bufs = prepare(stops=False)

    def unchecked():
        pdhg_dense_block_steps(cx, cX, pool, index, bufs[0], bufs[1], bufs[3], every, dense)

    t_k7, t_both = [], []
    for runs, fn in ((t_k7, unchecked), (t_both, lambda: checked(bufs, 100, never)),
                     (t_both, lambda: checked(bufs, 100, never)), (t_k7, unchecked)):
        runs.append(queued_ms(fn, reps=10))
    both, k7_ms = sum(t_both) / 2, sum(t_k7) / 2
    dev_ms = both - k7_ms
    ms = cuda_ms(lambda: checked(bufs, 100, never), reps=10)
    tw = prepare()
    plain_ms = cuda_ms(lambda: pdhg_check_plain(cx, cX, pool, index, *tw, every, 100, top, tol,
                                                dense), reps=3)
    b = bound(check_ops(n, 1, m, 0, 0, True), check_bytes(cx, cX, pool, index, dense, *bufs))
    stream_ms = nbytes(dense.G, dense.g) / PEAK_BYTES * 1e3
    kernel = {"cta": "pdhg_dense_cta_kernelILb1", "grid": "pdhg_dense_grid_kernelILb1"}[
        pdhg_dense.block_plan(n, m)]
    log(f"[pdhg_dense_check {label}] on the device (queued events, in turns): the checked "
        f"launch {t_both!r} ms, K7's block alone {t_k7!r} ms: K7c in the launch {dev_ms:.4f} ms; "
        f"the checked launch by events back to back {ms:.4f} ms; twin check {plain_ms:.4f} ms "
        f"(reads to the host included); K7c {share(max(dev_ms, 1e-9), b)} (of its device time); "
        f"G read once: {stream_ms:.4f} ms; ptxas (checked form): {spill_free(kernel)} ({SMI})")
    out = {"max_abs_err": worst, "ms": dev_ms, "device_ms": dev_ms, "plain_ms": plain_ms, **b,
           "streaming_bound_ms": stream_ms, "share": b["bound_ms"] / max(dev_ms, 1e-9),
           "checked_launch_ms": both, "unchecked_launch_ms": k7_ms,
           "checked_launch_events_ms": ms}
    if parent is not None:
        p_dense = importlib.import_module(f"{parent.__name__}.lp.pdhg_dense")
        same = True
        for rp in (10 ** 9, 100):
            mine, theirs = checked(prepare(), rp), prepare()
            p_dense.pdhg_dense_block_checked(cx, cX, pool, index, *theirs, every, rp, top, tol,
                                             dense)
            torch.cuda.synchronize()
            same = same and states_equal(mine[:3], theirs[:3]) and torch.equal(mine[3], theirs[3])
        p_bufs = prepare(stops=False)

        def parent_block():
            p_dense.pdhg_dense_block_steps(cx, cX, pool, index, p_bufs[0], p_bufs[1], p_bufs[3],
                                           every, dense)

        def parent_checked():
            p_dense.pdhg_dense_block_checked(cx, cX, pool, index, *p_bufs, every, 100, *never,
                                             dense)

        turns = {"parent": [], "this": []}
        for tree in ("parent", "this", "this", "parent"):
            block, pair = ((parent_block, parent_checked) if tree == "parent"
                           else (unchecked, lambda: checked(bufs, 100, never)))
            t_b, t_p = queued_ms(block, reps=10), queued_ms(pair, reps=10)
            turns[tree].append((t_p, t_b, t_p - t_b))
        log(f"[pdhg_dense_check {label}] this build's checked launch and the parent build's bit "
            f"for bit (restart periods 10^9 and 100): {same}; in turns on the device, (the "
            f"checked launch, the block alone, the check's share) ms: parent "
            f"{turns['parent']!r}, this build {turns['this']!r} ({SMI})")
        if not same:
            raise AssertionError(f"the dense route's checked launch does not give the parent "
                                 f"build's bits ({label})")
        out["parent_device_ms"] = sum(t[2] for t in turns["parent"]) / 2
        out["parent_turns"] = turns["parent"]
        out["this_turns"] = turns["this"]
    return out


def grid_slices_resident(n: int, m: int, P: int) -> bool:
    """Whether every CTA of the "grid" plan on P CTAs keeps its slice of G
    and g in shared memory for the launch: csrc/pdhg_dense.cu's
    GridCta::resident, m rows of the CTA's 16-byte-aligned spans within the
    slab that grid_layout leaves."""
    rest = pdhg_dense._SCRATCH + m + pdhg_dense.max_entries(n)
    slab = max((pdhg_dense._SMEM_WORDS - rest) & ~3, pdhg_dense._STAGES * pdhg_dense._STAGE)
    widest = 0
    for b in range(P):
        spans = (N * (b + 1) // P - N * b // P for N in (n * n, n))
        widest = max(widest, sum((L + 6) & ~3 if L > 0 else 0 for L in spans))
    return m * widest <= slab


def check_dense_norm(label: str, inputs, parent=None) -> dict:
    """K7n, the dense route's ||K|| on the block's launch plan, against its
    twin (estimate_norm_plain, 30 iterations, the seeded start vector) at
    rtol 1e-5, twice bit for bit, the C entry alone on the kept start
    vector bit for bit with the wrapper, as K6 is held; its plan and CTAs;
    its time by events (the wrapper) and on the device (queued events, the C
    entry alone) beside its bound and the streaming figure (G read once
    where every slice of it stays in shared memory, else twice a power
    iteration and once more for the last K z); ptxas without a spill or a
    stack.  ``parent``: the parent checkout's package, whose K7n is timed on
    the device in turns with this one through each tree's own wrapper (the
    parent's C entry takes other arguments)."""
    cx, cX, pool, index, dense, _ = inputs
    n, m = cx.shape[0], dense.m

    def norm(fn, gen=True):
        return fn(pool, n, 30, torch.Generator().manual_seed(0) if gen else None, index, dense)

    a, b2, t = norm(pdhg_dense_norm), norm(pdhg_dense_norm), norm(estimate_norm_plain)
    plan = pdhg_dense.block_plan(n, m)
    P = 1 if plan == "cta" else pdhg_dense.block_grid(n, m)
    resident = plan == "cta" or grid_slices_resident(n, m, P)
    y, Y = (u.contiguous() for u in pdhg_mod.start_vector(n, None, cx.device))
    work = (None if plan == "cta" else torch.empty(pdhg_dense._norm_work_words(n, m, P),
                                                   dtype=torch.float32, device=cx.device))
    out, grid = torch.empty((), device=cx.device), ctypes.c_int(0)
    args = (n, m, 30, pdhg_dense.PLANS.index(plan), pdhg_dense.smem_bytes(n, m),
            dense.G.data_ptr(), dense.g.data_ptr(), y.data_ptr(), Y.data_ptr(),
            *([None, None] if work is None else [work.data_ptr(), work[-1:].data_ptr()]),
            out.data_ptr(), ctypes.byref(grid), torch.cuda.current_stream().cuda_stream)
    lib = _build.lib()

    def launch():           # the entry point alone: no draw, upload or allocation
        _build.check(lib.pdhg_dense_norm_launch(*args), "pdhg_dense_norm_launch")

    launch()
    torch.cuda.synchronize()
    rel = abs(a.item() - t.item()) / abs(t.item())
    entry_same = torch.equal(out, a)
    kernel = {"cta": "pdhg_dense_norm_cta_kernel", "grid": "pdhg_dense_norm_grid_kernel"}[plan]
    ptxas = spill_free(kernel)
    log(f"[pdhg_dense_norm {label}] plan {plan!r}, {grid.value} CTA(s) x 512 threads, "
        f"{pdhg_dense.smem_bytes(n, m)} bytes of shared memory a CTA, G "
        f"{'resident' if resident else 'streamed'}; ||K|| kernel {a.item()!r}, twin "
        f"{t.item()!r}: rel diff {rel:.3e} (rtol {CONTROL_RTOL}); two launches bit for bit: "
        f"{torch.equal(a, b2)}; the C entry alone on the kept start vector bit for bit: "
        f"{entry_same}")
    if (rel > CONTROL_RTOL or not torch.equal(a, b2) or not entry_same
            or grid.value != P or re.search(r"[1-9]\d* bytes stack frame", ptxas)):
        raise AssertionError(f"the dense-route norm disagrees with its twin, does not repeat, "
                             f"or has a stack frame ({label}): {ptxas}")
    ms = cuda_ms(lambda: norm(pdhg_dense_norm, gen=False), reps=5)
    dev_ms = queued_ms(launch, reps=5)
    plain_ms = cuda_ms(lambda: norm(estimate_norm_plain), reps=2, warmup=1)
    bb = bound(norm_ops(n, 1, m, 0, 0, 30), nbytes(dense.G, dense.g, a) + 4 * (n + n * n))
    passes = 1 if resident else 61
    stream_ms = passes * nbytes(dense.G, dense.g) / PEAK_BYTES * 1e3
    log(f"[pdhg_dense_norm {label}] 30 iterations in one launch: {ms:.4f} ms by events (the "
        f"wrapper, the kept start vector), {dev_ms:.4f} ms on the device (queued events, the "
        f"entry point alone) = {dev_ms / 31 * 1e3:.2f} us a power iteration; twin "
        f"{plain_ms:.4f} ms; {share(dev_ms, bb)} (of the device time); G and g read "
        f"{passes} time(s) at {PEAK_BYTES / 1e12} TB/s: {stream_ms:.4f} ms, "
        f"{stream_ms / dev_ms:.2%} of the device time; ptxas: {ptxas} ({SMI})")
    res = {"max_abs_err": abs(a.item() - t.item()), "ms": ms, "device_ms": dev_ms,
           "plain_ms": plain_ms, **bb, "streaming_bound_ms": stream_ms,
           "share": bb["bound_ms"] / dev_ms, "plan": plan, "grid": P, "resident": resident}
    if parent is not None:
        p_dense = importlib.import_module(f"{parent.__name__}.lp.pdhg_dense")
        pa = norm(p_dense.pdhg_dense_norm, gen=False)
        turns = {"parent": [], "this": []}
        for tree in ("parent", "this", "this", "parent"):
            fn = p_dense.pdhg_dense_norm if tree == "parent" else pdhg_dense_norm
            turns[tree].append(queued_ms(lambda: norm(fn, gen=False), reps=5))
        log(f"[pdhg_dense_norm {label}] the parent build's K7n {pa.item()!r} (rel diff to the "
            f"twin {abs(pa.item() - t.item()) / abs(t.item()):.3e}); on the device in turns, "
            f"each tree's wrapper on the kept start vector: parent {turns['parent']!r} ms, this "
            f"build {turns['this']!r} ms ({SMI})")
        res.update({"parent_device_ms": sum(turns["parent"]) / 2,
                    "parent_device_ms_turns": turns["parent"], "device_ms_turns": turns["this"]})
    return res


def check_dense_route(dev, parent=None) -> dict:
    """Phase 3's dense route: K7's block, its checked launch (K7c) and the
    norm (K7n) at DENSE_SHAPES against their twins, and the block and the
    norm at n = 64 over 2048 rows (DENSE_BLOCK_EXTRA).  ``parent``: the
    parent checkout's package, whose block, checked launch and norm are
    timed in turns with this build's.  Returns {kernel: {shape label:
    numbers}}."""
    return check_dense_shapes((*DENSE_SHAPES, DENSE_BLOCK_EXTRA), DENSE_SHAPES, dev, parent)


def check_dense_shapes(shapes, checked, dev, parent=None) -> dict:
    """K7's block and norm at every (n, m) of ``shapes``, its checked launch
    (K7c) at those of ``checked``, each against its twin; {kernel: {shape
    label: numbers}}."""
    out = {"pdhg_dense": {}, "pdhg_dense_check": {}, "pdhg_dense_norm": {}}
    for n, m in shapes:
        label = f"n={n} m={m}"
        inputs = dense_inputs(n, m, dev)
        log(f"[pdhg_dense {label}] block plan {pdhg_dense.block_plan(n, m)!r} (the 'grid' plan "
            f"would take {pdhg_dense.block_grid(n, m)} CTAs, at most "
            f"{pdhg_dense.max_entries(n)} entries a CTA at column width "
            f"{pdhg_kernel.columns(n)}); shared bytes a CTA of the block, its checked form and "
            f"the norm: {pdhg_dense.smem_bytes(n, m)}; the route takes up to "
            f"{pdhg_dense.max_dense_rows(n)} rows at n = {n}")
        out["pdhg_dense"][label] = check_dense_block(label, inputs, parent)
        if (n, m) in checked:
            out["pdhg_dense_check"][label] = check_dense_check(label, inputs, parent)
        out["pdhg_dense_norm"][label] = check_dense_norm(label, inputs, parent)
    return out


def dense_entry(name: str, replaces: str, launches: int, shapes: dict,
                source: str = "pdhg_dense.cu", main: str = f"n=125 m={FULL_CAPACITY}") -> dict:
    """A kernels-line entry of the dense route (or of the grid route,
    ``source`` pdhg_grid.cu): the numbers at the shape labelled ``main`` (the
    full buffer at n = 125) as the entry's own, every shape's under its
    label, the largest error over the shapes."""
    return {"name": name, "route": "cuda", "source": f"sdpcutsel_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches, **shapes[main],
            "max_abs_err": max(s["max_abs_err"] for s in shapes.values()),
            "shapes": shapes}


PARENT_ALIAS = "parent_sdpcutsel_tpu_torch"


def parent_build(pkg):
    """The parent package's _build module (its kernels, its build log)."""
    return importlib.import_module(f"{pkg.__name__}._build")


def parent_package(parent: str):
    """The parent checkout's port package, imported once under another name
    (import_checkout); its kernels build into the parent checkout's own
    build/cuda/ at first use."""
    return sys.modules.get(PARENT_ALIAS) or import_checkout(parent, PARENT_ALIAS)


def checked_against_parent(pkg, label: str, inputs, dense, dev) -> bool:
    """This tree's checked block (one launch: K2, then K5 in it) and the
    parent build's (its checked launch, the same kernel source), from phase
    3's random state on a fresh record, restart_period 10^9 and 100: state,
    sums, anchor and record bit for bit.  Then both timed in turns (parent,
    this, this, parent) at restart_period 100, on the device (queued
    events) and by events back to back (the host's share included)."""
    cx, cX, pool, index, st0 = inputs
    n = cx.shape[0]
    normK = estimate_norm_plain(pool, n, 30, torch.Generator().manual_seed(0), index, dense)
    p_check = importlib.import_module(f"{pkg.__name__}.lp.pdhg_check")
    every, top, tol = CHECK_ARGS["check_every"], CHECK_ARGS["max_iters"], CHECK_ARGS["tol"]

    def prepare():
        return [st0.map(torch.clone), st0.map(torch.zeros_like), st0.map(torch.clone),
                new_record(normK, 1.0, 0.95, top, tol, dev)]

    same = True
    for rp in (10 ** 9, 100):
        def parent_call(bufs, rp=rp):
            p_check.pdhg_block_checked(cx, cX, pool, index, *bufs, every, rp, top, tol, dense)

        def this_call(bufs, rp=rp):
            pdhg_block_checked(cx, cX, pool, index, *bufs, every, rp, top, tol, dense)

        mine, theirs = prepare(), prepare()
        this_call(mine)
        parent_call(theirs)
        torch.cuda.synchronize()
        ok = states_equal(mine[:3], theirs[:3]) and torch.equal(mine[3], theirs[3])
        log(f"[pdhg_check {label}] restart_period {rp}: this build's checked launch and the "
            f"parent build's bit for bit (state, sums, anchor, record): {ok}")
        same &= ok
    dev_t, ev_t = {"parent": [], "this": []}, {"parent": [], "this": []}
    for tree, fn in (("parent", parent_call), ("this", this_call), ("this", this_call),
                     ("parent", parent_call)):
        bufs = prepare()
        dev_t[tree].append(queued_ms(lambda: fn(bufs), reps=10))
        ev_t[tree].append(cuda_ms(lambda: fn(bufs), reps=20))
    log(f"[pdhg_check {label}] a checked block in turns, on the device: parent "
        f"{dev_t['parent']!r} ms, this build (one launch) {dev_t['this']!r} ms; by events back "
        f"to back: parent {ev_t['parent']!r} ms, this build {ev_t['this']!r} ms ({SMI})")
    return same


def checked_batched_against_parent(pkg, insts, dev) -> bool:
    """checked_against_parent at the suite bucket's batch (B = 12, n = 125,
    one instance's record stopped): this tree's batched checked launch and
    the parent build's, bit for bit at restart_period 10^9 and 100, then
    timed in turns."""
    cx, cX, P, index, st0, _ = batched_inputs(insts, dev)
    B, n = cx.shape
    normK = estimate_norm_batched_plain(P, n, 30, torch.Generator().manual_seed(0), index)
    p_check = importlib.import_module(f"{pkg.__name__}.lp.pdhg_check")
    every, top, tol = CHECK_ARGS["check_every"], CHECK_ARGS["max_iters"], CHECK_ARGS["tol"]

    def prepare():
        rec = new_record(normK, 1.0, 0.95, top, tol, dev, batch=B)
        rec[B // 2 - 1, REC_STOP] = 1
        return [st0.map(torch.clone), st0.map(torch.zeros_like), st0.map(torch.clone), rec]

    same = True
    for rp in (10 ** 9, 100):
        def parent_call(bufs, rp=rp):
            p_check.pdhg_block_checked_batched(cx, cX, P, index, *bufs, every, rp, top, tol)

        def this_call(bufs, rp=rp):
            pdhg_block_checked_batched(cx, cX, P, index, *bufs, every, rp, top, tol)

        mine, theirs = prepare(), prepare()
        this_call(mine)
        parent_call(theirs)
        torch.cuda.synchronize()
        ok = states_equal(mine[:3], theirs[:3]) and torch.equal(mine[3], theirs[3])
        log(f"[pdhg_check batched] B={B}, restart_period {rp}: this build's checked launch and "
            f"the parent build's bit for bit: {ok}")
        same &= ok
    dev_t, ev_t = {"parent": [], "this": []}, {"parent": [], "this": []}
    for tree, fn in (("parent", parent_call), ("this", this_call), ("this", this_call),
                     ("parent", parent_call)):
        bufs = prepare()
        dev_t[tree].append(queued_ms(lambda: fn(bufs), reps=10))
        ev_t[tree].append(cuda_ms(lambda: fn(bufs), reps=20))
    log(f"[pdhg_check batched] a checked block of B={B} in turns, on the device: parent "
        f"{dev_t['parent']!r} ms, this build {dev_t['this']!r} ms; by events back to back: "
        f"parent {ev_t['parent']!r} ms, this build {ev_t['this']!r} ms ({SMI})")
    return same


def parent_k2(pkg, parent: str):
    """The K2 of another checkout (the parent commit's: steps from a control
    record), built alone with this build's nvcc flags into
    build/cuda/parent/, its entry point typed by the parent package's own
    signatures (``pkg``)."""
    src = os.path.join(parent, "sdpcutsel_tpu_torch", "csrc", "pdhg_block.cu")
    out = os.path.join(REPO, "build", "cuda", "parent", "libpdhg_block.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", out, src],
                   check=True, capture_output=True, text=True, timeout=600)
    lib = ctypes.CDLL(out)
    lib.pdhg_block_launch.argtypes = parent_build(pkg)._SIGNATURES["pdhg_block_launch"]
    lib.pdhg_block_launch.restype = ctypes.c_int
    return lib


def k2_against_parent(lib, label: str, args: tuple, dense, iters: int) -> bool:
    """This K2 and the parent build's on the same inputs, both with their
    steps from one control record: equal bit for bit?  Both entry points are
    then called directly and timed by events in turns (parent, this, this,
    parent), 20 back to back each, on prepared buffers."""
    cx, cX, pool, index, st, acc, tau, sigma = args
    B1 = rb.batch_of_one
    P1, I1, S1, A1 = B1(pool), B1(index), B1(st), B1(acc)
    D1 = None if dense is None else B1(dense)
    n, (M, k) = cx.shape[0], pool.idx.shape
    m = 0 if dense is None else dense.m
    plan = launch_plan(n, M, k, m)
    ins = [t.contiguous() for t in (*S1.fields(), *A1.fields())]
    outs_p, outs_t = [torch.empty_like(t) for t in ins], [torch.empty_like(t) for t in ins]
    d = [None] * 3 if D1 is None else [t.contiguous().data_ptr() for t in (D1.G, D1.g, D1.h)]
    c = [t.contiguous() for t in (cx[None], cX[None], I1.idx, P1.lin, P1.quad, P1.rhs,
                                  P1.active, I1.xoff, I1.xcut, I1.xcoef, I1.Xoff, I1.Xcut,
                                  I1.Xcoef)]
    rec = pdhg_kernel.steps_record([tau], [sigma], cx.device)

    def call(library, outs, who):
        # an entry point without the width argument (a build before the
        # 256-column form) takes the narrow plan's other arguments alone
        fn = library.pdhg_block_launch
        width = [plan.cols] if len(fn.argtypes) == len(_build._SIGNATURES[
            "pdhg_block_launch"]) else []
        err = fn(
            n, M, k, m, iters, plan.cluster, *width, plan.term_cap, plan.smem_bytes, 1,
            (ctypes.c_int * 1)(0), rec.data_ptr(), I1.xcut.shape[-1], I1.Xcut.shape[-1],
            *(t.data_ptr() for t in c), *d, *(t.data_ptr() for t in ins),
            *(t.data_ptr() for t in outs), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{who} pdhg_block_launch returned {err}")

    def parent_call():
        call(lib, outs_p, "the parent's")

    def this_call():
        call(_build.lib(), outs_t, "this build's")

    parent_call()
    this_call()
    torch.cuda.synchronize()
    same = all(torch.equal(u, v) for u, v in zip(outs_t, outs_p))
    t_parent, t_this = [], []
    for runs, fn in ((t_parent, parent_call), (t_this, this_call), (t_this, this_call),
                     (t_parent, parent_call)):
        runs.append(cuda_ms(fn, reps=20))
    log(f"[pdhg_block {label}] {iters} iterations: this build's K2 and the parent build's bit "
        f"for bit: {same}; in turns, parent {t_parent!r} ms, this build {t_this!r} ms")
    return same


def check_fused_score(label: str, Q, table: np.ndarray, sweeps: int, dev) -> dict:
    """K4 against its twin at the reference's kernel tolerances
    (tests/test_fused_score.py): feas atol 5e-4, nn rtol 2e-4 / atol 2e-5;
    its launch grid, its time by events and on the device, its bound."""
    args = fused_args(Q, table, sweeps, dev)
    x, X, table, triQ, scale, mlp, _ = args
    T, k = table.shape
    nn_k, feas_k = fused_score(*args)
    nn_p, feas_p = fused_score_plain(*args)
    torch.cuda.synchronize()
    err_f, r_f = excess(feas_k, feas_p, 0.0, 5e-4)
    err_n, r_n = excess(nn_k, nn_p, 2e-4, 2e-5)
    ms = cuda_ms(lambda: fused_score(*args), reps=50)
    dev_ms = device_ms(lambda: fused_score(*args), "fused_score_kernel")
    plain_ms = cuda_ms(lambda: fused_score_plain(*args), reps=5)
    ctas, threads, smem = scoring_grid(f"fused_score_kernelILi{k}E")
    b, parts = scoring_bound(T, nbytes(x, X, table, triQ, scale, nn_k, feas_k)
                             + mlp_bytes(mlp), dev_ms, k, sweeps)
    log(f"[fused_score {label}] k={k} T={T} sweeps={sweeps}: {min(ctas, -(-T // 32))} CTAs "
        f"x {threads} threads ({-(-T // 32)} tiles of 32, {smem} bytes of shared memory a "
        f"CTA); feas max|err| {err_f:.3e} ({r_f:.3f} of atol 5e-4); nn max|err| "
        f"{err_n:.3e} ({r_n:.3f} of rtol 2e-4 / atol 2e-5); kernel {ms:.4f} ms by events "
        f"({T / ms / 1e3:.1f} M cand/s), {dev_ms:.4f} ms on the device (profiler); twin "
        f"{plain_ms:.4f} ms; on the device time {share(dev_ms, b)}; {parts}")
    if not (r_f <= 1.0 and r_n <= 1.0):
        raise AssertionError(f"fused_score kernel disagrees with its twin ({label}, k={k})")
    return {"max_abs_err": max(err_f, err_n), "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, **b}


def check_k4(inst, dev) -> list:
    """K4 at the shapes of its callers: k = 2 over C(125, 2) (5 sweeps), k = 4
    and 5 over the clique tables of qcqp025-25-4-2 and qcqpband100-5-25-1 (6
    sweeps), and k = 3 over C(30, 3) (5 sweeps; no main path takes it).  The
    last entry is the QCQP main path's shape."""
    small = generate_spar(30, 100, 1)
    out = [check_fused_score(f"C({inst.n},2)", inst.Q, combinations_table(inst.n, 2), 5, dev),
           check_fused_score("C(30,3)", small.Q, combinations_table(30, 3), 5, dev)]
    for name in ("qcqp025-25-4-2", QCQP_INSTANCE):
        q = load_or_generate_qcqp(name)
        for k in (4, 5):
            out.append(check_fused_score(name, q.Q0, clique_table(q, k), 6, dev))
    return out


def check_guard(inst, unguarded, dev):
    """The overflow guard of score_common.cuh::rotate keeps the bits of the
    build without it (``unguarded``, scoring_variants.UNGUARDED): K1 on all
    C(n, 3) triples of ``inst`` at the scoring point, and K4 at k = 5 on the
    clique tables of qcqpband100-5-25-1 and qcqp025-25-4-2 (torch.equal on
    nn and feas); each timed on the device (profiler) in turns, guarded,
    unguarded, unguarded, guarded."""
    x, X, Q = scoring_point(inst, dev)
    table = torch.as_tensor(combinations_table(inst.n, 3), device=dev)
    mlp = MLPScorer(load_params(3), dev)
    cases = [(f"K1 {inst.name}", "pair_score_kernel",
              lambda lib: k1_call(lib, x, X, Q, table, mlp, 5))]
    for name in (QCQP_INSTANCE, "qcqp025-25-4-2"):
        q = load_or_generate_qcqp(name)
        args = fused_args(q.Q0, clique_table(q, 5), 6, dev)
        cases.append((f"K4 {name} k=5", "fused_score_kernel",
                      lambda lib, a=args: k4_call(lib, *a)))
    built = _build.lib()
    for label, kernel, call in cases:
        calls = {"guarded": call(built), "unguarded": call(unguarded)}
        for run, *_ in calls.values():
            run()
        same = all(torch.equal(a, b) for a, b in zip(calls["guarded"][1:],
                                                     calls["unguarded"][1:]))
        guarded, plain = [], []
        for runs, which in ((guarded, "guarded"), (plain, "unguarded"), (plain, "unguarded"),
                            (guarded, "guarded")):
            runs.append(device_ms(calls[which][0], kernel))
        log(f"[guard] {label}: nn and feas bit for bit equal to the unguarded build: {same}; "
            f"on the device in turns guarded {guarded!r} ms, unguarded {plain!r} ms (guarded / "
            f"unguarded {sum(guarded) / sum(plain):.4f})")
        if not same:
            raise AssertionError(f"the overflow guard changes the scores ({label})")


def check_large_instance(dev) -> dict:
    """generate_spar(300, 100, 1), past K2's cluster: 2 rounds with the default "auto" on K1 and
    the grid route's kernels (no K2, no plain block, twin check or norm),
    each round within GRID_RTOL of one CPU run of the port (small_references,
    at the end of the run).  spar150-100-1
    (generated, n = 150, K2's 256-column form): 2 rounds with "auto" on the
    card (K1, K2 with K5 and K6; no plain block, twin check or norm), and
    with LPConfig(use_kernel="off") 2 rounds of the plain loop there, each
    against the CPU port's 2 rounds (run once).  CutConfig(capacity=81920) at
    n = 150: one round with "auto", taken by the grid route's far form.
    Returns the launch counts of the "auto" runs at n = 150, at n = 300 and
    of the pool of 81,920 at n = 150."""
    lp = LARGE_LP
    # a pool of BIG_CAPACITY at n = 150, past K2's and the shared layout's:
    # taken, on the grid route's far form
    inst = load_or_generate("spar150-100-1")
    route = pdhg_kernel.route_refusal(inst.n, BIG_CAPACITY, 3, 0)
    far = pdhg_grid._form(inst.n, BIG_CAPACITY, 3, 0)[0]
    reset_launches()
    hist = CutSolver(inst, RunConfig(lp=lp, cuts=CutConfig(capacity=BIG_CAPACITY)),
                     device=dev).run(rounds=1)
    big = launch_counts()
    log(f"[small] spar150-100-1 with CutConfig(capacity={BIG_CAPACITY}), use_kernel='auto': "
        f"route {route}, the far form: {far}; bound {hist[0].bound!r}; launches {big}")
    if (route != ("grid", None) or not far or min(big[k] for k in GRID_NAMES) == 0
            or big["pdhg_block"] or big[PLAIN_BLOCKS] or big[PLAIN_CONTROL]
            or not np.isfinite(hist[0].bound)):
        raise AssertionError(f"a pool of {BIG_CAPACITY} at n = 150 was not taken by the grid "
                             f"route's far form")
    cases = large_cases()
    reset_launches()
    card_vs_cpu(*cases[0][:4], dev, rounds=2, rtol=GRID_RTOL)
    grid = launch_counts()
    log(f"[small] spar300-100-1, use_kernel='auto' (the grid route): launches {grid}")
    if (min(grid[k] for k in ("pair_score", *GRID_NAMES)) == 0
            or grid["pdhg_block"] or grid[PLAIN_BLOCKS] or grid[PLAIN_CONTROL]
            or grid[TWIN_SCORED]):
        raise AssertionError("the n = 300 solve did not run on K1 and the grid route alone")
    label, _, inst, cfg = cases[1][:4]
    reset_launches()
    card_vs_cpu(f"{label} use_kernel='auto'", CutSolver, inst, cfg, dev, rounds=2, ref=label)
    auto = launch_counts()
    log(f"[small] spar150-100-1, use_kernel='auto' (width {launch_plan(150, 1024, 3, 0).cols}): "
        f"launches {auto}")
    if (min(auto[k] for k in ("pair_score", "pdhg_block", "pdhg_check", "pdhg_norm")) == 0
            or auto[PLAIN_BLOCKS] or auto[PLAIN_CONTROL] or auto[TWIN_SCORED]):
        raise AssertionError("the n = 150 solve did not run on K1, K2, K5 and K6 alone")
    reset_launches()
    card_vs_cpu(f"{label} use_kernel='off'", CutSolver, inst,
                RunConfig(lp=dataclasses.replace(lp, use_kernel="off")), dev, rounds=2, ref=label)
    launches = launch_counts()
    log(f"[small] spar150-100-1, use_kernel='off': launches {launches}")
    if (launches["pdhg_block"] or launches["pdhg_check"] or launches["pdhg_norm"]
            or launches[PLAIN_BLOCKS] == 0 or launches[PLAIN_CONTROL] == 0):
        raise AssertionError("the n = 150 solve did not run the plain PDHG loop, check and "
                             "norm alone")
    return auto, grid, big


# phase 4's runs on the card, each held at the end of the run to the CPU
# port's same rounds, which the host references' process computes from the
# build on (small_cases, LARGE_CASES): label -> (the card's bounds, the CPU
# run's label, rtol of every round or None: round 0 at 2e-3, the rest 2e-2)
SMALL_RESULTS = {}
SMALL_LP = LPConfig(max_iters=6000, tol=1e-5)


def card_vs_cpu(label: str, solver_cls, inst, cfg, dev, rounds: int = 3, ref=None, rtol=None):
    """A few rounds on the card, kept for small_references, which holds them
    to the CPU port's (run ``ref``, by default ``label``), which the CPU
    tests hold to the JAX package.  Round 0 precedes any selection and
    agrees at rtol 2e-3 (tests/test_loop.py); later rounds may differ by tie
    order only, and stay within 2% (tests/test_pair_score.py); ``rtol``:
    every round within it."""
    gpu = [h.bound for h in solver_cls(inst, cfg, device=dev).run(rounds=rounds)]
    SMALL_RESULTS[label] = (gpu, label if ref is None else ref, rtol)
    log(f"[small] {label}: bounds on the card {gpu}")


def small_cases() -> list:
    """(label, solver class, instance, config, rounds) of phase 4's runs
    that check_small_instances holds to the CPU port."""
    name = "spar020-100-1"
    inst = parse_boxqp(os.path.join(DATA, f"{name}.in"), name=name)
    lp = SMALL_LP
    qname = "qcqp015-30-3-1"
    # the packed route in tests/test_pair_packed.py's configuration
    packed = RunConfig(lp=LPConfig(max_iters=3000, tol=2e-6),
                       cuts=CutConfig(k=3, sel_size=10, capacity=256, pair_layout="packed"),
                       scorer=ScorerConfig(strategy="feasibility"))
    return [
        (f"{name} k=3", CutSolver, inst, RunConfig(lp=lp), 3),
        (f"{name} k=2", CutSolver, inst, RunConfig(lp=lp, cuts=CutConfig(k=2)), 3),
        (f"{qname} k=5", CutSolverQCQP, load_or_generate_qcqp(qname),
         RunConfig(lp=lp, cuts=CutConfig(k=5, sel_size=8, capacity=128)), 3),
        ("spar070-100-1 packed feasibility", CutSolver, generate_spar(70, 100, 1), packed, 2),
        # the strategies and steering on spar020-100-1: their random draws
        # come from a CPU generator, so both devices see the same numbers
        *((f"{name} k=3 {strategy}", CutSolver, inst,
           RunConfig(lp=lp, scorer=ScorerConfig(strategy=strategy)), 3)
          for strategy in ("triangle", "optimality", "random")),
        (f"{name} k=3 neural steered (steer_eps 1e-3)", CutSolver, inst,
         RunConfig(lp=lp, loop=LoopConfig(steer_eps=1e-3)), 3),
    ]


LARGE_LP = LPConfig(max_iters=3000, tol=1e-5)


def large_cases() -> list:
    """check_large_instance's runs held to the CPU port, as small_cases:
    generate_spar(300, 100, 1) past K2's cluster, and spar150-100-1 (the
    card runs it with "auto" and with "off")."""
    return [("spar300-100-1 k=3 use_kernel='auto'", CutSolver, generate_spar(300, 100, 1),
             RunConfig(lp=LARGE_LP), 2),
            ("spar150-100-1 k=3", CutSolver, load_or_generate("spar150-100-1"),
             RunConfig(lp=LARGE_LP), 2)]


def small_references(refs: "References") -> dict:
    """The end of phase 4, once the host references are in: each run on the
    card (SMALL_RESULTS) against the CPU port's same rounds."""
    cpu_runs = refs.get()["small"]
    checks = {}
    for label, (gpu, ref, rtol) in SMALL_RESULTS.items():
        cpu = cpu_runs[ref]
        rel = [abs(g - c) / abs(c) for g, c in zip(gpu, cpu)]
        ok = len(gpu) == len(cpu) and (max(rel) <= rtol if rtol is not None
                                       else rel[0] <= 2e-3 and max(rel) <= 2e-2)
        log(f"[small] {label}: bounds on the card {gpu}, on the CPU {cpu}; rel diff {rel}")
        checks[f"{label}: the card's rounds within "
               f"{'rtol ' + str(rtol) if rtol else '2e-3 (round 0), 2e-2'} of the CPU port's"] = ok
    return checks


def check_small_instances(dev):
    """Phase 4's runs of small_cases on the card (small_references holds
    them to the CPU port at the end of the run)."""
    for label, solver_cls, inst, cfg, rounds in small_cases():
        card_vs_cpu(label, solver_cls, inst, cfg, dev, rounds=rounds)


def registry(family: str, name: str) -> dict:
    """The instance registry's values for ``name``: mccormick, sdp, and the
    floor every certificate must keep (BoxQP: the best known objective,
    data/boxqp/optima.json; QCQP: the certified sdp_lower)."""
    with open(os.path.join(REPO, "data", family, "bounds.json")) as f:
        reg = json.load(f)[name]
    if family == "qcqp":
        return {"mc": reg["mccormick"], "sdp": reg["sdp"], "floor": reg["sdp_lower"]}
    with open(os.path.join(DATA, "optima.json")) as f:
        best_known = json.load(f)[name]["best_known"]
    return {"mc": reg["mccormick"], "sdp": reg["sdp"], "floor": best_known}


def outcome(hist) -> list:
    """Everything a round reports except its wall time."""
    return [(h.bound, h.certificate, h.lp_iters, h.lp_kkt_error, h.cuts_added,
             h.cuts_active) for h in hist]


def report(tag: str, hist, mc: float, sdp: float):
    for h in hist:
        gap = min(max((mc - h.bound) / (mc - sdp), 0.0), 1.0)
        log(f"[{tag}] round {h.round}: bound {h.bound!r} certificate {h.certificate!r} "
            f"cuts_added {h.cuts_added} active {h.cuts_active} lp_iters {h.lp_iters} "
            f"kkt {h.lp_kkt_error:.3e} gap_closed {gap!r} wall {h.wall_time_s:.3f}s")


def finish(tag: str, checks: dict):
    for name, ok in checks.items():
        log(f"[{tag}] check {name}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise AssertionError(f"{tag} checks failed")


def control_checks(tag: str, launches: dict, steering: int = 0) -> dict:
    """The LP solve's control on the card, as the reference runs it: K5 once
    a solve block, in K2's launch (the checked launches, counted under
    "pdhg_check": every K2 launch but steering's), K6 once a solve, at most
    one host read of the control record a group of GROUP_BLOCKS blocks plus
    one a solve, and no twin check or norm on the card."""
    k2, k5, k6 = launches["pdhg_block"], launches["pdhg_check"], launches["pdhg_norm"]
    solves, reads, G = launches[SOLVES], launches[READS], pdhg_mod.GROUP_BLOCKS
    log(f"[{tag}] the solves' control: {solves} solves, K2 {k2} ({steering} of them steering), "
        f"checked (K5 in the launch) {k5}, K6 {k6}; host reads of the record {reads} = {reads / max(solves, 1):.2f} a "
        f"solve, {k5 / max(reads, 1):.2f} blocks a read (groups of {G})")
    return {
        "K5 once a solve block, in K2's launch": k5 == k2 - steering and k5 > 0,
        "K6 once a solve": k6 == solves and k6 > 0,
        f"at most one host read a group of {G} blocks plus one a solve": reads * G <= k5 + G * solves,
        "no twin check or norm on the card": launches[PLAIN_CONTROL] == 0,
    }


def blocks_enqueued(blocks_run: int, solves: int, launches: dict) -> bool:
    """K2's solve launches cover the blocks that ran, plus at most
    GROUP_BLOCKS - 1 enqueued after the last stop of each solve (they do
    nothing)."""
    return blocks_run <= launches["pdhg_check"] <= blocks_run + (pdhg_mod.GROUP_BLOCKS - 1) * solves


def boxqp_path(tag: str, inst, cfg, dev, launched: tuple, idle: tuple = ()):
    """CutSolver on spar125-100-1 in ``cfg``, ROUNDS rounds, counters reset
    before and read after; the bounds are held to the instance registry and
    a second run from a fresh solver must repeat the first bit for bit.
    Returns (launch counts, history, checks so far)."""
    reg = registry("boxqp", INSTANCE)
    mc, sdp, best_known = reg["mc"], reg["sdp"], reg["floor"]
    solver = CutSolver(inst, cfg, device=dev)
    reset_launches()
    t0 = time.perf_counter()
    hist = solver.run(rounds=ROUNDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    report(tag, hist, mc, sdp)
    bounds = np.array([h.bound for h in hist])
    certs = np.array([h.certificate for h in hist])
    round_s = sum(h.wall_time_s for h in hist)
    rel0 = float((bounds[0] - mc) / abs(mc))
    log(f"[{tag}] {len(hist)} rounds in {wall:.3f}s = {len(hist) / wall!r} rounds/s; "
        f"rounds / sum of wall_time_s {len(hist) / round_s!r} rounds/s; launches "
        f"{launches}; round-0 vs McCormick {mc!r}: rel {rel0!r}; final gap closed vs "
        f"sdp {sdp!r}: {float((mc - bounds[-1]) / (mc - sdp))!r}; rounds whose own "
        f"certificate rose: {int((np.diff(certs) > 0).sum())}; final bound "
        f"{float(bounds[-1])!r} (recorded: {BOXQP_RECORDED_FINAL!r}, equal: "
        f"{float(bounds[-1]) == BOXQP_RECORDED_FINAL})")
    # A reported bound is the running minimum of the rounds' certificates, so
    # it cannot rise; what can fail is each certificate, checked on its own.
    again = CutSolver(inst, cfg, device=dev).run(rounds=ROUNDS)
    return launches, hist, {
        f"{ROUNDS} rounds ran": len(hist) == ROUNDS,
        f"{' and '.join(launched)} launched": min(launches[k] for k in launched) > 0,
        **({f"{' and '.join(idle)} not launched": all(launches[k] == 0 for k in idle)}
           if idle else {}),
        "no plain PDHG block": launches[PLAIN_BLOCKS] == 0,
        "certificates finite": bool(np.isfinite(certs).all()),
        f"every certificate >= best known {best_known}": bool((certs >= best_known).all()),
        "bounds are the running minimum of the certificates":
            bool((bounds == np.minimum.accumulate(certs)).all()),
        "round 0 within 1e-2 of McCormick": abs(rel0) <= 1e-2,
        "last round below round 0": bool(bounds[-1] < bounds[0]),
        "a second run repeats every round bit for bit": outcome(again) == outcome(hist),
        **control_checks(tag, launches),
    }


def main_path(inst, dev):
    """Strategy neural, default cuts (the lexicographic table), per round.
    Returns (launch counts, history)."""
    cfg = RunConfig(lp=BOXQP_LP)
    launches, hist, checks = boxqp_path("main", inst, cfg, dev, ("pair_score", "pdhg_block"))
    finish("main", checks)
    return launches, hist


def packed_scan_path(inst, dev) -> dict:
    """Strategy neural on the packed layout, scan mode, after a one-round
    warm-up; a per-round run of the same configuration repeats the scan."""
    cfg = RunConfig(lp=BOXQP_LP, cuts=CutConfig(pair_layout="packed"),
                    loop=LoopConfig(use_scan=True))
    CutSolver(inst, cfg, device=dev).run(rounds=1)
    launches, hist, checks = boxqp_path("packed", inst, cfg, dev,
                                        ("pair_packed", "pdhg_block"), ("pair_score",))
    per_round_cfg = dataclasses.replace(cfg, loop=LoopConfig(use_scan=False))
    per_round = CutSolver(inst, per_round_cfg, device=dev).run(rounds=ROUNDS)
    checks["a per-round run repeats every round of the scan bit for bit"] = (
        outcome(per_round) == outcome(hist))
    finish("packed", checks)
    return launches


def rerun_with_k4_checks(inst, rounds: int, dev):
    """The QCQP main path again from a fresh solver, as run() goes: the
    first run's number of rounds one by one, then the polish.  After each
    round K4 and its twin score that round's LP point (x and X of the
    state, which do_round leaves as it scored them) at check_fused_score's
    tolerances; scoring is pure, so the run is the first one's.  Returns
    (solver, the largest nn excess as a share of its limit)."""
    solver = CutSolverQCQP(inst, QCQP_CFG, device=dev)
    worst = 0.0
    for _ in range(rounds):
        s = solver.do_round()
        args = (solver.state.x, solver.state.X, solver.table, solver.triQ, solver.scale,
                solver.mlp, QCQP_SWEEPS)
        nn_k, feas_k = fused_score(*args)
        nn_p, feas_p = fused_score_plain(*args)
        err_f, r_f = excess(feas_k, feas_p, 0.0, 5e-4)
        err_n, r_n = excess(nn_k, nn_p, 2e-4, 2e-5)
        log(f"[qcqp] round {s.round} point: K4 against its twin feas max|err| {err_f:.3e} "
            f"({r_f:.3f} of atol 5e-4); nn max|err| {err_n:.3e} ({r_n:.3f} of rtol 2e-4 / "
            f"atol 2e-5)")
        if not (r_f <= 1.0 and r_n <= 1.0):
            raise AssertionError(f"K4 disagrees with its twin at round {s.round}'s point")
        worst = max(worst, r_n)
    solver.polish()
    return solver, worst


def qcqp_main_path(dev) -> dict:
    """CutSolverQCQP on qcqpband100-5-25-1 in the suite configuration."""
    inst = load_or_generate_qcqp(QCQP_INSTANCE)
    reg = registry("qcqp", QCQP_INSTANCE)
    mc, sdp, sdp_lower = reg["mc"], reg["sdp"], reg["floor"]
    with open(os.path.join(REPO, "results", "qcqp.jsonl")) as f:
        jax_rec = next(r for r in map(json.loads, f)
                       if (r["instance"], r["strategy"], r.get("k")) == (QCQP_INSTANCE, "neural", 5))
    jax0 = jax_rec["bounds"][0]          # round 0 precedes any cut
    solver = CutSolverQCQP(inst, QCQP_CFG, device=dev)
    log(f"[qcqp] {QCQP_INSTANCE}: n={inst.n} m={inst.m} dense rows on the card "
        f"{tuple(solver.dense.G.shape)}, {solver.table.shape[0]} clique candidates at "
        f"k={QCQP_CFG.cuts.k}")
    reset_launches()
    t0 = time.perf_counter()
    hist = solver.run(rounds=QCQP_ROUNDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    report("qcqp", hist, mc, sdp)
    bounds = np.array([h.bound for h in hist])
    certs = np.array([h.certificate for h in hist])
    round_s = sum(h.wall_time_s for h in hist)
    d0 = float(bounds[0] - jax0)
    log(f"[qcqp] {len(hist)} rounds in {round_s:.3f}s = {len(hist) / round_s!r} rounds/s "
        f"(whole run with polish {wall:.3f}s); launches {launches} (pdhg_block with "
        f"m={solver.dense.m}); polish certificate {solver.polish_certificate!r}")
    log(f"[qcqp] final bound {float(bounds[-1])!r} (recorded: {QCQP_RECORDED_FINAL!r}, equal: "
        f"{float(bounds[-1]) == QCQP_RECORDED_FINAL})")
    log(f"[qcqp] round 0 {float(bounds[0])!r} vs the JAX package's recorded {jax0!r}: "
        f"diff {d0!r}, rel {d0 / jax0!r}; gap closed vs mccormick {mc!r}, "
        f"sdp {sdp!r}: round 0 {float((mc - bounds[0]) / (mc - sdp))!r}, final "
        f"{float((mc - bounds[-1]) / (mc - sdp))!r} (the JAX package's record: "
        f"{jax_rec['final_gap_closed']!r} after {len(jax_rec['bounds'])} rounds)")
    again_solver, worst = rerun_with_k4_checks(inst, len(hist), dev)
    again = again_solver.history
    log(f"[qcqp] K4's largest nn excess at the main path's round points: {worst:.3f} of the "
        f"limit")
    runmin = np.minimum.accumulate(certs)
    finish("qcqp", {
        f"{QCQP_ROUNDS} rounds ran (or the early stop ended the run)":
            len(hist) == QCQP_ROUNDS or hist[-1].cuts_added == 0,
        "pdhg_block and fused_score launched": min(launches["pdhg_block"],
                                                   launches["fused_score"]) > 0,
        "no plain PDHG block": launches[PLAIN_BLOCKS] == 0,
        "certificates finite": bool(np.isfinite(certs).all()),
        f"every certificate >= sdp_lower {sdp_lower}": bool((certs >= sdp_lower).all()),
        "bounds are the running minimum of the certificates, polish lowering only "
        "the last": bool((bounds[:-1] == runmin[:-1]).all()
                         and bounds[-1] == min(runmin[-1], solver.polish_certificate)),
        "round 0 within 1e-2 of the JAX package's round 0":
            abs(d0) <= 1e-2 * abs(jax0),
        "last bound below round 0": bool(bounds[-1] < bounds[0]),
        "a second run repeats every round bit for bit, polish included":
            outcome(again) == outcome(hist)
            and again_solver.polish_certificate == solver.polish_certificate,
        **control_checks("qcqp", launches),
    })
    return launches


def gap_closed(reg: dict, bound: float) -> float:
    return float((reg["mc"] - bound) / (reg["mc"] - reg["sdp"]))


def recorded_gap(path: str, **match) -> str:
    """The JAX package's final gap closed in the last row of results/``path``
    whose keys match, with its line, for printing beside a run."""
    found = None
    with open(os.path.join(REPO, "results", path)) as f:
        for line, row in enumerate(map(json.loads, f), 1):
            if all(row.get(k) == v for k, v in match.items()):
                found = (line, row)
    if found is None:
        return "no JAX record"
    line, row = found
    return (f"JAX record {row['final_gap_closed']!r} after {len(row['bounds'])} rounds "
            f"(results/{path}:{line})")


def keep_snapshot(solver, at_round: int, directory: str) -> str:
    """Make ``solver`` keep a copy, in ``directory``, of the snapshot its
    run writes after round ``at_round`` (each snapshot overwrites the last
    at ``<checkpoint_dir>/<instance>.ck``).  Returns the copy's path."""
    write = solver.checkpoint
    copy = os.path.join(directory, os.path.basename(solver._checkpoint_path()))

    def checkpoint(path):
        write(path)
        if len(solver.history) == at_round:
            os.makedirs(directory, exist_ok=True)
            shutil.copy(path, copy)
            shutil.copy(path + ".json", copy + ".json")

    solver.checkpoint = checkpoint
    return copy


def validity(hist, reg: dict) -> dict:
    """Every certificate finite and above the registry's floor; the bounds
    the certificates' running minimum (the last may be lowered by polish)."""
    certs = np.array([h.certificate for h in hist])
    bounds = np.array([h.bound for h in hist])
    runmin = np.minimum.accumulate(certs)
    return {
        "certificates finite": bool(np.isfinite(certs).all()),
        f"every certificate >= {reg['floor']}": bool((certs >= reg["floor"]).all()),
        "bounds are the running minimum of the certificates (polish may lower the last)":
            bool((bounds[:-1] == runmin[:-1]).all() and bounds[-1] <= runmin[-1]),
    }


def steered_qcqp_scan(dev) -> dict:
    """qcqpband100-5-25-1 in QCQP_CFG with scan mode and steering (steer_eps
    1e-3, 4,000 iterations a round), QCQP_ROUNDS rounds and the polish:
    twice, bit for bit; once per round with a snapshot every round, which
    repeats the scan's rounds bit for bit; and a fresh solver restored from
    round RESUME_AT's snapshot, which repeats the rest, gate state included.
    K2 launches exactly once a round for steering besides the solves' blocks."""
    inst = load_or_generate_qcqp(QCQP_INSTANCE)
    reg = registry("qcqp", QCQP_INSTANCE)
    cfg = QCQP_STEER_CFG
    solver = CutSolverQCQP(inst, cfg, device=dev)
    reset_launches()
    t0 = time.perf_counter()
    hist = solver.run(rounds=QCQP_ROUNDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    every = cfg.lp.check_every
    blocks = (sum(h.lp_iters for h in hist) + solver.polish_info["iters"]) // every
    report("steer", hist, reg["mc"], reg["sdp"])
    final = float(hist[-1].bound)
    log(f"[steer] {len(hist)} scan rounds + polish in {wall:.3f}s; rounds / sum of "
        f"wall_time_s {len(hist) / sum(h.wall_time_s for h in hist)!r} rounds/s; launches "
        f"{launches}: the solves' and the polish's blocks run {blocks}, enqueued "
        f"{launches['pdhg_check']}, steering {launches['pdhg_block'] - launches['pdhg_check']}; final bound {final!r} (the recorded unsteered main "
        f"path: {QCQP_RECORDED_FINAL!r}); gap closed {gap_closed(reg, final)!r} ("
        f"{recorded_gap('qcqp.jsonl', instance=QCQP_INSTANCE, strategy='neural', k=5)}, "
        f"unsteered)")
    # steering's time a round at the last round's pool and solved state
    setup = solve_setup(solver.c, solver.pool, cfg.lp, solver.dense)
    gen = torch.Generator().manual_seed(SEED)
    steer_ms = cuda_ms(lambda: steer_to_vertex(
        solver.Q, solver.c, solver.pool, solver.state, cfg.lp, gen, cfg.loop.steer_eps,
        cfg.loop.steer_iters, solver.dense, setup), reps=5, warmup=1)
    log(f"[steer] steering a round ({cfg.loop.steer_iters} iterations, one K2 launch, "
        f"m={inst.m}): {steer_ms:.4f} ms = {steer_ms * 1e3 / cfg.loop.steer_iters:.3f} "
        f"us/iteration by events")
    again = CutSolverQCQP(inst, cfg, device=dev)
    again.run(rounds=QCQP_ROUNDS)
    shutil.rmtree(SNAPSHOTS, ignore_errors=True)
    per_cfg = dataclasses.replace(cfg, loop=dataclasses.replace(
        cfg.loop, use_scan=False, checkpoint_every=1, checkpoint_dir=SNAPSHOTS))
    per = CutSolverQCQP(inst, per_cfg, device=dev)
    snapshot = keep_snapshot(per, RESUME_AT["qcqp"], os.path.join(SNAPSHOTS, "resume"))
    per.run(rounds=QCQP_ROUNDS)
    resumed = CutSolverQCQP(inst, dataclasses.replace(
        cfg, loop=dataclasses.replace(cfg.loop, use_scan=False)), device=dev)
    resumed.restore(snapshot)
    resumed.run(rounds=QCQP_ROUNDS - RESUME_AT["qcqp"])
    log(f"[steer] resumed from round {RESUME_AT['qcqp']}'s snapshot: final bound "
        f"{float(resumed.history[-1].bound)!r}")
    shutil.rmtree(SNAPSHOTS, ignore_errors=True)
    finish("steer", {
        f"{QCQP_ROUNDS} scan rounds ran": len(hist) == QCQP_ROUNDS,
        "pdhg_block and fused_score launched": min(launches["pdhg_block"],
                                                   launches["fused_score"]) > 0,
        "steering is exactly one K2 launch a round":
            launches["pdhg_block"] - launches["pdhg_check"] == len(hist),
        "the solves' K2 launches cover their blocks":
            blocks_enqueued(blocks, len(hist) + 1, launches),
        **control_checks("steer", launches, steering=len(hist)),
        "no plain PDHG block": launches[PLAIN_BLOCKS] == 0,
        **validity(hist, reg),
        "a second scan run repeats every round bit for bit, polish included":
            outcome(again.history) == outcome(hist)
            and again.polish_certificate == solver.polish_certificate,
        "a per-round run repeats every round of the scan bit for bit, polish included":
            outcome(per.history) == outcome(hist)
            and per.polish_certificate == solver.polish_certificate,
        f"the run resumed from round {RESUME_AT['qcqp']}'s snapshot repeats it bit for bit, "
        "polish and gate state included":
            outcome(resumed.history) == outcome(per.history)
            and resumed.polish_certificate == per.polish_certificate
            and torch.equal(resumed._last_viol, per._last_viol)
            and torch.equal(resumed._cooldown, per._cooldown),
    })
    return launches


def boxqp_resume(inst, main_hist, dev) -> dict:
    """The BoxQP main path's configuration per round with a snapshot every
    round, and a fresh solver restored from round RESUME_AT's snapshot: both
    repeat the main path's rounds bit for bit."""
    cfg = RunConfig(lp=BOXQP_LP,
                    loop=LoopConfig(checkpoint_every=1, checkpoint_dir=SNAPSHOTS))
    shutil.rmtree(SNAPSHOTS, ignore_errors=True)
    per = CutSolver(inst, cfg, device=dev)
    snapshot = keep_snapshot(per, RESUME_AT["boxqp"], os.path.join(SNAPSHOTS, "resume"))
    reset_launches()
    per.run(rounds=ROUNDS)
    resumed = CutSolver(inst, RunConfig(lp=cfg.lp), device=dev).restore(snapshot)
    resumed.run(rounds=ROUNDS - RESUME_AT["boxqp"])
    torch.cuda.synchronize()
    launches = launch_counts()
    shutil.rmtree(SNAPSHOTS, ignore_errors=True)
    log(f"[resume] {INSTANCE}: launches {launches}; final bound "
        f"{float(resumed.history[-1].bound)!r}")
    finish("resume", {
        "pair_score and pdhg_block launched": min(launches["pair_score"],
                                                  launches["pdhg_block"]) > 0,
        "no plain PDHG block": launches[PLAIN_BLOCKS] == 0,
        "the run with snapshots repeats the main path bit for bit":
            outcome(per.history) == outcome(main_hist),
        f"the run resumed from round {RESUME_AT['boxqp']}'s snapshot repeats the main path "
        "bit for bit": outcome(resumed.history) == outcome(main_hist),
        **control_checks("resume", launches),
    })
    return launches


def strategy_path(tag: str, solver_cls, inst, cfg, rounds: int, reg: dict, record: str,
                  dev):
    """One strategy at full width: a run, counters reset before and read
    after, and a second run from a fresh solver that must repeat it bit for
    bit; every certificate valid.  Returns (launch counts, solver)."""
    solver = solver_cls(inst, cfg, device=dev)
    reset_launches()
    t0 = time.perf_counter()
    hist = solver.run(rounds=rounds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    report(tag, hist, reg["mc"], reg["sdp"])
    final = float(hist[-1].bound)
    log(f"[{tag}] {len(hist)} rounds in {wall:.3f}s (polish included: "
        f"{cfg.loop.polish_iters > 0}); rounds / sum of wall_time_s "
        f"{len(hist) / sum(h.wall_time_s for h in hist)!r} rounds/s; per-round wall "
        f"{[round(h.wall_time_s, 4) for h in hist]} s; launches {launches}; final bound "
        f"{final!r}, gap closed {gap_closed(reg, final)!r} ({record})")
    again = solver_cls(inst, cfg, device=dev).run(rounds=rounds)
    finish(tag, {
        f"{rounds} rounds ran (or the early stop ended the run)":
            len(hist) == rounds or hist[-1].cuts_added == 0,
        "pdhg_block launched": launches["pdhg_block"] > 0,
        "no plain PDHG block": launches[PLAIN_BLOCKS] == 0,
        **validity(hist, reg),
        "last bound below round 0": bool(hist[-1].bound < hist[0].bound),
        "a second run repeats every round bit for bit": outcome(again) == outcome(hist),
        **control_checks(tag, launches),
    })
    return launches, solver


def strategies(inst, dev) -> dict:
    """Strategies triangle, random and optimality on spar125-100-1 (k = 3,
    the BoxQP main path's LP) and feasibility, random and optimality on
    qcqpband100-5-25-1 at k = 4 (QCQP_CFG), each run twice; the optimality
    ADMM's time and repeatability at the last BoxQP point."""
    out = {}
    reg = registry("boxqp", INSTANCE)
    for strategy, rounds in BOXQP_STRATEGY_ROUNDS.items():
        cfg = RunConfig(lp=BOXQP_LP, scorer=ScorerConfig(strategy=strategy))
        record = "; ".join(recorded_gap("suite.jsonl", instance=INSTANCE, strategy=strategy,
                                        k=3, sel_size=sel) + f" at sel_size {sel}"
                           for sel in (cfg.cuts.sel_size, 50))
        out[f"boxqp {strategy}"], solver = strategy_path(
            f"box-{strategy}", CutSolver, inst, cfg, rounds, reg, record, dev)
    x, X = solver.state.x, solver.state.X            # the last optimality run's point
    first, second = solver._exact(x, X), solver._exact(x, X)
    admm_ms = cuda_ms(lambda: solver._exact(x, X), reps=2, warmup=0)
    log(f"[box-optimality] the ADMM over {solver.table.shape[0]} blocks (300 iterations of "
        f"a batched 3x3 eigh, {EIGH_CHUNK} blocks a call): {admm_ms:.2f} ms a round by "
        f"events; two calls bit for bit: {torch.equal(first, second)}")
    finish("box-optimality", {"the ADMM repeats bit for bit": torch.equal(first, second)})
    qinst = load_or_generate_qcqp(QCQP_INSTANCE)
    qreg = registry("qcqp", QCQP_INSTANCE)
    for strategy in QCQP_STRATEGIES:
        cfg = dataclasses.replace(QCQP_CFG, cuts=dataclasses.replace(QCQP_CFG.cuts, k=4),
                                  scorer=ScorerConfig(strategy=strategy))
        record = recorded_gap("qcqp.jsonl", instance=QCQP_INSTANCE, strategy=strategy, k=4)
        out[f"qcqp {strategy}"], _ = strategy_path(
            f"qcqp-{strategy}", CutSolverQCQP, qinst, cfg, QCQP_ROUNDS, qreg, record, dev)
    return out


def batched_states_equal(a, b) -> bool:
    """Every tensor of two BatchedRoundStates equal, bit for bit."""
    return all(torch.equal(u, v) for u, v in zip(
        [a.Q, a.c, *rb.values(a.pool), *a.pdhg.fields(), a.bound, a.best_bound],
        [b.Q, b.c, *rb.values(b.pool), *b.pdhg.fields(), b.bound, b.best_bound]))


def batched_run(step, insts, table, valid, dev, rounds: int, kmax: int = 3, dense=None):
    """Per-round steps from a fresh batched state of ``insts`` (BoxQP or
    QCQP).  Returns (state, f32 best bound after each round (rounds, B),
    lp_iters (rounds, B), seconds, synchronised)."""
    qcqp = hasattr(insts[0], "Q0")
    state = init_batched_state(np.stack([i.Q0 if qcqp else i.Q for i in insts]),
                               np.stack([i.c0 if qcqp else i.c for i in insts]), 1024, kmax,
                               m_dense=0 if dense is None else dense.G.shape[1], device=dev)
    best, iters = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(rounds):
        state, info = step(state, table, valid, dense)
        best.append(state.best_bound)
        iters.append(info["lp_iters"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return state, torch.stack(best).cpu().numpy(), np.stack(iters), wall


def suite_bucket_path(dev) -> dict:
    """The n = 125 bucket of scripts/bench_batched.py --suite (the twelve
    spar125-{25,50,75,100}-{1,2,3} of data/boxqp), capacity 1024, k = 3,
    BATCH_KNOBS, Mesh(1, 1), BATCH_ROUNDS per-round steps, then
    certify_batched_f64; twice, bit for bit; instances SUITE_ALONE also as
    batches of one."""
    insts = [parse_boxqp(os.path.join(DATA, f"{name}.in"), name=name) for name in SUITE_BUCKET]
    regs = [registry("boxqp", name) for name in SUITE_BUCKET]
    B, n = len(insts), insts[0].n
    mesh = make_mesh(1, 1)
    table, valid = shard_candidates(combinations_table(n, 3), mesh, device=dev)
    step = make_sharded_round_step(mesh, **BATCH_KNOBS)
    reset_launches()
    state, best, iters, wall = batched_run(step, insts, table, valid, dev, BATCH_ROUNDS)
    launches = launch_counts()
    cert = certify_batched_f64(state)
    blocks = int(sum(it.max() // 100 for it in iters))       # checked blocks of the batch
    again, best2, iters2, wall2 = batched_run(step, insts, table, valid, dev, BATCH_ROUNDS)
    repeat = (batched_states_equal(state, again) and np.array_equal(best, best2)
              and np.array_equal(iters, iters2)
              and np.array_equal(cert, certify_batched_f64(again)))
    alone = {}
    for b in SUITE_ALONE:
        one = batched_run(step, [insts[b]], table, valid, dev, BATCH_ROUNDS)[0]
        alone[b] = (float(certify_batched_f64(one)[0]),
                    torch.equal(one.pool.idx[0], state.pool.idx[b])
                    and all(torch.equal(u[0], v[b]) for u, v in zip(one.pdhg.fields(),
                                                                    state.pdhg.fields())))
    for i, (inst, reg) in enumerate(zip(insts, regs)):
        log(f"[suite] {inst.name}: certified f64 {float(cert[i])!r} (best known {reg['floor']!r}), "
            f"gap closed {gap_closed(reg, cert[i])!r}; f32 bound by round "
            f"{best[:, i].tolist()}; lp_iters by round {iters[:, i].tolist()}; cuts "
            f"{int(state.pool.count[i])}")
    for b, (c1, bits) in alone.items():
        log(f"[suite] {insts[b].name} as a batch of one: certified {c1!r} against {float(cert[b])!r} "
            f"in the batch of {B} (rel {float(abs(c1 - cert[b]) / abs(cert[b]))!r}); bit-equal pool "
            f"and state: {bits}")
    log(f"[suite] {B} x {BATCH_ROUNDS} rounds in {wall:.4f} s = "
        f"{B * BATCH_ROUNDS / wall!r} instance-rounds/s, again {wall2:.4f} s = "
        f"{B * BATCH_ROUNDS / wall2!r} ({SMI}); launches {launches}; checked blocks {blocks}")
    finish("suite", {
        "every certificate finite and >= its best known": bool(
            np.isfinite(cert).all() and all(c >= r["floor"] for c, r in zip(cert, regs))),
        "running bounds monotone over rounds": bool((np.diff(best, axis=0) <= 0).all()),
        "f32 bound within 1e-2 of the f64 certificate":
            bool((np.abs(best[-1] - cert) <= 1e-2 * (1 + np.abs(cert))).all()),
        "a second run repeats every bound and pool bit for bit": repeat,
        "the batches of one agree within rtol 2e-3":
            all(abs(c1 - cert[b]) <= 2e-3 * abs(cert[b]) for b, (c1, _) in alone.items()),
        "the batched K2 launches cover the batch's checked blocks":
            blocks_enqueued(blocks, BATCH_ROUNDS, launches),
        f"pair_score launched once an instance a round ({B * BATCH_ROUNDS})":
            launches["pair_score"] == B * BATCH_ROUNDS,
        "no plain PDHG block, no twin-scored call":
            launches[PLAIN_BLOCKS] == 0 and launches[TWIN_SCORED] == 0,
        **control_checks("suite", launches),
    })
    return launches


def bench_scan_path(dev) -> dict:
    """bench.py:188-223's configuration: 8 x generate_spar(30, 100, s + 1),
    scan mode, BATCH_ROUNDS rounds, BATCH_KNOBS; certify_scan_f64; the scan
    repeats a per-round run bit for bit; instance-rounds/s, the median of 3
    after a warm-up."""
    n, B = BENCH_BATCH
    insts = [generate_spar(n, 100, s + 1) for s in range(B)]
    mesh = make_mesh(1, 1)
    table, valid = shard_candidates(combinations_table(n, 3), mesh, device=dev)
    start = init_batched_state(np.stack([i.Q for i in insts]), np.stack([i.c for i in insts]),
                               1024, 3, device=dev)
    scan = make_sharded_scan_step(mesh, rounds=BATCH_ROUNDS, **BATCH_KNOBS)
    scan(start, table, valid)                                   # warm-up
    reset_launches()
    final, outs = scan(start, table, valid)
    torch.cuda.synchronize()
    launches = launch_counts()
    blocks = int(outs["lp_iters"].max(1).values.sum()) // 100    # checked blocks of the batch
    bounds = certify_scan_f64(final.Q, final.c, outs)
    step = make_sharded_round_step(mesh, **BATCH_KNOBS)
    state, same_pools = start, True
    for r in range(BATCH_ROUNDS):
        same_pools &= all(torch.equal(getattr(outs["pool"], f)[r], v)
                          for f, v in zip(("idx", "lin", "quad", "rhs", "active", "count"),
                                          rb.values(state.pool)))
        state, _ = step(state, table, valid)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scan(start, table, valid)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    rate = B * BATCH_ROUNDS / sorted(times)[1]
    log(f"[bench-scan] {B} x generate_spar({n}, 100, s + 1), {BATCH_ROUNDS} rounds in one scan: "
        f"certified bounds of the last round {bounds[-1].tolist()}; cuts "
        f"{final.pool.count.tolist()}; launches {launches}")
    log(f"[bench-scan] instance-rounds/s {rate!r} (median of 3 after a warm-up; runs "
        f"{times!r} s) on {SMI}")
    finish("bench-scan", {
        "certificates finite and monotone over rounds":
            bool(np.isfinite(bounds).all() and (np.diff(bounds, axis=0) <= 0).all()),
        "the scan repeats a per-round run bit for bit":
            same_pools and batched_states_equal(final, state),
        "the batched K2 launches cover the batch's checked blocks":
            blocks_enqueued(blocks, BATCH_ROUNDS, launches),
        f"pair_score launched once an instance a round ({B * BATCH_ROUNDS})":
            launches["pair_score"] == B * BATCH_ROUNDS,
        "no plain PDHG block, no twin-scored call":
            launches[PLAIN_BLOCKS] == 0 and launches[TWIN_SCORED] == 0,
        **control_checks("bench-scan", launches),
    })
    return launches


def qcqp_family_path(dev) -> dict:
    """scripts/bench_batched.py --qcqp at its defaults: the family
    QCQP_FAMILY, the chordal clique table at k = 4, the constraints as a
    batched dense block, BATCH_KNOBS, QCQP_FAMILY_ROUNDS per-round steps on
    the card; the first QCQP_FAMILY_CPU_ROUNDS held to the CPU port at rtol
    2e-3."""
    fam = generate_qcqp_family(*QCQP_FAMILY)
    n, m, B = fam[0].n, fam[0].m, len(fam)
    cliques, _ = chordal_decomposition(n, fam[0].sparsity_graph())
    table_np = clique_candidates(cliques, 4)
    mesh = make_mesh(1, 1)
    step = make_sharded_round_step(mesh, **BATCH_KNOBS, kmax=4, m_dense=m)

    def run(device, rounds):
        dense = batched_dense_from_qcqp(fam, device)
        table, valid = shard_candidates(table_np, mesh, device=device)
        state = init_batched_state(np.stack([i.Q0 for i in fam]), np.stack([i.c0 for i in fam]),
                                   1024, 4, m_dense=m, device=device)
        certs, best, blocks = [], [], 0
        for _ in range(rounds):
            state, info = step(state, table, valid, dense)
            certs.append(certify_batched_f64(state, dense))
            best.append(state.best_bound.cpu().numpy())
            blocks += int(info["lp_iters"].max()) // 100
        return state, np.stack(certs), np.stack(best), blocks

    reset_launches()
    t0 = time.perf_counter()
    state, certs, best, blocks = run(dev, QCQP_FAMILY_ROUNDS)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    cpu_certs = run(torch.device("cpu"), QCQP_FAMILY_CPU_ROUNDS)[1]
    rel = np.abs(certs[:QCQP_FAMILY_CPU_ROUNDS] - cpu_certs) / np.abs(cpu_certs)
    log(f"[qcqp-family] {B} x n={n}, m={m}, {table_np.shape[0]} clique candidates at k = 4; "
        f"certified bounds by round {certs.tolist()}; cuts {state.pool.count.tolist()}; "
        f"{QCQP_FAMILY_ROUNDS} rounds with the certificates in {wall:.3f} s; launches "
        f"{launches}")
    log(f"[qcqp-family] against the CPU port, rounds 0-{QCQP_FAMILY_CPU_ROUNDS - 1}: largest "
        f"rel diff {float(rel.max())!r}")
    finish("qcqp-family", {
        "certificates finite": bool(np.isfinite(certs).all()),
        "running bounds monotone over rounds": bool((np.diff(best, axis=0) <= 0).all()),
        "the last certificate below round 0's": bool((certs[-1] < certs[0]).all()),
        "within rtol 2e-3 of the CPU port": bool((rel <= 2e-3).all()),
        f"fused_score launched once an instance a round ({B * QCQP_FAMILY_ROUNDS})":
            launches["fused_score"] == B * QCQP_FAMILY_ROUNDS,
        "the batched K2 launches cover the batch's checked blocks":
            blocks_enqueued(blocks, QCQP_FAMILY_ROUNDS, launches),
        "no plain PDHG block, no twin-scored call":
            launches[PLAIN_BLOCKS] == 0 and launches[TWIN_SCORED] == 0,
        **control_checks("qcqp-family", launches),
    })
    return launches


def sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def run_cli(argv) -> tuple:
    """(rc, stdout lines) of an in-process ``cli.main`` call."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue().splitlines()


DENSE_NAMES = ("pdhg_dense", "pdhg_dense_check", "pdhg_dense_norm")
GRID_NAMES = ("pdhg_grid", "pdhg_grid_check", "pdhg_grid_norm")


def dense_route_checks(tag: str, launches: dict, names: tuple = DENSE_NAMES) -> dict:
    """The certifier's LP on the card, as the reference runs it on its
    device: the dense route's checked launches (K7's block with K7c in it)
    and norm launched, every dense block a checked launch (no standalone
    check, no unchecked block), one norm a solve, at most one host read of
    the control record a group of GROUP_BLOCKS blocks plus one a solve, and
    no plain block, no twin check or norm, no K2, K5 or K6.  ``names``: the
    route's counters (GRID_NAMES: the grid route's kernels, which also run
    the dense route past n = 256), whose other kernels must stay idle."""
    blk, chk, nrm = (launches[k] for k in names)
    others = [k for k in (*DENSE_NAMES, *GRID_NAMES) if k not in names]
    solves, reads, G = launches[SOLVES], launches[READS], pdhg_mod.GROUP_BLOCKS
    log(f"[{tag}] the route ({names[0]}): {solves} solves, block launches {blk}, checked "
        f"launches {chk}, norm {nrm}; host reads of the record {reads}; "
        f"plain blocks {launches[PLAIN_BLOCKS]}, twin checks and norms {launches[PLAIN_CONTROL]}")
    return {
        f"{names[0]}'s checked launches and norm launched": min(blk, chk, nrm) > 0,
        "every block a checked launch (no standalone check)": chk == blk,
        "one norm a solve": nrm == solves,
        f"at most one host read a group of {G} blocks plus one a solve":
            reads * G <= chk + G * solves,
        "no plain block, twin check or norm on the card":
            launches[PLAIN_BLOCKS] == 0 and launches[PLAIN_CONTROL] == 0,
        "K2, K5 and K6 not launched":
            launches["pdhg_block"] == launches["pdhg_check"] == launches["pdhg_norm"] == 0,
        f"{', '.join(others)} not launched": all(launches[k] == 0 for k in others),
    }


def certifier_miss_then_hit(tmp: str, dev) -> tuple:
    """(a) A registry miss on the card at the sandwich settings, then a hit
    that runs no LP block; the card's pair beside the CPU port's."""
    gen, args, lp, rounds, rel_max = SANDWICH["boxqp"]
    inst = gen(*args)
    reg_path = os.path.join(tmp, "bounds.json")
    reset_launches()
    t0 = time.perf_counter()
    pair = ensure_certified_bounds(inst, reg_path, lp, max_rounds=rounds,
                                   verbose=False, device=dev)
    wall = time.perf_counter() - t0
    miss = launch_counts()
    rec = load_registry(reg_path)[inst.name]
    reset_launches()
    again = ensure_certified_bounds(inst, reg_path, lp, max_rounds=rounds,
                                    verbose=False, device=dev)
    hit = launch_counts()
    cpu = ensure_certified_bounds(inst, os.path.join(tmp, "cpu.json"), lp,
                                  max_rounds=rounds, verbose=False, device="cpu")
    rel = [abs(a - b) / abs(b) for a, b in zip(pair, cpu)]
    log(f"[certifier] miss on {inst.name}: {rec} in {wall:.3f}s; launches {miss}; hit "
        f"{again} launches {hit}; the CPU port's (mccormick, sdp) {cpu}, rel diff {rel}")
    return miss, {
        "the miss wrote sdp_ok": rec["sdp_ok"] is True,
        "sdp_lower <= sdp": rec["sdp_lower"] <= rec["sdp"],
        f"sdp_rel_width <= {rel_max}": rec["sdp_rel_width"] <= rel_max,
        **{f"the miss: {k}": v for k, v in dense_route_checks("certifier miss", miss).items()},
        "the hit returned the same pair": again == pair,
        "the hit ran no LP block": hit["pdhg_block"] == hit["pdhg_dense"] == hit[PLAIN_BLOCKS] == 0,
        "the card's pair within rtol 2e-3 of the CPU port's": max(rel) <= 2e-3,
    }


def lp_us(hist) -> tuple:
    """(LP seconds, LP iterations, microseconds an iteration) of a
    certifier's rounds."""
    lp_s, iters = sum(h["seconds"]["lp"] for h in hist), sum(h["lp_iters"] for h in hist)
    return lp_s, iters, lp_s / iters * 1e6


def sandwich_run(sdp_bound_mod, lp, dev) -> tuple:
    """(b)'s run through a package's ``loop/sdp_bound.py`` (this tree's, or
    another checkout's with --parent): ``validate_sdp_bound`` on the QCQP
    sandwich at its own in-out defaults, with the rounds of the
    ``sdp_relaxation_bound`` call it makes.  Returns ((ub, lb, rel), rounds)."""
    gen, args, _, rounds, _ = SANDWICH["qcqp"]
    kept = []
    real = sdp_bound_mod.sdp_relaxation_bound

    def keep(*a, **kw):
        out = real(*a, **kw)
        kept.append(out[2])
        return out

    sdp_bound_mod.sdp_relaxation_bound = keep
    try:
        out = sdp_bound_mod.validate_sdp_bound(gen(*args), lp, max_rounds=rounds, device=dev)
    finally:
        sdp_bound_mod.sdp_relaxation_bound = real
    return out, kept[0]


def qcqp_sandwich(dev) -> tuple:
    """(b) validate_sdp_bound on a QCQP on the card: tests/test_sdp_bound.py::
    test_validate_qcqp_sandwich's instance, LP and limits, cut to 8 rounds."""
    gen, args, lp, rounds, rel_max = SANDWICH["qcqp"]
    reset_launches()
    t0 = time.perf_counter()
    (ub, lb, rel), hist = sandwich_run(sdp_bound_mod, lp, dev)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    lp_s, iters, us = lp_us(hist)
    log(f"[certifier] qcqp sandwich generate_qcqp{args}: ub {ub!r} lb {lb!r} rel {rel!r} in "
        f"{wall:.3f}s, {len(hist)} rounds; the LP {lp_s:.4f}s for {iters} iterations = "
        f"{us:.2f} us a certifier LP iteration ({SMI}); launches {launches}")
    return launches, {"qcqp sandwich lb <= ub": lb <= ub + 1e-9,
                      f"qcqp sandwich rel <= {rel_max}": rel <= rel_max,
                      **{f"qcqp sandwich: {k}": v
                         for k, v in dense_route_checks("qcqp sandwich", launches).items()}}


def full_width_case() -> tuple:
    """(c)'s instance, its registry record, the Burer-Monteiro point's lb
    and host seconds, and ``sdp_relaxation_bound``'s keywords: FULL_ROUNDS
    in-out rounds over a FULL_CAPACITY-row buffer seeded with the point's
    null directions, purge_at one row past the seeds (so round 1 purges)."""
    inst = parse_boxqp(os.path.join(DATA, f"{INSTANCE}.in"), name=INSTANCE)
    reg = load_registry(os.path.join(DATA, "bounds.json"))[INSTANCE]
    t0 = time.perf_counter()
    x_in, X_in, lb = bm_feasible_point(inst.Q, inst.c)
    bm_s = time.perf_counter() - t0
    seeds = bm_null_directions(x_in, X_in)
    kw = dict(max_rounds=FULL_ROUNDS, anchor=(x_in, X_in), max_cuts_per_round=48,
              capacity=FULL_CAPACITY, seed_dirs=seeds, purge_at=len(seeds) + 1)
    return inst, reg, lb, bm_s, kw


def certifier_full_width(dev) -> tuple:
    """(c) spar125-100-1: the Burer-Monteiro point on the host, then
    FULL_ROUNDS in-out eigencut rounds on the card over a FULL_CAPACITY-row
    buffer seeded with its null directions, purge_at one row past the seeds
    (so round 1 purges; ``full_width_case``), twice from scratch, bit for
    bit."""
    inst, reg, lb, bm_s, kw = full_width_case()
    kw["device"] = dev
    seeds = kw["seed_dirs"]
    n = inst.n
    buffer_bytes = 4 * FULL_CAPACITY * (n * n + n + 1)
    log(f"[certifier] {INSTANCE}: Burer-Monteiro lb {lb!r} in {bm_s:.3f}s on the host "
        f"(registry sdp {reg['sdp']!r}, sdp_lower {reg['sdp_lower']!r}); {len(seeds)} seed "
        f"directions; dense buffer {FULL_CAPACITY} x {n} x {n} + rows: {buffer_bytes} bytes "
        f"on the card")
    reset_launches()
    t0 = time.perf_counter()
    best, b0, hist = sdp_relaxation_bound(inst, FULL_LP, **kw)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    for h in hist:
        sec = h["seconds"]
        log(f"[certifier] {INSTANCE} round {h['round']}: certificate {h['bound']!r} lam_min "
            f"{h['lam_min']:.4e} count {h['cuts']} lp_iters {h['lp_iters']} kkt "
            f"{h['lp_kkt']:.3e}; seconds {sum(sec.values()):.4f} = lp {sec['lp']:.4f} + "
            f"dual_bound_f64 {sec['certificate']:.4f} + host eigh/rows {sec['host_cuts']:.4f} "
            f"+ uploads {sec['upload']:.4f} + purge {sec['purge']:.4f}; "
            f"{sec['lp'] / h['lp_iters'] * 1e6:.2f} us a certifier LP iteration on the dense "
            f"route, count {h['cuts']} rows ({SMI})")
    again = sdp_relaxation_bound(inst, FULL_LP, **kw)[2]
    certs = np.array([h["bound"] for h in hist])

    def outcome_of(hs):
        return [(h["bound"], h["lam_min"], h["cuts"], h["lp_iters"], h["lp_kkt"]) for h in hs]

    lp_s, iters, us = lp_us(hist)
    log(f"[certifier] {INSTANCE}: {len(hist)} rounds in {wall:.3f}s, best {best!r}; the LP "
        f"{lp_s:.4f}s for {iters} iterations = {us:.2f} us a certifier LP iteration ({SMI}); "
        f"launches {launches}")
    return launches, {
        f"BM lb <= the registry's sdp {reg['sdp']}": lb <= reg["sdp"],
        f"{FULL_ROUNDS} rounds ran": len(hist) == FULL_ROUNDS,
        f"every certificate >= the registry's sdp_lower {reg['sdp_lower']}":
            bool((certs >= reg["sdp_lower"]).all()),
        "every certificate >= the port's BM lb": bool((certs >= lb).all()),
        "the running bound never rises": bool((np.diff(np.minimum.accumulate(certs)) <= 0).all())
            and best == certs.min(),
        "the purge ran": any(h["seconds"]["purge"] > 0 for h in hist),
        **dense_route_checks(f"certifier {INSTANCE}", launches),
        "a second run repeats every round bit for bit": outcome_of(again) == outcome_of(hist),
    }


def cli_path(tmp: str, dev) -> tuple:
    """(d) The CLI on the card: solve on a registry hit against CutSolver on
    the same configuration, a QCQP solve, and a suite of 2 records; the
    repository's registries unchanged."""
    registries = [os.path.join(REPO, "data", f, "bounds.json") for f in ("boxqp", "qcqp")]
    before = [sha256(p) for p in registries]
    name = "spar020-100-1"
    argv = ["solve", name, "--rounds", "5", "--data-dir", DATA]
    reset_launches()
    rc, out = run_cli(argv)
    launches = counts = launch_counts()
    rec = json.loads(out[-1])
    cfg = cli._config(cli.build_parser().parse_args(argv))
    hist = CutSolver(load_or_generate(name, data_dir=DATA), cfg, device=dev).run(rounds=5)
    floor = registry("boxqp", name)["floor"]
    certs = [h.certificate for h in hist]
    log(f"[cli] {' '.join(argv)}: rc {rc}; bounds {rec['bounds']}; gap closed "
        f"{rec['gap_closed']}; platform {rec['platform']}; launches {launches}; CutSolver "
        f"on _config: {[h.bound for h in hist]}")
    checks = {
        "cli solve rc 0": rc == 0,
        "cli solve bounds == CutSolver's bit for bit": rec["bounds"] == [h.bound for h in hist],
        "cli solve gap closed > 0": rec["final_gap_closed"] > 0,
        f"every certificate >= best known {floor}": min(certs) >= floor,
        "cli solve launched pair_score and pdhg_block, no plain block":
            launches["pair_score"] > 0 and launches["pdhg_block"] > 0
            and launches[PLAIN_BLOCKS] == 0,
    }
    qname, qflags = CLI_QCQP
    reset_launches()
    trace_dir = os.path.join(tmp, "trace")
    rc, out = run_cli(["solve", qname, "--rounds", "3", "--data-dir", DATA, *qflags,
                       "--trace", trace_dir])
    q = launch_counts()
    qrec = json.loads(out[-1])
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    log(f"[cli] solve {qname} {' '.join(qflags)} --trace: rc {rc}; bounds "
        f"{qrec['bounds']}; gap closed {qrec['gap_closed']}; launches {q}; the trace holds "
        f"{len(events)} events, {kernels} of them device kernels")
    checks.update({
        "cli solve qcqp rc 0, gap closed > 0": rc == 0 and qrec["final_gap_closed"] > 0,
        "cli solve qcqp launched fused_score and pdhg_block":
            q["fused_score"] > 0 and q["pdhg_block"] > 0 and q[PLAIN_BLOCKS] == 0,
        "cli solve --trace recorded device kernels": kernels > 0,
    })
    counts = {k: counts[k] + q[k] for k in counts}
    log_path = os.path.join(tmp, "suite.jsonl")
    reset_launches()
    rc, out = run_cli(["suite", "--sizes", "20", "--densities", "100", "--seeds", "1",
                       "--strategies", "neural,feasibility", "--rounds", "3", "--log", log_path,
                       "--data-dir", DATA])
    u = launch_counts()
    with open(log_path) as f:
        lines = [json.loads(line) for line in f]
    log(f"[cli] suite: rc {rc}; summary {out[-1]}; records "
        f"{[(r['strategy'], r['bounds'], r['platform']) for r in lines[:2]]}; launches {u}")
    counts = {k: counts[k] + u[k] for k in counts}
    after = [sha256(p) for p in registries]
    checks.update({
        "cli suite rc 0": rc == 0,
        "cli suite wrote 2 records and a summary":
            len(lines) == 3 and "summary" in lines[2]
            and [r.get("strategy") for r in lines[:2]] == ["neural", "feasibility"],
        "cli suite records on platform cuda": all(r["platform"] == "cuda" for r in lines[:2]),
        "the repository's registries unchanged": after == before,
    })
    return counts, checks


def certifiers_and_cli(dev) -> dict:
    """Phase 15: (a)-(d), registries written only in a temporary directory.
    Returns the phase's launch counts, summed over its parts."""
    t0 = time.perf_counter()
    total = None
    checks = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        for part in (lambda: certifier_miss_then_hit(tmp, dev), lambda: qcqp_sandwich(dev),
                     lambda: certifier_full_width(dev), lambda: cli_path(tmp, dev)):
            t1 = time.perf_counter()
            counts, part_checks = part()
            log(f"[certifier] part done in {time.perf_counter() - t1:.1f}s")
            checks.update(part_checks)
            total = counts if total is None else {k: total[k] + counts[k] for k in total}
    log(f"[certifier] phase 15 in {time.perf_counter() - t0:.1f}s ({SMI}); launches {total}")
    finish("certifier", checks)
    return total


def import_checkout(root: str, alias: str):
    """The port package of another checkout, imported under ``alias``: its
    modules import one another relatively, so both trees live in one
    process, each with its own modules and counters."""
    pkg_dir = os.path.join(os.path.abspath(root), "sdpcutsel_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(pkg_dir, "__init__.py"), submodule_search_locations=[pkg_dir])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[alias] = pkg
    spec.loader.exec_module(pkg)
    return pkg


def certifier_against_parent(parent: str, dev) -> dict:
    """With --parent DIR: the certifier's LP in the parent checkout's package
    and in this tree's on phase 15's (c) and (b) (``full_width_case``,
    ``sandwich_run``), the same LP configs and the same Burer-Monteiro point
    for (c).  One warm-up run of (c) a tree, then the runs in turns (parent,
    this, this, parent); each run's microseconds a certifier LP iteration
    and its round split.  Returns the microseconds by tree and case."""
    alias = parent_package(parent).__name__
    mods = {"parent": importlib.import_module(f"{alias}.loop.sdp_bound"),
            "this": sdp_bound_mod}
    configs = {"parent": importlib.import_module(f"{alias}.config"),
               "this": config_mod}
    inst, _, _, _, kw = full_width_case()

    def lp_of(tree, lp):
        return configs[tree].LPConfig(**dataclasses.asdict(lp))

    def run(tree) -> dict:
        out = {}
        for case, go in (
                (f"{INSTANCE} (c)", lambda: mods[tree].sdp_relaxation_bound(
                    inst, lp_of(tree, FULL_LP), device=dev, **kw)[2]),
                ("qcqp sandwich (b)", lambda: sandwich_run(
                    mods[tree], lp_of(tree, SANDWICH["qcqp"][2]), dev)[1])):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hist = go()
            wall = time.perf_counter() - t0
            lp_s, iters, us = lp_us(hist)
            split = {k: sum(h["seconds"].get(k, 0.0) for h in hist)
                     for k in ("lp", "certificate", "host_cuts", "upload", "purge")}
            log(f"[certifier timing] {tree}: {case} {len(hist)} rounds in {wall:.4f}s, best "
                f"{min(h['bound'] for h in hist)!r}; the LP {lp_s:.4f}s for {iters} iterations "
                f"= {us:.2f} us a certifier LP iteration; seconds {json.dumps(split)} ({SMI})")
            out[case] = us
        return out

    for tree in ("parent", "this"):
        mods[tree].sdp_relaxation_bound(inst, lp_of(tree, FULL_LP), device=dev, **kw)
    runs = {"parent": [], "this": []}
    for tree in ("parent", "this", "this", "parent"):
        runs[tree].append(run(tree))
    summary = {tree: {case: [r[case] for r in rs] for case in rs[0]} for tree, rs in runs.items()}
    log(f"[certifier timing] us a certifier LP iteration, in turns: {json.dumps(summary)} ({SMI})")
    return summary


@contextlib.contextmanager
def probe_training(seen: dict):
    """Record where the first training step finds its tensors: the dataset
    and the batch, the MLP, and (after the step) Adam's moments."""
    step = train_mod.train_step

    def probed(model, optimizer, lr_t, ftr, ltr, idx):
        loss = step(model, optimizer, lr_t, ftr, ltr, idx)
        if not seen:
            seen["dataset"] = {str(t.device) for t in (ftr, ltr, idx)}
            seen["mlp"] = {str(p.device) for p in model.parameters()}
            seen["adam moments"] = {str(v.device) for st in optimizer.state.values()
                                    for name, v in st.items() if name != "step"}
        return loss

    train_mod.train_step = probed
    try:
        yield
    finally:
        train_mod.train_step = step


def training_split(lines) -> dict:
    """The seconds of labelling and harvests and the steps/s that
    ``train_scorer`` printed."""
    split = {}
    for line in lines:
        if m := re.match(r"\[train\] synthetic: (\d+) rows labelled in ([0-9.]+)s", line):
            split["labelling_s"] = float(m[2])
        elif m := re.match(r"\[train\] harvest: (\d+) rows.* in ([0-9.]+)s", line):
            split["harvest_rows"], split["harvest_s"] = int(m[1]), float(m[2])
        elif m := re.match(r"\[train\] \+qcqp harvest: (\d+) rows.* in ([0-9.]+)s", line):
            split["qcqp_harvest_rows"], split["qcqp_harvest_s"] = int(m[1]), float(m[2])
        elif m := re.match(r"\[train\] (\d+) steps of batch \d+ in ([0-9.]+)s = ([0-9.]+)", line):
            split["steps"], split["steps_s"], split["steps_per_s"] = (
                int(m[1]), float(m[2]), float(m[3]))
    return split


def train_cli(tag: str, argv, seen=None) -> tuple:
    """``cli train`` in-process, counters reset before and read after.
    Returns (launch counts, metrics, split)."""
    reset_launches()
    t0 = time.perf_counter()
    with probe_training(seen if seen is not None else {}):
        rc, out = run_cli(argv)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    for line in out[:-1]:
        log(f"[{tag}] {line}")
    metrics = json.loads(out[-1])
    split = training_split(out)
    log(f"[{tag}] {' '.join(argv)}: rc {rc} in {wall:.3f}s; split {split}; launches "
        f"{launches} ({SMI})")
    log(f"[{tag}] metrics {json.dumps(metrics)}")
    if rc != 0:
        raise AssertionError(f"{tag}: cli train returned {rc}")
    return launches, metrics, split


def training(main_hist, dev) -> dict:
    """Phase 16: (a)-(e), weights written only in a temporary directory.
    Returns the phase's launch counts, summed over its parts."""
    t_phase = time.perf_counter()
    shipped = sorted(glob.glob(os.path.join(REPO, "sdpcutsel_tpu_torch", "models", "artifacts",
                                            "*.npz")))
    shipped += [os.path.join(REPO, "data", f, "bounds.json") for f in ("boxqp", "qcqp")]
    before = [sha256(p) for p in shipped]
    checks = {}
    parts = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        # (a) k = 3 at the reference's full defaults
        k3_path = os.path.join(tmp, "mlp_k3.npz")
        seen: dict = {}
        a, m3, split3 = train_cli("train k=3", ["train", "--k", "3", "--out", k3_path],
                          seen)
        parts.append(a)
        log(f"[train k=3] tensors of the first step: {seen}; the JAX package's CPU run "
            f"{TRAIN_REF_K3}")
        checks.update({
            "k=3 launched pair_score and pdhg_block": a["pair_score"] > 0 and a["pdhg_block"] > 0,
            "k=3 no plain PDHG block, no twin-scored call":
                a[PLAIN_BLOCKS] == 0 and a[TWIN_SCORED] == 0,
            **{f"k=3 {k}": v for k, v in control_checks("train k=3", a).items()},
            **{f"k=3 {name} >= {ref - TRAIN_SLACK:.4f}": m3[name] >= ref - TRAIN_SLACK
               for name, ref in TRAIN_REF_K3.items()},
            "k=3 datasets, MLP and Adam's moments on cuda":
                bool(seen) and all(dev_set == {str(dev)} for dev_set in seen.values()),
            "k=3 wrote its weights": os.path.exists(k3_path),
        })
        # (b) k = 4: the QCQP harvest adds K4 and K2 with dense rows
        k4_path = os.path.join(tmp, "mlp_k4.npz")
        b, m4, split4 = train_cli("train k=4", ["train", "--k", "4", "--out", k4_path])
        parts.append(b)
        checks.update({
            "k=4 launched fused_score and pdhg_block": b["fused_score"] > 0
                and b["pdhg_block"] > 0,
            "k=4 no plain PDHG block, no twin-scored call":
                b[PLAIN_BLOCKS] == 0 and b[TWIN_SCORED] == 0,
            **{f"k=4 {k}": v for k, v in control_checks("train k=4", b).items()},
            "k=4 harvested QCQP rows": split4.get("qcqp_harvest_rows", 0) > 0,
            "k=4 metrics finite": all(np.isfinite(v) for v in m4.values() if v is not None),
            "k=4 wrote its weights": os.path.exists(k4_path),
        })
        # (c) a solve with the weights of (a)
        inst = parse_boxqp(os.path.join(DATA, f"{INSTANCE}.in"), name=INSTANCE)
        _, err, _ = k1_twin_check("trained weights", inst, 5, dev, weights_path=k3_path)
        cfg = RunConfig(lp=BOXQP_LP, scorer=ScorerConfig(weights_path=k3_path))
        c, hist, solve_checks = boxqp_path("trained", inst, cfg, dev, ("pair_score", "pdhg_block"))
        parts.append(c)
        reg = registry("boxqp", INSTANCE)
        gap, shipped_gap = gap_closed(reg, hist[-1].bound), gap_closed(reg, main_hist[-1].bound)
        log(f"[trained] gap closed after {ROUNDS} rounds with the weights of (a): {gap!r}; "
            f"with the shipped weights (phase 5, this call): {shipped_gap!r}; K1 against its "
            f"twin with the trained weights: max|err| {err:.3e}")
        checks.update({f"trained-weight solve: {name}": ok for name, ok in solve_checks.items()})
        checks["trained-weight solve closes gap > 0"] = gap > 0
        # (d) twice from one seed, bit for bit
        runs = []
        for i in range(2):
            reset_launches()
            t0 = time.perf_counter()
            params, metrics = train_mod.train_scorer(
                **TRAIN_REPEAT, seed=SEED, out_path=os.path.join(tmp, f"repeat{i}.npz"),
                verbose=False, device=dev)
            parts.append(launch_counts())
            runs.append((params, {n: v for n, v in metrics.items() if n != "train_time_s"}))
            log(f"[train repeat] run {i}: {TRAIN_REPEAT} in {time.perf_counter() - t0:.3f}s "
                f"({SMI}); metrics {metrics}")
        (p0, m0), (p1, m1) = runs
        checks["a second training run repeats the weights bit for bit"] = (
            sorted(p0) == sorted(p1) and all(np.array_equal(p0[n], p1[n]) for n in p0))
        checks["a second training run repeats the metrics (but the time)"] = m0 == m1
    # (e) the shipped weights and the registries untouched
    after = [sha256(p) for p in shipped]
    checks[f"the {len(shipped)} shipped weight and registry files unchanged"] = after == before
    total = {k: sum(p[k] for p in parts) for k in parts[0]}
    log(f"[train] phase 16 in {time.perf_counter() - t_phase:.1f}s; launches {total} ({SMI})")
    finish("train", checks)
    return total


def rank_launches(outs) -> list:
    """Each rank's ``[launches rank R] {...}`` line."""
    found = []
    for r, out in enumerate(outs):
        m = re.search(rf"^\[launches rank {r}\] (\{{.*\}})$", out, re.M)
        if m is None:
            raise AssertionError(f"rank {r} printed no launch counts:\n{out[-2000:]}")
        found.append(json.loads(m.group(1)))
    return found


def rank_lines(tag: str, outs) -> list:
    """Log every rank's lines; return its launch counts."""
    for r, out in enumerate(outs):
        for line in out.splitlines():
            if line.startswith(("[rank", "[launches", "dryrun_multichip", "{")):
                log(f"[{tag}] rank {r}: {line}")
    return rank_launches(outs)


def clean_ranks(launches, kernels: tuple) -> dict:
    """Every rank launched ``kernels``, and no plain PDHG block or twin;
    each rank's solves ran their control on the card (control_checks)."""
    out = {f"every rank launched {' and '.join(kernels)}":
               all(min(c[k] for k in kernels) > 0 for c in launches),
           "no plain PDHG block, no twin-scored call on any rank":
               all(c[PLAIN_BLOCKS] == 0 and c[TWIN_SCORED] == 0 for c in launches)}
    for r, c in enumerate(launches):
        out.update({f"rank {r}: {k}": v for k, v in control_checks(f"rank {r}", c).items()})
    return out


def multihost(args, ranks: int, save: str) -> tuple:
    """run_multihost as ``ranks`` subprocesses; (outputs, the saved npz)."""
    t0 = time.perf_counter()
    outs = distributed.spawn(["-m", "sdpcutsel_tpu_torch.run_multihost", *args, "--save", save],
                             ranks, RANK_TIMEOUT)
    log(f"[multi] run_multihost {' '.join(args)} on {ranks} ranks in "
        f"{time.perf_counter() - t0:.1f}s")
    return outs, np.load(save)


def same_bits(got, state, cert, iters) -> bool:
    return (np.array_equal(got["idx"], state.pool.idx.cpu().numpy())
            and np.array_equal(got["count"], state.pool.count.cpu().numpy())
            and np.array_equal(got["best_bound"], state.best_bound.cpu().numpy())
            and np.array_equal(got["cert"], cert) and np.array_equal(got["lp_iters"], iters))


def timed_dryrun(data: int) -> tuple:
    """dryrun_multichip over 2 ranks at 'data' = ``data``: (outputs, seconds)."""
    t0 = time.perf_counter()
    return dryrun_multichip(2, data, timeout=RANK_TIMEOUT), time.perf_counter() - t0


def suite_runner(cmd: list) -> list:
    """run_suite_incremental twice in turn (``cmd``): each call's output."""
    said = []
    for _ in range(2):
        t0 = time.perf_counter()
        run = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                             timeout=RANK_TIMEOUT)
        if run.returncode:
            raise AssertionError(f"run_suite_incremental failed:\n{run.stdout}{run.stderr}")
        said.append(run.stdout)
        log(f"[runner] run_suite_incremental in {time.perf_counter() - t0:.1f}s: "
            f"{run.stdout.strip()!r}")
    return said


def multi_process(dev) -> dict:
    """Phase 17: the multi-process paths, each rank a subprocess; returns
    the launches summed over every rank.  The rank groups of (a)-(d) and
    the runner of (e) start together (each group its own file store; they
    share the card and the host's cores), and each is waited for where its
    checks are; the gathers' timing of (b) runs alone after them."""
    t_phase = time.perf_counter()
    checks, launches = {}, []
    with (tempfile.TemporaryDirectory(prefix="chip_smoke_multi_") as tmp,
          concurrent.futures.ThreadPoolExecutor(6) as jobs):
        n, B = BENCH_BATCH
        data = os.path.join(tmp, "boxqp")
        os.makedirs(data)
        for name in ("spar020-100-1.in", "bounds.json"):
            shutil.copy(os.path.join(DATA, name), data)
        out_path = os.path.join(tmp, "suite_torch.jsonl")
        started = {
            "dry": {d: jobs.submit(timed_dryrun, d) for d in (2, 1)},
            "full": jobs.submit(multihost, [
                "--instances", INSTANCE, "--data", "1", "--cand", "2", "--capacity", "1024",
                "--rounds", str(BATCH_ROUNDS), "--lp-iters", "400", "--sel-size", "16"], 2,
                os.path.join(tmp, "full.npz")),
            "scan": jobs.submit(multihost, [
                "--n", str(n), "--batch", str(B), "--rounds", str(BATCH_ROUNDS), "--data", "2",
                "--cand", "1", "--capacity", "1024", "--lp-iters", "400", "--sel-size", "16",
                "--use-scan"], 2, os.path.join(tmp, "scan.npz")),
            "nccl": jobs.submit(multihost, ["--data", "1", "--cand", "1"], 1,
                                os.path.join(tmp, "nccl.npz")),
            "runner": jobs.submit(suite_runner, [
                sys.executable, "-m", "sdpcutsel_tpu_torch.run_suite_incremental", "--sizes",
                "20", "--densities", "100", "--seeds", "1", "--strategies", "feasibility",
                "--rounds", "2", "--data-dir", data, "--out", out_path]),
        }
        # (a) the dry run's two shapes of 2 ranks
        for data_ in (2, 1):
            outs, seconds = started["dry"][data_].result()
            counts = rank_lines("dryrun", outs)
            launches += counts
            line = next((ln for ln in outs[0].splitlines()
                         if ln.startswith("dryrun_multichip ok")), "")
            shape = f"{data_}x{2 // data_}"
            log(f"[dryrun] {shape} in {seconds:.1f}s, beside the other groups ({SMI})")
            checks[f"(a) dry run {shape}: its checks, bit for bit per shard"] = (
                f"mesh=({shape})" in line and "bit_equal_to_per_shard_batches=True" in line)
            checks.update({f"(a) {shape}: {k}": v for k, v in clean_ranks(
                counts, ("pair_score", "fused_score", "pdhg_block")).items()})

        # (b) spar125-100-1 alone, 'cand' across two ranks
        inst = parse_boxqp(os.path.join(DATA, f"{INSTANCE}.in"), name=INSTANCE)
        outs, got = started["full"].result()
        counts = rank_lines("multi-full", outs)
        launches += counts
        half = "158875 of 317750 candidate rows"
        runs = {}
        for cand in (2, 1):
            mesh = Mesh(1, cand)
            table, valid = shard_candidates(combinations_table(inst.n, 3), mesh, device=dev)
            step = make_sharded_round_step(mesh, **MULTI_FULL_KNOBS)
            state = init_batched_state(inst.Q[None], inst.c[None], 1024, 3, device=dev)
            step(state, table, valid)                                    # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(BATCH_ROUNDS):
                state, info = step(state, table, valid)
            torch.cuda.synchronize()
            log(f"[multi-full] in-process Mesh(1, {cand}): {BATCH_ROUNDS} rounds in "
                f"{time.perf_counter() - t0:.4f} s after a warm-up round ({SMI})")
            runs[cand] = (state, certify_batched_f64(state), info["lp_iters"])
        one_rel = float(np.abs(got["cert"] - runs[1][1]).max() / np.abs(runs[1][1]).max())
        log(f"[multi-full] {INSTANCE} at 1 x 2 over 2 ranks: certified {got['cert'].tolist()} "
            f"cuts {got['count'].tolist()}; in-process Mesh(1, 2) {runs[2][1].tolist()}, "
            f"Mesh(1, 1) {runs[1][1].tolist()} (rel {one_rel!r}; pools equal "
            f"{np.array_equal(got['idx'], runs[1][0].pool.idx.cpu().numpy())})")
        checks.update({
            "(b) each rank scores 158,875 of the 317,750 candidates":
                all(half in out for out in outs),
            "(b) 1 x 2 over two ranks = the in-process Mesh(1, 2) run, bit for bit":
                same_bits(got, *runs[2]),
            "(b) within rtol 2e-5 of Mesh(1, 1)": bool(
                np.allclose(got["cert"], runs[1][1], rtol=2e-5, atol=0)
                and np.allclose(got["best_bound"], runs[1][0].best_bound.cpu().numpy(),
                                rtol=2e-5, atol=0)),
            f"(b) K1 once a rank a round ({BATCH_ROUNDS})":
                all(c["pair_score"] == BATCH_ROUNDS for c in counts),
            **{f"(b) {k}": v for k, v in clean_ranks(counts, ("pair_score", "pdhg_block")).items()},
        })

        # (c) bench.py's batched scan, 'data' across two ranks
        outs, got = started["scan"].result()
        counts = rank_lines("multi-scan", outs)
        launches += counts
        insts = [generate_spar(n, 100, s + 1) for s in range(B)]
        start = init_batched_state(np.stack([i.Q for i in insts]), np.stack([i.c for i in insts]),
                                   1024, 3, device=dev)
        table, valid = shard_candidates(combinations_table(n, 3), Mesh(1, 1), device=dev)
        scan = make_sharded_scan_step(Mesh(1, 1), rounds=BATCH_ROUNDS, **MULTI_FULL_KNOBS)
        halves = [scan(instances_of(start, h * B // 2, (h + 1) * B // 2), table, valid)
                  for h in range(2)]
        per_round = np.concatenate([certify_scan_f64(f.Q, f.c, o) for f, o in halves], 1)
        idx = np.concatenate([f.pool.idx.cpu().numpy() for f, _ in halves])
        count = np.concatenate([f.pool.count.cpu().numpy() for f, _ in halves])
        best = np.concatenate([f.best_bound.cpu().numpy() for f, _ in halves])
        log(f"[multi-scan] {B} x generate_spar({n}, 100, s + 1) at 2 x 1: last round "
            f"{got['per_round'][-1].tolist()}; in-process halves {per_round[-1].tolist()}")
        checks.update({
            "(c) 2 x 1 over two ranks = the two 4-instance batches, bit for bit":
                bool(np.array_equal(got["per_round"], per_round)
                     and np.array_equal(got["idx"], idx) and np.array_equal(got["count"], count)
                     and np.array_equal(got["best_bound"], best)),
            f"(c) K1 once an instance a round on each rank ({B // 2 * BATCH_ROUNDS})":
                all(c["pair_score"] == B // 2 * BATCH_ROUNDS for c in counts),
            **{f"(c) {k}": v for k, v in clean_ranks(counts, ("pair_score", "pdhg_block")).items()},
        })

        # (d) NCCL at world size 1, the backend by the rule (a rank with its own card)
        outs, got = started["nccl"].result()
        counts = rank_lines("multi-nccl", outs)
        launches += counts
        result = json.loads([ln for ln in outs[0].splitlines() if ln.startswith("{")][-1])
        checks.update({
            "(d) run_multihost over nccl, certificates finite":
                result["backend"] == "nccl" and bool(np.isfinite(got["cert"]).all()),
            **{f"(d) {k}": v for k, v in clean_ranks(counts, ("pair_score", "pdhg_block")).items()},
        })

        # (e) a runner on the card: one cell, then a second call skips it
        said = started["runner"].result()
        rows = [json.loads(line) for line in open(out_path)]
        checks.update({
            "(e) one record, platform cuda": len(rows) == 1 and rows[0]["platform"] == "cuda"
                and rows[0]["final_gap_closed"] > 0,
            "(e) the second call skips the cell": "[suite] spar020-100-1" not in said[1],
        })
        # (b)'s gathers timed once every other group has ended
        gathers = [json.loads(out.strip().splitlines()[-1])
                   for out in distributed.spawn(["-c", GATHER_TIMING], 2, RANK_TIMEOUT)]
        log(f"[multi-full] gloo's two gathers of a round at 1 x 2 on one card, us per round "
            f"by rank, of card tensors (through the host) and of host tensors: "
            f"{[g['us_per_round'] for g in gathers]} ({SMI})")
    total = {k: sum(c[k] for c in launches) for k in launches[0]}
    log(f"[multi] phase 17 in {time.perf_counter() - t_phase:.1f}s ({SMI}); launches over "
        f"{len(launches)} ranks {total}")
    finish("multi", checks)
    return total

# ---- the wide phase: n > 128 on the kernels' 256-column forms ----------------
# K2 (both forms) and K6 at (n, k, m): BoxQP at n = 150 and 256 with k = 3
# cuts, and a QCQP at n = 150 with k = 5 cuts and 16 dense rows
WIDE_SHAPES = {"n=150 m=0": (150, 3, 0), "n=256 m=0": (256, 3, 0),
               "n=150 k=5 m=16": (150, 5, 16)}
WIDE_BATCH = 4                        # generate_spar(150, 100, s + 1), s < 4, one launch
WIDE_DENSE = ((150, 368), (256, 368), (256, FULL_CAPACITY))
WIDE_INSTANCE = (256, 100, 1)         # generate_spar's arguments: the wide solve and K1
WIDE_ROUNDS = 5
WIDE_CERT = (150, 100, 1)             # the certifier's instance at n = 150


def wide_inputs(label: str, dev):
    """(Q, c, table, dense) of a wide K2 shape: generate_spar(n, 100, 1) and
    its lexicographic triples, or generate_qcqp(150, 30, 16, 1)'s objective
    and 16 dense rows with 2,000 random 5-subsets of its columns."""
    n, k, m = WIDE_SHAPES[label]
    if m == 0:
        inst = generate_spar(n, 100, 1)
        return inst.Q, inst.c, combinations_table(n, k), None
    q = generate_qcqp(n, 30, m, 1)
    rng = np.random.default_rng(SEED + 4)
    table = np.sort(np.stack([rng.choice(n, k, replace=False) for _ in range(2000)]), axis=1)
    return q.Q0, q.c0, table, dense_from_qcqp(q.Qs, q.cs, q.bs, dev)


def wide_kernels(dev, pkg=None, lib=None) -> dict:
    """K2 (unchecked, 7 and 100 iterations), its checked launch (K5) and K6
    at WIDE_SHAPES against their twins at phase 3's tolerances, twice bit for
    bit, each timed beside its bound; the batch of WIDE_BATCH n = 150
    instances in one launch (K2, then K5 and K6), each instance bit for bit
    with its batch of one; K7, K7c and K7n at WIDE_DENSE; K1 over all
    C(256, 3) candidates.  ``pkg``, ``lib``: the parent checkout's package
    and its K2 (parent_k2), whose K2, checked launch, K6, K7, K7c and K7n
    must then give these bits at these shapes.  Returns {kernel: numbers}."""
    out = {"pdhg_block": {}, "pdhg_check": {}, "pdhg_norm": {}}
    for label, (n, k, m) in WIDE_SHAPES.items():
        Q, c, table, dense = wide_inputs(label, dev)
        plan = launch_plan(n, 1024, k, m, checked=True)
        log(f"[wide {label}] K2's checked plan: width {plan.cols}, {plan.rows} rows a CTA, "
            f"{plan.smem_bytes} bytes a CTA, {plan.term_cap} cut-index terms; the largest pool "
            f"{plan.max_capacity} and dense rows {plan.max_dense} at this shape; K6 "
            f"(words, resident, staged) {pdhg_norm_mod.smem_words(n, 1024, k, m)}")
        out["pdhg_block"][label] = check_pdhg_block(label, Q, c, table, dense, dev)
        inputs = pdhg_inputs(Q, c, table, dense, dev)
        out["pdhg_check"][label] = check_pdhg_check(label, inputs, dense, dev)
        out["pdhg_norm"][label] = check_pdhg_norm(label, inputs, dense, dev, pkg)
        if pkg is not None:
            same = [checked_against_parent(pkg, label, inputs, dense, dev)]
            cx, cX, pool, index, st = inputs
            eta = 0.95 / estimate_norm_plain(pool, c.shape[0], 30,
                                             torch.Generator().manual_seed(0), index,
                                             dense).item()
            same += [k2_against_parent(lib, label, (cx, cX, pool, index, st,
                                                    st.map(torch.zeros_like), eta, eta),
                                       dense, iters) for iters in (7, 100)]
            if not all(same):
                raise AssertionError(f"K2 or its checked launch does not give the parent "
                                     f"build's bits at phase 18's shapes ({label})")
    insts = [generate_spar(150, 100, s + 1) for s in range(WIDE_BATCH)]
    out["batched"] = check_pdhg_block_batched(insts, out["pdhg_block"]["n=150 m=0"], dev)
    out["control_batched"] = check_control_batched(insts, dev)
    out.update(check_dense_shapes(WIDE_DENSE, WIDE_DENSE, dev, pkg))
    inst = generate_spar(*WIDE_INSTANCE)
    args, err, moved = k1_twin_check(inst.name, inst, 5, dev)
    x, X, Q, table, mlp = args
    ms = cuda_ms(lambda: pair_score(*args), reps=20)
    dev_ms = device_ms(lambda: pair_score(*args), "pair_score_kernel", reps=20)
    plain_ms = cuda_ms(lambda: pair_score_plain(*args), reps=2, warmup=1)
    T = table.shape[0]
    b, parts = scoring_bound(T, moved + mlp_bytes(mlp), ms)
    log(f"[pair_score {inst.name}] T={T}: kernel {ms:.4f} ms by events ({T / ms / 1e3:.1f} M "
        f"cand/s), {dev_ms:.4f} ms on the device (profiler); twin {plain_ms:.4f} ms; "
        f"{share(ms, b)}; {parts} ({SMI})")
    out["pair_score"] = {"max_abs_err": err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                         "candidates": T, **b}
    return out


def feasible_objective(inst, x) -> float:
    """f(z) = 1/2 z'Qz + c'z in f64 at a feasible point: x rounded to {0, 1},
    then single flips while one raises f.  Every certificate, an upper bound
    on max f over the box, must reach it."""
    Q, c = inst.Q, inst.c
    z = (np.asarray(x, np.float64) > 0.5).astype(np.float64)
    while True:
        # flipping z_i changes f by (1 - 2 z_i) (Q z + c)_i + Q_ii / 2
        gain = (1.0 - 2.0 * z) * (Q @ z + c) + 0.5 * np.diag(Q)
        i = int(np.argmax(gain))
        if gain[i] <= 0.0:
            return float(0.5 * z @ Q @ z + c @ z)
        z[i] = 1.0 - z[i]


def wide_solve(dev, k2_ms: float) -> tuple:
    """CutSolver on generate_spar(256, 100, 1) with the default cuts, strategy
    neural and the suite's LP config, WIDE_ROUNDS rounds with "auto" (the
    256-column forms), counters reset before and read after: K1, K2, K5 and
    K6 and no plain block or twin; a second run from a fresh solver repeats
    every round bit for bit; the bound is the certificates' running minimum
    and every certificate reaches a feasible point's objective.  Then the
    synchronised stage split of a third run (profile_round.stage_split).
    Returns (launch counts, checks)."""
    from sdpcutsel_tpu_torch.profile_round import stage_split

    inst = generate_spar(*WIDE_INSTANCE)
    cfg = RunConfig(lp=BOXQP_LP)
    combinations_table.cache_clear()       # time the solver's cold build of its table
    t0 = time.perf_counter()
    table = combinations_table(inst.n, 3)
    table_s = time.perf_counter() - t0
    solver = CutSolver(inst, cfg, device=dev)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = solver.run(rounds=WIDE_ROUNDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    floor = feasible_objective(inst, solver.state.x.cpu().numpy())
    for h in hist:
        log(f"[wide {inst.name}] round {h.round}: bound {h.bound!r} certificate "
            f"{h.certificate!r} cuts_added {h.cuts_added} active {h.cuts_active} lp_iters "
            f"{h.lp_iters} kkt {h.lp_kkt_error:.3e} wall {h.wall_time_s:.3f}s")
    bounds = np.array([h.bound for h in hist])
    certs = np.array([h.certificate for h in hist])
    iters = sum(h.lp_iters for h in hist)
    log(f"[wide {inst.name}] {len(hist)} rounds in {wall:.3f}s = {len(hist) / wall!r} rounds/s "
        f"({iters} LP iterations; K2 at n = 256: {k2_ms * 10:.3f} us an iteration, phase 3's "
        f"100-iteration block); launches {launches}; a feasible point's f {floor!r}; "
        f"combinations_table(256, 3) {table_s:.4f}s on the host ({table.shape[0]} rows; {SMI})")
    again = CutSolver(inst, cfg, device=dev).run(rounds=WIDE_ROUNDS)
    split_wall, stages = stage_split((inst, CutSolver, cfg, WIDE_ROUNDS), dev, WIDE_ROUNDS)
    for label, (sec, calls) in stages.items():
        if calls:
            log(f"[wide {inst.name}] split: {label} {sec:.4f}s ({sec / split_wall:.2%} of the "
                f"synchronised run's {split_wall:.4f}s), {calls} calls")
    checks = {
        f"{WIDE_ROUNDS} rounds ran": len(hist) == WIDE_ROUNDS,
        "K1, K2, K5 and K6 launched": min(launches[k] for k in (
            "pair_score", "pdhg_block", "pdhg_check", "pdhg_norm")) > 0,
        "no plain PDHG block, twin check, norm or scorer on the card":
            launches[PLAIN_BLOCKS] == launches[PLAIN_CONTROL] == launches[TWIN_SCORED] == 0,
        "certificates finite": bool(np.isfinite(certs).all()),
        f"every certificate >= a feasible point's f {floor}": bool((certs >= floor).all()),
        "bounds are the running minimum of the certificates":
            bool((bounds == np.minimum.accumulate(certs)).all()),
        "last round below round 0": bool(bounds[-1] < bounds[0]),
        "a second run repeats every round bit for bit": outcome(again) == outcome(hist),
        **control_checks(f"wide {inst.name}", launches),
    }
    return launches, checks


def certifier_wide(dev) -> tuple:
    """The certifier at n = 150 (generate_spar(150, 100, 1), no registry
    record): the Burer-Monteiro point on the host, then FULL_ROUNDS in-out
    eigencut rounds of FULL_LP over a FULL_CAPACITY-row buffer seeded with
    its null directions (full_width_case's settings), on the dense route
    only; every certificate finite and >= the BM lb; the run repeated bit
    for bit.  Returns (launch counts, checks)."""
    inst = generate_spar(*WIDE_CERT)
    t0 = time.perf_counter()
    x_in, X_in, lb = bm_feasible_point(inst.Q, inst.c)
    bm_s = time.perf_counter() - t0
    seeds = bm_null_directions(x_in, X_in)
    kw = dict(max_rounds=FULL_ROUNDS, anchor=(x_in, X_in), max_cuts_per_round=48,
              capacity=FULL_CAPACITY, seed_dirs=seeds, purge_at=len(seeds) + 1, device=dev)
    reset_launches()
    t0 = time.perf_counter()
    best, _, hist = sdp_relaxation_bound(inst, FULL_LP, **kw)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    for h in hist:
        sec = h["seconds"]
        log(f"[wide certifier {inst.name}] round {h['round']}: certificate {h['bound']!r} count "
            f"{h['cuts']} lp_iters {h['lp_iters']} kkt {h['lp_kkt']:.3e}; seconds "
            f"{sum(sec.values()):.4f} = lp {sec['lp']:.4f} + dual_bound_f64 "
            f"{sec['certificate']:.4f} + host eigh/rows {sec['host_cuts']:.4f} + uploads "
            f"{sec['upload']:.4f} + purge {sec['purge']:.4f}")
    again = sdp_relaxation_bound(inst, FULL_LP, **kw)[2]
    certs = np.array([h["bound"] for h in hist])
    lp_s, iters, us = lp_us(hist)
    log(f"[wide certifier {inst.name}] BM lb {lb!r} in {bm_s:.3f}s on the host, {len(seeds)} "
        f"seed directions; {len(hist)} rounds in {wall:.3f}s, best {best!r}; the LP {lp_s:.4f}s "
        f"for {iters} iterations = {us:.2f} us a certifier LP iteration ({SMI}); launches "
        f"{launches}")

    def outcome_of(hs):
        return [(h["bound"], h["lam_min"], h["cuts"], h["lp_iters"], h["lp_kkt"]) for h in hs]

    return launches, {
        f"{FULL_ROUNDS} rounds ran": len(hist) == FULL_ROUNDS,
        "certificates finite": bool(np.isfinite(certs).all()),
        "every certificate >= the port's BM lb": bool((certs >= lb).all()),
        **dense_route_checks(f"wide certifier {inst.name}", launches),
        "a second run repeats every round bit for bit": outcome_of(again) == outcome_of(hist),
    }


def wide_phase(dev, pkg=None, lib=None) -> dict:
    """Phase 18: the kernels' 256-column forms against their twins
    (wide_kernels; with ``pkg``, ``lib`` the parent's, to its bits too), the
    wide solve (wide_solve) and the certifier at n = 150 (certifier_wide),
    each path's launches into PATH_LAUNCHES.  Returns wide_kernels'
    numbers."""
    t0 = time.perf_counter()
    out = wide_kernels(dev, pkg, lib)
    PATH_LAUNCHES["wide boxqp n=256"], checks = wide_solve(
        dev, out["pdhg_block"]["n=256 m=0"]["ms"])
    finish("wide solve", checks)
    PATH_LAUNCHES["wide certifier n=150"], checks = certifier_wide(dev)
    finish("wide certifier", checks)
    log(f"[wide] phase 18 took {time.perf_counter() - t0:.1f}s")
    return out



# ---- phase 19, the grid route: n <= 512, and dense rows past K2's cluster -----
# The grid kernels (csrc/pdhg_grid.cu) at (n, k, m), M = 1024 with 400 active
# unit cuts as phase 3's: BoxQP at n = 300 and 512 with k = 3, a QCQP at
# n = 200 with k = 5 and generate_qcqp(200, 30, 25, 1)'s 25 dense rows (K2's
# cluster holds 10 at n = 200) and at n = 150 with generate_qcqp(150, 30, 64,
# 1)'s 64 (it holds 25); their form without cuts, the dense route's past
# n = 256, at n = 300 over 368 of the certifier's rows
GRID_SHAPES = {"n=300 m=0": (300, 3, 0), "n=512 m=0": (512, 3, 0),
               "n=200 k=5 m=25": (200, 5, 25), "n=150 k=5 m=64": (150, 5, 64)}
GRID_CERT = (300, 368)
GRID_INSTANCE = (512, 100, 1)         # spar512-100-1, CutSolver with the defaults
GRID_ROUNDS = 3
GRID_BAND = (200, 5, 25, 1)           # generate_qcqp_band: K2 holds 10 of its 25 rows
GRID_BAND_CFG = RunConfig(lp=LPConfig(max_iters=3000, tol=1e-5),
                          cuts=CutConfig(k=5, sel_size=16, capacity=1024))
GRID_BAND_ROUNDS = 2
GRID_RTOL = 2e-3                      # a round on the card against the CPU port's
GRID_CERT_N, GRID_CERT_ROUNDS = 300, 3  # the certifier past n = 256


def grid_inputs(label: str, dev):
    """(cx, cX, pool, index, state, dense) of a GRID_SHAPES shape:
    generate_spar(n, 100, 1) and its lexicographic triples, or
    generate_qcqp(n, 30, m, 1)'s objective and m dense rows with 2,000 random
    5-subsets of its columns; phase 3's pool and random state."""
    n, k, m = GRID_SHAPES[label]
    if m == 0:
        inst = generate_spar(n, 100, 1)
        Q, c, table, dense = inst.Q, inst.c, combinations_table(n, k), None
    else:
        q = generate_qcqp(n, 30, m, 1)
        rng = np.random.default_rng(SEED + 4)
        table = np.sort(np.stack([rng.choice(n, k, replace=False) for _ in range(2000)]), axis=1)
        Q, c, dense = q.Q0, q.c0, dense_from_qcqp(q.Qs, q.cs, q.bs, dev)
    return (*pdhg_inputs(Q, c, table, dense, dev), dense)


def grid_ptxas() -> str:
    """ptxas's lines of every grid-route kernel, the far form's too; fails on
    a spill or a stack frame."""
    rep = "; ".join(spill_free(k) for k in ("pdhg_grid_kernel", "pdhg_grid_norm_kernel",
                                            "pdhg_grid_far_kernel",
                                            "pdhg_grid_far_norm_kernel"))
    if re.search(r"[1-9]\d* bytes stack frame", rep):
        raise AssertionError(f"a grid-route kernel has a stack frame: {rep}")
    return rep


def check_grid_block(label: str, inputs, reps: int = 10) -> dict:
    """The grid route's block against its twin (pdhg_block_plain) from phase
    3's random state: 7 iterations at rtol = atol = 2e-5 and 100 at K2's
    100-iteration tolerances (the certifier's pool: K7's 2e-5), two launches
    bit for bit, the inputs unchanged, the in-place block with the record's
    steps bit for bit equal to the host-step launch; its grid, form, layout
    and time (``reps`` launches) by events and on the device beside its
    bound."""
    cx, cX, pool, index, st, dense = inputs
    n, (M, k), m = cx.shape[0], pool.idx.shape, 0 if dense is None else dense.m
    cuts = (M, k) != (1, 1)
    eta = 0.95 / estimate_norm_plain(pool, n, 30, torch.Generator().manual_seed(0), index,
                                     dense).item()
    zero = st.map(torch.zeros_like)
    args = (cx, cX, pool, index, st, zero, eta, eta)
    before = [t.clone() for t in (*st.fields(), *zero.fields())]
    worst, nf = 0.0, len(st.fields())
    tol100 = ((3e-4, 3e-4), (3e-4, 3e-2)) if cuts else ((DENSE_RTOL,) * 2, (DENSE_RTOL,) * 2)
    for iters, (tol_st, tol_acc) in ((7, ((2e-5, 2e-5), (2e-5, 2e-5))), (100, tol100)):
        got, again = pdhg_grid_block(*args, iters, dense), pdhg_grid_block(*args, iters, dense)
        want = pdhg_block_plain(*args, iters, dense)
        torch.cuda.synchronize()
        errs, ratio = [], 0.0
        for g_, w_, tol in zip((*got[0].fields(), *got[1].fields()),
                               (*want[0].fields(), *want[1].fields()),
                               [tol_st] * nf + [tol_acc] * nf):
            if g_.numel():
                e, r = excess(g_, w_, *tol)
                errs.append(e)
                ratio = max(ratio, r)
        same = states_equal(list(got), list(again))
        log(f"[pdhg_grid {label}] {iters} iterations: max|err| {max(errs):.3e}; {ratio:.3f} of "
            f"the limit (state {tol_st}, sums {tol_acc}); two launches bit for bit: {same}")
        if ratio > 1.0 or not same:
            raise AssertionError(f"the grid block disagrees with its twin or does not repeat "
                                 f"({label}, {iters} iterations)")
        worst = max(worst, *errs)
    unchanged = all(torch.equal(a, b) for a, b in zip((*st.fields(), *zero.fields()), before))
    ip = [st.map(torch.clone), zero.map(torch.clone)]
    rec = pdhg_kernel.steps_record([eta], [eta], cx.device)[0]
    pdhg_grid_block_steps(cx, cX, pool, index, *ip, rec, 100, dense)
    in_place = states_equal(ip, list(got))
    far, smem, P, _ = pdhg_grid._form(n, M, k, m)
    log(f"[pdhg_grid {label}] {P} CTAs x 512 threads, column width {pdhg_kernel.columns(n)}, "
        f"the {'far' if far else 'shared'} form, at most {pdhg_grid.max_entries(n)} entries "
        f"and {-(-M // P) if cuts else 0} pool slots a CTA, {smem} bytes of shared memory a "
        f"CTA; inputs unchanged: {unchanged}; the in-place block with the record's steps bit "
        f"for bit: {in_place}")
    if not (unchanged and in_place):
        raise AssertionError(f"the grid block wrote its inputs or its in-place form differs "
                             f"({label})")
    ms = cuda_ms(lambda: pdhg_grid_block(*args, 100, dense), reps=reps)
    dev_ms = queued_ms(lambda: pdhg_grid_block_steps(cx, cX, pool, index, *ip, rec, 100, dense),
                       reps=reps)
    plain_ms = cuda_ms(lambda: pdhg_block_plain(*args, 100, dense), reps=2, warmup=1)
    terms = index.Xcut.numel() + index.xcut.numel() if cuts else 0
    b = bound(pdhg_ops(n, k, m, int(pool.active.sum()) if cuts else 0, terms, 100),
              nbytes(cx, cX, index.idx, pool.lin, pool.quad, pool.rhs, pool.active, index.xoff,
                     index.xcut, index.xcoef, index.Xoff, index.Xcut, index.Xcoef, *before,
                     *got[0].fields(), *got[1].fields(),
                     *([] if dense is None else [dense.G, dense.g, dense.h])))
    log(f"[pdhg_grid {label}] 100-iteration block: {ms:.4f} ms by events back to back, "
        f"{dev_ms:.4f} ms on the device (queued events) = {dev_ms * 10:.3f} us an iteration; "
        f"twin {plain_ms:.4f} ms; {share(dev_ms, b)} (of the device time) ({SMI})")
    return {"max_abs_err": worst, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, **b,
            "share": b["bound_ms"] / dev_ms, "us_per_iteration": dev_ms * 10, "grid": P,
            "far": far}


def check_grid_check(label: str, inputs, reps: int = 10, split: bool = False) -> dict:
    """The grid route's checked launch (a 100-iteration block, then the
    checked block's control on the slices each CTA owns) from phase 3's
    state against the grid block (pdhg_grid_block_steps) followed by the twin
    check (pdhg_check_plain), as check_pdhg_check holds K5: restart periods
    10^9 and 100, the record's float words at rtol 1e-5 and its ints equal,
    the state, sums and anchor bit for bit, twice bit for bit, a stopped
    record left as it is; the check's time the checked launch's less the
    block's on the device, in turns (``split``, or where that is not
    positive: also from the checked kernel alone, its launches of 1 and 100
    iterations)."""
    cx, cX, pool, index, st0, dense = inputs
    n, (M, k), m = cx.shape[0], pool.idx.shape, 0 if dense is None else dense.m
    normK = estimate_norm_plain(pool, n, 30, torch.Generator().manual_seed(0), index, dense)
    every, top, tol = CHECK_ARGS["check_every"], CHECK_ARGS["max_iters"], CHECK_ARGS["tol"]
    never = (10 ** 9, -1.0)           # a stop test that never stops (the timed launches)

    def prepare():
        return [st0.map(torch.clone), st0.map(torch.zeros_like), st0.map(torch.clone),
                new_record(normK, 1.0, 0.95, top, tol, cx.device)]

    def checked(bufs, rp, stop=(top, tol)):
        pdhg_grid_block_checked(cx, cX, pool, index, *bufs, every, rp, *stop, dense)
        return bufs

    def twin(bufs, rp):
        pdhg_grid_block_steps(cx, cX, pool, index, bufs[0], bufs[1], bufs[3], every, dense)
        pdhg_check_plain(cx, cX, pool, index, *bufs, every, rp, top, tol, dense)
        return bufs

    worst = 0.0
    for rp in (10 ** 9, 100):
        ka, kb, tw = checked(prepare(), rp), checked(prepare(), rp), twin(prepare(), rp)
        torch.cuda.synchronize()
        bad, rel, absd = record_diff(ka[3], tw[3], slice(None))
        same = states_equal(ka[:3], tw[:3])
        repeat = states_equal(ka[:3], kb[:3]) and torch.equal(ka[3], kb[3])
        r = ka[3].cpu().numpy()
        log(f"[pdhg_grid_check {label}] restart_period {rp}: restart {bool(r[REC_RESTART])}, "
            f"use_avg {bool(r[REC_USE_AVG])}, omega {float(record_floats(r)[REC_OMEGA])!r}; "
            f"against the block then the twin check: int words differing {bad}, largest rel "
            f"diff of the float words {rel:.3e} (rtol {CONTROL_RTOL}), max|err| of "
            f"err/p/d/omega {absd:.3e}; state, sums and anchor bit for bit: {same}; two "
            f"launches bit for bit: {repeat}")
        if bad or rel > CONTROL_RTOL or not (same and repeat):
            raise AssertionError(f"the grid route's checked launch disagrees with its block and "
                                 f"the twin check or does not repeat ({label})")
        worst = max(worst, absd)
    args = prepare()
    args[3][REC_STOP] = 1
    before = [t.clone() for t in (*[u for x in args[:3] for u in x.fields()], args[3])]
    checked(args, 100)
    frozen = all(torch.equal(a, b) for a, b in zip(
        before, (*[u for x in args[:3] for u in x.fields()], args[3])))
    if not frozen:
        raise AssertionError(f"the grid route's checked launch wrote a stopped record ({label})")
    bufs = prepare()
    bufs[3] = new_record(normK, 1.0, 0.95, 10 ** 9, 0.0, cx.device)

    def unchecked():
        pdhg_grid_block_steps(cx, cX, pool, index, bufs[0], bufs[1], bufs[3], every, dense)

    t_blk, t_both = [], []
    for runs, fn in ((t_blk, unchecked), (t_both, lambda: checked(bufs, 100, never)),
                     (t_both, lambda: checked(bufs, 100, never)), (t_blk, unchecked)):
        runs.append(queued_ms(fn, reps=reps))
    both, blk = sum(t_both) / 2, sum(t_blk) / 2
    dev_ms = both - blk
    extra = {}
    if dev_ms <= 0.0 or split:
        # the checked kernel runs its block faster (or, split, slower) than
        # the unchecked one: the check from the checked kernel alone, a
        # launch of one iteration less one iteration of it (launches of 1
        # and `every`, in turns)
        t_one, t_all = [], []
        for runs, iters in ((t_one, 1), (t_all, every), (t_all, every), (t_one, 1)):
            runs.append(queued_ms(lambda iters=iters: pdhg_grid_block_checked(
                cx, cX, pool, index, *bufs, iters, 100, *never, dense), reps=reps))
        one, full = sum(t_one) / 2, sum(t_all) / 2
        extra = {"checked_less_unchecked_ms": dev_ms, "one_iteration_launch_ms": one,
                 "checked_iteration_ms": (full - one) / (every - 1), "by_iterations": True}
        log(f"[pdhg_grid_check {label}] the checked launch less the block is {dev_ms:.4f} ms: "
            f"the checked kernel's launches of 1 and {every} iterations in turns {t_one!r}, "
            f"{t_all!r} ms give the check {one - (full - one) / (every - 1):.4f} ms ({SMI})")
        dev_ms = one - (full - one) / (every - 1)
    tw = prepare()
    plain_ms = cuda_ms(lambda: pdhg_check_plain(cx, cX, pool, index, *tw, every, 100, top, tol,
                                                dense), reps=3)
    cuts = (M, k) != (1, 1)
    terms = index.Xcut.numel() + index.xcut.numel() if cuts else 0
    b = bound(check_ops(n, k, m, int(pool.active.sum()) if cuts else 0, terms, True),
              check_bytes(cx, cX, pool, index, dense, *bufs))
    log(f"[pdhg_grid_check {label}] a stopped record left bit for bit: {frozen}; on the device "
        f"(queued events, in turns): the checked launch {t_both!r} ms, the block alone "
        f"{t_blk!r} ms: the check in the launch {dev_ms:.4f} ms; twin check {plain_ms:.4f} ms "
        f"(reads to the host included); {share(max(dev_ms, 1e-9), b)} (of its device time) "
        f"({SMI})")
    return {"max_abs_err": worst, "ms": dev_ms, "device_ms": dev_ms, "plain_ms": plain_ms, **b,
            "share": b["bound_ms"] / max(dev_ms, 1e-9), "checked_launch_ms": both,
            "unchecked_launch_ms": blk, **extra}


def check_grid_norm(label: str, inputs, reps: int = 5) -> dict:
    """The grid route's ||K|| (30 power iterations in one launch) against its
    twin (estimate_norm_plain, the seeded start vector) at rtol 1e-5, twice
    bit for bit, as K6 is held; its time by events and on the device beside
    its bound."""
    cx, cX, pool, index, _, dense = inputs
    n, (M, k), m = cx.shape[0], pool.idx.shape, 0 if dense is None else dense.m
    cuts = (M, k) != (1, 1)

    def norm(fn, gen=True):
        return fn(pool, n, 30, torch.Generator().manual_seed(0) if gen else None, index, dense)

    a, b2, t = norm(pdhg_grid_norm), norm(pdhg_grid_norm), norm(estimate_norm_plain)
    rel = abs(a.item() - t.item()) / abs(t.item())
    log(f"[pdhg_grid_norm {label}] ||K|| kernel {a.item()!r}, twin {t.item()!r}: rel diff "
        f"{rel:.3e} (rtol {CONTROL_RTOL}); two launches bit for bit: {torch.equal(a, b2)}")
    if rel > CONTROL_RTOL or not torch.equal(a, b2):
        raise AssertionError(f"the grid route's norm disagrees with its twin or does not repeat "
                             f"({label})")
    ms = cuda_ms(lambda: norm(pdhg_grid_norm, gen=False), reps=reps)
    dev_ms = queued_ms(lambda: norm(pdhg_grid_norm, gen=False), reps=reps)
    plain_ms = cuda_ms(lambda: norm(estimate_norm_plain), reps=2, warmup=1)
    terms = index.Xcut.numel() + index.xcut.numel() if cuts else 0
    bb = bound(norm_ops(n, k, m, int(pool.active.sum()) if cuts else 0, terms, 30),
               nbytes(index.idx, pool.lin, pool.quad, pool.active, index.xoff, index.xcut,
                      index.xcoef, index.Xoff, index.Xcut, index.Xcoef, a,
                      *([] if dense is None else [dense.G, dense.g])) + 4 * (n + n * n))
    log(f"[pdhg_grid_norm {label}] 30 iterations in one launch: {ms:.4f} ms by events, "
        f"{dev_ms:.4f} ms on the device (queued events) = {dev_ms / 31 * 1e3:.2f} us a power "
        f"iteration; twin {plain_ms:.4f} ms; {share(dev_ms, bb)} (of the device time) ({SMI})")
    return {"max_abs_err": abs(a.item() - t.item()), "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, **bb, "share": bb["bound_ms"] / dev_ms}


def grid_kernels(dev) -> dict:
    """The grid route's block, checked launch and norm at GRID_SHAPES and,
    in their form without cuts, at GRID_CERT, each against its twin; ptxas
    without a spill or a stack.  Returns {kernel: {shape label: numbers}}."""
    out = {"pdhg_grid": {}, "pdhg_grid_check": {}, "pdhg_grid_norm": {}}
    log(f"[pdhg_grid] ptxas: {grid_ptxas()}")
    cases = [(label, lambda label=label: grid_inputs(label, dev)) for label in GRID_SHAPES]
    n, m = GRID_CERT
    cases.append((f"certifier n={n} m={m}",
                  lambda: (lambda cx, cX, pool, index, dense, st: (cx, cX, pool, index, st, dense))(
                      *dense_inputs(n, m, dev))))
    for label, make in cases:
        t0 = time.perf_counter()
        inputs = make()
        out["pdhg_grid"][label] = check_grid_block(label, inputs)
        out["pdhg_grid_check"][label] = check_grid_check(label, inputs)
        out["pdhg_grid_norm"][label] = check_grid_norm(label, inputs)
        log(f"[pdhg_grid {label}] checked in {time.perf_counter() - t0:.1f}s")
    inst = generate_spar(*GRID_INSTANCE)
    args, err, moved = k1_twin_check(inst.name, inst, 5, dev)
    ms = cuda_ms(lambda: pair_score(*args), reps=10)
    dev_ms = device_ms(lambda: pair_score(*args), "pair_score_kernel", reps=10)
    plain_ms = cuda_ms(lambda: pair_score_plain(*args), reps=2, warmup=1)
    T = args[3].shape[0]
    b, parts = scoring_bound(T, moved + mlp_bytes(args[4]), ms)
    log(f"[pair_score {inst.name}] T={T}: kernel {ms:.4f} ms by events ({T / ms / 1e3:.1f} M "
        f"cand/s), {dev_ms:.4f} ms on the device (profiler); twin {plain_ms:.4f} ms; "
        f"{share(ms, b)}; {parts} ({SMI})")
    out["pair_score"] = {"max_abs_err": err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                         "candidates": T, **b}
    return out


def grid_solve(dev) -> tuple:
    """CutSolver on spar512-100-1 (generate_spar(512, 100, 1)) with the
    defaults (k = 3, neural, sel_size 20, capacity 1024, LPConfig()),
    GRID_ROUNDS rounds with "auto" twice, bit for bit: K1 over all
    22,238,720 triples and the grid route's kernels for every LP and norm,
    no K2, no plain block or twin; every certificate reaches a feasible
    point's objective.  Returns (launch counts, checks)."""
    inst = generate_spar(*GRID_INSTANCE)
    cfg = RunConfig()
    t0 = time.perf_counter()
    solver = CutSolver(inst, cfg, device=dev)
    setup_s = time.perf_counter() - t0
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = solver.run(rounds=GRID_ROUNDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    floor = feasible_objective(inst, solver.state.x.cpu().numpy())
    for h in hist:
        log(f"[grid {inst.name}] round {h.round}: bound {h.bound!r} certificate "
            f"{h.certificate!r} cuts_added {h.cuts_added} active {h.cuts_active} lp_iters "
            f"{h.lp_iters} kkt {h.lp_kkt_error:.3e} wall {h.wall_time_s:.3f}s")
    bounds = np.array([h.bound for h in hist])
    certs = np.array([h.certificate for h in hist])
    log(f"[grid {inst.name}] {len(hist)} rounds in {wall:.3f}s = {len(hist) / wall!r} rounds/s "
        f"({sum(h.lp_iters for h in hist)} LP iterations; the solver's set-up, the table of "
        f"{solver.table.shape[0]} triples included, {setup_s:.3f}s); launches {launches}; a "
        f"feasible point's f {floor!r} ({SMI})")
    again = CutSolver(inst, cfg, device=dev).run(rounds=GRID_ROUNDS)
    return launches, {
        f"{GRID_ROUNDS} rounds ran": len(hist) == GRID_ROUNDS,
        "K1 launched, K2 not": launches["pair_score"] > 0 and launches["pdhg_block"] == 0,
        "no plain PDHG block, twin check, norm or scorer on the card":
            launches[PLAIN_BLOCKS] == launches[PLAIN_CONTROL] == launches[TWIN_SCORED] == 0,
        "certificates finite": bool(np.isfinite(certs).all()),
        f"every certificate >= a feasible point's f {floor}": bool((certs >= floor).all()),
        "bounds are the running minimum of the certificates":
            bool((bounds == np.minimum.accumulate(certs)).all()),
        "a second run repeats every round bit for bit": outcome(again) == outcome(hist),
        **dense_route_checks(f"grid {inst.name}", launches, GRID_NAMES),
    }


def grid_band(dev) -> tuple:
    """CutSolverQCQP on generate_qcqp_band(200, 5, 25, 1), whose 25 dense
    rows K2's cluster does not hold at n = 200, GRID_BAND_ROUNDS rounds with
    "auto" in GRID_BAND_CFG: K4 and the grid route's kernels alone, each
    round within GRID_RTOL of the CPU port's (computed in the host
    references' process; huge_references compares at the end of the run).
    Returns (launch counts, checks)."""
    inst = generate_qcqp_band(*GRID_BAND)
    why = plan_refusal(inst.n, GRID_BAND_CFG.cuts.capacity, GRID_BAND_CFG.cuts.k, inst.m)
    solver = CutSolverQCQP(inst, GRID_BAND_CFG, device=dev)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = solver.run(rounds=GRID_BAND_ROUNDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gpu = [h.bound for h in hist]
    HUGE_RESULTS["grid band"] = gpu
    launches = launch_counts()
    log(f"[grid {inst.name}] K2's cluster: {why}; bounds on the card {gpu}; {len(hist)} rounds "
        f"in {wall:.3f}s = {len(hist) / wall!r} rounds/s ({[h.lp_iters for h in hist]} LP "
        f"iterations; {SMI}); launches {launches}")
    return launches, {
        f"{GRID_BAND_ROUNDS} rounds ran": len(gpu) == GRID_BAND_ROUNDS,
        "K2's cluster refuses the shape": why is not None,
        "K4 launched": launches["fused_score"] > 0,
        "no plain PDHG block, twin check, norm or scorer on the card":
            launches[PLAIN_BLOCKS] == launches[PLAIN_CONTROL] == launches[TWIN_SCORED] == 0,
        **dense_route_checks(f"grid {inst.name}", launches, GRID_NAMES),
    }


def grid_certifier(dev) -> tuple:
    """The certifier past n = 256: sdp_relaxation_bound on
    generate_spar(GRID_CERT_N, 100, 1), GRID_CERT_ROUNDS plain eigencut
    rounds of FULL_LP (no Burer-Monteiro anchor: its host ascent takes about
    a minute at n = 300), twice, bit for bit, on the dense route alone, whose
    kernels there are the grid route's form without cuts at 512 columns;
    every certificate finite and at least a feasible point's objective.
    Returns (launch counts, checks)."""
    inst = generate_spar(GRID_CERT_N, 100, 1)
    kw = dict(max_rounds=GRID_CERT_ROUNDS, capacity=512, max_cuts_per_round=48,
              with_point=True, device=dev)
    reset_launches()
    t0 = time.perf_counter()
    best, _, hist, (x, _) = sdp_relaxation_bound(inst, FULL_LP, **kw)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    floor = feasible_objective(inst, x)
    for h in hist:
        log(f"[grid certifier {inst.name}] round {h['round']}: certificate {h['bound']!r} count "
            f"{h['cuts']} lp_iters {h['lp_iters']} kkt {h['lp_kkt']:.3e}; seconds "
            f"{sum(h['seconds'].values()):.4f} (lp {h['seconds']['lp']:.4f})")
    again = sdp_relaxation_bound(inst, FULL_LP, **kw)[2]
    certs = np.array([h["bound"] for h in hist])
    lp_s, iters, us = lp_us(hist)
    log(f"[grid certifier {inst.name}] {len(hist)} rounds in {wall:.3f}s, best {best!r}; the LP "
        f"{lp_s:.4f}s for {iters} iterations = {us:.2f} us a certifier LP iteration ({SMI}); "
        f"launches {launches}")

    def outcome_of(hs):
        return [(h["bound"], h["lam_min"], h["cuts"], h["lp_iters"], h["lp_kkt"]) for h in hs]

    return launches, {
        f"{GRID_CERT_ROUNDS} rounds ran": len(hist) == GRID_CERT_ROUNDS,
        "certificates finite": bool(np.isfinite(certs).all()),
        f"every certificate >= a feasible point's f {floor}": bool((certs >= floor).all()),
        **dense_route_checks(f"grid certifier {inst.name}", launches, GRID_NAMES),
        "a second run repeats every round bit for bit": outcome_of(again) == outcome_of(hist),
    }


def grid_phase(dev) -> dict:
    """Phase 19: the grid route's kernels against their twins (grid_kernels),
    spar512-100-1 (grid_solve), the band instance (grid_band) and the
    certifier at n = 300 (grid_certifier), each path's launches into
    PATH_LAUNCHES.  Returns grid_kernels' numbers."""
    t0 = time.perf_counter()
    out = grid_kernels(dev)
    PATH_LAUNCHES["grid boxqp n=512"], checks = grid_solve(dev)
    finish("grid solve", checks)
    PATH_LAUNCHES["grid qcqp band n=200"], checks = grid_band(dev)
    finish("grid band", checks)
    PATH_LAUNCHES["grid certifier n=300"], checks = grid_certifier(dev)
    finish("grid certifier", checks)
    out["seconds"] = time.perf_counter() - t0
    log(f"[grid] phase 19 took {out['seconds']:.1f}s ({SMI})")
    return out


# ---- phase 20, grid batches: the grid route's instance walk ---------------------
# The grid kernels' batched entries (csrc/pdhg_grid.cu: one cooperative
# launch walks the instances of a batch one after another, each over the
# whole card) at B = GRID_BATCH: at n = 512 with k = 3 cuts, at n = 200 with
# k = 5 cuts and 25 dense rows, and at n = 201 with 25 (G's instance stride,
# 25 x 201^2 floats, not a multiple of 4); then the batched round past K2's
# cluster, BoxQP at n = 512 and the QCQP band at n = 200; then bench_batched
# at n = 300 on the card.
GRID_BATCH = 4
GRID_BATCH_SHAPES = {"n=512 k=3 m=0": (512, 3, 0), "n=200 k=5 m=25": (200, 5, 25),
                     "n=201 k=5 m=25": (201, 5, 25)}
GRID_BATCH_FROZEN = 2                 # the instance left out of ids, or stopped in its record
GRID_BATCH_INSTANCE = (512, 100)      # generate_spar(512, 100, s + 1), s < GRID_BATCH
GRID_BATCH_ROUNDS = 5
GRID_BATCH_BAND = (200, 5, 25)        # generate_qcqp_band(200, 5, 25, s), s = 1..GRID_BATCH
GRID_BATCH_BAND_ROUNDS = 2
GRID_BATCH_BAND_CPU_ROUNDS = 1        # of them held to the CPU port's batched round
GRID_BATCH_CLI = ["--n", "300", "--batch", "4", "--rounds", "3"]


def grid_batch_inputs(label: str, dev, shapes=None, B: int = GRID_BATCH, M: int = 1024,
                      active: int = 400):
    """(cx, cX, pool, index, state, dense, singles) of a GRID_BATCH_SHAPES
    shape (or of ``shapes``) at B instances: instance s has generate_spar(n, 100, s + 1)'s
    objective (m = 0) or generate_qcqp(n, 30, m, s + 1)'s and its m dense
    rows, its own pool of M (1024) with ``active`` (400) active random unit
    cuts on 2,000 random k-subsets of its columns and a random state (phase
    3's random_pool and random_state); ``singles``: each instance's (cx, cX,
    pool, its own cut index, state, dense rows in a tensor of their own)."""
    n, k, m = (GRID_BATCH_SHAPES if shapes is None else shapes)[label]
    rng = np.random.default_rng(SEED + 5)
    f32 = dict(dtype=torch.float32, device=dev)
    singles = []
    for s in range(B):
        if m == 0:
            inst = generate_spar(n, 100, s + 1)
            Q, c, dense = inst.Q, inst.c, None
        else:
            q = generate_qcqp(n, 30, m, s + 1)
            Q, c, dense = q.Q0, q.c0, dense_from_qcqp(q.Qs, q.cs, q.bs, dev)
        table = np.sort(np.stack([rng.choice(n, k, replace=False) for _ in range(2000)]), axis=1)
        pool = random_pool(table, M, active, rng, dev)
        st = random_state(n, M, m, pool, rng, dev)
        singles.append((torch.as_tensor(-c, **f32), torch.as_tensor(-0.5 * Q, **f32), pool,
                        build_cut_index(pool, n), st, dense))
    cxs, cXs, pools, _, sts, denses = zip(*singles)
    P = rb.stack(list(pools))
    return (torch.stack(cxs), torch.stack(cXs), P, rb.build_cut_index(P, n),
            rb.stack(list(sts)), None if m == 0 else rb.stack(list(denses)), singles)


def grid_batch_shape(inputs) -> tuple:
    cx, _, P, _, _, dense, _ = inputs
    return (*cx.shape, *P.idx.shape[1:], 0 if dense is None else dense.G.shape[1])


def grid_batch_eta(inputs):
    """Each instance's 0.95 / ||K|| (the twin's norm), (B,) float32."""
    cx, _, P, index, _, dense, _ = inputs
    normK = estimate_norm_batched_plain(P, cx.shape[1], 30, torch.Generator().manual_seed(0),
                                        index, dense)
    return (np.float32(0.95) / normK.cpu().numpy()).astype(np.float32)


def fields_of(pair) -> list:
    return [*pair[0].fields(), *pair[1].fields()]


def grid_batch_bound(inputs, ops_of, moved: int) -> dict:
    """The batch's bound: every instance's operations (ops_of(active,
    terms) of its own pool and cut index), the bytes ``moved``."""
    singles = inputs[6]
    return bound(sum(ops_of(int(p.active.sum()), int(i.Xcut.numel() + i.xcut.numel()))
                     for _, _, p, i, _, _ in singles), moved)


def in_turns(batched, singles, reps: int) -> tuple:
    """The batched call and the B single calls on the device (queued events),
    in turns: batched, singles, singles, batched; the means."""
    tb, ts = [], []
    for runs, fn in ((tb, batched), (ts, singles), (ts, singles), (tb, batched)):
        runs.append(queued_ms(fn, reps=reps))
    return sum(tb) / 2, sum(ts) / 2, tb, ts


def check_grid_block_batched(label: str, inputs, reps: int = 5) -> dict:
    """The batched block (pdhg_grid_block_batched) with instance
    GRID_BATCH_FROZEN (a smaller batch's last) left out of ids against its
    twin (pdhg_block_batched_plain) at phase 19's tolerances, 7 and 100
    iterations; the instance left out unchanged bit for bit; every listed
    instance bit for bit the single-instance entry's (pdhg_grid_block) on
    its own cut index; two launches bit for bit; the inputs unchanged; the
    in-place form with the records' steps (that instance's record stopped)
    bit for bit; the batched launch and the B single launches timed on the
    device in turns, beside the batch's bound."""
    cx, cX, P, index, st, dense, singles = inputs
    B, n, M, k, m = grid_batch_shape(inputs)
    eta = grid_batch_eta(inputs)
    acc = st.map(torch.zeros_like)
    args = (cx, cX, P, index, st, acc, eta, eta)
    frozen = min(GRID_BATCH_FROZEN, B - 1)
    ids = [b for b in range(B) if b != frozen]
    before = [t.clone() for t in (*st.fields(), *acc.fields())]
    worst = 0.0
    for iters, (tol_st, tol_acc) in ((7, ((2e-5, 2e-5), (2e-5, 2e-5))),
                                     (100, ((3e-4, 3e-4), (3e-4, 3e-2)))):
        got = pdhg_grid_block_batched(*args, iters, ids, dense)
        again = pdhg_grid_block_batched(*args, iters, ids, dense)
        want = pdhg_block_batched_plain(*args, iters, ids, dense)
        torch.cuda.synchronize()
        errs, ratio = [], 0.0
        for g_, w_, tol in zip(fields_of(got), fields_of(want), [tol_st] * 6 + [tol_acc] * 6):
            if g_[ids].numel():
                e, r = excess(g_[ids], w_[ids], *tol)
                errs.append(e)
                ratio = max(ratio, r)
        repeat = states_equal(list(got), list(again))
        left_out = all(torch.equal(g_[frozen], w_[frozen]) for g_, w_ in zip(fields_of(got),
                                                                             before))
        alone = True
        for b in ids:
            sx, sX, sp, si, ss, sd = singles[b]
            one = pdhg_grid_block(sx, sX, sp, si, ss, ss.map(torch.zeros_like), float(eta[b]),
                                  float(eta[b]), iters, sd)
            alone &= all(torch.equal(u, v[b]) for u, v in zip(fields_of(one), fields_of(got)))
        log(f"[pdhg_grid batched {label}] B={B}, {iters} iterations, instance {frozen} left out: "
            f"max|err| {max(errs):.3e}, {ratio:.3f} of the limit (state {tol_st}, sums "
            f"{tol_acc}); two launches bit for bit: {repeat}; the instance left out unchanged "
            f"bit for bit: {left_out}; each listed instance bit for bit the single entry's: "
            f"{alone}")
        if not (ratio <= 1.0 and repeat and left_out and alone):
            raise AssertionError(f"the batched grid block fails its checks ({label}, {iters} "
                                 f"iterations)")
        worst = max(worst, *errs)
    unchanged = all(torch.equal(a, b) for a, b in zip((*st.fields(), *acc.fields()), before))
    ip = [st.map(torch.clone), acc.map(torch.clone)]
    rec = pdhg_kernel.steps_record(eta, eta, cx.device)
    rec[frozen, REC_STOP] = 1
    pdhg_grid_block_steps_batched(cx, cX, P, index, *ip, rec, 100, dense)
    in_place = all(torch.equal(u[b], v[b]) for b in ids
                   for u, v in zip(fields_of(ip), fields_of(got)))
    stopped = all(torch.equal(u[frozen], v[frozen]) for u, v in zip(fields_of(ip), before))
    log(f"[pdhg_grid batched {label}] inputs unchanged: {unchanged}; the in-place block with the "
        f"records' steps bit for bit: {in_place}; a stopped record's instance unchanged: "
        f"{stopped}")
    if not (unchanged and in_place and stopped):
        raise AssertionError(f"the batched grid block wrote its inputs, its in-place form "
                             f"differs or it ran a stopped instance ({label})")
    rec = pdhg_kernel.steps_record(eta, eta, cx.device)
    views = [[rb.instance(s, b) for s in ip] for b in range(B)]

    def batched():
        pdhg_grid_block_steps_batched(cx, cX, P, index, *ip, rec, 100, dense)

    def each():
        for b in range(B):
            sx, sX, sp, si, _, sd = singles[b]
            pdhg_grid_block_steps(sx, sX, sp, si, *views[b], rec[b], 100, sd)

    dev_ms, singles_ms, tb, ts = in_turns(batched, each, reps=reps)
    ms = cuda_ms(lambda: pdhg_grid_block_batched(*args, 100, list(range(B)), dense), reps=reps)
    plain_ms = cuda_ms(lambda: pdhg_block_batched_plain(*args, 100, list(range(B)), dense),
                       reps=1, warmup=1)
    b_ = grid_batch_bound(inputs, lambda a, t: pdhg_ops(n, k, m, a, t, 100), nbytes(
        cx, cX, index.idx, P.lin, P.quad, P.rhs, P.active, index.xoff, index.xcut, index.xcoef,
        index.Xoff, index.Xcut, index.Xcoef, *before, *fields_of(got),
        *([] if dense is None else [dense.G, dense.g, dense.h])))
    log(f"[pdhg_grid batched {label}] 100 iterations of all {B}: one batched launch {dev_ms:.4f} "
        f"ms on the device (queued events; in turns {tb!r}), the {B} single launches "
        f"{singles_ms:.4f} ms ({ts!r}): {dev_ms / singles_ms:.4f} of them; by events back to "
        f"back {ms:.4f} ms; twin {plain_ms:.4f} ms; {share(dev_ms, b_)} (of the device time) "
        f"({SMI})")
    return {"batch": B, "max_abs_err": worst, "ms": ms, "device_ms": dev_ms,
            "singles_device_ms": singles_ms, "plain_ms": plain_ms, **b_,
            "share": b_["bound_ms"] / dev_ms}


def check_grid_check_batched(label: str, inputs, reps: int = 5) -> dict:
    """The batched checked launch (pdhg_grid_block_checked_batched: a
    100-iteration block, then the checked block's control, every instance in
    one launch) against the batched block then the batched twin check
    (pdhg_check_batched_plain), as phase 19 holds the single one: restart
    periods 10^9 and 100, the records' float words at rtol 1e-5 and their
    ints equal, the state, sums and anchor bit for bit, twice bit for bit;
    instance GRID_BATCH_FROZEN's record stopped, left as it is; every other
    instance bit for bit the single checked entry's; the batched checked
    launch and the B single ones timed on the device in turns, the check's
    share the checked launch's less the block's."""
    cx, cX, P, index, st0, dense, singles = inputs
    B, n, M, k, m = grid_batch_shape(inputs)
    normK = estimate_norm_batched_plain(P, n, 30, torch.Generator().manual_seed(0), index, dense)
    every, top, tol = CHECK_ARGS["check_every"], CHECK_ARGS["max_iters"], CHECK_ARGS["tol"]
    never = (10 ** 9, -1.0)
    frozen = min(GRID_BATCH_FROZEN, B - 1)
    ids = [b for b in range(B) if b != frozen]

    def prepare(stop=True):
        rec = new_record(normK, 1.0, 0.95, top, tol, cx.device, batch=B)
        if stop:
            rec[frozen, REC_STOP] = 1
        return [st0.map(torch.clone), st0.map(torch.zeros_like), st0.map(torch.clone), rec]

    def checked(bufs, rp, stop=(top, tol)):
        pdhg_grid_block_checked_batched(cx, cX, P, index, *bufs, every, rp, *stop, dense)
        return bufs

    def twin(bufs, rp):
        pdhg_grid_block_steps_batched(cx, cX, P, index, bufs[0], bufs[1], bufs[3], every, dense)
        pdhg_check_batched_plain(cx, cX, P, index, *bufs, every, rp, top, tol, dense)
        return bufs

    def flat(bufs) -> list:
        return [*(u for x in bufs[:3] for u in x.fields()), bufs[3]]

    worst = 0.0
    for rp in (10 ** 9, 100):
        ka, kb, tw, fresh = checked(prepare(), rp), checked(prepare(), rp), twin(prepare(), rp), \
            prepare()
        torch.cuda.synchronize()
        bad, rel, absd = record_diff(ka[3], tw[3], ids)
        same = states_equal(ka[:3], tw[:3])
        repeat = states_equal(ka[:3], kb[:3]) and torch.equal(ka[3], kb[3])
        left = all(torch.equal(u[frozen], v[frozen]) for u, v in zip(flat(ka), flat(fresh)))
        alone = True
        for b in ids:
            sx, sX, sp, si, _, sd = singles[b]
            one = [rb.instance(x, b).map(torch.clone) for x in fresh[:3]] + [fresh[3][b].clone()]
            pdhg_grid_block_checked(sx, sX, sp, si, *one, every, rp, top, tol, sd)
            alone &= all(torch.equal(u, v[b]) for u, v in zip(flat(one), flat(ka)))
        r = ka[3].cpu().numpy()
        log(f"[pdhg_grid_check batched {label}] restart_period {rp}: restarts "
            f"{r[:, REC_RESTART].tolist()}, use_avg {r[:, REC_USE_AVG].tolist()}; against the "
            f"batched block then the twin check: int words differing {bad}, largest rel diff of "
            f"the float words {rel:.3e} (rtol {CONTROL_RTOL}), max|err| of err/p/d/omega "
            f"{absd:.3e}; state, sums and anchor bit for bit: {same}; two launches bit for bit: "
            f"{repeat}; the stopped instance left as it is: {left}; each other instance bit "
            f"for bit the single checked entry's: {alone}")
        if bad or rel > CONTROL_RTOL or not (same and repeat and left and alone):
            raise AssertionError(f"the batched grid checked launch fails its checks ({label}, "
                                 f"restart_period {rp})")
        worst = max(worst, absd)
    bufs = prepare(stop=False)
    bufs[3] = new_record(normK, 1.0, 0.95, 10 ** 9, 0.0, cx.device, batch=B)
    views = [[rb.instance(x, b) for x in bufs[:3]] + [bufs[3][b]] for b in range(B)]

    def batched():
        checked(bufs, 100, never)

    def each():
        for b in range(B):
            sx, sX, sp, si, _, sd = singles[b]
            pdhg_grid_block_checked(sx, sX, sp, si, *views[b], every, 100, *never, sd)

    def unchecked():
        pdhg_grid_block_steps_batched(cx, cX, P, index, bufs[0], bufs[1], bufs[3], every, dense)

    both, singles_ms, tb, ts = in_turns(batched, each, reps=reps)
    blk, _, tk, _ = in_turns(unchecked, batched, reps=reps)
    dev_ms = both - blk
    extra = {}
    if dev_ms <= 0.0:                  # as check_grid_check: by the checked kernel alone
        one, full, t_one, t_all = in_turns(
            lambda: pdhg_grid_block_checked_batched(cx, cX, P, index, *bufs, 1, 100, *never,
                                                    dense), batched, reps=reps)
        extra = {"checked_less_unchecked_ms": dev_ms, "one_iteration_launch_ms": one,
                 "by_iterations": True}
        log(f"[pdhg_grid_check batched {label}] the checked launch less the block is "
            f"{dev_ms:.4f} ms: the checked kernel's launches of 1 and {every} iterations in "
            f"turns {t_one!r}, {t_all!r} ms give the check "
            f"{one - (full - one) / (every - 1):.4f} ms ({SMI})")
        dev_ms = one - (full - one) / (every - 1)
    tw = prepare()
    plain_ms = cuda_ms(lambda: pdhg_check_batched_plain(cx, cX, P, index, *tw, every, 100, top,
                                                        tol, dense), reps=2)
    b_ = grid_batch_bound(inputs, lambda a, t: check_ops(n, k, m, a, t, True),
                          check_bytes(cx, cX, P, index, dense, *bufs))
    log(f"[pdhg_grid_check batched {label}] on the device (queued events, in turns): the batched "
        f"checked launch {both:.4f} ms ({tb!r}), the {B} single checked launches "
        f"{singles_ms:.4f} ms ({ts!r}); the batched block alone {blk:.4f} ms ({tk!r}): the "
        f"check in the launch {dev_ms:.4f} ms; twin check {plain_ms:.4f} ms; "
        f"{share(max(dev_ms, 1e-9), b_)} (of its device time) ({SMI})")
    return {"batch": B, "max_abs_err": worst, "ms": dev_ms, "device_ms": dev_ms,
            "checked_launch_ms": both, "singles_checked_ms": singles_ms,
            "unchecked_launch_ms": blk, "plain_ms": plain_ms, **b_,
            "share": b_["bound_ms"] / max(dev_ms, 1e-9), **extra}


def check_grid_norm_batched(label: str, inputs, reps: int = 5) -> dict:
    """The batched norm (pdhg_grid_norm_batched, 30 power iterations of
    every instance in one launch) against its twin
    (estimate_norm_batched_plain) at rtol 1e-5, twice bit for bit, every
    instance bit for bit the single entry's; the batched launch and the B
    single ones timed on the device in turns."""
    cx, cX, P, index, _, dense, singles = inputs
    B, n, M, k, m = grid_batch_shape(inputs)

    def gen():
        return torch.Generator().manual_seed(0)

    a = pdhg_grid_norm_batched(P, n, 30, gen(), index, dense)
    a2 = pdhg_grid_norm_batched(P, n, 30, gen(), index, dense)
    t = estimate_norm_batched_plain(P, n, 30, gen(), index, dense)
    rel = float(((a - t).abs() / t.abs()).max())
    ones = torch.stack([pdhg_grid_norm(sp, n, 30, gen(), si, sd)
                        for _, _, sp, si, _, sd in singles])
    repeat, alone = torch.equal(a, a2), torch.equal(a, ones)
    log(f"[pdhg_grid_norm batched {label}] ||K|| {a.tolist()}, twin {t.tolist()}: largest rel "
        f"diff {rel:.3e} (rtol {CONTROL_RTOL}); two launches bit for bit: {repeat}; each "
        f"instance bit for bit the single entry's: {alone}")
    if rel > CONTROL_RTOL or not (repeat and alone):
        raise AssertionError(f"the batched grid norm fails its checks ({label})")

    def batched():
        pdhg_grid_norm_batched(P, n, 30, None, index, dense)

    def each():
        for _, _, sp, si, _, sd in singles:
            pdhg_grid_norm(sp, n, 30, None, si, sd)

    dev_ms, singles_ms, tb, ts = in_turns(batched, each, reps=reps)
    ms = cuda_ms(batched, reps=reps)
    plain_ms = cuda_ms(lambda: estimate_norm_batched_plain(P, n, 30, gen(), index, dense), reps=1,
                       warmup=1)
    b_ = grid_batch_bound(inputs, lambda a_, t_: norm_ops(n, k, m, a_, t_, 30), nbytes(
        index.idx, P.lin, P.quad, P.active, index.xoff, index.xcut, index.xcoef, index.Xoff,
        index.Xcut, index.Xcoef, a, *([] if dense is None else [dense.G, dense.g]))
        + 4 * (n + n * n))
    log(f"[pdhg_grid_norm batched {label}] 30 power iterations of all {B}: one batched launch "
        f"{dev_ms:.4f} ms on the device (queued events; in turns {tb!r}), the {B} single "
        f"launches {singles_ms:.4f} ms ({ts!r}); by events {ms:.4f} ms; twin {plain_ms:.4f} ms; "
        f"{share(dev_ms, b_)} (of the device time) ({SMI})")
    return {"batch": B, "max_abs_err": float((a - t).abs().max()), "ms": ms, "device_ms": dev_ms,
            "singles_device_ms": singles_ms, "plain_ms": plain_ms, **b_,
            "share": b_["bound_ms"] / dev_ms}


def grid_batch_kernels(dev) -> dict:
    """Phase 20 (a): the batched block, checked launch and norm at
    GRID_BATCH_SHAPES against their twins and the single entries; ptxas
    without a spill or a stack.  Returns {kernel: {shape label: numbers}}."""
    out = {"pdhg_grid": {}, "pdhg_grid_check": {}, "pdhg_grid_norm": {}}
    log(f"[grid batch] ptxas: {grid_ptxas()}")
    for label in GRID_BATCH_SHAPES:
        t0 = time.perf_counter()
        inputs = grid_batch_inputs(label, dev)
        n, m = inputs[0].shape[1], grid_batch_shape(inputs)[4]
        if m:
            G, _, _, sG, _ = pdhg_grid.dense_layout(inputs[5])
            copied = G.data_ptr() != inputs[5].G.data_ptr()
            log(f"[grid batch {label}] G's instance stride {m * n * n} floats, the walk's {sG}: "
                f"{'a padded copy' if copied else 'the batch itself'}")
        out["pdhg_grid"][label] = check_grid_block_batched(label, inputs)
        out["pdhg_grid_check"][label] = check_grid_check_batched(label, inputs)
        out["pdhg_grid_norm"][label] = check_grid_norm_batched(label, inputs)
        log(f"[grid batch {label}] checked in {time.perf_counter() - t0:.1f}s")
    return out


def grid_launch_checks(tag: str, launches: dict, blocks: int, solves: int, scorer: str,
                       scored: int) -> dict:
    """A batched round on the grid route: one batched checked launch a
    checked block of the batch (at most GROUP_BLOCKS - 1 more a solve, which
    do nothing), every block a checked launch, one batched norm a solve,
    ``scorer`` once an instance a round, and no plain block, twin check or
    twin-scored call, no K2, K5 or K6."""
    G = pdhg_mod.GROUP_BLOCKS
    chk = launches["pdhg_grid_check"]
    log(f"[{tag}] the grid route: {launches[SOLVES]} solves, {blocks} checked blocks, batched "
        f"checked launches {chk}, block launches {launches['pdhg_grid']}, norms "
        f"{launches['pdhg_grid_norm']}; {scorer} {launches[scorer]}; launches {launches}")
    return {
        "one batched checked launch a checked block": blocks <= chk <= blocks + (G - 1) * solves,
        "every block a checked launch": launches["pdhg_grid"] == chk,
        "one batched norm a solve": launches["pdhg_grid_norm"] == launches[SOLVES] == solves,
        f"{scorer} once an instance a round ({scored})": launches[scorer] == scored,
        "no plain block, twin check or twin-scored call":
            launches[PLAIN_BLOCKS] == launches[PLAIN_CONTROL] == launches[TWIN_SCORED] == 0,
        "no K2, K5 or K6": launches["pdhg_block"] == launches["pdhg_check"]
        == launches["pdhg_norm"] == 0,
    }


def grid_batch_boxqp(dev) -> tuple:
    """Phase 20 (b): GRID_BATCH x generate_spar(512, 100, s + 1) with
    BATCH_KNOBS (capacity 1024, k = 3 over all 22,238,720 triples, Mesh(1,
    1)), GRID_BATCH_ROUNDS per-round steps, twice bit for bit, then the
    scan of as many rounds, equal to the per-round steps; every certificate
    at least its instance's feasible objective, the running bounds
    monotone; the launches of grid_launch_checks.  Returns (launch counts,
    checks)."""
    n, d = GRID_BATCH_INSTANCE
    insts = [generate_spar(n, d, s + 1) for s in range(GRID_BATCH)]
    B, R_ = len(insts), GRID_BATCH_ROUNDS
    mesh = make_mesh(1, 1)
    table, valid = shard_candidates(combinations_table(n, 3), mesh, device=dev)
    step = make_sharded_round_step(mesh, **BATCH_KNOBS)
    reset_launches()
    state, best, iters, wall = batched_run(step, insts, table, valid, dev, R_)
    launches = launch_counts()
    blocks = int(sum(it.max() // 100 for it in iters))
    again, best2, iters2, _ = batched_run(step, insts, table, valid, dev, R_)
    repeat = (batched_states_equal(state, again) and np.array_equal(best, best2)
              and np.array_equal(iters, iters2))
    start = init_batched_state(np.stack([i.Q for i in insts]), np.stack([i.c for i in insts]),
                               1024, 3, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, outs = make_sharded_scan_step(mesh, rounds=R_, **BATCH_KNOBS)(start, table, valid)
    torch.cuda.synchronize()
    scan_wall = time.perf_counter() - t0
    certs = certify_scan_f64(final.Q, final.c, outs)
    floors = [feasible_objective(inst, state.pdhg.x[b].cpu().numpy())
              for b, inst in enumerate(insts)]
    for b, inst in enumerate(insts):
        log(f"[grid batch {inst.name}] certificates by round {certs[:, b].tolist()}; f32 running "
            f"bound {best[:, b].tolist()}; lp_iters {iters[:, b].tolist()}; cuts "
            f"{int(state.pool.count[b])}; a feasible point's f {floors[b]!r}")
    log(f"[grid batch boxqp] {B} x generate_spar({n}, {d}, s + 1), {R_} per-round steps in "
        f"{wall:.3f} s = {B * R_ / wall!r} instance-rounds/s; the scan {scan_wall:.3f} s = "
        f"{B * R_ / scan_wall!r} instance-rounds/s ({SMI})")
    return launches, {
        f"{R_} rounds ran": len(best) == R_,
        "a second run repeats every round bit for bit": repeat,
        "the scan equals the per-round steps": batched_states_equal(final, state),
        "certificates finite": bool(np.isfinite(certs).all()),
        "every certificate >= its instance's feasible objective":
            bool(all((certs[:, b] >= floors[b]).all() for b in range(B))),
        "running bounds monotone": bool((np.diff(best, axis=0) <= 0).all()),
        **grid_launch_checks("grid batch boxqp", launches, blocks, R_, "pair_score", B * R_),
    }


def grid_batch_band(dev) -> tuple:
    """Phase 20 (c): GRID_BATCH x generate_qcqp_band(200, 5, 25, s), whose
    25 dense rows K2's cluster does not hold at n = 200 (its plan takes 10),
    one clique table at k = 5 (the band graph's 5,876 candidates),
    sel_size 16, GRID_BAND_CFG's LP, GRID_BATCH_BAND_ROUNDS per-round steps
    on the card, twice bit for bit (band_batch_run); the first
    GRID_BATCH_BAND_CPU_ROUNDS certificates are held within GRID_RTOL of the
    CPU port's batched round at the end of the run (host_reference_checks,
    the CPU round in the host references); K4 once an instance a round and
    the launches of grid_launch_checks.  Returns (launch counts, checks)."""
    n, bw, m = GRID_BATCH_BAND
    B, R_ = GRID_BATCH, GRID_BATCH_BAND_ROUNDS
    cliques, _ = chordal_decomposition(n, generate_qcqp_band(n, bw, m, 1).sparsity_graph())
    table_np = clique_candidates(cliques, 5)
    why = plan_refusal(n, 1024, 5, m)
    reset_launches()
    t0 = time.perf_counter()
    state, certs, best, blocks = band_batch_run(dev, R_)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    again = band_batch_run(dev, R_)
    repeat = batched_states_equal(state, again[0]) and np.array_equal(certs, again[1])
    HUGE_RESULTS["band batch"] = certs[:GRID_BATCH_BAND_CPU_ROUNDS].tolist()
    log(f"[grid batch band] {B} x generate_qcqp_band({n}, {bw}, {m}, s), {table_np.shape[0]} "
        f"clique candidates at k = 5; K2's cluster: {why}; certificates by round "
        f"{certs.tolist()} (the CPU port's first {GRID_BATCH_BAND_CPU_ROUNDS} in the host "
        f"references, compared at the end of the run); {R_} rounds with the certificates in "
        f"{wall:.3f} s = {B * R_ / wall!r} instance-rounds/s ({SMI})")
    return launches, {
        f"{R_} rounds ran": len(certs) == R_,
        "K2's cluster refuses the shape": why is not None,
        "a second run repeats every round bit for bit": repeat,
        "certificates finite": bool(np.isfinite(certs).all()),
        "running bounds monotone": bool((np.diff(best, axis=0) <= 0).all()),
        **grid_launch_checks("grid batch band", launches, blocks, R_, "fused_score", B * R_),
    }


def band_batch_run(device, rounds: int):
    """grid_batch_band's rounds on ``device``: (the batched state, each
    round's certificates (rounds, B), the running bounds, the blocks of the
    longest solve).  The host references run its CPU round."""
    n, bw, m = GRID_BATCH_BAND
    fam = [generate_qcqp_band(n, bw, m, s) for s in range(1, GRID_BATCH + 1)]
    cliques, _ = chordal_decomposition(n, fam[0].sparsity_graph())
    mesh = make_mesh(1, 1)
    step = make_sharded_round_step(mesh, GRID_BAND_CFG, kmax=5, m_dense=m)
    dense = batched_dense_from_qcqp(fam, device)
    table, valid = shard_candidates(clique_candidates(cliques, 5), mesh, device=device)
    state = init_batched_state(np.stack([i.Q0 for i in fam]), np.stack([i.c0 for i in fam]),
                               1024, 5, m_dense=m, device=device)
    certs, best, blocks = [], [], 0
    for _ in range(rounds):
        state, info = step(state, table, valid, dense)
        certs.append(certify_batched_f64(state, dense))
        best.append(state.best_bound.cpu().numpy())
        blocks += int(info["lp_iters"].max()) // 100
    return state, np.stack(certs), np.stack(best), blocks


def grid_batch_cli() -> dict:
    """Phase 20 (d): ``python3 -m sdpcutsel_tpu_torch.bench_batched --n 300
    --batch 4 --rounds 3`` in a subprocess of its own on the card (past K2's
    cluster: the grid route's batch): exit 0 and its record printed."""
    argv = [sys.executable, "-m", "sdpcutsel_tpu_torch.bench_batched", *GRID_BATCH_CLI]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=REPO, capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - t0
    records = []
    for line in proc.stdout.splitlines():
        with contextlib.suppress(ValueError):
            records.append(json.loads(line))
    log(f"[grid batch cli] {' '.join(argv[1:])}: exit {proc.returncode} in {seconds:.1f} s; "
        f"records {records}")
    if proc.returncode:
        log(f"[grid batch cli] stderr: {proc.stderr[-2000:]}")
    return {"bench_batched --n 300 ran to its end": proc.returncode == 0,
            "its record printed": any(isinstance(r, dict) and r for r in records)}


def grid_against_parent(pkg, dev) -> bool:
    """With --parent DIR: this tree's single-instance grid entries (the
    batch of one of the walk) and the parent build's at phase 19's shapes,
    bit for bit: the block at 7 and 100 iterations, the checked launch at
    restart periods 10^9 and 100, the norm; the block then timed in turns
    (parent, this, this, parent) on the device."""
    p_grid = importlib.import_module(f"{pkg.__name__}.lp.pdhg_grid")
    same = True
    every, top, tol = CHECK_ARGS["check_every"], CHECK_ARGS["max_iters"], CHECK_ARGS["tol"]
    for label in GRID_SHAPES:
        cx, cX, pool, index, st, dense = grid_inputs(label, dev)
        n = cx.shape[0]
        normK = estimate_norm_plain(pool, n, 30, torch.Generator().manual_seed(0), index, dense)
        eta = 0.95 / normK.item()
        ok = []
        for iters in (7, 100):
            args = (cx, cX, pool, index, st, st.map(torch.zeros_like), eta, eta, iters, dense)
            ok.append(states_equal(list(pdhg_grid_block(*args)),
                                   list(p_grid.pdhg_grid_block(*args))))

        def prepare():
            return [st.map(torch.clone), st.map(torch.zeros_like), st.map(torch.clone),
                    new_record(normK, 1.0, 0.95, top, tol, dev)]

        for rp in (10 ** 9, 100):
            mine, theirs = prepare(), prepare()
            pdhg_grid_block_checked(cx, cX, pool, index, *mine, every, rp, top, tol, dense)
            p_grid.pdhg_grid_block_checked(cx, cX, pool, index, *theirs, every, rp, top, tol,
                                           dense)
            ok.append(states_equal(mine[:3], theirs[:3]) and torch.equal(mine[3], theirs[3]))
        gen = torch.Generator
        ok.append(torch.equal(pdhg_grid_norm(pool, n, 30, gen().manual_seed(0), index, dense),
                              p_grid.pdhg_grid_norm(pool, n, 30, gen().manual_seed(0), index,
                                                    dense)))
        rec = pdhg_kernel.steps_record([eta], [eta], dev)[0]
        bufs = [st.map(torch.clone), st.map(torch.zeros_like)]
        t = {"parent": [], "this": []}
        for tree, fn in (("parent", p_grid.pdhg_grid_block_steps), ("this", pdhg_grid_block_steps),
                         ("this", pdhg_grid_block_steps),
                         ("parent", p_grid.pdhg_grid_block_steps)):
            t[tree].append(queued_ms(lambda: fn(cx, cX, pool, index, *bufs, rec, 100, dense),
                                     reps=5))
        log(f"[pdhg_grid {label}] this build's single entries and the parent build's bit for bit "
            f"(block 7, 100; checked 10^9, 100; norm): {ok}; a 100-iteration block in turns on "
            f"the device: parent {t['parent']!r} ms, this build {t['this']!r} ms ({SMI})")
        same &= all(ok)
    return same


def grid_batch_phase(dev, pkg=None) -> dict:
    """Phase 20: the grid route's instance walk (grid_batch_kernels), the
    BoxQP batch at n = 512 (grid_batch_boxqp), the QCQP band batch
    (grid_batch_band), bench_batched --n 300 (grid_batch_cli), each path's
    launches into PATH_LAUNCHES; with --parent the single-instance grid
    entries against the parent build's.  Returns grid_batch_kernels'
    numbers."""
    t0 = time.perf_counter()
    out = grid_batch_kernels(dev)
    PATH_LAUNCHES["grid batch boxqp n=512"], checks = grid_batch_boxqp(dev)
    finish("grid batch boxqp", checks)
    PATH_LAUNCHES["grid batch qcqp band n=200"], checks = grid_batch_band(dev)
    finish("grid batch band", checks)
    finish("grid batch cli", grid_batch_cli())
    if pkg is not None:
        finish("grid parent", {"the single grid entries give the parent build's bits":
                               grid_against_parent(pkg, dev)})
    for key in ("pdhg_grid", "pdhg_grid_check", "pdhg_grid_norm"):
        batched = sum(PATH_LAUNCHES[p][key] for p in ("grid batch boxqp n=512",
                                                      "grid batch qcqp band n=200"))
        for numbers in out[key].values():
            numbers["launches"] = batched      # the batched paths' launches of the kernel
    out["seconds"] = time.perf_counter() - t0
    log(f"[grid batch] phase 20 took {out['seconds']:.1f}s ({SMI})")
    return out


# ---- phase 21, the grid route's 1024-column form: 512 < n <= 1024 ------------
# csrc/pdhg_grid.cu's fourth form (GridForm<kHuge>), whose owned state lives
# in global memory: the block, checked launch and norm at (n, k, m), M = 1024
# with 400 active unit cuts on 2,000 random k-subsets of the columns (the
# lexicographic table at n = 1024 holds 178M rows): BoxQP at n = 600 and
# 1024 with k = 3, a QCQP at n = 700 with k = 5 and generate_qcqp(700, 30,
# 25, 1)'s 25 dense rows; the form without cuts (the dense route's past
# n = 512) at n = 600 over 368 certifier rows; the walk at B = 2, n = 1024
HUGE_SHAPES = {"n=600 m=0": (600, 3, 0), "n=1024 m=0": (1024, 3, 0),
               "n=700 k=5 m=25": (700, 5, 25)}
HUGE_CERT = (600, 368)
HUGE_BATCH = 2
HUGE_BATCH_SHAPES = {"n=1024 k=3 m=0": (1024, 3, 0)}
HUGE_INSTANCE = (1024, 100, 1)        # CutSolver with the defaults
HUGE_ROUNDS = 3
HUGE_BAND = (600, 5, 25, 1)           # generate_qcqp_band, at the grid QCQP's settings
HUGE_BAND_ROUNDS = 2
HUGE_BAND_CPU_ROUNDS = 1              # of them held to the CPU port (3 min, then 8, there)
HUGE_CERT_N, HUGE_CERT_ROUNDS = 600, 3  # the certifier past n = 512
REFERENCE_TIMEOUT = 1100              # seconds from the run's start for the host references
K1_CHUNK = 8 << 20                    # rows of the table a twin call (its activations)


def huge_inputs(label: str, dev, shapes=None):
    """(cx, cX, pool, index, state, dense) of a HUGE_SHAPES shape (or of
    ``shapes``): generate_spar(n, 100, 1), or generate_qcqp(n, 30, m, 1)'s
    objective and m dense rows; the pool's supports from 2,000 random
    k-subsets of the columns; phase 3's pool and random state."""
    n, k, m = (HUGE_SHAPES if shapes is None else shapes)[label]
    rng = np.random.default_rng(SEED + 6)
    table = np.sort(np.stack([rng.choice(n, k, replace=False) for _ in range(2000)]), axis=1)
    if m == 0:
        inst = generate_spar(n, 100, 1)
        Q, c, dense = inst.Q, inst.c, None
    else:
        q = generate_qcqp(n, 30, m, 1)
        Q, c, dense = q.Q0, q.c0, dense_from_qcqp(q.Qs, q.cs, q.bs, dev)
    return (*pdhg_inputs(Q, c, table, dense, dev), dense)


def k1_chunked_check(inst, dev) -> dict:
    """K1 over all C(n, 3) triples of ``inst`` in one launch at the scoring
    point, held to its twin chunk by chunk (K1_CHUNK rows each: the twin's
    activations over the whole table would not fit the card) at
    k1_twin_check's tolerances; its time by events and on the device
    (queued events), the chunked twin's, beside the bound."""
    x, X, Q = scoring_point(inst, dev)
    t0 = time.perf_counter()
    host = combinations_table(inst.n, 3)
    table_s = time.perf_counter() - t0
    table = torch.as_tensor(host, device=dev)
    T = table.shape[0]
    mlp = MLPScorer(load_params(3), dev)
    nn_k, feas_k = pair_score(x, X, Q, table, mlp, 5)
    again = pair_score(x, X, Q, table, mlp, 5)
    errs = []

    def twin_pass():                   # every chunk against the kernel's rows
        for s in range(0, T, K1_CHUNK):
            nn_p, feas_p = pair_score_plain(x, X, Q, table[s:s + K1_CHUNK], mlp, 5)
            errs.append((*excess(feas_k[s:s + K1_CHUNK], feas_p, 0.0, 5e-5),
                         *excess(nn_k[s:s + K1_CHUNK], nn_p, 2e-4, 2e-4)))

    plain_ms = cuda_ms(twin_pass, reps=1, warmup=0)
    worst = max(max(e[0], e[2]) for e in errs)
    ratio = max(max(e[1], e[3]) for e in errs)
    repeat = torch.equal(nn_k, again[0]) and torch.equal(feas_k, again[1])
    log(f"[pair_score {inst.name}] T={T} (the table {table_s:.2f}s on the host, "
        f"{nbytes(table)} bytes on the card): max|err| {worst:.3e}, {ratio:.3f} of the limit "
        f"(feas atol 5e-5, nn rtol/atol 2e-4) over {-(-T // K1_CHUNK)} twin chunks; two "
        f"launches bit for bit: {repeat}")
    if ratio > 1.0 or not repeat:
        raise AssertionError(f"pair_score disagrees with its twin or does not repeat "
                             f"({inst.name})")
    moved = nbytes(x, X, Q, table, nn_k, feas_k)
    del again, nn_k, feas_k
    ms = cuda_ms(lambda: pair_score(x, X, Q, table, mlp, 5), reps=5, warmup=1)
    # on the device by queued events: the profiler recorded no launch of this
    # 58 ms kernel in three sessions of one call
    dev_ms = queued_ms(lambda: pair_score(x, X, Q, table, mlp, 5), reps=3)
    b, parts = scoring_bound(T, moved + mlp_bytes(mlp), ms)
    log(f"[pair_score {inst.name}] T={T}: kernel {ms:.4f} ms by events ({T / ms / 1e3:.1f} M "
        f"cand/s), {dev_ms:.4f} ms on the device (queued events); the twin in {K1_CHUNK}-row "
        f"chunks {plain_ms:.4f} ms; {share(ms, b)}; {parts} ({SMI})")
    return {"max_abs_err": worst, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "candidates": T, **b}


def huge_kernels(dev) -> dict:
    """Phase 21 (a): the 1024-column form's block, checked launch and norm at
    HUGE_SHAPES and, without cuts, at HUGE_CERT, each against its twin at
    phase 19's tolerances, twice bit for bit; the walk at B = HUGE_BATCH,
    n = 1024, each instance bit for bit its single entry's; ptxas without a
    spill or a stack; K1 over all C(1024, 3) triples.  Returns {kernel:
    {shape label: numbers}}."""
    out = {"pdhg_grid": {}, "pdhg_grid_check": {}, "pdhg_grid_norm": {}}
    log(f"[huge] ptxas: {grid_ptxas()}")
    cases = [(label, lambda label=label: huge_inputs(label, dev)) for label in HUGE_SHAPES]
    n, m = HUGE_CERT
    cases.append((f"certifier n={n} m={m}",
                  lambda: (lambda cx, cX, pool, index, dense, st: (cx, cX, pool, index, st, dense))(
                      *dense_inputs(n, m, dev))))
    for label, make in cases:
        t0 = time.perf_counter()
        inputs = make()
        n_ = inputs[0].shape[0]
        if pdhg_kernel.columns(n_) != pdhg_kernel.HUGE:
            raise AssertionError(f"{label} is not a 1024-column shape")
        out["pdhg_grid"][label] = check_grid_block(label, inputs)
        out["pdhg_grid_check"][label] = check_grid_check(label, inputs)
        out["pdhg_grid_norm"][label] = check_grid_norm(label, inputs)
        del inputs
        log(f"[huge {label}] checked in {time.perf_counter() - t0:.1f}s")
    for label in HUGE_BATCH_SHAPES:
        t0 = time.perf_counter()
        inputs = grid_batch_inputs(label, dev, HUGE_BATCH_SHAPES, HUGE_BATCH)
        out["pdhg_grid"][f"batched {label}"] = check_grid_block_batched(label, inputs)
        out["pdhg_grid_check"][f"batched {label}"] = check_grid_check_batched(label, inputs)
        out["pdhg_grid_norm"][f"batched {label}"] = check_grid_norm_batched(label, inputs)
        del inputs
        log(f"[huge batch {label}] checked in {time.perf_counter() - t0:.1f}s")
    out["pair_score"] = k1_chunked_check(generate_spar(*HUGE_INSTANCE), dev)
    return out


def huge_solve(dev) -> tuple:
    """CutSolver on generate_spar(1024, 100, 1) with the defaults (k = 3,
    neural, sel_size 20, capacity 1024, LPConfig()), HUGE_ROUNDS rounds with
    "auto" twice, bit for bit: K1 over all 178,433,024 triples and the grid
    route's 1024-column form for every LP and norm, no K2, no plain block,
    twin check or twin-scored call; every certificate reaches a feasible
    point's objective.  Then the synchronised stage split of a third run
    (profile_round.stage_split; the grid route's norm runs in solve_setup,
    its checked launches in solve_lp).  Returns (launch counts, checks)."""
    from sdpcutsel_tpu_torch.profile_round import STAGES, stage_split

    inst = generate_spar(*HUGE_INSTANCE)
    cfg = RunConfig()
    t0 = time.perf_counter()
    solver = CutSolver(inst, cfg, device=dev)
    setup_s = time.perf_counter() - t0
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = solver.run(rounds=HUGE_ROUNDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    floor = feasible_objective(inst, solver.state.x.cpu().numpy())
    for h in hist:
        log(f"[huge {inst.name}] round {h.round}: bound {h.bound!r} certificate "
            f"{h.certificate!r} cuts_added {h.cuts_added} active {h.cuts_active} lp_iters "
            f"{h.lp_iters} kkt {h.lp_kkt_error:.3e} wall {h.wall_time_s:.3f}s")
    bounds = np.array([h.bound for h in hist])
    certs = np.array([h.certificate for h in hist])
    log(f"[huge {inst.name}] {len(hist)} rounds in {wall:.3f}s = {len(hist) / wall!r} rounds/s "
        f"({sum(h.lp_iters for h in hist)} LP iterations; the solver's set-up, the table of "
        f"{solver.table.shape[0]} triples included, {setup_s:.3f}s); launches {launches}; a "
        f"feasible point's f {floor!r} ({SMI})")
    del solver
    again = CutSolver(inst, cfg, device=dev).run(rounds=HUGE_ROUNDS)
    stages = [*STAGES, (pdhg_grid, "_checked_launcher", "  grid checked step's set-up")]
    split_wall, split = stage_split((inst, CutSolver, cfg, HUGE_ROUNDS), dev, HUGE_ROUNDS,
                                    stages)
    for label, (sec, calls) in split.items():
        if calls:
            log(f"[huge {inst.name}] split: {label} {sec:.4f}s ({sec / split_wall:.2%} of the "
                f"synchronised run's {split_wall:.4f}s), {calls} calls")
    return launches, {
        f"{HUGE_ROUNDS} rounds ran": len(hist) == HUGE_ROUNDS,
        "K1 launched, K2 not": launches["pair_score"] > 0 and launches["pdhg_block"] == 0,
        "no plain PDHG block, twin check, norm or scorer on the card":
            launches[PLAIN_BLOCKS] == launches[PLAIN_CONTROL] == launches[TWIN_SCORED] == 0,
        "certificates finite": bool(np.isfinite(certs).all()),
        f"every certificate >= a feasible point's f {floor}": bool((certs >= floor).all()),
        "bounds are the running minimum of the certificates":
            bool((bounds == np.minimum.accumulate(certs)).all()),
        "a second run repeats every round bit for bit": outcome(again) == outcome(hist),
        **dense_route_checks(f"huge {inst.name}", launches, GRID_NAMES),
    }


HOST_THREADS = 2                      # the host references' threads, beside the card's work
HOST_PROCESSES = 2                    # the processes the host references' groups share


def host_references(path: str, groups) -> None:
    """What phases 4 and 19-24 compare with that only the host computes,
    written to ``path`` as JSON, for the phase groups ``groups``: with "4"
    the CPU port's rounds of phase 4's runs (small_cases, large_cases); with
    "18-21" phase 19's band's CPU rounds, the
    Burer-Monteiro lb of phase 21's certifier instance
    (generate_spar(HUGE_CERT_N, 100, 1)), the CPU port's
    HUGE_BAND_CPU_ROUNDS rounds of its band instance at GRID_BAND_CFG and
    phase 20's band batch's first GRID_BATCH_BAND_CPU_ROUNDS (band_batch_run
    on the CPU); with "22" the CPU port's round 0 of phase 22's solve
    (bigpool_solve's configuration); with "23" the Burer-Monteiro lb of
    phase 23's certifier instance (generate_spar(1100, 100, 1), VAST_BM's
    stages); with "24" that of phase 24's (generate_spar(2100, 100, 1),
    OPEN_BM's stages); each with its seconds.  Minutes of host
    work, so ``--host-references PATH`` runs it in a process of its own from
    the end of the build (References), and host_reference_checks compares
    at the end of the run."""
    torch.set_num_threads(HOST_THREADS)
    out = {}
    if "4" in groups:
        t0 = time.perf_counter()
        out["small"] = {label: [h.bound for h in cls(inst, cfg, device="cpu").run(rounds=rounds)]
                        for label, cls, inst, cfg, rounds in (*small_cases(), *large_cases())}
        out["small_seconds"] = time.perf_counter() - t0
    if "24" in groups:
        t0 = time.perf_counter()
        inst = generate_spar(*OPEN_PIECES)
        out["open_bm_lb"] = float(bm_feasible_point(inst.Q, inst.c, **OPEN_BM)[2])
        out["open_bm_seconds"] = time.perf_counter() - t0
    if "23" in groups:
        t0 = time.perf_counter()
        inst = generate_spar(*VAST_SMALL)
        out["vast_bm_lb"] = float(bm_feasible_point(inst.Q, inst.c, **VAST_BM)[2])
        out["vast_bm_seconds"] = time.perf_counter() - t0
    if "22" in groups:
        t0 = time.perf_counter()
        hist = CutSolver(generate_spar(*BIG_INSTANCE), big_config(), device="cpu").run(rounds=1)
        out["big_round0"] = hist[0].bound
        out["big_seconds"] = time.perf_counter() - t0
    if "18-21" in groups:
        t0 = time.perf_counter()
        inst = generate_spar(HUGE_CERT_N, 100, 1)
        out["bm_lb"] = float(bm_feasible_point(inst.Q, inst.c)[2])
        out["bm_seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        hist = CutSolverQCQP(generate_qcqp_band(*HUGE_BAND), GRID_BAND_CFG, device="cpu").run(
            rounds=HUGE_BAND_CPU_ROUNDS)
        out["band_bounds"] = [h.bound for h in hist]
        out["band_seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["band_batch"] = band_batch_run(torch.device("cpu"),
                                           GRID_BATCH_BAND_CPU_ROUNDS)[1].tolist()
        out["band_batch_seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["grid_band"] = [h.bound for h in CutSolverQCQP(
            generate_qcqp_band(*GRID_BAND), GRID_BAND_CFG, device="cpu").run(
            rounds=GRID_BAND_ROUNDS)]
        out["grid_band_seconds"] = time.perf_counter() - t0
    with open(path, "w") as f:
        json.dump(out, f)


class References:
    """host_references for the phase groups ``groups`` in subprocesses
    started at once, the groups split over HOST_PROCESSES of them (each
    with HOST_THREADS threads): ``get()`` waits for them (until
    REFERENCE_TIMEOUT seconds from the start) and returns their records
    merged; ``stop()`` ends any that still runs.  Their output goes to
    files, so that none waits on a full pipe."""

    def __init__(self, tmp: str, groups):
        threads = str(HOST_THREADS)
        env = {**os.environ, "OMP_NUM_THREADS": threads, "OPENBLAS_NUM_THREADS": threads,
               "MKL_NUM_THREADS": threads}
        self.t0 = time.perf_counter()
        shares = [[g for j, g in enumerate(groups) if j % HOST_PROCESSES == i]
                  for i in range(HOST_PROCESSES)]
        self.paths, self.logs, self.procs = [], [], []
        for i, share in enumerate(s for s in shares if s):
            self.paths.append(os.path.join(tmp, f"host_references_{i}.json"))
            self.logs.append(open(os.path.join(tmp, f"host_references_{i}.log"), "w+"))
            self.procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--host-references", self.paths[-1],
                 "--phases", ",".join(share)],
                cwd=REPO, env=env, stdout=self.logs[-1], stderr=subprocess.STDOUT, text=True))
        self.record = None

    def get(self) -> dict:
        if self.record is None:
            record = {}
            for path, log_file, proc in zip(self.paths, self.logs, self.procs):
                left = REFERENCE_TIMEOUT - (time.perf_counter() - self.t0)
                proc.wait(timeout=max(left, 1.0))
                if proc.returncode:
                    log_file.seek(0)
                    raise AssertionError(f"the host references failed: "
                                         f"{log_file.read()[-2000:]}")
                with open(path) as f:
                    record.update(json.load(f))
            self.record = record
            log(f"[huge] the host references ({time.perf_counter() - self.t0:.1f}s after their "
                f"start): {self.record}")
        return self.record

    def stop(self):
        for proc, log_file in zip(self.procs, self.logs):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log_file.close()


# what phase 21's paths leave for huge_references: the band's certificates
# on the card, the certifier's
HUGE_RESULTS = {}


def huge_band(dev) -> tuple:
    """CutSolverQCQP on generate_qcqp_band(600, 5, 25, 1) (25 dense rows,
    36 MB of G, streamed through the ring), HUGE_BAND_ROUNDS rounds with
    "auto" in GRID_BAND_CFG twice, bit for bit: K4 and the 1024-column form
    alone (huge_references holds the first HUGE_BAND_CPU_ROUNDS to the CPU
    port's).  Returns (launch counts, checks)."""
    inst = generate_qcqp_band(*HUGE_BAND)
    solver = CutSolverQCQP(inst, GRID_BAND_CFG, device=dev)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = solver.run(rounds=HUGE_BAND_ROUNDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    gpu = [h.bound for h in hist]
    again = [h.bound for h in CutSolverQCQP(inst, GRID_BAND_CFG, device=dev).run(
        rounds=HUGE_BAND_ROUNDS)]
    HUGE_RESULTS["band"] = gpu
    log(f"[huge {inst.name}] bounds on the card {gpu}; {len(hist)} rounds in {wall:.3f}s = "
        f"{len(hist) / wall!r} rounds/s ({[h.lp_iters for h in hist]} LP iterations; {SMI}); "
        f"launches {launches}")
    return launches, {
        f"{HUGE_BAND_ROUNDS} rounds ran": len(gpu) == HUGE_BAND_ROUNDS,
        "a second run repeats every round bit for bit": again == gpu,
        "K4 launched": launches["fused_score"] > 0,
        "no plain PDHG block, twin check, norm or scorer on the card":
            launches[PLAIN_BLOCKS] == launches[PLAIN_CONTROL] == launches[TWIN_SCORED] == 0,
        **dense_route_checks(f"huge {inst.name}", launches, GRID_NAMES),
    }


def huge_certifier(dev) -> tuple:
    """The certifier past n = 512: sdp_relaxation_bound on
    generate_spar(HUGE_CERT_N, 100, 1), HUGE_CERT_ROUNDS plain eigencut
    rounds of FULL_LP (phase 19's settings), twice, bit for bit, on the dense
    route alone, whose kernels there are the 1024-column form without cuts;
    every certificate finite (huge_references holds them to the
    Burer-Monteiro point's lb, computed on the host).  Returns (launch
    counts, checks)."""
    inst = generate_spar(HUGE_CERT_N, 100, 1)
    kw = dict(max_rounds=HUGE_CERT_ROUNDS, capacity=512, max_cuts_per_round=48, device=dev)
    reset_launches()
    t0 = time.perf_counter()
    best, _, hist = sdp_relaxation_bound(inst, FULL_LP, **kw)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    for h in hist:
        log(f"[huge certifier {inst.name}] round {h['round']}: certificate {h['bound']!r} count "
            f"{h['cuts']} lp_iters {h['lp_iters']} kkt {h['lp_kkt']:.3e}; seconds "
            f"{sum(h['seconds'].values()):.4f} (lp {h['seconds']['lp']:.4f})")
    again = sdp_relaxation_bound(inst, FULL_LP, **kw)[2]
    certs = np.array([h["bound"] for h in hist])
    lp_s, iters, us = lp_us(hist)
    HUGE_RESULTS["certificates"] = certs.tolist()
    log(f"[huge certifier {inst.name}] {len(hist)} rounds in {wall:.3f}s, best {best!r}; the LP {lp_s:.4f}s for {iters} "
        f"iterations = {us:.2f} us a certifier LP iteration ({SMI}); launches {launches}")

    def outcome_of(hs):
        return [(h["bound"], h["lam_min"], h["cuts"], h["lp_iters"], h["lp_kkt"]) for h in hs]

    return launches, {
        f"{HUGE_CERT_ROUNDS} rounds ran": len(hist) == HUGE_CERT_ROUNDS,
        "certificates finite": bool(np.isfinite(certs).all()),
        **dense_route_checks(f"huge certifier {inst.name}", launches, GRID_NAMES),
        "a second run repeats every round bit for bit": outcome_of(again) == outcome_of(hist),
    }


def huge_references(refs: References) -> dict:
    """The end of phases 19, 20 and 21, at the end of the run, once the host
    references are in (``refs``): phase 19's band within GRID_RTOL of the
    CPU port's rounds, phase 21's band's first HUGE_BAND_CPU_ROUNDS
    certificates on the card within GRID_RTOL of the CPU port's, every
    certificate of the certifier at n = 600 at least the Burer-Monteiro lb,
    and phase 20's band batch's first GRID_BATCH_BAND_CPU_ROUNDS
    certificates within GRID_RTOL of the CPU port's batched round."""
    r = refs.get()
    ggpu, gcpu = HUGE_RESULTS["grid band"], r["grid_band"]
    grel = [abs(g - c) / abs(c) for g, c in zip(ggpu, gcpu)]
    log(f"[grid] phase 19's band on the card {ggpu}, on the CPU {gcpu} "
        f"({r['grid_band_seconds']:.1f}s there): rel diff {grel} (rtol {GRID_RTOL})")
    gpu, cpu = HUGE_RESULTS["band"], r["band_bounds"]
    rel = [abs(g - c) / abs(c) for g, c in zip(gpu, cpu)]
    certs = np.array(HUGE_RESULTS["certificates"])
    bgpu, bcpu = np.array(HUGE_RESULTS["band batch"]), np.array(r["band_batch"])
    brel = np.abs(bgpu - bcpu) / np.abs(bcpu)
    log(f"[huge] the band's bounds on the card {gpu}, on the CPU {cpu} ({r['band_seconds']:.1f}s "
        f"there, in a process of its own): rel diff {rel} (rtol {GRID_RTOL}); the certifier's "
        f"certificates {certs.tolist()}, the Burer-Monteiro lb {r['bm_lb']!r} "
        f"({r['bm_seconds']:.1f}s on the host); phase 20's band batch on the card "
        f"{bgpu.tolist()}, on the CPU {bcpu.tolist()} ({r['band_batch_seconds']:.1f}s there): "
        f"largest rel diff {float(brel.max())!r}")
    return {
        f"phase 19's band: every round within {GRID_RTOL} of the CPU port":
            len(gcpu) == len(ggpu) and max(grel) <= GRID_RTOL,
        f"the CPU port ran the band's first {HUGE_BAND_CPU_ROUNDS} round(s)":
            len(cpu) == HUGE_BAND_CPU_ROUNDS,
        f"each within {GRID_RTOL} of the card's": max(rel) <= GRID_RTOL,
        f"every certificate of the certifier >= the BM lb {r['bm_lb']}":
            bool((certs >= r["bm_lb"]).all()),
        f"the band batch within rtol {GRID_RTOL} of the CPU port":
            bgpu.shape == bcpu.shape and bool((brel <= GRID_RTOL).all()),
    }


def huge_phase(dev) -> dict:
    """Phase 21: the 1024-column form's kernels against their twins
    (huge_kernels), generate_spar(1024, 100, 1) (huge_solve), the band
    instance at n = 600 (huge_band) and the certifier at n = 600
    (huge_certifier), each path's launches into PATH_LAUNCHES and into the
    form's kernel entries; huge_references ends it at the end of the run.
    Returns huge_kernels' numbers."""
    t0 = time.perf_counter()
    out = huge_kernels(dev)
    paths = {"huge boxqp n=1024": huge_solve, "huge qcqp band n=600": huge_band,
             "huge certifier n=600": huge_certifier}
    for path, run in paths.items():
        PATH_LAUNCHES[path], checks = run(dev)
        finish(path, checks)
    for key in ("pdhg_grid", "pdhg_grid_check", "pdhg_grid_norm"):
        out[f"{key} launches"] = sum(PATH_LAUNCHES[p][key] for p in paths)
    out["seconds"] = time.perf_counter() - t0
    log(f"[huge] phase 21 took {out['seconds']:.1f}s ({SMI})")
    return out


# ---- phase 22: any pool and any number of dense rows (the grid route's far form) ----

BIG_SHAPES = {                         # label: (n, M, k, active cuts, m)
    "n=125 M=81920": (125, 81920, 3, 2000, 0),
    "n=300 M=32768": (300, 32768, 3, 2000, 0),
    "n=300 k=5 m=6000": (300, 1024, 5, 400, 6000),
    "n=600 M=49152": (600, 49152, 3, 2000, 0),
}
BIG_CERTS = ((300, 7000), (64, 23000))  # the certifier's (n, m) past its shared layouts
BIG_BATCH = 2                          # the walk at "n=300 M=32768"
BIG_BATCH_SHAPE = "n=300 M=32768"
BIG_HEAVY_REPS = 2                     # timed launches at the shapes that stream GBs of G
BIG_INSTANCE = (300, 100, 1)           # generate_spar's arguments: the end-to-end solve
BIG_CAPACITY = 81920
BIG_ROUNDS = 2


def device_rows(n: int, m: int, rng, dev, chunk: int = 256) -> DenseRows:
    """m normalised rank-1 rows v v' >= 0 of random unit directions (the
    seed rows' form, loop/sdp_bound.py::_seed_rows) made on the card in
    float64 from one host draw, chunk by chunk, then rounded to float32:
    GBs of G that the host would take minutes to build."""
    V = rng.standard_normal((m, n + 1))
    Vd = torch.as_tensor(V / np.linalg.norm(V, axis=1, keepdims=True), dtype=torch.float64,
                         device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    G, g, h = torch.empty((m, n, n), **f32), torch.empty((m, n), **f32), torch.empty(m, **f32)
    for s0 in range(0, m, chunk):
        v0, U = Vd[s0:s0 + chunk, 0], Vd[s0:s0 + chunk, 1:]
        Gm, gm, hm = U[:, :, None] * U[:, None, :], 2.0 * v0[:, None] * U, -(v0 ** 2)
        nrm = torch.sqrt((Gm ** 2).sum((1, 2)) + (gm ** 2).sum(1)) + 1e-30
        G[s0:s0 + chunk] = Gm / nrm[:, None, None]
        g[s0:s0 + chunk] = gm / nrm[:, None]
        h[s0:s0 + chunk] = hm / nrm
    return DenseRows(G, g, h)


def big_inputs(label: str, dev, shapes=None):
    """(cx, cX, pool, index, state, dense) of a BIG_SHAPES shape (or of
    ``shapes``): generate_spar(n, 100, 1)'s objective, a pool of M with
    ``active`` random unit cuts on random k-subsets of the columns and a
    random state (phase 3's random_pool and random_state), and m
    device_rows."""
    n, M, k, active, m = (BIG_SHAPES if shapes is None else shapes)[label]
    rng = np.random.default_rng(SEED + 7)
    inst = generate_spar(n, 100, 1)
    table = np.sort(np.stack([rng.choice(n, k, replace=False)
                              for _ in range(max(2000, active))]), axis=1)
    pool = random_pool(table, M, active, rng, dev)
    st = random_state(n, M, m, pool, rng, dev)
    dense = device_rows(n, m, rng, dev) if m else None
    f32 = dict(dtype=torch.float32, device=dev)
    return (torch.as_tensor(-inst.c, **f32), torch.as_tensor(-0.5 * inst.Q, **f32), pool,
            build_cut_index(pool, n), st, dense)


def big_cert_inputs(n: int, m: int, dev):
    """dense_inputs' certifier LP at (n, m) with device_rows: (cx, cX, pool,
    index, state, dense)."""
    inst = generate_spar(n, 100, 1)
    rng = np.random.default_rng(SEED + 8)
    dense = device_rows(n, m, rng, dev)
    pool = empty_pool(1, 1, dev)
    st = random_state(n, 1, m, pool, rng, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    st.yD = torch.as_tensor(0.2 * rng.random(m) * (rng.random(m) < 0.3), **f32)
    return (torch.as_tensor(-inst.c, **f32), torch.as_tensor(-0.5 * inst.Q, **f32), pool,
            build_cut_index(pool, n), st, dense)


def bigpool_kernels(dev) -> dict:
    """Phase 22 (a): the far form's block, checked launch and norm at
    BIG_SHAPES and, without cuts, at BIG_CERTS (the certifier's pool past
    K7's rows and the shared layout's), each against its twin at phase 19's
    tolerances, twice bit for bit, timed on the device beside its bound; the
    walk at B = BIG_BATCH (each instance its single entry's bits); ptxas
    without a spill or a stack.  Every shape must take the far form by
    shape (route_refusal's route, no refusal).  Returns {kernel: {shape
    label: numbers}}."""
    out = {"pdhg_grid": {}, "pdhg_grid_check": {}, "pdhg_grid_norm": {}}
    log(f"[big] ptxas: {grid_ptxas()}")
    cases = [(label, lambda label=label: big_inputs(label, dev)) for label in BIG_SHAPES]
    cases += [(f"certifier n={n} m={m}", lambda n=n, m=m: big_cert_inputs(n, m, dev))
              for n, m in BIG_CERTS]
    for label, make in cases:
        t0 = time.perf_counter()
        inputs = make()
        cx, _, pool, _, _, dense = inputs
        n, (M, k), m = cx.shape[0], pool.idx.shape, 0 if dense is None else dense.m
        route = pdhg_kernel.route_refusal(n, M, k, m)
        far = pdhg_grid._form(n, M, k, m)[0]
        log(f"[big {label}] route {route}, the far form: {far}; K7 takes it: "
            f"{pdhg_dense.k7_takes(n, m) if (M, k) == (1, 1) else None}; "
            f"{nbytes(*([] if dense is None else [dense.G]))} bytes of G; made in "
            f"{time.perf_counter() - t0:.1f}s")
        if route[1] is not None or not far:
            raise AssertionError(f"{label} is not the far form's, or is refused: {route}")
        reps = BIG_HEAVY_REPS if m > 2048 else 10
        out["pdhg_grid"][label] = check_grid_block(label, inputs, reps)
        out["pdhg_grid_check"][label] = check_grid_check(label, inputs, reps)
        out["pdhg_grid_norm"][label] = check_grid_norm(label, inputs, min(reps, 5))
        del inputs, dense
        log(f"[big {label}] checked in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    n, M, k, active, m = BIG_SHAPES[BIG_BATCH_SHAPE]
    inputs = grid_batch_inputs(BIG_BATCH_SHAPE, dev, {BIG_BATCH_SHAPE: (n, k, m)}, BIG_BATCH,
                               M, active)
    label = f"batched {BIG_BATCH_SHAPE}"
    out["pdhg_grid"][label] = check_grid_block_batched(BIG_BATCH_SHAPE, inputs)
    out["pdhg_grid_check"][label] = check_grid_check_batched(BIG_BATCH_SHAPE, inputs)
    out["pdhg_grid_norm"][label] = check_grid_norm_batched(BIG_BATCH_SHAPE, inputs)
    log(f"[big batch {BIG_BATCH_SHAPE}] B = {BIG_BATCH} checked in "
        f"{time.perf_counter() - t0:.1f}s")
    return out


def far_against_shared(dev) -> dict:
    """Phase 22 (b): the far form forced (the wrappers' private ``_far``) at
    phase 19's shapes n = 512 (M = 1024, 400 active) and n = 200 with k = 5
    and 25 dense rows, which the shared form takes: the block (7 and 100
    iterations), the checked launch (restart periods 10^9 and 100) and the
    norm give the shared form's bits; the 100-iteration block of each form
    timed on the device in turns (shared, far, far, shared).  Returns
    {label: (shared ms, far ms)}."""
    out = {}
    for label in ("n=512 m=0", "n=200 k=5 m=25"):
        cx, cX, pool, index, st, dense = grid_inputs(label, dev)
        n, (M, k) = cx.shape[0], pool.idx.shape
        m = 0 if dense is None else dense.m
        if pdhg_grid._form(n, M, k, m)[0]:
            raise AssertionError(f"{label} is not the shared form's shape")
        eta = 0.95 / estimate_norm_plain(pool, n, 30, torch.Generator().manual_seed(0), index,
                                         dense).item()
        zero = st.map(torch.zeros_like)
        same = {}
        for iters in (7, 100):
            a = pdhg_grid_block(cx, cX, pool, index, st, zero, eta, eta, iters, dense)
            b = pdhg_grid_block(cx, cX, pool, index, st, zero, eta, eta, iters, dense, _far=True)
            same[f"block {iters}"] = states_equal(list(a), list(b))
        normK = estimate_norm_plain(pool, n, 30, torch.Generator().manual_seed(0), index, dense)
        for rp in (10 ** 9, 100):
            bufs = {}
            for far in (None, True):
                bufs[far] = [st.map(torch.clone), st.map(torch.zeros_like), st.map(torch.clone),
                             new_record(normK, 1.0, 0.95, CHECK_ARGS["max_iters"],
                                        CHECK_ARGS["tol"], cx.device)]
                pdhg_grid_block_checked(cx, cX, pool, index, *bufs[far],
                                        CHECK_ARGS["check_every"], rp, CHECK_ARGS["max_iters"],
                                        CHECK_ARGS["tol"], dense, _far=far)
            same[f"checked rp={rp}"] = (states_equal(bufs[None][:3], bufs[True][:3])
                                        and torch.equal(bufs[None][3], bufs[True][3]))
        norms = [pdhg_grid_norm(pool, n, 30, torch.Generator().manual_seed(0), index, dense,
                                _far=far) for far in (None, True)]
        same["norm"] = torch.equal(*norms)
        rec = pdhg_kernel.steps_record([eta], [eta], cx.device)[0]
        ip = [st.map(torch.clone), zero.map(torch.clone)]
        t_sh, t_far = [], []
        for runs, far in ((t_sh, None), (t_far, True), (t_far, True), (t_sh, None)):
            runs.append(queued_ms(lambda far=far: pdhg_grid_block_steps(
                cx, cX, pool, index, *ip, rec, 100, dense, _far=far), reps=10))
        sh, fa = sum(t_sh) / 2, sum(t_far) / 2
        log(f"[big far/shared {label}] the far form forced against the shared form, bit for "
            f"bit: {same}; 100 iterations on the device (queued events, in turns) shared "
            f"{t_sh!r} ms, far {t_far!r} ms: far / shared {fa / sh:.4f} ({SMI})")
        if not all(same.values()):
            raise AssertionError(f"the far form does not give the shared form's bits ({label})")
        out[label] = {"shared_ms": sh, "far_ms": fa, "ratio": fa / sh}
    return out


def bigpool_solve(dev) -> tuple:
    """Phase 22 (c): CutSolver on generate_spar(300, 100, 1) with the
    defaults but CutConfig(capacity=81920) and "auto", BIG_ROUNDS rounds
    twice, bit for bit: K1 and the grid route's far form (the pool takes it
    by shape) alone, no K2, no plain block, twin check or norm; every
    certificate at least a feasible point's objective; rounds/s and the
    synchronised stage split.  Round 0 is held to the CPU port's in the host
    references at the end of the run (big_references).  Returns (launch
    counts, checks)."""
    from sdpcutsel_tpu_torch.profile_round import STAGES, stage_split

    inst = generate_spar(*BIG_INSTANCE)
    cfg = big_config()
    far = pdhg_grid._form(inst.n, BIG_CAPACITY, cfg.cuts.k, 0)[0]
    solver = CutSolver(inst, cfg, device=dev)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = solver.run(rounds=BIG_ROUNDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    floor = feasible_objective(inst, solver.state.x.cpu().numpy())
    for h in hist:
        log(f"[big {inst.name}] round {h.round}: bound {h.bound!r} certificate "
            f"{h.certificate!r} cuts_added {h.cuts_added} active {h.cuts_active} lp_iters "
            f"{h.lp_iters} kkt {h.lp_kkt_error:.3e} wall {h.wall_time_s:.3f}s")
    del solver
    again = CutSolver(inst, cfg, device=dev).run(rounds=BIG_ROUNDS)
    certs = np.array([h.certificate for h in hist])
    bounds = np.array([h.bound for h in hist])
    BIG_RESULTS["round0"] = hist[0].bound
    log(f"[big {inst.name}] capacity {BIG_CAPACITY}, the far form: {far}; {len(hist)} rounds in "
        f"{wall:.3f}s = {len(hist) / wall!r} rounds/s ({sum(h.lp_iters for h in hist)} LP "
        f"iterations); launches {launches}; a feasible point's f {floor!r} ({SMI})")
    stages = [*STAGES, (pdhg_grid, "_checked_launcher", "  grid checked step's set-up")]
    split_wall, split = stage_split((inst, CutSolver, cfg, BIG_ROUNDS), dev, BIG_ROUNDS, stages)
    for label, (sec, calls) in split.items():
        if calls:
            log(f"[big {inst.name}] split: {label} {sec:.4f}s ({sec / split_wall:.2%} of the "
                f"synchronised run's {split_wall:.4f}s), {calls} calls")
    return launches, {
        f"{BIG_ROUNDS} rounds ran": len(hist) == BIG_ROUNDS,
        "the pool takes the far form": far,
        "K1 launched, K2 not": launches["pair_score"] > 0 and launches["pdhg_block"] == 0,
        "no plain PDHG block, twin check, norm or scorer on the card":
            launches[PLAIN_BLOCKS] == launches[PLAIN_CONTROL] == launches[TWIN_SCORED] == 0,
        "certificates finite": bool(np.isfinite(certs).all()),
        f"every certificate >= a feasible point's f {floor}": bool((certs >= floor).all()),
        "bounds are the running minimum of the certificates":
            bool((bounds == np.minimum.accumulate(certs)).all()),
        "a second run repeats every round bit for bit": outcome(again) == outcome(hist),
        **dense_route_checks(f"big {inst.name}", launches, GRID_NAMES),
    }


def big_config() -> RunConfig:
    """Phase 22's solve: CutSolver's defaults but a pool of BIG_CAPACITY."""
    return RunConfig(cuts=CutConfig(capacity=BIG_CAPACITY))


# what phase 22 leaves for big_references: round 0's bound on the card
BIG_RESULTS = {}


def big_references(refs: "References") -> dict:
    """The end of phase 22, once the host references are in: round 0 of the
    end-to-end solve on the card within GRID_RTOL of the CPU port's."""
    r = refs.get()
    gpu, cpu = BIG_RESULTS["round0"], r["big_round0"]
    rel = abs(gpu - cpu) / abs(cpu)
    log(f"[big] round 0 at capacity {BIG_CAPACITY}: on the card {gpu!r}, on the CPU {cpu!r} "
        f"({r['big_seconds']:.1f}s there, in a process of its own): rel diff {rel:.3e} "
        f"(rtol {GRID_RTOL})")
    return {f"round 0 within {GRID_RTOL} of the CPU port's": rel <= GRID_RTOL}


def bigpool_phase(dev) -> dict:
    """Phase 22: the far form's kernels against their twins
    (bigpool_kernels), against the shared form (far_against_shared), and
    the end-to-end solve at capacity 81,920 (bigpool_solve), its launches
    into PATH_LAUNCHES and into the grid entries; big_references ends it at
    the end of the run.  Returns bigpool_kernels' numbers, with
    far_against_shared's under "far/shared"."""
    t0 = time.perf_counter()
    out = bigpool_kernels(dev)
    out["far/shared"] = far_against_shared(dev)
    PATH_LAUNCHES["big boxqp capacity=81920"], checks = bigpool_solve(dev)
    finish("big boxqp capacity=81920", checks)
    out["seconds"] = time.perf_counter() - t0
    log(f"[big] phase 22 took {out['seconds']:.1f}s ({SMI})")
    return out


# ---- phase 23: past n = 1024 (the grid route's 2048-column form) ----------------

VAST_SHAPES = {"n=1100 m=0": (1100, 3, 0), "n=2048 m=0": (2048, 3, 0),
               "n=1500 k=5 m=25": (1500, 5, 25)}
VAST_FAR = {"n=2048 M=65536": (2048, 65536, 3, 2000, 0)}   # (n, M, k, active cuts, m)
VAST_CERT = (1500, 64)                 # the form without cuts: the certifier's (n, m)
VAST_BATCH = 2
VAST_BATCH_SHAPES = {"n=2048 k=3 m=0": (2048, 3, 0)}
VAST_INSTANCE = (2048, 100, 1)         # CutSolver with the defaults
VAST_ROUNDS = 1                        # cut from 3 to make room for phase 24
VAST_SPLIT_ROUNDS = 0                  # of a third run, synchronised stage by stage (0: none)
VAST_SMALL = (1100, 100, 1)            # round 0 against "off"; the certifier's instance
VAST_BAND = (1500, 5, 25, 1)           # generate_qcqp_band, at the grid QCQP's settings
VAST_BAND_ROUNDS = 1                   # cut from 2 to make room for phase 24
VAST_CERT_ROUNDS, VAST_CERT_CAPACITY = 1, 64   # rounds cut from 2 for phase 24
VAST_BM = dict(stages=4, iters_per_stage=100)   # the BM lb at n = 1100, cut to the phase's time
VAST_K1_FORCED = 1 << 26               # rows a launch in the forced split at n = 1024


def vast_ptxas() -> str:
    """ptxas's lines of the 2048-column instantiations (Cols = 2048 in the
    mangled names: the block, its checked form and the norm, with cuts and
    without, shared and far: 12 kernels); fails on a spill, a stack frame or
    a missing kernel."""
    rep = spill_free("Li2048E")
    count = len(re.findall(r"Used \d+ registers", rep))
    if re.search(r"[1-9]\d* bytes stack frame", rep) or count != 12:
        raise AssertionError(f"the 2048-column kernels: {count} in the log, or a stack frame: "
                             f"{rep}")
    return rep


def k1_vast_check(dev) -> dict:
    """K1 over all C(2048, 3) triples (17.2 GB of table, written on the card
    by combinations_table_on) in the launches of launch_ranges, each
    counted: the first and last K1_CHUNK rows and K1_CHUNK rows around each
    launch boundary against the twin at k1_twin_check's tolerances, two
    calls bit for bit, its time by events and on the device beside the
    bound; then at n = 1024 a split forced to VAST_K1_FORCED rows a launch
    gives the one launch's bits."""
    inst = generate_spar(*VAST_INSTANCE)
    x, X, Q = scoring_point(inst, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table = combinations_table_on(inst.n, 3, dev)
    torch.cuda.synchronize()
    table_s = time.perf_counter() - t0
    T = table.shape[0]
    ranges = launch_ranges(T, 3)
    mlp = MLPScorer(load_params(3), dev)
    before = pair_score.launches
    nn_k, feas_k = pair_score(x, X, Q, table, mlp, 5)
    launched = pair_score.launches - before
    again = pair_score(x, X, Q, table, mlp, 5)
    repeat = torch.equal(nn_k, again[0]) and torch.equal(feas_k, again[1])
    del again
    half = K1_CHUNK // 2
    windows = [(0, K1_CHUNK), (T - K1_CHUNK, T), *((e - half, e + half) for _, e in ranges[:-1])]
    errs = []

    def twin_pass():
        for s, e in windows:
            nn_p, feas_p = pair_score_plain(x, X, Q, table[s:e], mlp, 5)
            errs.append((*excess(feas_k[s:e], feas_p, 0.0, 5e-5),
                         *excess(nn_k[s:e], nn_p, 2e-4, 2e-4)))

    plain_ms = cuda_ms(twin_pass, reps=1, warmup=0)
    worst = max(max(e[0], e[2]) for e in errs)
    ratio = max(max(e[1], e[3]) for e in errs)
    moved = nbytes(x, X, Q, table, nn_k, feas_k)
    log(f"[vast pair_score {inst.name}] T={T} ({nbytes(table)} bytes of table written on the "
        f"card in {table_s:.3f}s) in {launched} launches {ranges}: max|err| {worst:.3e}, "
        f"{ratio:.3f} of the limit (feas atol 5e-5, nn rtol/atol 2e-4) over the rows "
        f"{windows}; two calls bit for bit: {repeat}")
    if ratio > 1.0 or not repeat or launched != len(ranges) or len(ranges) != 2:
        raise AssertionError("K1 over C(2048, 3) disagrees with its twin, does not repeat or "
                             "did not run in its two launches")
    del nn_k, feas_k
    ms = cuda_ms(lambda: pair_score(x, X, Q, table, mlp, 5), reps=3, warmup=1)
    dev_ms = queued_ms(lambda: pair_score(x, X, Q, table, mlp, 5), reps=2)
    b, parts = scoring_bound(T, moved + mlp_bytes(mlp), ms)
    log(f"[vast pair_score {inst.name}] T={T}: {ms:.4f} ms by events ({T / ms / 1e3:.1f} M "
        f"cand/s) for its {launched} launches, {dev_ms:.4f} ms on the device (queued events); "
        f"the twin on {sum(e - s for s, e in windows)} rows {plain_ms:.4f} ms; {share(ms, b)}; "
        f"{parts} ({SMI})")
    del table
    small = generate_spar(1024, 100, 1)
    x2, X2, Q2 = scoring_point(small, dev)
    table2 = combinations_table_on(1024, 3, dev)
    one = pair_score(x2, X2, Q2, table2, mlp, 5)
    before = pair_score.launches
    split = pair_score(x2, X2, Q2, table2, mlp, 5, _max_rows=VAST_K1_FORCED)
    forced = pair_score.launches - before
    same = torch.equal(one[0], split[0]) and torch.equal(one[1], split[1])
    log(f"[vast pair_score {small.name}] T={table2.shape[0]} split into {forced} launches of at "
        f"most {VAST_K1_FORCED} rows: the one launch's bits: {same}")
    if not same or forced != len(launch_ranges(table2.shape[0], 3, VAST_K1_FORCED)) or forced < 2:
        raise AssertionError("a forced split of K1 at n = 1024 changed its bits")
    return {"max_abs_err": worst, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "plain_rows": sum(e - s for s, e in windows), "candidates": T,
            "launches_a_call": launched, "table_s": table_s, **b}


def vast_kernels(dev) -> dict:
    """Phase 23 (a) and (b): the 2048-column form's block, checked launch and
    norm at VAST_SHAPES (huge_inputs' pools and states), in the far form at
    VAST_FAR, without cuts at VAST_CERT, each against its twin at phase
    19's tolerances, twice bit for bit, timed on the device beside its
    bound; the walk at B = VAST_BATCH, n = 2048 (each instance its single
    entry's bits); ptxas of the 12 new kernels without a spill or a stack;
    K1 over C(2048, 3) (k1_vast_check).  Returns {kernel: {shape label:
    numbers}}."""
    out = {"pdhg_grid": {}, "pdhg_grid_check": {}, "pdhg_grid_norm": {}}
    log(f"[vast] ptxas of the 2048-column kernels: {vast_ptxas()}")
    cases = [(label, lambda label=label: huge_inputs(label, dev, VAST_SHAPES))
             for label in VAST_SHAPES]
    cases += [(label, lambda label=label: big_inputs(label, dev, VAST_FAR)) for label in VAST_FAR]
    n, m = VAST_CERT
    cases.append((f"certifier n={n} m={m}", lambda: big_cert_inputs(n, m, dev)))
    for label, make in cases:
        t0 = time.perf_counter()
        inputs = make()
        cx, _, pool, _, _, dense = inputs
        n_, (M, k), m_ = cx.shape[0], pool.idx.shape, 0 if dense is None else dense.m
        route = pdhg_kernel.route_refusal(n_, M, k, m_)
        far = pdhg_grid._form(n_, M, k, m_)[0]
        log(f"[vast {label}] route {route}, column width {pdhg_kernel.columns(n_)}, the far "
            f"form: {far}; made in {time.perf_counter() - t0:.1f}s")
        if (route[1] is not None or pdhg_kernel.columns(n_) != pdhg_kernel.VAST
                or far != (label in VAST_FAR)):
            raise AssertionError(f"{label} is not the 2048-column form's it should be: {route}")
        out["pdhg_grid"][label] = check_grid_block(label, inputs, 5)
        out["pdhg_grid_check"][label] = check_grid_check(label, inputs, 5, split=label in VAST_FAR)
        out["pdhg_grid_norm"][label] = check_grid_norm(label, inputs, 3)
        del inputs, dense
        log(f"[vast {label}] checked in {time.perf_counter() - t0:.1f}s")
    for label in VAST_BATCH_SHAPES:
        t0 = time.perf_counter()
        inputs = grid_batch_inputs(label, dev, VAST_BATCH_SHAPES, VAST_BATCH)
        out["pdhg_grid"][f"batched {label}"] = check_grid_block_batched(label, inputs)
        out["pdhg_grid_check"][f"batched {label}"] = check_grid_check_batched(label, inputs)
        out["pdhg_grid_norm"][f"batched {label}"] = check_grid_norm_batched(label, inputs)
        del inputs
        log(f"[vast batch {label}] checked in {time.perf_counter() - t0:.1f}s")
    out["pair_score"] = k1_vast_check(dev)
    return out


def mccormick_off(inst, capacity: int, dev) -> tuple:
    """The McCormick bound of a BoxQP instance as the plain loop certifies
    it on the card: the LP without cuts (an empty pool of ``capacity``, the
    first round's) solved with LPConfig(use_kernel="off"), its dual bound in
    f64 (dual_bound_f64).  Returns (the bound, the LP's iterations)."""
    f32 = dict(dtype=torch.float32, device=dev)
    Q, c = torch.as_tensor(inst.Q, **f32), torch.as_tensor(inst.c, **f32)
    pool = empty_pool(capacity, 3, dev)
    st, info = pdhg_mod.solve_lp(Q, c, pool, init_state(inst.n, capacity, dev),
                                 LPConfig(use_kernel="off"))
    return pdhg_mod.dual_bound_f64(inst.Q, inst.c, pool, st), int(info["iters"])


def vast_solve(dev) -> tuple:
    """Phase 23 (c): CutSolver on generate_spar(2048, 100, 1) with the
    defaults (k = 3, neural, sel_size 20, capacity 1024, LPConfig()),
    VAST_ROUNDS rounds with "auto" twice, bit for bit: K1 over all
    1,429,559,296 triples in two launches a round and the 2048-column form
    for every LP and norm, no K2, no plain block, twin check or
    twin-scored call; every certificate reaches a feasible point's
    objective; round 0 within 1e-2 of the McCormick bound (mccormick_off);
    rounds/s and the card's peak memory; then, with VAST_SPLIT_ROUNDS, the
    synchronised stage split of a third run.  Returns (launch counts,
    checks)."""
    from sdpcutsel_tpu_torch.profile_round import STAGES, stage_split

    inst = generate_spar(*VAST_INSTANCE)
    cfg = RunConfig()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    solver = CutSolver(inst, cfg, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    hist = solver.run(rounds=VAST_ROUNDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    floor = feasible_objective(inst, solver.state.x.cpu().numpy())
    for h in hist:
        log(f"[vast {inst.name}] round {h.round}: bound {h.bound!r} certificate "
            f"{h.certificate!r} cuts_added {h.cuts_added} active {h.cuts_active} lp_iters "
            f"{h.lp_iters} kkt {h.lp_kkt_error:.3e} wall {h.wall_time_s:.3f}s")
    del solver
    bounds = np.array([h.bound for h in hist])
    certs = np.array([h.certificate for h in hist])
    log(f"[vast {inst.name}] {len(hist)} rounds in {wall:.3f}s = {len(hist) / wall!r} rounds/s "
        f"({sum(h.lp_iters for h in hist)} LP iterations; the solver's set-up, the table of "
        f"{math.comb(inst.n, 3)} triples written on the card included, {setup_s:.3f}s); the "
        f"card's peak memory {peak} bytes ({peak / 2 ** 30:.2f} GiB) over the set-up and the "
        f"rounds; launches {launches}; a feasible point's f {floor!r} ({SMI})")
    again = CutSolver(inst, cfg, device=dev).run(rounds=VAST_ROUNDS)
    t0 = time.perf_counter()
    mc, mc_iters = mccormick_off(inst, cfg.cuts.capacity, dev)
    rel0 = (bounds[0] - mc) / abs(mc)
    log(f"[vast {inst.name}] the McCormick bound by the plain loop on the card {mc!r} "
        f"({mc_iters} iterations, {time.perf_counter() - t0:.1f}s); round 0 {bounds[0]!r}: "
        f"rel {rel0!r}")
    stages = [*STAGES, (pdhg_grid, "_checked_launcher", "  grid checked step's set-up")]
    if VAST_SPLIT_ROUNDS:
        split_wall, split = stage_split((inst, CutSolver, cfg, VAST_SPLIT_ROUNDS), dev,
                                        VAST_SPLIT_ROUNDS, stages)
        for label, (sec, calls) in split.items():
            if calls:
                log(f"[vast {inst.name}] split: {label} {sec:.4f}s ({sec / split_wall:.2%} of "
                    f"the synchronised run's {split_wall:.4f}s), {calls} calls")
    torch.cuda.empty_cache()
    return launches, {
        f"{VAST_ROUNDS} rounds ran": len(hist) == VAST_ROUNDS,
        "K1 launched twice a round, K2 not":
            launches["pair_score"] == 2 * VAST_ROUNDS and launches["pdhg_block"] == 0,
        "no plain PDHG block, twin check, norm or scorer on the card":
            launches[PLAIN_BLOCKS] == launches[PLAIN_CONTROL] == launches[TWIN_SCORED] == 0,
        "certificates finite": bool(np.isfinite(certs).all()),
        f"every certificate >= a feasible point's f {floor}": bool((certs >= floor).all()),
        f"round 0 within 1e-2 of the McCormick bound {mc}": abs(rel0) <= 1e-2,
        "bounds are the running minimum of the certificates":
            bool((bounds == np.minimum.accumulate(certs)).all()),
        "a second run repeats every round bit for bit": outcome(again) == outcome(hist),
        **dense_route_checks(f"vast {inst.name}", launches, GRID_NAMES),
    }


def twin_scores(inst, dev):
    """A score_fn for CutSolver on ``inst``: the neural scores of every row
    of its lexicographic table (k = 3) by K1's twin on the card
    (pair_score_plain, K1_CHUNK rows a call)."""
    table = combinations_table_on(inst.n, 3, dev)
    Q = torch.as_tensor(inst.Q, dtype=torch.float32, device=dev)
    mlp = MLPScorer(load_params(3), dev)

    def score(x, X, _generator):
        return torch.cat([pair_score_plain(x, X, Q, table[s:s + K1_CHUNK], mlp, SWEEPS)[0]
                          for s in range(0, table.shape[0], K1_CHUNK)])
    return score


def vast_against_off(dev) -> tuple:
    """Phase 23 (c) at n = 1100: round 0 of CutSolver's defaults on the
    kernels ("auto": K1 and the 2048-column form) within GRID_RTOL of the
    same round under use_kernel="off" with K1's twin as the scores, both on
    the card.  Returns (the kernel run's launch counts, checks)."""
    inst = generate_spar(*VAST_SMALL)
    reset_launches()
    got = CutSolver(inst, RunConfig(), device=dev).run(rounds=1)
    launches = launch_counts()
    solver = CutSolver(inst, RunConfig(lp=LPConfig(use_kernel="off")), device=dev,
                       score_fn=twin_scores(inst, dev))
    reset_launches()
    off = solver.run(rounds=1)
    plain = launch_counts()
    rel = abs(got[0].bound - off[0].bound) / abs(off[0].bound)
    log(f"[vast {inst.name}] round 0 on the kernels {got[0].bound!r} ({got[0].lp_iters} LP "
        f"iterations), with use_kernel='off' and the scoring twin {off[0].bound!r} "
        f"({off[0].lp_iters}): rel diff {rel!r} (rtol {GRID_RTOL}); launches {launches}, off "
        f"{plain}")
    return launches, {
        f"round 0 within {GRID_RTOL} of the plain loop's": rel <= GRID_RTOL,
        "the kernel run on K1 and the grid route":
            launches["pair_score"] == 1 and min(launches[k] for k in GRID_NAMES) > 0,
        "no plain block, twin check or twin-scored call in the kernel run":
            launches[PLAIN_BLOCKS] == launches[PLAIN_CONTROL] == launches[TWIN_SCORED] == 0,
        "the off run on the plain loop and the twin alone":
            plain[PLAIN_BLOCKS] > 0 and plain["pair_score"] == 0
            and all(plain[k] == 0 for k in GRID_NAMES),
    }


def vast_band(dev) -> tuple:
    """Phase 23 (d): CutSolverQCQP on generate_qcqp_band(1500, 5, 25, 1) (25
    dense rows, 225 MB of G, read in place) at the grid QCQP's settings
    (GRID_BAND_CFG), VAST_BAND_ROUNDS rounds with "auto" twice, bit for bit,
    on K4 and the 2048-column form alone; round 0 within GRID_RTOL of the
    same round under use_kernel="off" on the card.  Returns (launch counts,
    checks)."""
    inst = generate_qcqp_band(*VAST_BAND)
    solver = CutSolverQCQP(inst, GRID_BAND_CFG, device=dev)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = solver.run(rounds=VAST_BAND_ROUNDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    gpu = [h.bound for h in hist]
    again = [h.bound for h in CutSolverQCQP(inst, GRID_BAND_CFG, device=dev).run(
        rounds=VAST_BAND_ROUNDS)]
    off_cfg = dataclasses.replace(GRID_BAND_CFG, lp=dataclasses.replace(GRID_BAND_CFG.lp,
                                                                       use_kernel="off"))
    off = CutSolverQCQP(inst, off_cfg, device=dev).run(rounds=1)[0].bound
    rel = abs(gpu[0] - off) / abs(off)
    log(f"[vast {inst.name}] bounds on the card {gpu}; {len(hist)} rounds in {wall:.3f}s = "
        f"{len(hist) / wall!r} rounds/s ({[h.lp_iters for h in hist]} LP iterations; {SMI}); "
        f"round 0 with use_kernel='off' {off!r}: rel diff {rel!r} (rtol {GRID_RTOL}); launches "
        f"{launches}")
    return launches, {
        f"{VAST_BAND_ROUNDS} rounds ran": len(gpu) == VAST_BAND_ROUNDS,
        "a second run repeats every round bit for bit": again == gpu,
        f"round 0 within {GRID_RTOL} of the plain loop's": rel <= GRID_RTOL,
        "K4 launched": launches["fused_score"] > 0,
        "no plain PDHG block, twin check, norm or scorer on the card":
            launches[PLAIN_BLOCKS] == launches[PLAIN_CONTROL] == launches[TWIN_SCORED] == 0,
        **dense_route_checks(f"vast {inst.name}", launches, GRID_NAMES),
    }


# what phase 23 leaves for vast_references: the certifier's certificates
VAST_RESULTS = {}


def vast_certifier(dev) -> tuple:
    """Phase 23 (e): sdp_relaxation_bound on generate_spar(1100, 100, 1),
    capacity VAST_CERT_CAPACITY, VAST_CERT_ROUNDS plain eigencut rounds of
    FULL_LP, twice, bit for bit, on the dense route alone, whose kernels
    there are the 2048-column form without cuts; every certificate finite
    (vast_references holds them to the Burer-Monteiro lb).  Returns (launch
    counts, checks)."""
    inst = generate_spar(*VAST_SMALL)
    kw = dict(max_rounds=VAST_CERT_ROUNDS, capacity=VAST_CERT_CAPACITY, max_cuts_per_round=48,
              device=dev)
    reset_launches()
    t0 = time.perf_counter()
    best, _, hist = sdp_relaxation_bound(inst, FULL_LP, **kw)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    again = sdp_relaxation_bound(inst, FULL_LP, **kw)[2]
    certs = np.array([h["bound"] for h in hist])
    lp_s, iters, us = lp_us(hist)
    VAST_RESULTS["certificates"] = certs.tolist()
    log(f"[vast certifier {inst.name}] certificates {certs.tolist()} in {wall:.3f}s, best "
        f"{best!r}; the LP {lp_s:.4f}s for {iters} iterations = {us:.2f} us a certifier LP "
        f"iteration ({SMI}); launches {launches}")

    def outcome_of(hs):
        return [(h["bound"], h["lam_min"], h["cuts"], h["lp_iters"], h["lp_kkt"]) for h in hs]

    return launches, {
        f"{VAST_CERT_ROUNDS} rounds ran": len(hist) == VAST_CERT_ROUNDS,
        "certificates finite": bool(np.isfinite(certs).all()),
        **dense_route_checks(f"vast certifier {inst.name}", launches, GRID_NAMES),
        "a second run repeats every round bit for bit": outcome_of(again) == outcome_of(hist),
    }


def vast_references(refs: "References") -> dict:
    """The end of phase 23, once the host references are in: every
    certificate of the certifier at n = 1100 at least the Burer-Monteiro lb
    (VAST_BM's stages, computed on the host)."""
    r = refs.get()
    certs = np.array(VAST_RESULTS["certificates"])
    log(f"[vast] the certifier's certificates {certs.tolist()}, the Burer-Monteiro lb "
        f"{r['vast_bm_lb']!r} ({VAST_BM}, {r['vast_bm_seconds']:.1f}s on the host)")
    return {f"every certificate of the certifier >= the BM lb {r['vast_bm_lb']}":
            bool(np.isfinite(r["vast_bm_lb"]) and (certs >= r["vast_bm_lb"]).all())}


def vast_phase(dev) -> dict:
    """Phase 23: the 2048-column form's kernels and K1 over C(2048, 3)
    (vast_kernels), generate_spar(2048, 100, 1) (vast_solve), round 0 at
    n = 1100 against the plain loop (vast_against_off), the band at
    n = 1500 (vast_band) and the certifier at n = 1100 (vast_certifier),
    each path's launches into PATH_LAUNCHES and into the form's kernel
    entries; the card's peak memory over the phase; vast_references ends it
    at the end of the run.  Returns vast_kernels' numbers."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = vast_kernels(dev)
    kernels_peak = torch.cuda.max_memory_allocated()
    paths = {"vast boxqp n=2048": vast_solve, "vast boxqp n=1100": vast_against_off,
             "vast qcqp band n=1500": vast_band, "vast certifier n=1100": vast_certifier}
    for path, run in paths.items():
        PATH_LAUNCHES[path], checks = run(dev)
        finish(path, checks)
    for key in ("pdhg_grid", "pdhg_grid_check", "pdhg_grid_norm", "pair_score"):
        out[f"{key} launches"] = sum(PATH_LAUNCHES[p][key] for p in paths)
    out["seconds"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    log(f"[vast] phase 23 took {out['seconds']:.1f}s; the card's peak memory "
        f"{kernels_peak} bytes in (a)-(b), {torch.cuda.max_memory_allocated()} over the phase "
        f"(torch.cuda.max_memory_allocated; {SMI})")
    return out


# ---- phase 24: past n = 2048 (the open form; k = 3 rounds by pieces) --------------

OPEN_SHAPES = {"n=2049 m=0": (2049, 3, 0), "n=4096 m=0": (4096, 3, 0),
               "n=3000 k=5 m=25": (3000, 5, 25), "n=6000 m=0": (6000, 3, 0)}
OPEN_FAR = {"n=4096 M=65536": (4096, 65536, 3, 2000, 0)}   # (n, M, k, active cuts, m)
OPEN_CERT = (3000, 64)                 # the form without cuts: the certifier's (n, m)
OPEN_BATCH = 2
OPEN_BATCH_SHAPES = {"n=4096 k=3 m=0": (4096, 3, 0)}
OPEN_FORCED = {"n=2048 m=0": (2048, 3, 0), "n=1500 k=5 m=25": (1500, 5, 25)}  # against kVast
OPEN_INSTANCE = (4096, 100, 1)         # CutSolver with the defaults, by pieces
OPEN_ROUNDS = 1                        # cut from 2 for phase 25
OPEN_PIECES = (2100, 100, 1)           # round 0 by pieces and on the whole table; the certifier's
OPEN_BAND = (3000, 5, 25, 1)           # generate_qcqp_band, at the grid QCQP's settings
OPEN_BAND_ROUNDS = 1                   # cut from 2 for phase 25
OPEN_CERT_ROUNDS, OPEN_CERT_CAPACITY = 1, 64
OPEN_BM = dict(stages=3, iters_per_stage=30)   # the BM lb at n = 2100 (certified from stage 3)
OPEN_REFUSED = pdhg_kernel.OPEN_NMAX + 1        # past the open form's 32-bit bound


def open_ptxas() -> str:
    """ptxas's lines of the open form's instantiations (Cols = 65536 in the
    mangled names: the block, its checked form and the norm, with cuts and
    without, shared and far: 12 kernels); fails on a spill, a stack frame or
    a missing kernel."""
    rep = spill_free("Li65536E")
    count = len(re.findall(r"Used \d+ registers", rep))
    if re.search(r"[1-9]\d* bytes stack frame", rep) or count != 12:
        raise AssertionError(f"the open form's kernels: {count} in the log, or a stack frame: "
                             f"{rep}")
    return rep


def open_against_vast(label: str, inputs) -> dict:
    """The open form forced (the wrappers' private _open) where the
    2048-column form takes n: its block (100 iterations), checked launch
    (restart period 100) and norm against kVast's on the same inputs, bit
    for bit (else within the twin's tolerances, the largest difference
    printed), the block timed on the device in turns with kVast's."""
    cx, cX, pool, index, st, dense = inputs
    n = cx.shape[0]
    eta = 0.95 / estimate_norm_plain(pool, n, 30, torch.Generator().manual_seed(0), index,
                                     dense).item()
    zero = st.map(torch.zeros_like)
    args = (cx, cX, pool, index, st, zero, eta, eta, 100, dense)
    vast, opened = pdhg_grid_block(*args), pdhg_grid_block(*args, _open=True)
    block_same = states_equal(list(vast), list(opened))
    errs = [excess(a, b, 3e-4, 3e-4)[1] for a, b in zip(
        (*vast[0].fields(), *vast[1].fields()), (*opened[0].fields(), *opened[1].fields()))
        if a.numel()]
    normK = estimate_norm_plain(pool, n, 30, torch.Generator().manual_seed(0), index, dense)
    every, top, tol = CHECK_ARGS["check_every"], CHECK_ARGS["max_iters"], CHECK_ARGS["tol"]

    def checked(**kw):
        bufs = [st.map(torch.clone), st.map(torch.zeros_like), st.map(torch.clone),
                new_record(normK, 1.0, 0.95, top, tol, cx.device)]
        pdhg_grid_block_checked(cx, cX, pool, index, *bufs, every, 100, top, tol, dense, **kw)
        return bufs

    a, b = checked(), checked(_open=True)
    check_same = states_equal(a[:3], b[:3]) and torch.equal(a[3], b[3])
    bad, rel, _ = record_diff(b[3], a[3], slice(None))

    def norm(**kw):
        return pdhg_grid_norm(pool, n, 30, torch.Generator().manual_seed(0), index, dense, **kw)

    na, nb = norm(), norm(_open=True)
    ip = [st.map(torch.clone), zero.map(torch.clone)]
    rec = pdhg_kernel.steps_record([eta], [eta], cx.device)[0]
    t_vast, t_open = [], []
    for runs, kw in ((t_vast, {}), (t_open, {"_open": True}), (t_open, {"_open": True}),
                     (t_vast, {})):
        runs.append(queued_ms(lambda kw=kw: pdhg_grid_block_steps(
            cx, cX, pool, index, *ip, rec, 100, dense, **kw), reps=3))
    log(f"[open forced {label}] against the 2048-column form: the block bit for bit "
        f"{block_same} ({max(errs):.3f} of the 100-iteration limit), the checked launch "
        f"{check_same} (record words differing {bad}, rel {rel:.3e}), the norm "
        f"{torch.equal(na, nb)} ({na.item()!r}, {nb.item()!r}); the block on the device in "
        f"turns: kVast {t_vast!r} ms, open {t_open!r} ms ({SMI})")
    if max(errs) > 1.0 or bad or rel > CONTROL_RTOL or abs(
            na.item() - nb.item()) > CONTROL_RTOL * abs(na.item()):
        raise AssertionError(f"the open form forced at {label} disagrees with the 2048-column "
                             f"form past the twins' tolerances")
    return {"block_bits": block_same, "check_bits": check_same,
            "norm_bits": bool(torch.equal(na, nb)), "vast_ms": t_vast, "open_ms": t_open}


def open_kernels(dev) -> dict:
    """Phase 24 (a): the open form's block, checked launch and norm at
    OPEN_SHAPES (huge_inputs' pools and states), in the far form at
    OPEN_FAR, without cuts at OPEN_CERT, each against its twin at phase
    19's tolerances, twice bit for bit, timed on the device beside its
    bound; the walk at B = OPEN_BATCH, n = 4096; ptxas of the 12 new kernels
    without a spill or a stack; the open form forced at OPEN_FORCED against
    the 2048-column form (open_against_vast).  Returns {kernel: {shape
    label: numbers}}, the forced comparisons under "forced"."""
    out = {"pdhg_grid": {}, "pdhg_grid_check": {}, "pdhg_grid_norm": {}, "forced": {}}
    log(f"[open] ptxas of the open form's kernels: {open_ptxas()}")
    cases = [(label, lambda label=label: huge_inputs(label, dev, OPEN_SHAPES))
             for label in OPEN_SHAPES]
    cases += [(label, lambda label=label: big_inputs(label, dev, OPEN_FAR)) for label in OPEN_FAR]
    n, m = OPEN_CERT
    cases.append((f"certifier n={n} m={m}", lambda: big_cert_inputs(n, m, dev)))
    for label, make in cases:
        t0 = time.perf_counter()
        inputs = make()
        cx, _, pool, _, _, dense = inputs
        n_, (M, k), m_ = cx.shape[0], pool.idx.shape, 0 if dense is None else dense.m
        route = pdhg_kernel.route_refusal(n_, M, k, m_)
        far = pdhg_grid._form(n_, M, k, m_)[0]
        log(f"[open {label}] route {route}, column width {pdhg_kernel.columns(n_)}, the far "
            f"form: {far}; made in {time.perf_counter() - t0:.1f}s")
        if (route[1] is not None or pdhg_kernel.columns(n_) != pdhg_kernel.OPEN
                or far != (label in OPEN_FAR)):
            raise AssertionError(f"{label} is not the open form's it should be: {route}")
        out["pdhg_grid"][label] = check_grid_block(label, inputs, 1)
        out["pdhg_grid_check"][label] = check_grid_check(label, inputs, 1, split=label in OPEN_FAR)
        out["pdhg_grid_norm"][label] = check_grid_norm(label, inputs, 1)
        del inputs, dense
        torch.cuda.empty_cache()
        log(f"[open {label}] checked in {time.perf_counter() - t0:.1f}s")
    for label in OPEN_BATCH_SHAPES:
        t0 = time.perf_counter()
        inputs = grid_batch_inputs(label, dev, OPEN_BATCH_SHAPES, OPEN_BATCH)
        out["pdhg_grid"][f"batched {label}"] = check_grid_block_batched(label, inputs, 1)
        out["pdhg_grid_check"][f"batched {label}"] = check_grid_check_batched(label, inputs, 1)
        out["pdhg_grid_norm"][f"batched {label}"] = check_grid_norm_batched(label, inputs, 1)
        del inputs
        torch.cuda.empty_cache()
        log(f"[open batch {label}] checked in {time.perf_counter() - t0:.1f}s")
    for label in OPEN_FORCED:
        out["forced"][label] = open_against_vast(label, huge_inputs(label, dev, OPEN_FORCED))
    return out


def k1_piece_check(dev) -> dict:
    """K1 over the first piece of C(4096, 3) (first_index_pieces at the
    solver's PIECE_ROWS; its rows written on the card by
    combinations_rows_on) in its launches: the first and last K1_CHUNK rows
    against the twin at k1_twin_check's tolerances, two calls bit for bit,
    its time by events beside the bound and the row writer's."""
    inst = generate_spar(*OPEN_INSTANCE)
    x, X, Q = scoring_point(inst, dev)
    i0, i1, offset, rows = first_index_pieces(inst.n, 3, solver_mod.PIECE_ROWS)[0]
    pairs = combinations_table_on(inst.n, 2, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table = combinations_rows_on(inst.n, 3, i0, i1, dev, pairs)
    torch.cuda.synchronize()
    table_s = time.perf_counter() - t0
    T = table.shape[0]
    mlp = MLPScorer(load_params(3), dev)
    before = pair_score.launches
    nn_k, feas_k = pair_score(x, X, Q, table, mlp, 5)
    launched = pair_score.launches - before
    again = pair_score(x, X, Q, table, mlp, 5)
    repeat = torch.equal(nn_k, again[0]) and torch.equal(feas_k, again[1])
    del again
    windows = [(0, K1_CHUNK), (T - K1_CHUNK, T)]
    errs = []

    def twin_pass():
        for s, e in windows:
            nn_p, feas_p = pair_score_plain(x, X, Q, table[s:e], mlp, 5)
            errs.append((*excess(feas_k[s:e], feas_p, 0.0, 5e-5),
                         *excess(nn_k[s:e], nn_p, 2e-4, 2e-4)))

    plain_ms = cuda_ms(twin_pass, reps=1, warmup=0)
    worst = max(max(e[0], e[2]) for e in errs)
    ratio = max(max(e[1], e[3]) for e in errs)
    moved = nbytes(x, X, Q, table, nn_k, feas_k)
    del nn_k, feas_k
    ms = cuda_ms(lambda: pair_score(x, X, Q, table, mlp, 5), reps=3, warmup=1)
    b, parts = scoring_bound(T, moved + mlp_bytes(mlp), ms)
    log(f"[open pair_score {inst.name}] the first piece: first indices [{i0}, {i1}), {T} rows "
        f"written on the card in {table_s:.3f}s, {launched} launches: max|err| {worst:.3e}, "
        f"{ratio:.3f} of the limit over the rows {windows}; two calls bit for bit: {repeat}; "
        f"{ms:.4f} ms by events ({T / ms / 1e3:.1f} M cand/s); the twin on "
        f"{2 * K1_CHUNK} rows {plain_ms:.4f} ms; {share(ms, b)}; {parts} ({SMI})")
    if ratio > 1.0 or not repeat or launched != len(launch_ranges(T, 3)):
        raise AssertionError("K1 over a piece of C(4096, 3) disagrees with its twin or does not "
                             "repeat")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "plain_rows": 2 * K1_CHUNK, "candidates": T, "rows_s": table_s, **b}


def open_solve(dev) -> tuple:
    """Phase 24 (c): CutSolver on generate_spar(4096, 100, 1) with the
    defaults (k = 3, neural, sel_size 20, capacity 1024) but PIECES_LP (cut
    from LPConfig() for phase 25), OPEN_ROUNDS round by pieces: K1 over all
    11,444,858,880 triples a
    round, a launch a piece, and the open form for every LP and norm, no
    K2, no plain block, twin check or twin-scored call; every certificate
    reaches a feasible point's objective and the bound never rises; a fresh
    solver's round 0 repeats the first bit for bit; rounds/s, the card's
    peak memory and the survivors' largest count.  Returns (launch counts,
    checks)."""
    inst = generate_spar(*OPEN_INSTANCE)
    cfg = RunConfig(lp=PIECES_LP)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    solver = CutSolver(inst, cfg, device=dev)
    pieces = solver.pieces
    per_round = sum(len(launch_ranges(rows, 3)) for *_, rows in pieces)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    most = []
    for _ in range(OPEN_ROUNDS):
        solver.do_round()
        most.append(solver.last_selection.most)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    hist = solver.history
    floor = feasible_objective(inst, solver.state.x.cpu().numpy())
    for h in hist:
        log(f"[open {inst.name}] round {h.round}: bound {h.bound!r} certificate "
            f"{h.certificate!r} cuts_added {h.cuts_added} active {h.cuts_active} lp_iters "
            f"{h.lp_iters} kkt {h.lp_kkt_error:.3e} wall {h.wall_time_s:.3f}s")
    del solver
    torch.cuda.empty_cache()
    certs = np.array([h.certificate for h in hist])
    bounds = np.array([h.bound for h in hist])
    log(f"[open {inst.name}] {len(hist)} rounds in {wall:.3f}s = {len(hist) / wall!r} rounds/s "
        f"({sum(h.lp_iters for h in hist)} LP iterations); {len(pieces)} pieces a round "
        f"({pieces[0][3]} to {pieces[-1][3]} rows), {per_round} K1 launches a round over "
        f"{sum(p[3] for p in pieces)} triples; the survivors' largest count a round {most}; "
        f"the card's peak memory {peak} bytes ({peak / 2 ** 30:.2f} GiB); launches {launches}; "
        f"a feasible point's f {floor!r} ({SMI})")
    again = CutSolver(inst, cfg, device=dev).run(rounds=1)
    torch.cuda.empty_cache()
    return launches, {
        f"{OPEN_ROUNDS} rounds ran": len(hist) == OPEN_ROUNDS,
        "K1 over every triple a round, a launch a piece; K2 not":
            sum(p[3] for p in pieces) == math.comb(inst.n, 3)
            and launches["pair_score"] == per_round * OPEN_ROUNDS and launches["pdhg_block"] == 0,
        "no plain PDHG block, twin check, norm or scorer on the card":
            launches[PLAIN_BLOCKS] == launches[PLAIN_CONTROL] == launches[TWIN_SCORED] == 0,
        "certificates finite": bool(np.isfinite(certs).all()),
        f"every certificate >= a feasible point's f {floor}": bool((certs >= floor).all()),
        "the bound never rises": bool((np.diff(bounds) <= 0).all()),
        "bounds are the running minimum of the certificates":
            bool((bounds == np.minimum.accumulate(certs)).all()),
        "a fresh solver's round 0 repeats the first bit for bit":
            outcome(again) == outcome(hist[:1]),
        **dense_route_checks(f"open {inst.name}", launches, GRID_NAMES),
    }


def open_pieces_vs_whole(dev) -> tuple:
    """Phase 24 (c) at n = 2100: round 0 of CutSolver's defaults but
    PIECES_LP (cut from LPConfig() for phase 25: both routes share the LP)
    by pieces (the default past n = 2048) and on the whole table (the
    private _pieces=False; C(2100, 3) = 1,541,295,700 rows, 18.5 GB, fits):
    the picks (global indices and rows) and the pool's cut rows bit for bit,
    and the round's outcome.  Returns (the piecewise run's launch counts,
    checks)."""
    inst = generate_spar(*OPEN_PIECES)
    cfg = RunConfig(lp=PIECES_LP)
    whole_sel = []
    select = solver_mod.select_and_generate

    def keep(*args, **kw):          # the whole table's picks
        out = select(*args, **kw)
        whole_sel.append((out[1], args[2][out[1]]))
        return out

    torch.cuda.empty_cache()
    reset_launches()
    pieced = CutSolver(inst, cfg, device=dev)
    hist_p = pieced.run(rounds=1)
    launches = launch_counts()
    _, idx_p, _, rows_p = pieced.last_selection.result()
    pool_p = [t.clone() for t in (pieced.pool.idx, pieced.pool.lin, pieced.pool.quad,
                                  pieced.pool.rhs, pieced.pool.active)]
    n_pieces, most = len(pieced.pieces), pieced.last_selection.most
    del pieced
    torch.cuda.empty_cache()
    solver_mod.select_and_generate = keep
    try:
        whole = CutSolver(inst, cfg, device=dev, _pieces=False)
        hist_w = whole.run(rounds=1)
    finally:
        solver_mod.select_and_generate = select
    pool_w = [whole.pool.idx, whole.pool.lin, whole.pool.quad, whole.pool.rhs, whole.pool.active]
    idx_w, rows_w = whole_sel[0]
    same_picks = torch.equal(idx_p, idx_w) and torch.equal(rows_p, rows_w.to(rows_p.dtype))
    same_rows = all(torch.equal(a, b) for a, b in zip(pool_p, pool_w))
    del whole
    torch.cuda.empty_cache()
    log(f"[open {inst.name}] round 0 by {n_pieces} pieces (the survivors' largest count {most}) "
        f"and on the whole table: bounds {hist_p[0].bound!r}, {hist_w[0].bound!r}; picks bit "
        f"for bit {same_picks} ({idx_p.tolist()}); the pool's cut rows bit for bit {same_rows}; "
        f"launches by pieces {launches}")
    return launches, {
        "the picks by pieces are the whole table's, bit for bit": same_picks,
        "the cut rows by pieces are the whole table's, bit for bit": same_rows,
        "round 0 by pieces repeats the whole table's": outcome(hist_p) == outcome(hist_w),
        "K1 launched a piece at a time":
            launches["pair_score"] == sum(len(launch_ranges(p[3], 3)) for p in
                                          first_index_pieces(inst.n, 3, solver_mod.PIECE_ROWS)),
    }


def open_band(dev) -> tuple:
    """Phase 24 (d): CutSolverQCQP on generate_qcqp_band(3000, 5, 25, 1) (25
    dense rows, 900 MB of G, read in place) at the grid QCQP's settings
    (GRID_BAND_CFG), OPEN_BAND_ROUNDS rounds with "auto" twice, bit for bit,
    on K4 and the open form alone.  Returns (launch counts, checks)."""
    inst = generate_qcqp_band(*OPEN_BAND)
    solver = CutSolverQCQP(inst, GRID_BAND_CFG, device=dev)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = solver.run(rounds=OPEN_BAND_ROUNDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    gpu = [h.bound for h in hist]
    del solver
    again = [h.bound for h in CutSolverQCQP(inst, GRID_BAND_CFG, device=dev).run(
        rounds=OPEN_BAND_ROUNDS)]
    log(f"[open {inst.name}] bounds on the card {gpu}; {len(hist)} rounds in {wall:.3f}s = "
        f"{len(hist) / wall!r} rounds/s ({[h.lp_iters for h in hist]} LP iterations; {SMI}); "
        f"launches {launches}")
    return launches, {
        f"{OPEN_BAND_ROUNDS} rounds ran": len(gpu) == OPEN_BAND_ROUNDS,
        "a second run repeats every round bit for bit": again == gpu,
        "certificates finite": bool(np.isfinite(gpu).all()),
        "K4 launched": launches["fused_score"] > 0,
        "no plain PDHG block, twin check, norm or scorer on the card":
            launches[PLAIN_BLOCKS] == launches[PLAIN_CONTROL] == launches[TWIN_SCORED] == 0,
        **dense_route_checks(f"open {inst.name}", launches, GRID_NAMES),
    }


# what phase 24 leaves for open_references: the certifier's certificates
OPEN_RESULTS = {}


def open_certifier(dev) -> tuple:
    """Phase 24 (e): sdp_relaxation_bound on generate_spar(2100, 100, 1),
    capacity OPEN_CERT_CAPACITY, OPEN_CERT_ROUNDS plain eigencut round of
    FULL_LP on the dense route alone, whose kernels there are the open form
    without cuts; every certificate finite (open_references holds them to
    the Burer-Monteiro lb).  Returns (launch counts, checks)."""
    inst = generate_spar(*OPEN_PIECES)
    reset_launches()
    t0 = time.perf_counter()
    best, _, hist = sdp_relaxation_bound(inst, FULL_LP, max_rounds=OPEN_CERT_ROUNDS,
                                         capacity=OPEN_CERT_CAPACITY, max_cuts_per_round=48,
                                         device=dev)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    certs = np.array([h["bound"] for h in hist])
    lp_s, iters, us = lp_us(hist)
    OPEN_RESULTS["certificates"] = certs.tolist()
    log(f"[open certifier {inst.name}] certificates {certs.tolist()} in {wall:.3f}s, best "
        f"{best!r}; the LP {lp_s:.4f}s for {iters} iterations = {us:.2f} us a certifier LP "
        f"iteration ({SMI}); launches {launches}")
    return launches, {
        f"{OPEN_CERT_ROUNDS} rounds ran": len(hist) == OPEN_CERT_ROUNDS,
        "certificates finite": bool(np.isfinite(certs).all()),
        **dense_route_checks(f"open certifier {inst.name}", launches, GRID_NAMES),
    }


def open_refusal(dev) -> dict:
    """Phase 24 (f): n = OPEN_NMAX + 1, past the open form's 32-bit bound:
    the solve's set-up (the entry every solve goes through) refuses on the
    card with the route's reason for a pool of cuts and for the certifier's
    pool, before any allocation or launch."""
    n = OPEN_REFUSED
    c = torch.zeros(n, dtype=torch.float32, device=dev)
    checks = {}
    reset_launches()
    for pool in (empty_pool(CutConfig().capacity, 3, dev), empty_pool(1, 1, dev)):
        M, k = pool.idx.shape
        why = pdhg_kernel.route_refusal(n, M, k, 0)[1]
        try:
            pdhg_mod.solve_setup(c, pool, LPConfig())
            refused = None
        except ValueError as e:
            refused = str(e)
        log(f"[open] n = {n}, a pool of {M} x {k}, use_kernel='auto': {refused!r}")
        checks[f"n = {n} (M = {M}, k = {k}) refused with the route's reason"] = (
            refused is not None and why is not None and why in refused
            and f"n <= {pdhg_kernel.OPEN_NMAX}" in refused)
    checks["nothing launched"] = not any(v for key, v in launch_counts().items()
                                         if key not in (READS, SOLVES))
    return checks


def open_references(refs: "References") -> dict:
    """The end of phase 24, once the host references are in: every
    certificate of the certifier at n = 2100 at least the Burer-Monteiro lb
    (OPEN_BM's stages, computed on the host)."""
    r = refs.get()
    certs = np.array(OPEN_RESULTS["certificates"])
    log(f"[open] the certifier's certificates {certs.tolist()}, the Burer-Monteiro lb "
        f"{r['open_bm_lb']!r} ({OPEN_BM}, {r['open_bm_seconds']:.1f}s on the host)")
    return {f"every certificate of the certifier >= the BM lb {r['open_bm_lb']}":
            bool(np.isfinite(r["open_bm_lb"]) and (certs >= r["open_bm_lb"]).all())}


def open_phase(dev) -> dict:
    """Phase 24: the open form's kernels (open_kernels), K1 over a piece of
    C(4096, 3) (k1_piece_check), generate_spar(4096, 100, 1) by pieces
    (open_solve), round 0 at n = 2100 by pieces and on the whole table
    (open_pieces_vs_whole), the band at n = 3000 (open_band), the certifier
    at n = 2100 (open_certifier) and the refusal past the bound
    (open_refusal), each path's launches into PATH_LAUNCHES and into the
    form's kernel entries; open_references ends it at the end of the run.
    Returns open_kernels' numbers."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = open_kernels(dev)
    out["pair_score"] = k1_piece_check(dev)
    torch.cuda.empty_cache()
    paths = {"open boxqp n=4096": open_solve, "open boxqp n=2100": open_pieces_vs_whole,
             "open qcqp band n=3000": open_band, "open certifier n=2100": open_certifier}
    for path, run in paths.items():
        t1 = time.perf_counter()
        PATH_LAUNCHES[path], checks = run(dev)
        finish(path, checks)
        log(f"[open] {path} took {time.perf_counter() - t1:.1f}s")
    finish("open refusal", open_refusal(dev))
    for key in ("pdhg_grid", "pdhg_grid_check", "pdhg_grid_norm", "pair_score"):
        out[f"{key} launches"] = sum(PATH_LAUNCHES[p][key] for p in paths)
    out["seconds"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    log(f"[open] phase 24 took {out['seconds']:.1f}s ({SMI})")
    return out


# ---- phase 25: random, triangle and optimality by pieces of the table ------------------

PIECES_LP = LPConfig(max_iters=3000, tol=1e-5)   # phase 25's rounds (both routes share the LP)
PIECES_N = (1024, 100, 1)              # (a): forced pieces against the whole table
PIECES_FORCED = 1 << 25                # (a): rows a forced piece holds at most (6 of C(1024, 3))
OPT_FORCED = 5 * EIGH_CHUNK            # (b): optimality's forced pieces at n = 125 (8 of them)
TRIANGLE_OPEN = OPEN_PIECES            # (c): triangle on the default route past n = 2048
                                       # (cut from n = 4096 to keep the run under its limit)
RANDOM_OPEN = OPEN_PIECES              # (c): random on the default route past its threshold
RANDOM_MOST = 878_134                  # (c): a tenth of the 8,781,343 that tau's band alone kept


def strategy_cfg(strategy: str) -> RunConfig:
    return RunConfig(lp=PIECES_LP, scorer=ScorerConfig(strategy=strategy))


def route_round(inst, strategy: str, dev, pieces, cfg: RunConfig | None = None) -> dict:
    """Round 0 of CutSolver with ``strategy`` at PIECES_LP (or in ``cfg``)
    on the route ``pieces`` (the private _pieces: None the default, False
    the whole table, an int forced pieces), counters reset before and read
    after:
    the history, the cut rows (append_cuts's arguments), the picks (global
    indices: StreamedTopk's by pieces; on the whole table
    select_and_generate's, or the flat ones triangle's masked_topk takes),
    the scores handed to the selection (optimality), the pool, the
    generator's state, the host seconds the scores took (random: the draw
    and its upload), the card's peak above what was allocated before the
    solver, and the survivors' largest count."""
    rows, picks, scores, score_s = [], [], [], [0.0]
    patched = [(solver_mod, "append_cuts"), (solver_mod, "select_and_generate"),
               (triangle_mod, "masked_topk")]
    saved = [getattr(mod, name) for mod, name in patched]

    def keep_rows(pool, *r):
        rows.append([t.clone() for t in r])
        return saved[0](pool, *r)

    def keep_picks(*a):
        out = saved[1](*a)
        picks.append(out[1].clone())
        return out

    def keep_flat(*a):
        out = saved[2](*a)
        picks.append(out[1].clone())
        return out

    torch.cuda.synchronize()
    gc.collect()                  # an earlier solver (its _scores wrapper is a cycle)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for (mod, name), fn in zip(patched, (keep_rows, keep_picks, keep_flat)):
        setattr(mod, name, fn)
    try:
        solver = CutSolver(inst, cfg or strategy_cfg(strategy), device=dev, _pieces=pieces)
        method = solver._scores

        def timed_scores(x, X, table=None):
            t0 = time.perf_counter()
            out = method(x, X, table)
            score_s[0] += time.perf_counter() - t0
            if strategy == "optimality":      # kept to compare; a piece's scores else go
                scores.append(out)
            return out

        solver._scores = timed_scores
        reset_launches()
        t0 = time.perf_counter()
        hist = solver.run(rounds=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
    finally:
        for (mod, name), fn in zip(patched, saved):
            setattr(mod, name, fn)
    peak = torch.cuda.max_memory_allocated() - base
    sel = solver.last_selection
    out = {"hist": hist, "rows": rows[0], "launches": launches, "wall": wall, "peak": peak,
           "score_s": score_s[0], "generator": solver.generator.get_state(),
           "pool": [t.clone() for t in (solver.pool.idx, solver.pool.lin, solver.pool.quad,
                                        solver.pool.rhs, solver.pool.active)],
           "pieces": None if solver.pieces is None else len(solver.pieces),
           "picks": picks[0] if picks else sel.result()[1],
           "most": None if sel is None else sel.most, "x": solver.state.x.cpu().numpy()}
    if strategy == "optimality":
        out["scores"] = torch.cat(scores) if len(scores) > 1 else scores[0]
    del solver, scores, method, timed_scores
    gc.collect()
    torch.cuda.empty_cache()
    return out


def same_round(a: dict, b: dict) -> dict:
    """Two runs of route_round bit for bit: outcome, picks, cut rows, pool,
    the generator's state."""
    return {
        "the round's outcome": outcome(a["hist"]) == outcome(b["hist"]),
        "the picks": torch.equal(a["picks"], b["picks"]),
        "the cut rows": all(torch.equal(u, v) for u, v in zip(a["rows"], b["rows"])),
        "the pool": all(torch.equal(u, v) for u, v in zip(a["pool"], b["pool"])),
        "the generator's state": torch.equal(a["generator"], b["generator"]),
    }


def pieces_against_whole(dev) -> tuple:
    """Phase 25 (a): generate_spar(1024, 100, 1) (C(1024, 3) = 178,433,024
    rows) at PIECES_LP, round 0 of random and of triangle by pieces (forced:
    both take the whole table by default at n = 1024) and on the whole
    table: picks, cut rows, pool, outcome and generator's state bit for bit;
    each route's peak on the card a table row.  Returns ({path: launch
    counts}, checks, {strategy: bytes a row of each route})."""
    inst = generate_spar(*PIECES_N)
    T = math.comb(inst.n, 3)
    launches, checks, per_row = {}, {}, {}
    for strategy in ("random", "triangle"):
        pieced = route_round(inst, strategy, dev, PIECES_FORCED)
        whole = route_round(inst, strategy, dev, False)
        same = same_round(pieced, whole)
        per_row[strategy] = {"pieces": pieced["peak"] / T, "whole": whole["peak"] / T}
        launches[f"pieces {strategy} n={inst.n}"] = pieced["launches"]
        launches[f"pieces {strategy} n={inst.n} whole table"] = whole["launches"]
        floor = feasible_objective(inst, whole["x"])
        drawn = (f" (the draws and their uploads {pieced['score_s']:.3f}s, "
                 f"{whole['score_s']:.3f}s)" if strategy == "random" else "")
        log(f"[pieces {strategy} {inst.name}] round 0 by {pieced['pieces']} forced pieces and "
            f"on the whole table: bounds {pieced['hist'][0].bound!r}, {whole['hist'][0].bound!r} "
            f"(cuts {whole['hist'][0].cuts_added}, lp_iters {whole['hist'][0].lp_iters}); "
            f"{pieced['wall']:.3f}s and {whole['wall']:.3f}s{drawn}; the card's peak above the "
            f"set-up's start "
            f"{pieced['peak']} and {whole['peak']} bytes = {pieced['peak'] / T:.2f} and "
            f"{whole['peak'] / T:.2f} B a table row; the survivors' largest count "
            f"{pieced['most']}; picks {pieced['picks'].tolist()}; {same}; a feasible point's f "
            f"{floor!r} ({SMI})")
        checks.update({f"{strategy}: {k} by pieces are the whole table's, bit for bit": v
                       for k, v in same.items()})
        checks[f"{strategy}: the whole route holds the table, the pieces do not"] = (
            whole["pieces"] is None and pieced["pieces"] > 1)
        checks[f"{strategy}: the certificate >= a feasible point's f {floor}"] = bool(
            np.isfinite(whole["hist"][0].certificate) and whole["hist"][0].certificate >= floor)
        for path in (f"pieces {strategy} n={inst.n}", f"pieces {strategy} n={inst.n} whole table"):
            checks.update({f"{path}: {k}": v for k, v in
                           dense_route_checks(path, launches[path], GRID_NAMES).items()})
    return launches, checks, per_row


def optimality_pieces(dev) -> tuple:
    """Phase 25 (b): optimality on spar125-100-1 at PIECES_LP, round 0 by 8
    forced pieces of OPT_FORCED rows (whole eigh chunks) against the whole
    table: the ADMM's scores, the picks, the cut rows and the round bit for
    bit; then a quarter and a whole default-size piece (OPTIMALITY_PIECE_ROWS
    rows) of C(1024, 3) through the ADMM at a random point: each one's time
    by events, the card's peak above its start (bytes a row, and from the
    two, what grows with the rows and what does not), its scores finite and
    >= 0, and a round's time at n = 1024 and 4096 by rows.  Returns (launch
    counts, checks, numbers)."""
    inst = parse_boxqp(os.path.join(DATA, f"{INSTANCE}.in"), name=INSTANCE)
    pieced = route_round(inst, "optimality", dev, OPT_FORCED)
    whole = route_round(inst, "optimality", dev, False)
    same = same_round(pieced, whole)
    same["the ADMM's scores"] = torch.equal(pieced["scores"], whole["scores"])
    log(f"[pieces optimality {inst.name}] round 0 by {pieced['pieces']} forced pieces and on "
        f"the whole table: bounds {pieced['hist'][0].bound!r}, {whole['hist'][0].bound!r} "
        f"(cuts {whole['hist'][0].cuts_added}); {pieced['wall']:.3f}s and {whole['wall']:.3f}s "
        f"(the ADMM {pieced['score_s']:.3f}s, {whole['score_s']:.3f}s); the card's peak above "
        f"the set-up's start {pieced['peak']} and {whole['peak']} bytes = "
        f"{whole['peak'] / whole['scores'].numel():.1f} B a table row on the whole table; blocks "
        f"that improve {int((whole['scores'] > 0).sum())}; the survivors' largest count "
        f"{pieced['most']}; {same} ({SMI})")
    checks = {f"optimality: {k} by pieces are the whole table's, bit for bit": v
              for k, v in same.items()}
    checks.update({f"optimality n=125: {k}": v for k, v in
                   control_checks("pieces optimality", pieced["launches"]).items()})
    big = generate_spar(*PIECES_N)
    x, X, Q = scoring_point(big, dev)
    fn, numbers = exact_score_fn(Q), {}
    for R in (solver_mod.OPTIMALITY_PIECE_ROWS // 4, solver_mod.OPTIMALITY_PIECE_ROWS):
        rows, got = combinations_range_on(big.n, 3, 0, R, dev), []
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: got.append(fn(x, X, rows=rows)), reps=1, warmup=0)
        peak = torch.cuda.max_memory_allocated() - base
        sc = got[0]
        numbers[R] = {"ms": ms, "peak": peak, "round_s n=1024": ms * math.comb(1024, 3) / R / 1e3,
                      "round_s n=4096": ms * math.comb(4096, 3) / R / 1e3}
        log(f"[pieces optimality {big.name}] a piece of {R} rows through the ADMM (300 "
            f"iterations, {EIGH_CHUNK} blocks an eigh call): {ms:.2f} ms by events, the card's "
            f"peak above its start {peak} bytes = {peak / R:.1f} B a row; {int((sc > 0).sum())} "
            f"blocks improve; a round's ADMM by rows at n = 1024 "
            f"{numbers[R]['round_s n=1024']:.1f}s, at n = 4096 {numbers[R]['round_s n=4096']:.1f}s "
            f"({SMI})")
        checks[f"the ADMM's piece of {R} rows: scores finite and >= 0"] = bool(
            torch.isfinite(sc).all() and (sc >= 0).all())
        del got, sc, rows
    (r0, a), (r1, b) = numbers.items()
    per_row = (b["peak"] - a["peak"]) / (r1 - r0)
    log(f"[pieces optimality {big.name}] the ADMM's peak by rows: {per_row:.1f} B a row and "
        f"{a['peak'] - per_row * r0:.0f} bytes fixed ({SMI})")
    torch.cuda.empty_cache()
    return pieced["launches"], checks, numbers


def pieces_past_2048(dev) -> tuple:
    """Phase 25 (c): the default route past n = 2048 at PIECES_LP, each run
    twice from a fresh solver, bit for bit: triangle (its streamed flat
    selection over 4 C(2100, 3) = 6,165,182,800 candidates) and random (one
    CPU draw a piece) on generate_spar(2100, 100, 1); the certificate at
    least a feasible point's objective; the seconds, the host draw's, the
    card's peak and the survivors' largest count printed.  Returns ({path:
    launch counts}, checks, numbers)."""
    launches, checks, numbers = {}, {}, {}
    for strategy, shape in (("triangle", TRIANGLE_OPEN), ("random", RANDOM_OPEN)):
        inst = generate_spar(*shape)
        first = route_round(inst, strategy, dev, None)
        again = route_round(inst, strategy, dev, None)
        same = same_round(first, again)
        path = f"pieces {strategy} n={inst.n}"
        launches[path] = first["launches"]
        cert = first["hist"][0].certificate
        floor = feasible_objective(inst, first["x"])
        rows = math.comb(inst.n, 3)
        numbers[strategy] = {"n": inst.n, "seconds": first["wall"], "score_s": first["score_s"],
                             "peak": first["peak"], "most": first["most"],
                             "pieces": first["pieces"]}
        drawn = (f" (the host draw and its upload {first['score_s']:.3f}s = "
                 f"{first['score_s'] / rows * 1e9:.3f} ns a row)" if strategy == "random" else "")
        log(f"[{path}] the default route: {first['pieces']} pieces; round 0 in "
            f"{first['wall']:.3f}s and {again['wall']:.3f}s{drawn}; bound {first['hist'][0].bound!r} "
            f"(cuts {first['hist'][0].cuts_added}, lp_iters {first['hist'][0].lp_iters}); the "
            f"card's peak above the set-up's start {first['peak']} bytes "
            f"({first['peak'] / 2 ** 30:.2f} GiB); the survivors' largest count "
            f"{first['most']}; a second run {same}; a feasible point's f {floor!r} ({SMI})")
        checks.update({f"{strategy} n={inst.n}: a second run repeats {k}": v
                       for k, v in same.items()})
        checks[f"{strategy} n={inst.n}: by pieces by default"] = first["pieces"] is not None
        if strategy == "random":
            checks[f"random n={inst.n}: the survivors' largest count <= {RANDOM_MOST}"] = (
                first["most"] <= RANDOM_MOST)
        checks[f"{strategy} n={inst.n}: the certificate >= a feasible point's f {floor}"] = bool(
            np.isfinite(cert) and cert >= floor)
        checks.update({f"{path}: {k}": v for k, v in
                       dense_route_checks(path, launches[path], GRID_NAMES).items()})
    return launches, checks, numbers


def pieces_phase(dev) -> dict:
    """Phase 25: random, triangle and optimality at k = 3 by pieces of the
    candidate table (pieces_against_whole, optimality_pieces,
    pieces_past_2048), each path's launches into PATH_LAUNCHES.  Returns
    the numbers it measured."""
    t0 = time.perf_counter()
    out = {}
    for name, run in (("against the whole table", pieces_against_whole),
                      ("optimality", optimality_pieces), ("past n = 2048", pieces_past_2048)):
        t1 = time.perf_counter()
        launches, checks, out[name] = run(dev)
        if name == "optimality":
            PATH_LAUNCHES["pieces optimality n=125"] = launches
        else:
            PATH_LAUNCHES.update(launches)
        finish(f"pieces {name}", checks)
        log(f"[pieces] {name} took {time.perf_counter() - t1:.1f}s")
    out["seconds"] = time.perf_counter() - t0
    log(f"[pieces] phase 25 took {out['seconds']:.1f}s ({SMI})")
    return out


# ---- phase 26: BoxQP at k = 4 and 5 by pieces of the table ----------------------------

KPIECES_WHOLE = ((4, "neural", (200, 100, 1)), (4, "random", (200, 100, 1)),
                 (5, "neural", (80, 100, 1)), (5, "random", (80, 100, 1)))
                                       # (a): forced pieces against the whole table
KPIECES_FORCED = 1 << 24               # (a): rows a forced piece holds (4 of C(200, 4))
KOPT_CHUNK = 1024                      # (a): optimality's eigh chunk at spar020, k = 4
KOPT_FORCED = 2 * KOPT_CHUNK           # (a): its forced pieces, whole chunks (3 of C(20, 4))
KADMM_ROWS = (1 << 14, 1 << 16)        # (a): ADMM pieces at k = 4, 5: its bytes a row
KPIECES_DEFAULT = ((4, (512, 100, 1)), (5, (200, 100, 1)))   # (b): the default route
KPIECES_MOST = 1 << 20                 # (b): the survivors' largest count stays under it
KPIECES_PEAK = 10 * 10 ** 9            # (b): the card's peak above the set-up at n = 512, k = 4
K4_WINDOW = 1 << 16                    # rows of a K4 piece held to the twin, at each end


def kcfg(k: int, strategy: str) -> RunConfig:
    """Phase 26's rounds: PIECES_LP, CutConfig(k=k) (sel_size 10 at k = 5)."""
    return RunConfig(lp=PIECES_LP, cuts=CutConfig(k=k, sel_size=10 if k == 5 else 20),
                     scorer=ScorerConfig(strategy=strategy))


def solve_route_checks(path: str, launches: dict, n: int, k: int) -> dict:
    """The LP's route at n, k with the default pool: K2 (its control,
    control_checks) or the grid route (dense_route_checks)."""
    if pdhg_kernel.route_refusal(n, CutConfig().capacity, k, 0)[0] == "k2":
        return control_checks(path, launches)
    return dense_route_checks(path, launches, GRID_NAMES)


def k4_launches(rows: int, k: int) -> int:
    """K4's launches over ``rows`` candidates of width k (launch_ranges)."""
    return len(launch_ranges(rows, k * (k + 1) // 2))


def kpieces_against_whole(dev) -> tuple:
    """Phase 26 (a): round 0 at k = 4 (neural, random) on
    generate_spar(200, 100, 1) (64,684,950 rows) and at k = 5 (neural) on
    generate_spar(80, 100, 1) (24,040,016 rows), by forced pieces of
    KPIECES_FORCED rows and on the whole table: picks, cut rows, pool,
    outcome and generator's state bit for bit, each route's peak a table
    row, K4 once a piece; k = 4 optimality on spar020-100-1 (eigh chunks of
    KOPT_CHUNK blocks) by pieces of two chunks against the whole table, its
    scores too; the ADMM's peak a row at k = 4 and 5 from pieces of
    KADMM_ROWS rows.  Returns ({path: launch counts}, checks, numbers)."""
    launches, checks, numbers = {}, {}, {}
    for k, strategy, shape in KPIECES_WHOLE:
        inst = generate_spar(*shape)
        T, cfg = math.comb(inst.n, k), kcfg(k, strategy)
        pieced = route_round(inst, strategy, dev, KPIECES_FORCED, cfg)
        whole = route_round(inst, strategy, dev, False, cfg)
        same = same_round(pieced, whole)
        path = f"kpieces {strategy} k={k} n={inst.n}"
        launches[path], launches[f"{path} whole table"] = pieced["launches"], whole["launches"]
        numbers[path] = {"rows": T, "pieces B a row": pieced["peak"] / T,
                         "whole B a row": whole["peak"] / T, "pieces s": pieced["wall"],
                         "whole s": whole["wall"], "pieces": pieced["pieces"]}
        floor = feasible_objective(inst, whole["x"])
        log(f"[{path}] round 0 by {pieced['pieces']} forced pieces and on the whole table: "
            f"bounds {pieced['hist'][0].bound!r}, {whole['hist'][0].bound!r} (cuts "
            f"{whole['hist'][0].cuts_added}, lp_iters {whole['hist'][0].lp_iters}); "
            f"{pieced['wall']:.3f}s and {whole['wall']:.3f}s; the card's peak above the "
            f"set-up's start {pieced['peak']} and {whole['peak']} bytes = "
            f"{pieced['peak'] / T:.2f} and {whole['peak'] / T:.2f} B a table row; the "
            f"survivors' largest count {pieced['most']}; K4 launches {pieced['launches']['fused_score']}"
            f" and {whole['launches']['fused_score']}; {same}; a feasible point's f {floor!r} "
            f"({SMI})")
        tag = f"k={k} {strategy}"
        checks.update({f"{tag}: {key} by pieces are the whole table's, bit for bit": v
                       for key, v in same.items()})
        checks[f"{tag}: the whole route holds the table, the pieces do not"] = (
            whole["pieces"] is None and pieced["pieces"] == -(-T // KPIECES_FORCED) > 1)
        checks[f"{tag}: the certificate >= a feasible point's f {floor}"] = bool(
            np.isfinite(whole["hist"][0].certificate) and whole["hist"][0].certificate >= floor)
        scored = strategy == "neural"
        checks[f"{tag}: K4 once a piece, and over the whole table in its launches"] = (
            pieced["launches"]["fused_score"] == (pieced["pieces"] if scored else 0)
            and whole["launches"]["fused_score"] == (k4_launches(T, k) if scored else 0)
            and pieced["launches"][TWIN_SCORED] == whole["launches"][TWIN_SCORED] == 0)
        for p in (path, f"{path} whole table"):
            checks.update({f"{p}: {key}": v for key, v in
                           solve_route_checks(p, launches[p], inst.n, k).items()})
    # optimality at k = 4: pieces of whole (patched) eigh chunks
    inst = parse_boxqp(os.path.join(DATA, "spar020-100-1.in"), name="spar020-100-1")
    chunk, labels_mod.EIGH_CHUNK = labels_mod.EIGH_CHUNK, KOPT_CHUNK
    try:
        pieced = route_round(inst, "optimality", dev, KOPT_FORCED, kcfg(4, "optimality"))
        whole = route_round(inst, "optimality", dev, False, kcfg(4, "optimality"))
    finally:
        labels_mod.EIGH_CHUNK = chunk
    same = same_round(pieced, whole)
    same["the ADMM's scores"] = torch.equal(pieced["scores"], whole["scores"])
    path = "kpieces optimality k=4 n=20"
    launches[path] = pieced["launches"]
    log(f"[{path}] round 0 by {pieced['pieces']} forced pieces (eigh chunks of {KOPT_CHUNK}) "
        f"and on the whole table: bounds {pieced['hist'][0].bound!r}, "
        f"{whole['hist'][0].bound!r} (cuts {whole['hist'][0].cuts_added}); "
        f"{pieced['wall']:.3f}s and {whole['wall']:.3f}s; {same} ({SMI})")
    checks.update({f"k=4 optimality: {key} by pieces are the whole table's, bit for bit": v
                   for key, v in same.items()})
    checks.update({f"{path}: {key}": v for key, v in control_checks(path, pieced["launches"]).items()})
    # the ADMM's bytes a row at k = 4 and 5
    for k, shape in ((4, (200, 100, 1)), (5, (80, 100, 1))):
        big = generate_spar(*shape)
        x, X, Q = scoring_point(big, dev)
        fn, peaks = exact_score_fn(Q), []
        for R in KADMM_ROWS:
            rows, got = combinations_range_on(big.n, k, 0, R, dev), []
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: got.append(fn(x, X, rows=rows)), reps=1, warmup=0)
            peaks.append(torch.cuda.max_memory_allocated() - base)
            checks[f"k={k}: the ADMM's piece of {R} rows: scores finite and >= 0"] = bool(
                torch.isfinite(got[0]).all() and (got[0] >= 0).all())
            log(f"[kpieces optimality k={k} {big.name}] a piece of {R} rows through the ADMM: "
                f"{ms:.2f} ms by events, the card's peak above its start {peaks[-1]} bytes ({SMI})")
            del rows, got
        (r0, r1), (p0, p1) = KADMM_ROWS, peaks
        per_row = (p1 - p0) / (r1 - r0)
        numbers[f"optimality k={k}"] = {"B a row": per_row, "fixed": p0 - per_row * r0,
                                        "ms a row": ms / r1}
        log(f"[kpieces optimality k={k}] the ADMM's peak by rows: {per_row:.1f} B a row and "
            f"{p0 - per_row * r0:.0f} bytes fixed; {ms / r1 * 1e3:.3f} us a row ({SMI})")
    torch.cuda.empty_cache()
    return launches, checks, numbers


def k4_piece_check(inst, k: int, dev) -> dict:
    """K4 over the default route's piece that starts at row 2^31 of
    C(n, k) (PIECE_ROWS_WIDE[k] rows, written on the card from the pair
    table, its features by candidate_q_features) at the scoring point,
    neural's sweeps: the first and last K4_WINDOW rows against the twin
    (feas atol 5e-4 as check_fused_score; nn rtol = atol = 2e-4, as K1 over
    its pieces, k1_piece_check: over 131,072 random rows the tensor cores'
    truncated sums (nn_precision.py) reach 1.2 times check_fused_score's
    atol 2e-5 at k = 5, printed beside), two calls bit for bit, its time by
    events beside the bound, and the rows' and features' times."""
    x, X, Q = scoring_point(inst, dev)
    R = solver_mod.PIECE_ROWS_WIDE[k]
    start = 1 << 31 if math.comb(inst.n, k) >= (1 << 31) + R else 0
    pairs = combinations_table_on(inst.n, 2, dev)
    rows_ms = cuda_ms(lambda: combinations_range_on(inst.n, k, start, start + R, dev, pairs),
                      reps=2, warmup=1)
    table = combinations_range_on(inst.n, k, start, start + R, dev, pairs)
    feat_ms = cuda_ms(lambda: candidate_q_features(Q, table), reps=2, warmup=1)
    triQ, scale = candidate_q_features(Q, table)
    mlp = MLPScorer(load_params(k), dev)
    before = fused_score.launches
    nn_k, feas_k = fused_score(x, X, table, triQ, scale, mlp, SWEEPS)
    launched = fused_score.launches - before
    again = fused_score(x, X, table, triQ, scale, mlp, SWEEPS)
    repeat = torch.equal(nn_k, again[0]) and torch.equal(feas_k, again[1])
    del again
    windows, errs = [(0, K4_WINDOW), (R - K4_WINDOW, R)], []

    def twin_pass():
        for s, e in windows:
            nn_p, feas_p = fused_score_plain(x, X, table[s:e], triQ[s:e], scale[s:e], mlp, SWEEPS)
            errs.append((*excess(feas_k[s:e], feas_p, 0.0, 5e-4),
                         *excess(nn_k[s:e], nn_p, 2e-4, 2e-4),
                         excess(nn_k[s:e], nn_p, 2e-4, 2e-5)[1]))

    plain_ms = cuda_ms(twin_pass, reps=1, warmup=0)
    worst = max(max(e[0], e[2]) for e in errs)
    ratio = max(max(e[1], e[3]) for e in errs)
    small_atol = max(e[4] for e in errs)
    moved = nbytes(x, X, table, triQ, scale, nn_k, feas_k) + mlp_bytes(mlp)
    del nn_k, feas_k
    ms = cuda_ms(lambda: fused_score(x, X, table, triQ, scale, mlp, SWEEPS), reps=3, warmup=1)
    b, parts = scoring_bound(R, moved, ms, k, SWEEPS)
    log(f"[kpieces fused_score k={k} {inst.name}] the piece at row {start}: {R} rows written on "
        f"the card in {rows_ms:.3f} ms, their features in {feat_ms:.3f} ms; {launched} "
        f"launches: max|err| {worst:.3e}, {ratio:.3f} of the limit (feas atol 5e-4, nn rtol "
        f"= atol = 2e-4, K1's piece tolerance: the same tensor-core body; {small_atol:.3f} of "
        f"nn rtol 2e-4 / atol 2e-5) over the rows {windows}; two calls bit for bit: {repeat}; "
        f"{ms:.4f} ms by events ({R / ms / 1e3:.1f} M cand/s); the twin on {2 * K4_WINDOW} rows "
        f"{plain_ms:.4f} ms; {share(ms, b)}; {parts} ({SMI})")
    if ratio > 1.0 or not repeat or launched != k4_launches(R, k):
        raise AssertionError(f"K4 over a piece of C({inst.n}, {k}) disagrees with its twin or "
                             f"does not repeat")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "plain_rows": 2 * K4_WINDOW,
            "candidates": R, "rows_ms": rows_ms, "features_ms": feat_ms,
            "of the limit": ratio, "of nn atol 2e-5": small_atol, **b}


def kpieces_default(dev) -> tuple:
    """Phase 26 (b): the default route at k = 4 on generate_spar(512, 100, 1)
    (2,829,877,120 rows, past 2^31) and at k = 5 on generate_spar(200, 100,
    1) (2,535,650,040 rows), neural, round 0 twice from a fresh solver bit
    for bit; the certificate at least a feasible point's objective; K4 once
    a piece; the survivors' largest count under KPIECES_MOST; the card's
    peak (at k = 4 under KPIECES_PEAK); K4 over a piece against its twin,
    timed (k4_piece_check).  Returns ({path: launch counts}, checks,
    numbers, {k: the piece check})."""
    launches, checks, numbers, k4 = {}, {}, {}, {}
    for k, shape in KPIECES_DEFAULT:
        inst = generate_spar(*shape)
        k4[k] = k4_piece_check(inst, k, dev)
        torch.cuda.empty_cache()
        first = route_round(inst, "neural", dev, None, kcfg(k, "neural"))
        again = route_round(inst, "neural", dev, None, kcfg(k, "neural"))
        same = same_round(first, again)
        path = f"kpieces neural k={k} n={inst.n}"
        launches[path] = first["launches"]
        cert, rows = first["hist"][0].certificate, math.comb(inst.n, k)
        floor = feasible_objective(inst, first["x"])
        numbers[path] = {"rows": rows, "pieces": first["pieces"], "seconds": first["wall"],
                         "again": again["wall"], "peak": first["peak"], "most": first["most"],
                         "s a piece": first["wall"] / first["pieces"]}
        log(f"[{path}] the default route: {first['pieces']} pieces of "
            f"{solver_mod.PIECE_ROWS_WIDE[k]} rows over {rows}; round 0 in {first['wall']:.3f}s "
            f"and {again['wall']:.3f}s = {first['wall'] / first['pieces'] * 1e3:.1f} ms a piece "
            f"(K4 {k4[k]['ms']:.2f}, its rows {k4[k]['rows_ms']:.2f}, their features "
            f"{k4[k]['features_ms']:.2f} ms a piece); bound {first['hist'][0].bound!r} (cuts "
            f"{first['hist'][0].cuts_added}, lp_iters {first['hist'][0].lp_iters}); the card's "
            f"peak above the set-up's start {first['peak']} bytes "
            f"({first['peak'] / 2 ** 30:.2f} GiB); the survivors' largest count "
            f"{first['most']}; K4 launches {first['launches']['fused_score']}; a second run "
            f"{same}; a feasible point's f {floor!r} ({SMI})")
        tag = f"k={k} n={inst.n}"
        checks.update({f"{tag}: a second run repeats {key}": v for key, v in same.items()})
        checks[f"{tag}: by pieces by default"] = first["pieces"] == -(
            -rows // solver_mod.PIECE_ROWS_WIDE[k])
        checks[f"{tag}: the certificate >= a feasible point's f {floor}"] = bool(
            np.isfinite(cert) and cert >= floor)
        checks[f"{tag}: K4 once a piece, no twin"] = (
            first["launches"]["fused_score"] == first["pieces"]
            and first["launches"][TWIN_SCORED] == 0)
        checks[f"{tag}: the survivors' largest count under {KPIECES_MOST}"] = (
            0 < first["most"] < KPIECES_MOST)
        if k == 4:
            checks[f"{tag}: the card's peak above the set-up under {KPIECES_PEAK} bytes"] = (
                first["peak"] < KPIECES_PEAK)
        checks.update({f"{path}: {key}": v for key, v in
                       solve_route_checks(path, launches[path], inst.n, k).items()})
        del first, again
        torch.cuda.empty_cache()
    return launches, checks, numbers, k4


def kpieces_registry(dev) -> tuple:
    """Phase 26 (c): spar125-100-1 at k = 5, sel_size 10, neural, round 0
    by the route its threshold picks (C(125, 5) = 234,531,275 rows), at the
    BoxQP main path's LP (BOXQP_LP: at PIECES_LP round 0's LP stops 1.07%
    above McCormick, the LP's accuracy, not the route's): round 0 within
    1e-2 of McCormick, the certificate at least the best known objective.
    Returns (launch counts, checks, numbers)."""
    inst = parse_boxqp(os.path.join(DATA, f"{INSTANCE}.in"), name=INSTANCE)
    reg = registry("boxqp", INSTANCE)
    k = 5
    run = route_round(inst, "neural", dev, None,
                      dataclasses.replace(kcfg(k, "neural"), lp=BOXQP_LP))
    h = run["hist"][0]
    rows = math.comb(inst.n, k)
    pieced = inst.n > solver_mod.PIECE_N_OF["neural", k]
    rel0 = (h.bound - reg["mc"]) / abs(reg["mc"])
    path = f"kpieces neural k=5 {INSTANCE}"
    log(f"[{path}] the route its threshold ({solver_mod.PIECE_N_OF['neural', k]}) picks: "
        f"{run['pieces']} pieces over {rows} rows; round 0 in {run['wall']:.3f}s: bound "
        f"{h.bound!r} certificate {h.certificate!r} (cuts {h.cuts_added}, lp_iters "
        f"{h.lp_iters}); McCormick {reg['mc']!r}: rel {rel0!r}; best known {reg['floor']!r}; "
        f"the card's peak above the set-up's start {run['peak']} bytes; the survivors' largest "
        f"count {run['most']} ({SMI})")
    checks = {
        "by the route the threshold picks": (run["pieces"] is not None) == pieced,
        "round 0 within 1e-2 of McCormick": bool(abs(rel0) <= 1e-2),
        f"the certificate >= the best known {reg['floor']}": bool(
            np.isfinite(h.certificate) and h.certificate >= reg["floor"]),
        "K4 launched, no twin": (run["launches"]["fused_score"]
                                 == (run["pieces"] if pieced else k4_launches(rows, k))
                                 and run["launches"][TWIN_SCORED] == 0),
        **solve_route_checks(path, run["launches"], inst.n, k),
    }
    return {path: run["launches"]}, checks, {"seconds": run["wall"], "pieces": run["pieces"],
                                              "peak": run["peak"], "most": run["most"]}


def kpieces_phase(dev) -> dict:
    """Phase 26: BoxQP at k = 4 and 5 by pieces of the candidate table
    (kpieces_against_whole, kpieces_default, kpieces_registry), each path's
    launches into PATH_LAUNCHES.  Returns the numbers it measured, K4's
    piece checks under "fused_score"."""
    t0 = time.perf_counter()
    out = {}
    for name, run in (("against the whole table", kpieces_against_whole),
                      ("the default route", kpieces_default),
                      ("spar125-100-1 at k = 5", kpieces_registry)):
        t1 = time.perf_counter()
        launches, checks, out[name], *k4 = run(dev)
        if k4:
            out["fused_score"] = k4[0]
        PATH_LAUNCHES.update(launches)
        finish(f"kpieces {name}", checks)
        log(f"[kpieces] {name} took {time.perf_counter() - t1:.1f}s")
    out["seconds"] = time.perf_counter() - t0
    log(f"[kpieces] phase 26 took {out['seconds']:.1f}s ({SMI})")
    return out


BPIECES_B = 4                          # instances a batch: generate_spar(n, 100, s + 1), s < 4
BPIECES_WHOLE = ((3, 512), (4, 80), (5, 40))   # (a): forced pieces against the whole route
BPIECES_CANDS = (1, 3)                 # (a): the meshes' cand (C(512, 3) leaves 2 padded rows)
BPIECES_FORCED = {3: 3_000_001, 4: 200_003, 5: 100_003}   # (a): rows a forced piece holds
BPIECES_OPEN = 2100                    # (b): k = 3 past the table's memory, no table written
BPIECES_K4 = 200                       # (c): k = 4, 4 x C(200, 4) rows past the whole route
K4_RANDOM_ROWS = 1 << 17               # (d): random rows of C(200, k), k = 2..5


def bpieces_insts(n: int) -> list:
    return [generate_spar(n, 100, s + 1) for s in range(BPIECES_B)]


def bpiece_count(table, cand: int, P: int) -> int:
    """The pieces of at most P rows a round takes over a one-process table:
    each shard's runs between multiples of P."""
    per = table.shape[0] // cand
    return sum(-(-(lo + per) // P) - lo // P for lo in range(0, table.shape[0], per))


def bround(insts, k: int, strategy: str, mesh, table, valid, pieces, dev) -> dict:
    """Round 0 of ``insts`` from a fresh batched state (capacity 1024,
    BATCH_KNOBS at ``strategy``, kmax k) on ``table`` by the route
    ``pieces`` (the step's private _pieces: None the default, False the
    whole route, an int forced pieces), counters reset before and read
    after: the state, the picks, the cut rows (append_cuts' arguments), the
    generators' states, the launches, the seconds and the card's peak above
    what was allocated before the step."""
    picks, rows = [], []
    select, append = round_mod._Round.select, rb.append_cuts

    def keep_picks(self, *a):
        out = select(self, *a)
        picks.append([t.clone() for t in out])
        return out

    def keep_rows(pool, *r):
        rows.append([t.clone() for t in r])
        return append(pool, *r)

    state = init_batched_state(np.stack([i.Q for i in insts]), np.stack([i.c for i in insts]),
                               1024, k, device=dev)
    step = make_sharded_round_step(mesh, **{**BATCH_KNOBS, "strategy": strategy}, kmax=k,
                                   _pieces=pieces)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    round_mod._Round.select, rb.append_cuts = keep_picks, keep_rows
    try:
        reset_launches()
        t0 = time.perf_counter()
        state, info = step(state, table, valid)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
    finally:
        round_mod._Round.select, rb.append_cuts = select, append
    return {"state": state, "picks": picks[0], "rows": rows[0], "launches": launches,
            "gens": [g.get_state() for g in state.generators], "wall": wall,
            "peak": torch.cuda.max_memory_allocated() - base, "lp_iters": info["lp_iters"]}


def same_bround(a: dict, b: dict) -> dict:
    """Two runs of bround bit for bit."""
    return {
        "the picks": all(torch.equal(u, v) for u, v in zip(a["picks"], b["picks"])),
        "the cut rows": all(torch.equal(u, v) for u, v in zip(a["rows"], b["rows"])),
        "the pools, PDHG states and f32 bounds": batched_states_equal(a["state"], b["state"]),
        "the generators' states": all(torch.equal(u, v) for u, v in zip(a["gens"], b["gens"])),
    }


def bpieces_against_whole(dev) -> tuple:
    """Phase 27 (a): round 0 of 4 x generate_spar(512, 100, s + 1) at k = 3,
    4 x spar80 at k = 4 and 4 x spar40 at k = 5, neural and random, at mesh
    cand 1 and 3, by forced pieces (BPIECES_FORCED rows: shard edges fall
    inside pieces, C(512, 3) leaves a padded row in the last of 3 shards)
    and on the whole batched route: picks, cut rows, pools, PDHG states,
    f32 bounds and generators' states bit for bit; K1 or K4 once an
    instance a piece; each route's peak an instance-row.  Returns ({path:
    launch counts}, checks, numbers)."""
    launches, checks, numbers = {}, {}, {}
    for k, n in BPIECES_WHOLE:
        insts = bpieces_insts(n)
        scorer = "pair_score" if k == 3 else "fused_score"
        for cand in BPIECES_CANDS:
            mesh = make_mesh(1, cand)
            table, valid = shard_combinations(n, k, mesh, device=dev)
            per = table.shape[0] // cand
            rows = BPIECES_B * table.shape[0]
            for strategy in ("neural", "random"):
                P = BPIECES_FORCED[k]
                pieced = bround(insts, k, strategy, mesh, table, valid, P, dev)
                whole = bround(insts, k, strategy, mesh, table, valid, False, dev)
                same = same_bround(pieced, whole)
                path = f"bpieces {strategy} k={k} n={n} cand={cand}"
                launches[path] = pieced["launches"]
                launches[f"{path} whole route"] = whole["launches"]
                count = bpiece_count(table, cand, P)
                numbers[path] = {"instance-rows": rows, "pieces": count,
                                 "pieces B an instance-row": pieced["peak"] / rows,
                                 "whole B an instance-row": whole["peak"] / rows,
                                 "pieces s": pieced["wall"], "whole s": whole["wall"]}
                log(f"[{path}] round 0 by {count} forced pieces of <= {P} rows and on the whole "
                    f"route ({BPIECES_B} x {table.shape[0]} rows, {cand} shards of {per}): "
                    f"f32 bounds {pieced['state'].bound.tolist()} and "
                    f"{whole['state'].bound.tolist()}; lp_iters {whole['lp_iters'].tolist()}; "
                    f"{pieced['wall']:.3f}s and {whole['wall']:.3f}s; the card's peak above the "
                    f"step's start {pieced['peak']} and {whole['peak']} bytes = "
                    f"{pieced['peak'] / rows:.2f} and {whole['peak'] / rows:.2f} B an "
                    f"instance-row; {scorer} launches {pieced['launches'][scorer]} and "
                    f"{whole['launches'][scorer]}; {same} ({SMI})")
                tag = f"k={k} {strategy} cand={cand}"
                checks.update({f"{tag}: {key} by pieces are the whole route's, bit for bit": v
                               for key, v in same.items()})
                scored = strategy != "random"
                whole_launches = sum(k4_launches(per, k) for _ in range(cand)) if k != 3 else cand
                checks[f"{tag}: {scorer} once an instance a piece, and a shard on the whole "
                       f"route"] = (
                    pieced["launches"][scorer] == (BPIECES_B * count if scored else 0)
                    and whole["launches"][scorer] == (BPIECES_B * whole_launches if scored else 0)
                    and pieced["launches"][TWIN_SCORED] == whole["launches"][TWIN_SCORED] == 0)
                for p in (path, f"{path} whole route"):
                    checks.update({f"{p}: {key}": v for key, v in
                                   solve_route_checks(p, launches[p], n, k).items()})
                del pieced, whole
            del table, valid
    torch.cuda.empty_cache()
    return launches, checks, numbers


def piece_split(state, k: int, table, valid, dev) -> dict:
    """The first piece of the default route at the point ``state`` holds
    (round 0's), timed by events: its rows written (a CombinationShards) or
    viewed, the instances' scores (K1, or each instance's features then
    K4), the running top-k's merge (these launches are not counted on any
    path)."""
    rnd = round_mod._build_round(make_mesh(1, 1), None, BATCH_KNOBS["lp_iters"],
                                 BATCH_KNOBS["sel_size"], None, "neural", None, 0, k, False, None)
    rnd.mlp = rnd.mlp.to(dev)
    x, X = state.pdhg.x, state.pdhg.X
    P = rnd.piece_rows(table, x.shape[0])
    _, get = rnd.spans(table, valid, dev)
    rows_ms = cuda_ms(lambda: get(0, P), reps=2, warmup=1)
    rows, ok = get(0, P)
    score_ms = cuda_ms(lambda: rnd.scores(state, x, X, rows, []), reps=2, warmup=1)
    scores = rnd.scores(state, x, X, rows, [])
    top = RunningTopk(BATCH_KNOBS["sel_size"])
    top.add(scores, ok, rows, 0)
    merge_ms = cuda_ms(lambda: top.add(scores, ok, rows, P), reps=2, warmup=1)
    return {"rows": P, "rows_ms": rows_ms, "score_ms": score_ms, "merge_ms": merge_ms}


def bpieces_default(dev) -> tuple:
    """Phase 27 (b) and (c): the default route past the table's memory,
    neural, round 0 twice from fresh states bit for bit: (b) 4 x
    generate_spar(2100, 100, s + 1) at k = 3 (4 x 1,541,295,700
    instance-rows; shard_combinations writes no table, the LP on the grid
    route's open form); (c) 4 x generate_spar(200, 100, s + 1) at k = 4 (4
    x 64,684,950; the written table scored by pieces, its views); each
    certify_batched_f64 at least a feasible point's objective; K1 or K4 once
    an instance a piece; the card's peak and the split of a piece.
    Returns ({path: launch counts}, checks, numbers)."""
    launches, checks, numbers = {}, {}, {}
    for k, n in ((3, BPIECES_OPEN), (4, BPIECES_K4)):
        insts = bpieces_insts(n)
        mesh = make_mesh(1, 1)
        table, valid = shard_combinations(n, k, mesh, device=dev)
        lazy = isinstance(table, round_mod.CombinationShards)
        scorer = "pair_score" if k == 3 else "fused_score"
        first = bround(insts, k, "neural", mesh, table, valid, None, dev)
        again = bround(insts, k, "neural", mesh, table, valid, None, dev)
        same = same_bround(first, again)
        cert = certify_batched_f64(first["state"])
        floors = [feasible_objective(inst, first["state"].pdhg.x[b].cpu().numpy())
                  for b, inst in enumerate(insts)]
        P = round_mod.PIECE_ROWS_OF[k] // BPIECES_B
        count = bpiece_count(table, 1, P)
        split = piece_split(first["state"], k, table, valid, dev)
        rows = BPIECES_B * table.shape[0]
        path = f"bpieces neural k={k} n={n}"
        launches[path] = first["launches"]
        numbers[path] = {"instance-rows": rows, "pieces": count, "seconds": first["wall"],
                         "again": again["wall"], "peak": first["peak"],
                         "peak B an instance-row": first["peak"] / rows,
                         "certificates": cert.tolist(), "floors": floors, **split}
        log(f"[{path}] the default route ({'no table written' if lazy else 'the written table'}"
            f", {count} pieces of {P} rows over {table.shape[0]}): round 0 in {first['wall']:.3f}s "
            f"and {again['wall']:.3f}s; a piece: its rows {split['rows_ms']:.3f} ms, "
            f"{BPIECES_B} instances' {scorer} {split['score_ms']:.3f} ms, the merge "
            f"{split['merge_ms']:.3f} ms; f64 certificates {cert.tolist()} against feasible "
            f"points' f {floors}; lp_iters {first['lp_iters'].tolist()}; the card's peak above "
            f"the step's start {first['peak']} bytes ({first['peak'] / 2 ** 30:.2f} GiB, "
            f"{first['peak'] / rows:.3f} B an instance-row); {scorer} launches "
            f"{first['launches'][scorer]}; a second run {same} ({SMI})")
        tag = f"k={k} n={n}"
        checks.update({f"{tag}: a second run repeats {key}": v for key, v in same.items()})
        checks[f"{tag}: {'no table written' if k == 3 else 'the written table'}, by pieces"] = (
            lazy == (k == 3) and count > 1)
        checks[f"{tag}: every certificate >= its feasible point's f"] = bool(
            np.isfinite(cert).all() and all(c >= f for c, f in zip(cert, floors)))
        checks[f"{tag}: {scorer} once an instance a piece, no twin"] = (
            first["launches"][scorer] == BPIECES_B * count
            and first["launches"][TWIN_SCORED] == 0)
        checks.update({f"{path}: {key}": v for key, v in
                       solve_route_checks(path, launches[path], n, k).items()})
        del first, again, table, valid
        torch.cuda.empty_cache()
    return launches, checks, numbers


def k4_window_check(label: str, x, X, Q, table, sweeps: int, dev) -> dict:
    """K4 over ``table`` (a path's shape) against its twin on the first and
    last K4_WINDOW rows (all of them where fewer): feas at atol 5e-4, nn as
    the largest share of the north star's per-candidate tolerance (rtol =
    atol = 2e-4) and of the reference's fused-kernel one (rtol 2e-4, atol
    2e-5)."""
    T, k = table.shape
    triQ, scale = candidate_q_features(Q, table)
    mlp = MLPScorer(load_params(k), dev)
    nn_k, feas_k = fused_score(x, X, table, triQ, scale, mlp, sweeps)
    windows = [(0, T)] if T <= 2 * K4_WINDOW else [(0, K4_WINDOW), (T - K4_WINDOW, T)]
    r_feas = r_star = r_kernel = err = 0.0
    for s, e in windows:
        nn_p, feas_p = fused_score_plain(x, X, table[s:e], triQ[s:e], scale[s:e], mlp, sweeps)
        e_f, f = excess(feas_k[s:e], feas_p, 0.0, 5e-4)
        e_n, n_star = excess(nn_k[s:e], nn_p, 2e-4, 2e-4)
        r_feas, r_star, err = max(r_feas, f), max(r_star, n_star), max(err, e_f, e_n)
        r_kernel = max(r_kernel, excess(nn_k[s:e], nn_p, 2e-4, 2e-5)[1])
    log(f"[k4 tolerance {label}] k={k}, {T} rows, {sweeps} sweeps, the rows {windows}: max|err| "
        f"{err:.3e}; feas {r_feas:.4f} of atol 5e-4; nn {r_star:.4f} of rtol = atol = 2e-4 (the "
        f"north star's), {r_kernel:.4f} of rtol 2e-4 / atol 2e-5 (the reference's fused kernel) "
        f"({SMI})")
    return {"rows": T, "k": k, "max_abs_err": err, "feas": r_feas, "of (2e-4, 2e-4)": r_star,
            "of (2e-4, 2e-5)": r_kernel}


def random_rows(n: int, k: int, count: int, dev) -> torch.Tensor:
    """``count`` random sorted k-subsets of range(n) (int32, on ``dev``),
    from a seeded CPU generator."""
    g = torch.Generator().manual_seed(n * 10 + k)
    pick = torch.rand((count, n), generator=g).argsort(dim=1)[:, :k]
    return pick.sort(dim=1).values.to(torch.int32).to(dev)


def k4_tolerance(dev) -> tuple:
    """Phase 27 (d): K4 against its twin at the shapes of every path that
    launches it: the QCQP band100 clique table at k = 5 (6 sweeps); a piece
    of C(125, 5) at spar125-100-1's Q; phase 26's pieces (C(512, 4) and
    C(200, 5) at row 2^31); phase 27's batched pieces (the forced ones of
    spar80 at k = 4 and spar40 at k = 5, the default ones of spar200 at
    k = 4, each instance's Q); K4_RANDOM_ROWS random rows of C(200, k),
    k = 2..5; the pieces at 5 sweeps (neural), each at scoring_point's
    (x, X).  Returns (checks, {path: ratios})."""
    out = {}
    band = load_or_generate_qcqp(QCQP_INSTANCE)
    x, X, table, _, _, _, sweeps = fused_args(band.Q0, clique_table(band, 5), 6, dev)
    Q = torch.as_tensor(band.Q0, dtype=torch.float32, device=dev)
    out["qcqp band100 k=5"] = k4_window_check("qcqp band100", x, X, Q, table, sweeps, dev)
    spar125 = parse_boxqp(os.path.join(DATA, f"{INSTANCE}.in"), name=INSTANCE)
    pieces = [(f"{INSTANCE} k=5 piece", spar125, 5, 0, solver_mod.PIECE_ROWS_WIDE[5])]
    for k, shape in KPIECES_DEFAULT:
        inst = generate_spar(*shape)
        R_ = solver_mod.PIECE_ROWS_WIDE[k]
        start = 1 << 31 if math.comb(inst.n, k) >= (1 << 31) + R_ else 0
        pieces.append((f"phase 26 {inst.name} k={k} piece", inst, k, start, R_))
    for k, n in BPIECES_WHOLE[1:]:
        pieces += [(f"phase 27 {inst.name} k={k} forced piece", inst, k, BPIECES_FORCED[k],
                    BPIECES_FORCED[k]) for inst in bpieces_insts(n)]
    pieces += [(f"phase 27 {inst.name} k=4 piece", inst, 4, 0,
                round_mod.PIECE_ROWS_OF[4] // BPIECES_B) for inst in bpieces_insts(BPIECES_K4)]
    for label, inst, k, start, R_ in pieces:
        x, X, Q = scoring_point(inst, dev)
        rows = combinations_range_on(inst.n, k, start, start + R_, dev)
        out[label] = k4_window_check(label, x, X, Q, rows, SWEEPS, dev)
        del rows
    inst = generate_spar(200, 100, 1)
    x, X, Q = scoring_point(inst, dev)
    for k in (2, 3, 4, 5):
        label = f"{K4_RANDOM_ROWS} random rows of C(200, {k})"
        out[label] = k4_window_check(label, x, X, Q, random_rows(200, k, K4_RANDOM_ROWS, dev),
                                     SWEEPS, dev)
    torch.cuda.empty_cache()
    star = max(r["of (2e-4, 2e-4)"] for r in out.values())
    kernel = max(r["of (2e-4, 2e-5)"] for r in out.values())
    log(f"[k4 tolerance] over {len(out)} shapes: nn at most {star:.4f} of rtol = atol = 2e-4 (the "
        f"north star's per-candidate tolerance) and {kernel:.4f} of rtol 2e-4 / atol 2e-5; feas "
        f"at most {max(r['feas'] for r in out.values()):.4f} of atol 5e-4 ({SMI})")
    return {"K4 within the north star's nn tolerance (rtol = atol = 2e-4) on every path's "
            "shape": star <= 1.0,
            "K4's feas within atol 5e-4 on every path's shape":
                max(r["feas"] for r in out.values()) <= 1.0}, out


def bpieces_phase(dev) -> dict:
    """Phase 27: the batched round past the table's memory
    (bpieces_against_whole, bpieces_default) and K4's tolerance on every
    path (k4_tolerance), each path's launches into PATH_LAUNCHES.  Returns
    the numbers it measured."""
    t0 = time.perf_counter()
    out = {}
    for name, run in (("against the whole route", bpieces_against_whole),
                      ("the default route", bpieces_default)):
        t1 = time.perf_counter()
        launches, checks, out[name] = run(dev)
        PATH_LAUNCHES.update(launches)
        finish(f"bpieces {name}", checks)
        log(f"[bpieces] {name} took {time.perf_counter() - t1:.1f}s")
    t1 = time.perf_counter()
    checks, out["k4 tolerance"] = k4_tolerance(dev)
    finish("k4 tolerance", checks)
    log(f"[bpieces] K4's tolerance took {time.perf_counter() - t1:.1f}s")
    out["seconds"] = time.perf_counter() - t0
    log(f"[bpieces] phase 27 took {out['seconds']:.1f}s ({SMI})")
    return out


# ---- phase 28: the survivors' dominance rules on the card ---------------------------

SURV_ZERO = OPEN_PIECES                # (a): neural on an all-zero MLP, by pieces and whole
SURV_TIED = (4096, 3, 1 << 28)         # (b): C(4096, 3) zeros, pieces of 2^28 rows
SURV_UNIFORM = (330, 5, 1 << 27, 3 * (1 << 24) + 7)  # (c): C(330, 5), two piece bounds


def survivors_zero_mlp(dev, tmp: str) -> tuple:
    """Phase 28 (a): neural at k = 3 on an MLP of zero weights (every score
    scale relu(0) = 0, so tau falls below 0) on generate_spar(2100, 100, 1)
    at a fixed point x ~ U(0.2, 0.8) seeded, X = x x^T (no LP): the default
    route by pieces (StreamedTopk's floor keeps C(60, 3) = 34,220 rows)
    against the whole table (C(2100, 3) = 1,541,295,700 rows, 18.5 GB):
    picks and cut rows bit for bit.  Returns (the pieces' launch counts,
    checks, numbers)."""
    inst = generate_spar(*SURV_ZERO)
    path = os.path.join(tmp, "mlp_k3_zero.npz")
    np.savez(path, **{k: np.zeros_like(v) for k, v in load_params(3).items()})
    cfg = RunConfig(lp=PIECES_LP, scorer=ScorerConfig(strategy="neural", weights_path=path))
    x = torch.as_tensor(np.random.default_rng(4).uniform(0.2, 0.8, inst.n), dtype=torch.float32,
                        device=dev)
    X = torch.outer(x, x)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    pieced = CutSolver(inst, cfg, device=dev)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows_p, sel = pieced._select_pieces(x, X)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    _, idx_p, valid_p, picked = sel.result()
    n_pieces = len(pieced.pieces)
    del pieced
    gc.collect()
    torch.cuda.empty_cache()
    whole = CutSolver(inst, cfg, device=dev, _pieces=False)
    t1 = time.perf_counter()
    scores = whole._scores(x, X)
    zeros = bool((scores == 0).all())
    rows_w, idx_w, _ = solver_mod.select_and_generate(x, X, whole.table, scores, cfg.cuts)
    torch.cuda.synchronize()
    wall_w = time.perf_counter() - t1
    same_picks = torch.equal(idx_p, idx_w) and torch.equal(picked, whole.table[idx_w])
    same_rows = len(rows_p) == len(rows_w) and all(torch.equal(a, b)
                                                   for a, b in zip(rows_p, rows_w))
    del whole, scores, rows_w
    gc.collect()
    torch.cuda.empty_cache()
    m = 3 * (cfg.cuts.sel_size - 1)
    log(f"[survivors zero MLP {inst.name}] by {n_pieces} pieces in {wall:.3f}s (the survivors' "
        f"largest count {sel.most}, the floor's bound C({m + 3}, 3) = {math.comb(m + 3, 3)}; "
        f"the card's peak above the start {peak} bytes = {peak / 2 ** 30:.2f} GiB) and on the "
        f"whole table in {wall_w:.3f}s: every score 0 {zeros}; picks bit for bit {same_picks} "
        f"({idx_p.tolist()}); cut rows bit for bit {same_rows}; launches {launches} ({SMI})")
    return launches, {
        "every score of the zero MLP is 0": zeros,
        "the picks by pieces are the whole table's, bit for bit": same_picks,
        "the cut rows by pieces are the whole table's, bit for bit": same_rows,
        "every pick valid": bool(valid_p.all()),
        f"the floor keeps C({m + 3}, 3) rows": sel.most == math.comb(m + 3, 3),
        "K1 launched a piece at a time": launches["pair_score"] == sum(
            len(launch_ranges(p[3], 3)) for p in first_index_pieces(inst.n, 3,
                                                                     solver_mod.PIECE_ROWS)),
        "no twin-scored call on the card": launches[TWIN_SCORED] == 0,
    }, {"seconds": wall, "whole s": wall_w, "most": sel.most, "peak": peak, "pieces": n_pieces}


def survivors_tied(dev) -> tuple:
    """Phase 28 (b): StreamedTopk (S = 20, alpha 1e-4, the table's n) over
    C(4096, 3) = 11,444,858,880 zero scores, its rows written on the card
    by combinations_range_on a piece of 2^28 rows at a time: the picks are
    the lexicographic disjoint rows (0, 1, 2) .. (57, 58, 59) at their
    global indices, every value 0 and valid; the survivors' largest count
    is the floor's C(60, 3) = 34,220.  Returns (checks, numbers)."""
    n, k, R = SURV_TIED
    S = CutConfig().sel_size
    pairs = combinations_table_on(n, 2, dev)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sel = StreamedTopk(S, CutConfig().diversity_alpha, k, dev, n=n)
    pieces = range_pieces(n, k, R)
    for _, _, off, cnt in pieces:
        rows = combinations_range_on(n, k, off, off + cnt, dev, pairs)
        sel.add(torch.zeros(cnt, device=dev), rows, off)
        del rows
    vals, idx, valid, picked = sel.result()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    want = torch.arange(S * k, dtype=torch.int32, device=dev).reshape(S, k)
    total = math.comb(n, k)
    ranks = [total - math.comb(n - a, k) + (math.comb(n - a - 1, 2) - math.comb(n - b, 2))
             + (c - b - 1) for a, b, c in want.tolist()]          # lexicographic ranks
    m = k * (S - 1)
    log(f"[survivors tied C({n}, {k})] {len(pieces)} pieces of {R} rows in {wall:.3f}s; picks "
        f"{picked.tolist()} at {idx.tolist()}; the survivors' largest count {sel.most} (the "
        f"floor's C({m + k}, {k}) = {math.comb(m + k, k)}); the card's peak above the start "
        f"{peak} bytes = {peak / 2 ** 30:.2f} GiB ({SMI})")
    return {
        f"the picks are (0, 1, 2) .. ({S * k - 3}, {S * k - 2}, {S * k - 1})":
            torch.equal(picked, want),
        "at their lexicographic ranks": idx.tolist() == ranks,
        "every pick 0 and valid": bool((vals == 0).all() and valid.all()),
        f"the survivors' largest count is C({m + k}, {k})": sel.most == math.comb(m + k, k),
    }, {"seconds": wall, "most": sel.most, "peak": peak, "pieces": len(pieces)}


def survivors_uniform(dev) -> tuple:
    """Phase 28 (c): uniform on-card scores over C(330, 5) =
    31,634,996,316 rows at S = 20 (alpha 1e-4: tau's band alpha P = 9.5e-3
    of the range, reckoned 3.0e8 rows, past SURVIVOR_CAP), the rows written
    by combinations_range_on a piece of 2^27 at a time, fed to three
    selections: a reference written here (each piece's rows at or above the
    running tau kept, the kept ones pruned to the last tau, then the port's
    diverse_topk over them: the threshold alone, with no cap), and
    StreamedTopk with the table's n (the packings of core size 2) on these
    pieces and on pieces cut again at 3 2^24 + 7 rows.  The three picks
    (values, global indices, validity, rows) bit for bit; the reference
    keeps more than 2^28 rows.  Returns (checks, numbers)."""
    n, k, R1, R2 = SURV_UNIFORM
    S, alpha = CutConfig().sel_size, CutConfig().diversity_alpha
    pairs = combinations_table_on(n, 2, dev)
    gen = torch.Generator(device=dev).manual_seed(28)
    pmax = torch.full((1,), k * (S - 1), dtype=torch.float32, device=dev)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sels = [StreamedTopk(S, alpha, k, dev, n=n) for _ in range(2)]
    secs = [0.0, 0.0, 0.0]
    kept, top = [], torch.empty(0, dtype=torch.float32, device=dev)

    def stream():
        for _, _, off, cnt in range_pieces(n, k, R1):
            yield (torch.rand(cnt, generator=gen, device=dev),
                   combinations_range_on(n, k, off, off + cnt, dev, pairs), off)

    def timed(i, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs[i] += time.perf_counter() - t

    def reference(scores, rows, off):
        nonlocal top
        top = torch.topk(torch.cat([top, scores]), min(S, top.numel() + scores.numel())).values
        tau = top[S - 1:S] - torch.mul(pmax, alpha)
        at = torch.nonzero(scores >= tau)[:, 0]
        kept.append((scores[at], at + off, rows[at]))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry = None
    for scores, rows, off in stream():
        timed(0, lambda: reference(scores, rows, off))
        timed(1, lambda: sels[0].add(scores, rows, off))
        # the second bounds: this piece joined to the last one's tail, cut at multiples of R2
        def second_add():
            nonlocal carry
            s, r, o = (scores, rows, off) if carry is None else (
                torch.cat([carry[0], scores]), torch.cat([carry[1], rows]), carry[2])
            cut = (o + s.shape[0]) // R2 * R2 - o
            if cut > 0:
                sels[1].add(s[:cut], r[:cut], o)
            carry = (s[cut:], r[cut:], o + cut) if cut < s.shape[0] else None
        timed(2, second_add)
    if carry is not None:
        timed(2, lambda: sels[1].add(*carry))
    tau = top[S - 1:S] - torch.mul(pmax, alpha)
    held = sum(int((v >= tau).sum()) for v, _, _ in kept)

    def reference_result():
        vals = torch.cat([v[v >= tau] for v, _, _ in kept])
        idx = torch.cat([i[v >= tau] for v, i, _ in kept])
        rows = torch.cat([r[v >= tau] for v, _, r in kept])
        kept.clear()
        got = diverse_topk(vals, rows, S, alpha)
        return got[0], idx[got[1]], got[2], rows[got[1]]

    want = []
    timed(0, lambda: want.append(reference_result()))
    results = []
    for i, sel in enumerate(sels):
        timed(i + 1, lambda: results.append(sel.result()))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    want = want[0]
    same = [all(torch.equal(a, b) for a, b in zip(got, want)) for got in results]
    log(f"[survivors uniform C({n}, {k})] S = {S}, alpha {alpha}: {-(-math.comb(n, k) // R1)} "
        f"pieces of {R1} rows in {wall:.3f}s; the reference keeps {held} rows (2^28 = "
        f"{1 << 28}) in {secs[0]:.3f}s; StreamedTopk (cores {[p.c for p in sels[0].packs]}) on "
        f"them: the survivors' largest count {sels[0].most}, {sels[0].vals.numel()} at the end, "
        f"{sels[0].rebuilds} rebuilds, {secs[1]:.3f}s; on pieces cut at {R2}: {sels[1].most}, "
        f"{sels[1].vals.numel()}, {sels[1].rebuilds}, {secs[2]:.3f}s; picks {want[1].tolist()}; the same bit for bit {same}; the card's peak "
        f"above the start {peak} bytes = {peak / 2 ** 30:.2f} GiB ({SMI})")
    return {
        "the reference keeps more than 2^28 rows": held > (1 << 28),
        "StreamedTopk gives the reference's picks, bit for bit": same[0],
        f"and on pieces cut at {R2}": same[1],
        "every pick valid": bool(want[2].all()),
    }, {"held": held, "most": [s.most for s in sels], "end": [s.vals.numel() for s in sels],
        "rebuilds": [s.rebuilds for s in sels], "seconds": secs, "peak": peak}


def survivors_phase(dev) -> dict:
    """Phase 28: StreamedTopk's dominance rules on the card (survivors_zero_mlp,
    survivors_tied, survivors_uniform), no fallback: a failed check fails
    the run.  Returns the numbers it measured."""
    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        launches, checks, out["zero MLP"] = survivors_zero_mlp(dev, tmp)
    PATH_LAUNCHES["survivors neural zero MLP n=2100"] = launches
    finish("survivors zero MLP", checks)
    log(f"[survivors] the zero MLP took {time.perf_counter() - t1:.1f}s")
    for name, run in (("tied", survivors_tied), ("uniform", survivors_uniform)):
        t1 = time.perf_counter()
        checks, out[name] = run(dev)
        finish(f"survivors {name}", checks)
        log(f"[survivors] {name} took {time.perf_counter() - t1:.1f}s")
    out["seconds"] = time.perf_counter() - t0
    log(f"[survivors] phase 28 took {out['seconds']:.1f}s ({SMI})")
    return out


GROUPS = ("3", "4", "5-13", "15-17", "18-21", "22", "23", "24", "25", "26",
          "27", "28")                  # --phases


def main(argv=None) -> int:
    global SMI
    import argparse

    parser = argparse.ArgumentParser(description="Smoke run of the port on one GPU.")
    parser.add_argument("--parent", help="a checkout of the parent commit: phase 3 then holds "
                        "K2's, K5's, K6's, K7's and K7c's bits to that build's on its inputs and "
                        "times K6, K7, K7c and K7n in turns with that build's, phase 20 the "
                        "single grid entries' bits at phase 19's shapes, and after phase 15 "
                        "the certifier's LP is timed in both trees in turns")
    parser.add_argument("--phases", default=",".join(GROUPS),
                        help=f"the phase groups to run, comma-separated, of {', '.join(GROUPS)} "
                        f"(default: all; the kernels line needs all)")
    parser.add_argument("--host-references", metavar="PATH", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    groups = [g for g in args.phases.split(",") if g]
    if not groups or any(g not in GROUPS for g in groups):
        parser.error(f"--phases takes groups of {', '.join(GROUPS)}, got {args.phases!r}")
    if args.host_references:                 # phases 20-22's host work, in a process of its own
        host_references(args.host_references, groups)
        return 0
    t_start = time.perf_counter()
    smi = SMI = environment()
    torch.backends.cuda.matmul.allow_tf32 = False    # see the module docstring
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    # the build without the Jacobi's overflow guard, for the bit check, in
    # parallel with the port's own
    finish_variants = start_variants({"unguarded": ([UNGUARDED], [])},
                                     ("pair_score", "fused_score"))
    _build.lib()
    log(f"[build] {os.path.relpath(_build.library_path(), REPO)} built and loaded in "
        f"{time.perf_counter() - t0:.2f}s (nvcc {_build.build_seconds:.2f}s)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line or "Compiling" in line:
            log(f"[build] {line.strip()}")
    tensor_core_kernels()

    def unguarded():
        """The unguarded variant's library, its build waited for at its first
        use (phase 3's guard check, at the end of the run: its nvcc runs
        beside the phases' card work) or at the end."""
        if not built:
            built.append(finish_variants()["unguarded"])
            log(f"[build] unguarded variant ready after {time.perf_counter() - t0:.2f}s")
        return built[0]

    built = []
    with tempfile.TemporaryDirectory() as tmp:
        hosted = [g for g in groups if g in ("4", "18-21", "22", "23", "24")]
        refs = References(tmp, hosted) if hosted else None
        try:
            return run_phases(args, groups, dev, smi, t_start, unguarded, refs)
        finally:
            unguarded()
            if refs is not None:
                refs.stop()


def run_phases(args, groups, dev, smi: str, t_start: float, unguarded, refs) -> int:
    """The phase groups ``groups`` after the build (every one by default),
    then, when every group ran, the kernels line; the nvidia-smi line and
    the last line; ``unguarded()``: the unguarded scoring variant's library
    (phase 3); ``refs``: phases 4 and 19-24's host references."""
    inst = parse_boxqp(os.path.join(DATA, f"{INSTANCE}.in"), name=INSTANCE)
    pkg = parent_package(args.parent) if args.parent else None
    lib = None

    def mark(what: str):               # the run's clock after each group of phases
        log(f"[time] {what} done {time.perf_counter() - t_start:.1f}s into the run")

    if "3" in groups:
        band = load_or_generate_qcqp(QCQP_INSTANCE)
        small = parse_boxqp(os.path.join(DATA, "spar020-100-1.in"), name="spar020-100-1")
        k1 = check_pair_score(inst, small, dev)
        k3 = check_pair_packed(inst, dev)
        band_dense = dense_from_qcqp(band.Qs, band.cs, band.bs, dev)
        shapes = {f"{INSTANCE} m=0": (inst.Q, inst.c, combinations_table(inst.n, 3), None),
                  f"{QCQP_INSTANCE} m={band.m}": (band.Q0, band.c0, clique_table(band, 5),
                                                  band_dense)}
        k2_box, k2 = (check_pdhg_block(label, *a, dev) for label, a in shapes.items())
        bucket = [parse_boxqp(os.path.join(DATA, f"{name}.in"), name=name)
                  for name in SUITE_BUCKET]
        k2_batched = check_pdhg_block_batched(bucket, k2_box, dev)
        k5s, k6s = [], []
        for label, (Q, c, table, dense) in shapes.items():
            inputs = pdhg_inputs(Q, c, table, dense, dev)
            k5s.append(check_pdhg_check(label, inputs, dense, dev))
            k6s.append(check_pdhg_norm(label, inputs, dense, dev, pkg))
        control_batched = check_control_batched(bucket, dev, pkg)
        dense_route = check_dense_route(dev, pkg)
        k2["parent_bits"] = k5s[1]["parent_bits"] = None
        if args.parent:
            same5 = [checked_against_parent(pkg, label,
                                            pdhg_inputs(Q, c, table, dense_rows, dev),
                                            dense_rows, dev)
                     for label, (Q, c, table, dense_rows) in shapes.items()]
            same5.append(checked_batched_against_parent(pkg, bucket, dev))
            k5s[1]["parent_bits"] = all(same5)
            if not all(same5):
                raise AssertionError("the checked block does not give the parent build's bits "
                                     "on phase 3's inputs")
            lib = parent_k2(pkg, args.parent)
            same = []
            for label, (Q, c, table, dense) in shapes.items():
                cx, cX, pool, index, st = pdhg_inputs(Q, c, table, dense, dev)
                eta = 0.95 / estimate_norm_plain(pool, c.shape[0], 30,
                                                 torch.Generator().manual_seed(0), index,
                                                 dense).item()
                for iters in (7, 100):
                    same.append(k2_against_parent(
                        lib, label, (cx, cX, pool, index, st, st.map(torch.zeros_like), eta,
                                     eta), dense, iters))
            k2["parent_bits"] = all(same)
            if not all(same):
                raise AssertionError("K2 does not give the parent build's bits on phase 3's "
                                     "inputs")
        k4 = check_k4(inst, dev)
        mark("phase 3")
    if "4" in groups:
        check_small_instances(dev)
        (PATH_LAUNCHES["wide boxqp spar150-100-1"], PATH_LAUNCHES["grid boxqp n=300"],
         PATH_LAUNCHES["grid boxqp spar150-100-1 capacity=81920"]) = check_large_instance(dev)
        mark("phase 4")
    if "18-21" in groups:
        wide = wide_phase(dev, pkg, lib)
        grid = grid_phase(dev)
        batch = grid_batch_phase(dev, pkg)
        huge = huge_phase(dev)
        mark("phases 18-21")
    if "22" in groups:
        big = bigpool_phase(dev)
        mark("phase 22")
    if "23" in groups:
        vast = vast_phase(dev)
        mark("phase 23")
    if "24" in groups:
        opened = open_phase(dev)
        mark("phase 24")
    if "25" in groups:
        pieces_phase(dev)
        mark("phase 25")
    if "26" in groups:
        kpieces = kpieces_phase(dev)
        mark("phase 26")
    if "27" in groups:
        bpieces = bpieces_phase(dev)
        mark("phase 27")
    if "28" in groups:
        survivors_phase(dev)
        mark("phase 28")
    main_hist = None
    if "5-13" in groups:
        PATH_LAUNCHES["boxqp main"], main_hist = main_path(inst, dev)
        PATH_LAUNCHES["qcqp main"] = qcqp_main_path(dev)
        PATH_LAUNCHES["boxqp packed scan"] = packed_scan_path(inst, dev)
        PATH_LAUNCHES["qcqp steered scan"] = steered_qcqp_scan(dev)
        PATH_LAUNCHES["boxqp resume"] = boxqp_resume(inst, main_hist, dev)
        PATH_LAUNCHES.update(strategies(inst, dev))
        PATH_LAUNCHES["batched suite bucket"] = suite_bucket_path(dev)
        PATH_LAUNCHES["batched bench scan"] = bench_scan_path(dev)
        PATH_LAUNCHES["batched qcqp family"] = qcqp_family_path(dev)
        mark("phases 5-13")
    if "15-17" in groups:
        PATH_LAUNCHES["certifiers and the CLI"] = certifiers_and_cli(dev)
        if args.parent:
            certifier_against_parent(args.parent, dev)
        mark("phase 15")
        if main_hist is None:            # training compares with phase 5's final bound
            PATH_LAUNCHES["boxqp main"], main_hist = main_path(inst, dev)
        PATH_LAUNCHES["training"] = training(main_hist, dev)
        mark("phase 16")
        PATH_LAUNCHES["multi-process (every rank)"] = multi_process(dev)
        mark("phase 17")
    if "3" in groups:                  # phase 3's last check, once the variant is built
        check_guard(inst, unguarded(), dev)
    if "4" in groups:
        finish("small references", small_references(refs))
    if "18-21" in groups:
        finish("huge references", huge_references(refs))
    if "22" in groups:
        finish("big references", big_references(refs))
    if "23" in groups:
        finish("vast references", vast_references(refs))
    if "24" in groups:
        finish("open references", open_references(refs))
    seconds = time.perf_counter() - t_start
    log(f"[done] phases {', '.join(groups)} passed in {seconds:.1f}s, {seconds / 900:.1%} of "
        f"a 900 s budget")
    for path, counts in PATH_LAUNCHES.items():
        log(f"[launches] {path}: {counts}")
    total = {name: sum(c[name] for c in PATH_LAUNCHES.values()) for name in WRAPPERS}
    narrow = {name: sum(c[name] for p, c in PATH_LAUNCHES.items()
                        if not p.startswith(("wide", "grid", "huge", "big", "vast", "open",
                                             "pieces", "kpieces", "bpieces")))
              for name in WRAPPERS}
    log(f"[launches] the paths at n <= 128 (every path but the wide, grid, huge, big, vast, "
        f"open, pieces, kpieces and bpieces ones): {narrow}")
    if set(groups) != set(GROUPS):
        log(f"[done] the kernels line needs every phase group; these ran: {', '.join(groups)}")
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    kernels = [
        {"name": "pair_score", "route": "cuda",
         "source": "sdpcutsel_tpu_torch/csrc/pair_score.cu",
         "replaces": "sdpcutsel_tpu/ops/pair_score.py:192",
         "launches": total["pair_score"], **k1, "n256": wide["pair_score"],
         "max_abs_err": max(k1["max_abs_err"], wide["pair_score"]["max_abs_err"])},
        {"name": "pair_packed", "route": "cuda",
         "source": "sdpcutsel_tpu_torch/csrc/pair_packed.cu",
         "replaces": "sdpcutsel_tpu/ops/pair_packed.py:196",
         "launches": total["pair_packed"], **k3},
        {"name": "pdhg_block", "route": "cuda",
         "source": "sdpcutsel_tpu_torch/csrc/pdhg_block.cu",
         "replaces": "sdpcutsel_tpu/lp/pdhg_kernel.py:51",
         "launches": total["pdhg_block"], **k2, **k2_batched,
         "wide": {**wide["pdhg_block"], "batched n=150": wide["batched"]},
         "max_abs_err": max(k2["max_abs_err"], k2_box["max_abs_err"],
                            k2_batched["batched_max_abs_err"],
                            wide["batched"]["batched_max_abs_err"],
                            *(e["max_abs_err"] for e in wide["pdhg_block"].values()))},
        {"name": "fused_score", "route": "cuda",
         "source": "sdpcutsel_tpu_torch/csrc/fused_score.cu",
         "replaces": "sdpcutsel_tpu/ops/fused_score.py:52",
         "launches": total["fused_score"], **k4[-1],
         "max_abs_err": max(r["max_abs_err"] for r in k4)},
        # K5 and K6: the reference computes them in XLA inside its while_loop
        # (no Pallas kernel); each entry holds the QCQP shape's numbers, the
        # BoxQP shape's under m0_*
        {"name": "pdhg_check (K5, in K2's launch)", "route": "cuda",
         "source": "sdpcutsel_tpu_torch/csrc/pdhg_check.cuh (the epilogue of the checked form "
                   "of csrc/pdhg_block.cu)",
         "replaces": "sdpcutsel_tpu/lp/pdhg.py:224 (checked_block; XLA, no Pallas kernel)",
         "launches": total["pdhg_check"], **k5s[1],
         **{f"m0_{key}": v for key, v in k5s[0].items()}, **control_batched["check"],
         "wide": {**wide["pdhg_check"], "batched n=150": wide["control_batched"]["check"]},
         "max_abs_err": max(k5s[0]["max_abs_err"], k5s[1]["max_abs_err"],
                            control_batched["check"]["batched_max_abs_err"],
                            wide["control_batched"]["check"]["batched_max_abs_err"],
                            *(e["max_abs_err"] for e in wide["pdhg_check"].values()))},
        {"name": "pdhg_norm", "route": "cuda",
         "source": "sdpcutsel_tpu_torch/csrc/pdhg_norm.cu",
         "replaces": "sdpcutsel_tpu/lp/pdhg.py:70 (estimate_norm; XLA, no Pallas kernel)",
         "launches": total["pdhg_norm"], **k6s[1],
         **{f"m0_{key}": v for key, v in k6s[0].items()}, **control_batched["norm"],
         "wide": {**wide["pdhg_norm"], "batched n=150": wide["control_batched"]["norm"]},
         "max_abs_err": max(k6s[0]["max_abs_err"], k6s[1]["max_abs_err"],
                            control_batched["norm"]["batched_max_abs_err"],
                            wide["control_batched"]["norm"]["batched_max_abs_err"],
                            *(e["max_abs_err"] for e in wide["pdhg_norm"].values()))},
    ]
    # K7, the dense route of the certifier's LP (csrc/pdhg_dense.cu): XLA in
    # the reference's solve (no Pallas kernel: it refuses dense rows); each
    # entry holds n = 125 at the full buffer, every shape (the wide ones
    # too) under "shapes"
    kernels += [
        dense_entry("pdhg_dense", "sdpcutsel_tpu/lp/pdhg.py:216 (run_block's fori_loop of "
                    "_one_iter with dense rows; XLA, no Pallas kernel)", total["pdhg_dense"],
                    {**dense_route["pdhg_dense"], **wide["pdhg_dense"]}),
        dense_entry("pdhg_dense_check (K7c, in K7's checked launch)", "sdpcutsel_tpu/lp/"
                    "pdhg.py:224 (checked_block with dense rows; XLA, no Pallas kernel)",
                    total["pdhg_dense_check"],
                    {**dense_route["pdhg_dense_check"], **wide["pdhg_dense_check"]}),
        dense_entry("pdhg_dense_norm", "sdpcutsel_tpu/lp/pdhg.py:71 (estimate_norm with dense "
                    "rows; XLA, no Pallas kernel)", total["pdhg_dense_norm"],
                    {**dense_route["pdhg_dense_norm"], **wide["pdhg_dense_norm"]}),
    ]
    # the grid route (csrc/pdhg_grid.cu): XLA in the reference's solve past its
    # Pallas kernel's shapes (n > 128, a pool past 1024, dense rows); each
    # entry holds spar512's shape, every shape (the dense route's 512-column
    # form among them) under "shapes"
    kernels += [dense_entry(name, replaces, total[key], grid[key], "pdhg_grid.cu", "n=512 m=0")
                for key, name, replaces in (
        ("pdhg_grid", "pdhg_grid", "sdpcutsel_tpu/lp/pdhg.py:216 (run_block's fori_loop of "
         "_one_iter past the Pallas kernel's shapes, :291-301; XLA, no Pallas kernel)"),
        ("pdhg_grid_check", "pdhg_grid_check (in the grid block's checked launch)",
         "sdpcutsel_tpu/lp/pdhg.py:224 (checked_block; XLA, no Pallas kernel)"),
        ("pdhg_grid_norm", "pdhg_grid_norm", "sdpcutsel_tpu/lp/pdhg.py:70 (estimate_norm; XLA, "
         "no Pallas kernel)"))]
    for entry, key in zip(kernels[-3:], ("pdhg_grid", "pdhg_grid_check", "pdhg_grid_norm")):
        entry["batched"] = batch[key]
        entry["max_abs_err"] = max(entry["max_abs_err"],
                                   *(e["max_abs_err"] for e in batch[key].values()))
    kernels[0]["n512"] = grid["pair_score"]
    kernels[0]["n1024"] = huge["pair_score"]
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], grid["pair_score"]["max_abs_err"],
                                    huge["pair_score"]["max_abs_err"])
    # the grid route's 1024-column form (GridForm<kHuge>, its owned state in
    # global memory): its own entries, with its launches on phase 21's paths;
    # each holds n = 1024's shape, every shape under "shapes"
    kernels += [dense_entry(f"{name} (1024 columns)", entry["replaces"],
                            huge[f"{key} launches"], huge[key], "pdhg_grid.cu", "n=1024 m=0")
                for entry, key, name in zip(kernels[-3:], ("pdhg_grid", "pdhg_grid_check",
                                                           "pdhg_grid_norm"),
                                            ("pdhg_grid", "pdhg_grid_check", "pdhg_grid_norm"))]
    # the far form (phase 22; the replicas and the slots in global memory):
    # under the grid entries, every shape and the forced form at phase 19's
    # shapes against the shared form, with its launches on phase 22's solve
    for entry, key in zip(kernels[-6:-3], ("pdhg_grid", "pdhg_grid_check", "pdhg_grid_norm")):
        entry["far"] = big[key]
        entry["far launches"] = PATH_LAUNCHES["big boxqp capacity=81920"][key]
        entry["max_abs_err"] = max(entry["max_abs_err"],
                                   *(e["max_abs_err"] for e in big[key].values()))
    kernels[-6]["far"]["against the shared form"] = big["far/shared"]
    # the 2048-column form (GridForm<kVast>, the dense rows read in place):
    # its own entries, with its launches on phase 23's paths; each holds
    # n = 2048's shape, every shape (the far form's and the walk's among
    # them) under "shapes"; K1 over C(2048, 3) in its launches under "n2048"
    kernels += [dense_entry(f"{key} (2048 columns)", entry["replaces"], vast[f"{key} launches"],
                            vast[key], "pdhg_grid_vast.cu", "n=2048 m=0")
                for entry, key in zip(kernels[-6:-3], ("pdhg_grid", "pdhg_grid_check",
                                                       "pdhg_grid_norm"))]
    kernels[0]["n2048"] = {**vast["pair_score"], "launches": vast["pair_score launches"]}
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], vast["pair_score"]["max_abs_err"])
    # the open form (GridForm<kOpen>, past n = 2048): its own entries, with
    # its launches on phase 24's paths; each holds n = 4096's shape, every
    # shape (the far form's and the walk's among them) under "shapes", the
    # form forced against the 2048-column form under "forced"; K1 over a
    # piece of C(4096, 3), with its launches on phase 24's paths, under
    # "n4096 piece"
    kernels += [dense_entry(f"{key} (open form)", entry["replaces"], opened[f"{key} launches"],
                            opened[key], "pdhg_grid_open.cu", "n=4096 m=0")
                for entry, key in zip(kernels[-6:-3], ("pdhg_grid", "pdhg_grid_check",
                                                       "pdhg_grid_norm"))]
    kernels[-3]["forced"] = opened["forced"]
    kernels[0]["n4096 piece"] = {**opened["pair_score"],
                                 "launches": opened["pair_score launches"]}
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"],
                                    opened["pair_score"]["max_abs_err"])
    # K4 over a piece of the k = 4 and 5 default routes (phase 26), with its
    # launches on phase 26's paths
    k4_entry = kernels[3]
    for k, piece in kpieces["fused_score"].items():
        k4_entry[f"k={k} piece"] = {**piece, "launches": sum(
            c["fused_score"] for p, c in PATH_LAUNCHES.items()
            if p.startswith("kpieces") and f"k={k}" in p)}
        k4_entry["max_abs_err"] = max(k4_entry["max_abs_err"], piece["max_abs_err"])
    # the batched round by pieces (phase 27): K1's and K4's launches on its
    # paths and the split of a piece past the table's memory; K4 on every
    # path's shape against its twin
    default = bpieces["the default route"]
    for entry, k, scorer in ((kernels[0], 3, "pair_score"), (k4_entry, 4, "fused_score")):
        entry["batched pieces"] = {
            "launches": sum(c[scorer] for p, c in PATH_LAUNCHES.items()
                            if p.startswith("bpieces")),
            **next(v for p, v in default.items() if f"k={k}" in p)}
    tolerance = bpieces["k4 tolerance"]
    k4_entry["every path's shape"] = {
        "of (2e-4, 2e-4)": max(r["of (2e-4, 2e-4)"] for r in tolerance.values()),
        "of (2e-4, 2e-5)": max(r["of (2e-4, 2e-5)"] for r in tolerance.values())}
    k4_entry["max_abs_err"] = max(k4_entry["max_abs_err"],
                                  *(r["max_abs_err"] for r in tolerance.values()))
    log(f"[grid] phase 19: {grid['seconds']:.1f}s; phase 20: {batch['seconds']:.1f}s; phase 21: "
        f"{huge['seconds']:.1f}s; phase 22: {big['seconds']:.1f}s; phase 23: "
        f"{vast['seconds']:.1f}s; phase 24: {opened['seconds']:.1f}s; phase 26: "
        f"{kpieces['seconds']:.1f}s; phase 27: {bpieces['seconds']:.1f}s")
    for entry in kernels:
        entry["library_ms"] = None       # no single PyTorch call computes any of them
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
