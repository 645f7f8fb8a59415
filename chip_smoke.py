"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

  python3 chip_smoke.py                  # n = 10,240 samples x 262,144 SNPs
  python3 chip_smoke.py --snps 1048576   # the BASELINE #3 shape

Phases (each prints its own seconds):
  1 device check: fails without CUDA; prints the card's name and power
    limit as nvidia-smi reports them
  2 build the five CUDA kernels from mixmogam_tpu_torch/csrc, one nvcc
    each, all started together, and beside them the host library
    (native.py: g++ over csrc/host/fast_parse.cpp and fast_vcf.cpp)
  3 each kernel against its plain PyTorch version on the card, at the
    main path's shapes (n samples, one 16,384-row tile): K1 and K4 (over
    a row range that starts mid-tile) bit-equal for ploidy 1 and 2, and
    again at n = 2,042 (a row pitch of 511 bytes: the kernels' byte loads)
    over 3,001 rows; K2 (int8x2, int8x3) and K5 (bf16, bf16x2, bf16x3,
    and bf16x3 on a genome with 2 % missing genotypes) on the main path's
    operands (the folded W'' and no Q0 columns) within f rtol 1e-4 /
    atol 1e-4, beta atol 1e-5, identical masks, and bit-equal between a
    launch on the operand prepared once per rotated null and one that
    prepares it on the spot; K3 at q = 1, 2, 4, 8, 11, 16, 20, 32, 64 and
    128 Q0 columns on the rotated rows of a real tile, each within those
    tolerances, bit-equal on repeat and to a launch that prepares its
    operand on the spot, and timed on the operand prepared once beside its
    bound, then at
    m = 1 and at n = 2,042 (an 8,168-byte row pitch). K2 and K5 run, as
    on the main path, one launch over all rows in 256-row blocks: they are held and timed on the least
    launch that fills the card (one block an SM: 33,792 rows on an H100),
    and their time is also given per 16,384 rows. Each kernel's time stands
    beside its bound
    (the larger of its bytes over 3.35 TB/s and its operations over the
    card's data-sheet peak for their type) and, for K1 and K4, beside one
    torch._int_mm over the unpacked int8 rows; beside K2 and K5 stand their
    products alone through the library on unpacked rows (torch._int_mm a
    plane, a bf16 matmul a part), which the port never calls. Then the
    'high' tier (no kernel of its own): its three bf16 library products
    with float32 outputs (ops/rotate.py::rotate_high; two on integer rows;
    on imputed rows one product a chunk of 2,048 samples a pass, added in
    cuBLAS's FMA epilogue) and the exact tier's mask and K3, on one
    16,384-row tile of integer rows and on three of imputed rows (seeds
    --seed + 11, 12 and 13), against the plain version on the card (the
    same bf16 splits, each product in float64, then K3's plain version):
    the products within n 2^-24 of sum |g u|, K3 on them within its
    limits, the whole within them (beta atol 1e-5 on every tile; beta
    printed beside the exact tier's own), timed beside the exact tier's
    fp32 GEMM on the same rows and beside their bound
  4 the main path at full width: draw the genome -> ResidentGenome on the
    card
    -> kinship_resident (K1) -> scale_k -> eigh on the card (float64)
    -> fit_null_model -> emmax_resident at 'exact' (K3), 'int8x3' (K2),
    'bf16x3' (K5) and 'high' (three bf16 passes, then K3 once an
    8,192-row tile; TF32 still off after it); every kernel's launch count
    must be > 0, and each fast tier within max |dp| 1e-4 of exact; each
    scan's rate beside PR 7's, and the fast tiers' mask of the rows inside
    col(X0) timed alone. Then the card's drift table: every tier (int8x2,
    int8x3, int8x4, bf16, bf16x2, bf16x3, high; the 'c' spellings run the
    same kernels) against exact
    on four fixtures: the intercept-only design, an intercept and 19
    covariates, 128 columns, and VanRaden's singular K of the genome (f64
    products) with delta at its bound (a trait in its 100 leading
    eigenvectors, no noise); each fixture's walls, each tier's max |dp| a
    fixture beside its ops/scan.py::TIER_P_DRIFT entry and the rule's value
    (twice the largest, one significant digit up); each tier with exact's
    masks and within its entry (int8x3 / bf16x3 also within 1e-4)
  5 end-to-end accuracy: exact-tier emmax on the card vs the port's
    float64 CPU path at n = 2,048 x 8,192 (max |dp| <= 1e-5, same masks)
  6 LOCO at full width, on phase 4's genome cut to --facade-snps rows in 5
    chromosomes in proportion to the Arabidopsis TAIR10 lengths (no
    boundary on a tile): the genome goes to a PLINK fileset (the port's
    write_plink) and the phenotype to a CSV, and api.run_gwas runs
    method='emmax_loco' from those files on the card (no device=); on its
    filtered rows emmax_loco runs directly at 'exact' and at 'bf16x3', each
    launching K4 exactly once per chromosome and K1 once; the facade's
    p-values equal the direct exact call's (max |dp| <= 1e-12) and its own
    ranked CSV; bf16x3 within max |dp| 1e-4 of exact; one chromosome's
    K_loco equal to scale_k of K1's gram over the other chromosomes' rows
    (max |d| <= 1e-12)
  7 the facade at full width, from the same files: api.run_gwas on the
    card with method='emmax' at 'exact', 'int8x3', 'bf16x3' and 'high'
    (TF32 still off after it); each
    call's timings_s and route (in-core, or packed and resident) are
    printed; its p-values must equal (max |dp| <= 1e-12) those of the
    port's emmax called on the same filtered rows, y and K, the ranked CSV
    must parse back to the same p-values, and the kernels' launch counts
    must be the tabled ones (PERF.md section 6), as for phase 6's call.
    Then at n = 2,048 x 4,096 with 2 % missing calls: run_gwas with the IBS
    and with the VanRaden kinship (float32 matmuls on the card) against the
    same call on the float64 CPU path: max |dK| <= 1e-5, max |dp| <= 1e-4;
    on that genome, VanRaden's K_loco of the middle chromosome in float64 on
    the card equals the direct kinship over the other rows (max |d| <=
    1e-12). Then VanRaden's K with delta at its lower bound (n = 256 x 3,000, seed
    3, no noise; a zero eigenvalue along the intercept): run_gwas on the
    card at 'exact', 'int8x3' and 'bf16x3', each against the float64 CPU
    path with identical masks and max |dp| <= 1e-4. Then, from
    phase 6's PLINK fileset: run_gwas method='emmax_stepwise' with its
    timings_s (K3 must launch), and emmax_loco with the VanRaden kinship on
    the card (float32 kinship matmuls, no K1 or K4: the float route; K3)
  8 stepwise MLMM on phase 4's resident genome, K and eigh (n x M, binary):
    emmax_step_wise with the stored rotation (10 steps: G @ U' once, then
    one K3 launch over all rows a step) and over the rotation budget (3
    steps: unpack + fp32 GEMM + K3 a tile, every step); each route's wall,
    the rotation, the mean per-step scan and K3's launches are printed; the
    two routes choose the same cofactors and their forward min_p agree to
    rtol 1e-4. Then the card (float32) against the float64 CPU path at
    n = 1,024 x 8,192: the same cofactor path and selected models, step 0's
    scan within max |dp| 1e-5 with identical masks
  9 multi-trait EMMAX on phase 4's resident genome and eigh: 50 traits
    drawn from its first 16,384 rows (h2 0.1-0.9), emmax_multi_trait at
    'exact', 'int8x3' and 'bf16x3' (each tile rotated once, then K3 once a
    trait: K3 must launch T x tiles times and nothing else); each tier's
    wall, REML, scan, rate and p-values, and its rotation, design mask and
    one K3 launch on a tile alone; three traits against emmax_resident at
    the same tier (identical masks, max |dp| <= 1e-5), each fast tier
    against exact (max |dp| <= 1e-4). Then at n = 2,048 x 4,096, 8 traits
    in three missing-phenotype groups, the card against the float64 CPU
    path (identical masks, max |dp| <= 1e-5). Then run_gwas_multi(batched=
    True) from phase 6's PLINK fileset and a 4-trait phenotype CSV: equal
    (max |dp| <= 1e-12) to emmax_multi_trait on its own rows, Y and K, and
    to its own CSVs
 10 EMMA at BASELINE #2's shape: a binary genome of n = 1,300 x 215,000
    (--snps when smaller, never below 16,384) -> ResidentGenome ->
    kinship_resident (K1 once) -> scale_k -> eigh (float64, card) -> emma
    in float64 on the card: its wall, timings_s split (rotation, grid,
    refine, F) and SNP-tests/s, and BASELINE #2's parity against
    emmax_resident at exact (printed, not gated: rank correlation of
    -log10 p, max |d -log10 p|, hits at p < 1e-5 and their overlap, the
    spread of log delta). Gates: (a) the
    card's first 2,048 rows against the float64 CPU path, identical masks,
    max |dp| <= 1e-8, max |d log delta| <= 1e-6; (b) test='lrt' on those
    rows, the same; (c) VanRaden's singular K (n = 256, seed 3), the same;
    (d) dtype=float32 on those rows finishes with finite p (its drift and
    bracket flips printed)
 11 the class tests: linear_model (K3 once a tile and nothing else),
    anova and kruskal_wallis on phase 4's resident genome, each wall and
    rate; at n = 2,048 x 8,192, card against the float64 CPU path: anova
    and kruskal_wallis (diploid, 2 % missing calls: the missing-call KW)
    with identical validity masks and max |dp| <= 1e-8, emmax_anova at
    ploidy 2 (max |dp| <= 1e-5, identical masks; its all-heterozygous SNP
    masked), at ploidy 1 bit-equal to emmax, and at ploidy 2 under
    VanRaden's singular K (max |dp| <= 1e-4); then run_gwas methods emma,
    lm, anova and kw from phase 6's PLINK fileset, each equal (max |dp| <=
    1e-12) to the direct call on its rows, y and K and to its own CSV, emma
    launching K1 once, lm K3 once a tile
12 gBLUP and GxE: emmax_gxe on phase 4's resident genome with two
    environments (N(0, 1) and 0/1; an interaction planted at SNP 100) at
    'exact', every int8 and bf16 tier and 'high': each wall, its scan's
    rotations
    and statistics apart (CUDA events), E M / scan GxE-tests/s and the host
    p-values' seconds; no kernel launch (the rotations are library
    products, the statistics plain torch); each tier's max |dp| on the
    three p fields beside its ops/scan.py::GXE_P_DRIFT entry, each with
    identical masks and within its entry (int8x3 / bf16x3 also within
    1e-4), and every interaction with exact p <= 0.05 / M below the tier's
    rescore cut (ops/scan.py::rescore_p_cut on GXE_P_DRIFT; the largest
    such p printed). The card
    against the float64 CPU path at n = 2,048 x 4,096 (identical masks,
    max |dp| <= 1e-5), and under VanRaden's singular K at the three tiers
    (<= 1e-4). gblup on phase 4's eigh, reliability() and gblup_cv (5
    folds, an eigh a fold) on its K, each timed; on 2,048 samples the card
    against the CPU (u_hat and reliability within 1e-8 of their scale).
    Then from phase 6's PLINK fileset and a CSV of the trait and the
    environment: run_gwas method='emmax_gxe' (K1 once) equal (max |dp| <=
    1e-12) to the direct call on its rows, y, environment and K and to its
    own CSV; the CLI's predict at --folds 0 and 5 (K1 once each), its CSV
    equal (<= 1e-12) to the direct gblup / gblup_cv call
13 the permutation test and the two-SNP scan on phase 4's resident genome
    and eigh: emmax_perm_test with P = 128 at 'exact', 'int8x3' and
    'bf16x3', each wall, its scan's rotations, P-column products and
    max-F epilogue apart (CUDA events), P M / scan perm-scan-tests/s and
    no kernel launch; each fast tier's max F per permutation within rtol
    1e-4 of exact's and its threshold within 1e-4 relative; the card
    against the float64 CPU path at n = 2,048 x 8,192 (P = 16) and under
    VanRaden's singular K at the three tiers, to the same limits. Then
    emmax_two_snps on phase 4's top 4 exact hits: its wall and split, K3
    launched once a focal SNP a tile (4 x 32 at M = 262,144) and nothing
    else, every focal SNP's own cond_p 1; the card against the float64 CPU
    path at n = 2,048 x 8,192 with 4 focal SNPs, with and without the
    per-focal REML (identical masks, max |dp| <= 1e-5), and under the
    singular K (<= 1e-4)
14 the spectrum REML, the class facade and the examples: (a)
    projected_spectrum on the card (cuSOLVER, float64) against host LAPACK
    at n = 2,048 (max |dxi| <= 1e-9 max xi, projectors within 1e-9);
    fit_null_model's REML and ML, explicit and spectrum, on the card
    against the float64 numpy/scipy oracle at n = 2,048 (|d log delta| <=
    1e-10, |d ll| <= 1e-12 |ll|; a float32 eigh's reading printed beside);
    fit_null_model(method='spectrum') against 'explicit', both on the
    card, on phase 4's K (|d log delta| <= 1e-6, |d h2| <= 1e-9), the
    projected eigh and reml_from_spectrum timed alone; (b) h2_profile_ci
    on the card against the CPU in float64 at n = 2,048 (both ends <= 1e-8),
    then on phase 4's null with its wall; (c) LinearMixedModel(y) (no
    device=: the card) with phase 4's K: get_expedited_REMLE against
    fit_null_model with the facade's 18 bisection steps on phase 4's eigh
    (a pass-through check, |d log delta| <= 1e-9), emmax_f_test on
    phase 4's resident genome at exact, int8x3 and bf16x3, each equal to the
    direct emmax on the same eig_k (max |dp| <= 1e-12), its K3 / K2 / K5
    launches counted into the kernels line; get_estimates (betas <= 1e-8
    relative) and lm_step_wise (3 steps, the same cofactors) on the card
    against the CPU in float64 at n = 2,048; (d) python -m
    mixmogam_tpu_torch.examples: every ported scenario at its default size
    in a temporary directory, each wall printed; any scenario that raises
    fails the phase, and so does streaming_at_scale without its part (a)
 15 the streamed scan (models/streaming.py::emmax_streamed): (a0) at
    'high' on phase 4's genome, tile 8,192 (K3 once a tile), bit-equal to
    emmax_resident at 'high' (the same tile); (a) an int8
    host source of n x 4M rows (BASELINE #3's 10,240 x 1,048,576; the
    first M rows are phase 4's genome, the rest drawn on the card, timed
    apart), emmax(stream=True, tile=32,768) on phase 4's eigh at exact,
    int8x3 and bf16x3, each launching its kernel (K3, K2, K5) once a tile
    and held to emmax_resident on the same rows (max |dp| <= 1e-6, equal
    masks), with its wall, SNP-tests/s, H2D bytes and rate, the seconds
    waited on the prep thread and the card's busy share of the loop, and
    each kernel alone on a 32,768-row tile; (b) a streamed exact scan with
    checkpoint_dir in a subprocess over a lazy source drawn from a seed
    (n x 65,536, 4,096-row tiles), SIGKILLed once 3 tile files exist and
    resumed here: at least 3 tiles restored, equal to an uninterrupted run
    (max |dp| <= 1e-12), and again after the manifest is cut to half its
    bytes; (c) float32 dosages in [0, 2] with 1 % NaN, n x 9M/8 (12.1 GB at
    full size, past the in-core budget): emmax with no stream= must stream
    by itself, rows
    [0, 32,768) equal to emmax(stream=False) on them (max |dp| <= 1e-6);
    then precision='bf16x3' with stream=True streams the first 65,536 of
    them through the float route (K3 once a tile, no K5): its wall, rate
    and stream_stats, rows [0, 32,768) equal to the in-core float route on
    them (max |dp| <= 1e-6, equal masks), the whole within
    FRACTIONAL_P_DRIFT['bf16x3'] of the streamed
    exact scan with equal masks; (d) emmax_multi_trait,
    T = 8, on (c)'s first 65,536 rows, streamed by stream_budget_bytes=1
    (every tile read from the host), K3 T
    times a tile, rows [0, 32,768) equal to the in-core multi-trait scan
    (max |dp| <= 1e-6), trait 0 within phase 9's 1e-5 of (c)'s single-trait
    p; (e) the CLI's run --stream on --checkpoint-dir on phase 6's PLINK
    fileset: its CSV equal to run_gwas emmax (max |dp| <= 1e-6), and a
    second identical run restores every tile and scans none
 16 the host data plane (native.py's C++ parsers, ResidentGenome's packed
    cache) at n samples, the rows cut so that writing the files (numpy,
    timed apart) fits the phase: (a) a dosage CSV of 32,768 rows (0.67 GB
    at full width): parse_snp_data on the native route, its GB/s, equal
    to the source rows; (b) a VCF of 16,384 rows and a VCF.gz of 8,192
    (haploid GT calls): read_vcf on the native route equal to the source,
    read_vcf_packed -> ResidentGenome on the card torch.equal to
    from_source of the same rows, each with its GB/s; read_vcf of the
    first 256 rows on the Python route equal to the source; (c) phase
    6's --facade-snps genome also as a dosage CSV and a VCF.gz: run_gwas
    emmax at 'exact' and 'int8x3' from the CSV and at 'bf16x3' from the
    VCF.gz, each equal (max |dp| <= 1e-12, the same masks) to the same
    call from phase 6's PLINK fileset, K1 once and K3 / K2 / K5; the exact
    call from the CSV's first 512 rows on the native and on the Python
    route, equal to each other (parse_snp_data's seconds on both routes,
    both parses equal to the source); (d) from_source(G,
    cache_path=) on phase 4's genome cold, warm and validated, with
    trust_cache=True and with G=None, each wall printed, each packed
    genome torch.equal to phase 4's, packs growing only on the cold call;
    emmax_resident int8x3 on the cached genome equal to phase 4's (max
    |dp| 0.0); the same shape with one row changed packs again. The phase
    fails when native.available() is false, and prints the compiler's
    message
 17 imputed (fractional) dosages: the imputed form of phase 4's genome
    drawn on the card (g * 0.97 + 0.01 + U(-0.01, 0.01), 1 % NaN, float32):
    (a) emmax in core (stream=False) at M = 32,768 (1.3 GB) on phase 4's
    eigh at exact, bf16x3, bf16x2, bf16 and 'high' (the dosages split
    too), each wall and rate, K3 once a tile and nothing else, the bf16
    rotation and the mask + K3 of one 16,384-row tile timed alone; each
    tier against exact with equal masks and max |dp| <=
    FRACTIONAL_P_DRIFT; bf16x3 with rescore_top
    rescores every SNP with exact p <= 0.05 / M (to exact's p, 1e-12),
    its count printed; (b) at n = 2,048 x 2,048 the card against the
    float64 CPU path at the three bf16 tiers and 'high' on one host eigh
    (equal masks,
    max |dp| <= 1e-5), and the bf16x3 products' float32 sums against the
    float64 products of the same bf16 operands (max |d| / sum |g w| <=
    n 2^-24);
    (d) emmax_loco on the first 16,384 rows in 2 chromosomes (TAIR10's
    proportions, 2-5 merged) at exact and bf16x3 (IBS) and exact
    (VanRaden): each wall,
    each chromosome's log lines (gram+fetch, algebra+eigh, fit+scan), K3
    once a chromosome tile and nothing else; bf16x3 within
    FRACTIONAL_P_DRIFT of exact with equal masks; the host route's
    loco_kinships on phase 6's integer genome (chromosomes 3-5 merged)
    cast to float32 against the resident route's (K1 / K4): max |dK| <=
    1e-6; (e) a DS VCF of the first 256 imputed rows in 2 chromosomes (the
    Python route parses DS): run_gwas
    emmax_loco and emmax bf16x3 from it, each equal to the direct call on
    its rows, y and K (max |dp| <= 1e-12)
 18 parallel/'s data-parallel core: (a) a world of one over NCCL (a
    file:// store), make_mesh() on the card, at full width:
    distributed_kinship bit-equal to kinship_resident, distributed_emmax
    at exact, int8x3 and bf16x3 equal to emmax_resident (identical masks,
    max |dp| <= 1e-12; whether bit-equal printed), K1, K3, K2 and K5 each
    launched by the distributed calls; then distributed_train_step (ROADMAP
    item 16e) on phase 4's genome and phase 9's T = 50 traits, top_k 8:
    its wall and split (kinship, eigh + spectrum, REML, nulls, broadcast,
    rotation and K3 from CUDA events, top-k + gather), K1 once and K3 T x
    16 tiles and nothing else, K bit-equal to phase 4's integer gram over
    M, every delta within 1e-6 relative of phase 9's exact multi-trait
    null (its eigh of scale_k(K), its explicit REML at esp 1e-6) times
    mean(diag(K)), traits 0 and 49 within 1e-10 of fit_null_model(method=
    'spectrum'), top_idx the top F of phase 9's exact multi-trait scan
    (ties to the lower row), top_f within 1e-4 relative; (c) in the same
    group, the sharded resident scan: from_source(upload=False) of phase
    4's genome (its wall; torch.cuda.memory_allocated() unchanged across
    it), emmax(mesh=)
    over that host-only container at exact, int8x3 and bf16x3, first call
    and again, each bit-equal to emmax_resident, the shard uploads (1, then
    0); distributed_kinship over it bit-equal to kinship_resident;
    emmax_loco(mesh=) on phase 6's genome bit-equal to phase 6's direct
    exact call; each wall beside the single-device one, and K1-K5 each
    launched by those calls; (b) two gloo ranks sharing the card,
    subprocesses, on the first 32,768 rows, held to the single-device
    calls by the same gates: distributed_emmax and distributed_emmax_
    resident (each rank's shard of a host-only container) at the three
    tiers, and emmax_loco(mesh=) on n = 2,048 x 8,192 rows packed at a
    2,048-row tile in 3 chromosomes, one on each rank and one across
    both, bounds on the tile; the same rows with bounds off it (3,000 and
    5,500, the middle chromosome tiled from the ranks' boundary on rank
    1) held to identical masks and max |dp| <= LOCO_OFF_TILE_TOL; which
    gloo collectives take CUDA tensors in this torch printed; the walls;
    then on the same rows the three campaign scans on the two ranks,
    emmax_step_wise(mesh=) (3 steps), emmax_multi_trait(mesh=) (4 traits)
    at exact, int8x3 and 'high' and over each rank's shard of a host-only
    container, and emma(mesh=), each held to its single-device call by
    the same gates (stepwise: the same path and selections, min_p and the
    criteria within rtol 1e-12); (d) in (a)'s group, item 16c's first
    half at full width, each call bit-equal to the single-device result
    its phase kept (no single-device call run again) with its wall beside
    that phase's: emmax_step_wise(mesh=) on phase 4's host genome and
    eigh (phase 8's stored route, 10 steps; K3 launched as often as
    there), emmax_multi_trait(mesh=) on phase 9's T = 50 traits at exact
    and int8x3 over phase 4's resident genome and once at exact over
    (c)'s host-only container (K3 T x tiles each), and emma(mesh=) on
    phase 10's n = 1,300 x 215,000 genome; (e) in that group, item 16c's
    second half at full width, each call bit-equal to the single-device
    result phase 11, 12 or 13 kept, its wall beside that phase's and K3
    launched as often as there: linear_model / anova / kruskal_wallis
    (mesh=) on phase 4's resident genome, emmax_gxe(mesh=) (E = 2) at
    exact and int8x3, emmax_perm_test(mesh=) (P = 128) at exact and
    int8x3, emmax_two_snps(mesh=) on phase 4's top 2 hits, and
    emmax_anova(mesh=) on a diploid genome of n x 16,384 (2 % missing
    calls) drawn in the phase, held to a single-device call on it; (b)
    then adds the five on its two gloo ranks (the class tests, GxE and the
    permutation test at exact, int8x3 and 'high' over each rank's shard of its
    host-only container, two-SNP with A = 4 and emmax_anova on the host rows),
    each within 1e-12 of its single-device call with identical masks; and, on
    the same two ranks as a (1, 2) 'sample' mesh (item 16d-i) on the first
    16,384 rows (one tile), distributed_kinship bit-equal to one device,
    distributed_emmax and distributed_emmax_resident at exact / int8x3 /
    bf16x3 with the masks of one device's emmax_resident and max |dp|
    within _tp_tol, emmax(mesh=) at int8x3, each rank's (n / 2, n) block of
    U' / the planes / the parts, and the int8x3 plane products summed over
    'sample' bit-equal to one device's whole-row torch._int_mm products;
    then on that mesh the campaign entry points (item 16d-ii), each held
    to its single-device call: emmax_step_wise(mesh=) (3 steps on the
    same rows; each rank stores its (16,384, n / 2) block of rotated
    columns; the same path, cofactors and selections, min_p within
    _tp_tol), emmax_multi_trait(mesh=) (T = 4; exact and 'high' in core
    and int8x3 over the host-only container; masks equal, p within _tp_tol,
    'high' within bf16x3's, int8x3's f_stats bit-equal) and emmax_loco(mesh=)
    on the n = 2,048 x 8,192 LOCO fixture (masks equal, p within _tp_tol,
    each delta within rtol 1e-12); and on that mesh's first 4,096 rows (a
    cut of depth, so the script keeps its clock) the remaining entry points (item 16d-iii),
    each held to its single-device call on the card on the same rows:
    emmax_gxe(mesh=) (E = 2) at exact (masks equal, p within _tp_tol) and
    at int8x3 with an exact rescore of its top 64 interactions (the same
    rows rescored, bit-equal off them, p within GXE_P_DRIFT) and at
    'high' (masks equal, p within bf16x3's _tp_tol),
    emmax_perm_test(mesh=) (P = 128; at 'high' it must raise the JAX
    package's refusal on both ranks, in core and over a container),
    emmax_two_snps(mesh=) (A = 2, K3 A
    x tiles a rank), emmax_anova(mesh=) binary (through emmax(mesh=), K3
    launched) and diploid on (e)'s genome (masks and dofs equal), each p
    within _tp_tol, and linear_model / anova / kruskal_wallis (mesh=)
    bit-equal (the axis replicates them); each call's wall beside one
    device's, the bytes each rank reduced and its launches printed (K1 /
    K4 / K3 added to the kernels line); then on the same two ranks
    distributed_train_step (item 16e; T = 4, top_k 8, the 32,768 rows) on
    the (2, 1) and the (1, 2) mesh and, in rank 0's process, a world of one:
    top_f, top_idx, deltas and K bit-equal across the three, K bit-equal to
    one device's integer gram, K1 once and K3 4 x tiles a call on a rank
    (added to the kernels line), and each rank's split printed; and
    parallel/dryrun.py::dryrun_rank on the (2, 1) mesh (the JAX dry run's
    phases at n = 32 x 64, each mesh call held to one device's), its
    summary line printed

The line before the last is a JSON object with each kernel's launches,
error, times and bound; the last line is {"ok": true, "device": {...}}. Any
failed phase exits non-zero before either is printed.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import subprocess
import sys
import tempfile
import time


def _phase(name, t0):
    print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def _cuda_ms(fn, reps: int = 3) -> float:
    """Mean device time of fn() over reps launches (after one warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# NVIDIA's data sheet for the H100 SXM, dense: operations a second by
# operand type, and device-memory bytes a second
_PEAK = {"int8": 1.979e15, "bf16": 9.89e14, "fp32": 6.7e13}
_HBM_BYTES_S = 3.35e12


def _bound(ops: float, kind: str, *tensors) -> dict:
    """The least time the card could take: every tensor given (inputs and
    the output) crosses device memory once, `ops` operations run at the
    peak rate of `kind`; the larger of the two, in ms."""
    by = sum(t.numel() * t.element_size() for t in tensors)
    t_b, t_o = by / _HBM_BYTES_S * 1e3, ops / _PEAK[kind] * 1e3
    return dict(bound_ms=max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o else "operations")


def _gram_ops(n: int, rows: int, ploidy: int) -> float:
    """K1 / K4: the upper triangle (diagonal included) of the 0/1 planes'
    gram, ploidy * rows deep, two operations a multiply-add."""
    return 2.0 * (n * (n + 1) // 2) * ploidy * rows


def _int_mm_ms(Zt, what: str):
    """Time of one torch._int_mm(Z^T, Z) over unpacked int8 rows given as
    the contiguous (n, rows) Z^T (rows padded with zeros to a multiple of
    8, which the call requires); None, with the reason printed, if this
    PyTorch lacks the call or refuses the shape."""
    import torch

    k = Zt.shape[1]
    if k % 8:
        Zt = torch.nn.functional.pad(Zt, (0, -k % 8))
    return _library_ms(lambda: torch._int_mm(Zt, Zt.t()),
                       f"{what}: torch._int_mm")


def _library_ms(fn, what: str):
    """Time of the library call fn(), which the port never makes; None,
    with the reason printed, if this PyTorch lacks the call or refuses the
    shape. A fault that an earlier kernel left on the card raises before
    the attempt, and one in the timed launches after it: neither is taken
    for a refusal."""
    import torch

    torch.cuda.synchronize()
    try:
        fn()
    except (AttributeError, RuntimeError) as exc:
        print(f"{what} not timed: {str(exc)[:200]}", flush=True)
        return None
    return _cuda_ms(fn)


def _check_stats(name, got, ref, beta_atol=1e-5):
    """K2/K3 against their plain versions: the JAX kernel tests'
    tolerances (tests/test_kernels.py: f rtol 1e-4 / atol 1e-4, beta
    atol 1e-5) and identical masks. Returns max |df|."""
    import torch

    g, r = got.double().cpu(), ref.double().cpu()
    if not torch.equal(g[3] > 0.5, r[3] > 0.5):
        raise AssertionError(f"{name}: masks differ in "
                             f"{int(((g[3] > 0.5) != (r[3] > 0.5)).sum())}"
                             " rows")
    df = (g[0] - r[0]).abs()
    if not bool((df <= 1e-4 + 1e-4 * r[0].abs()).all()):
        raise AssertionError(f"{name}: f differs by up to {df.max():.3e}")
    db = (g[1] - r[1]).abs().max().item()
    if db > beta_atol:
        raise AssertionError(f"{name}: beta differs by up to {db:.3e}")
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name}: non-finite output")
    return df.max().item()


def _read_ranked_csv(path):
    """{(chromosome, position): p} from a ranked p-value CSV."""
    with open(path) as f:
        head = f.readline().strip().split(",")
        if head[:3] != ["chromosomes", "positions", "scores"]:
            raise AssertionError(f"{path}: header {head}")
        return {(int(c), int(p)): float(v) for c, p, v in (
            line.split(",")[:3] for line in f)}


def _draw_genotypes(n: int, m: int, ploidy: int = 1,
                    missing_rate: float = 0.0, seed: int = 0, out=None):
    """(m, n) int8 host genotypes (-1 = missing) of data/simulate.py's
    model (Balding-Nichols: 3 populations, Fst 0.1, ancestral frequencies
    uniform on 0.05-0.5), written into `out` when given. The per-SNP
    frequencies come from numpy; the (m, n) uniform draws are made on the
    card, which numpy makes in half a minute for 262,144 x 10,240 on the
    host."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    p = rng.uniform(0.05, 0.5, size=m)
    freqs = torch.as_tensor(
        rng.beta(p * 9.0, (1.0 - p) * 9.0, size=(3, m)).astype(np.float32),
        device="cuda")
    pop = torch.as_tensor(rng.integers(0, 3, size=n), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    G = np.empty((m, n), dtype=np.int8) if out is None else out
    for s in range(0, m, 16_384):
        f = freqs[:, s:s + 16_384][pop].T               # (rows, n)
        acc = torch.zeros(f.shape, dtype=torch.int8, device="cuda")
        for _ in range(ploidy):
            acc += torch.rand(f.shape, generator=g, device="cuda") < f
        if missing_rate > 0:
            acc[torch.rand(f.shape, generator=g, device="cuda")
                < missing_rate] = -1
        G[s:s + 16_384] = acc.cpu().numpy()
    return G


def _draw_traits(G_rows, T: int, seed: int):
    """(T, n) phenotypes of data/simulate.py's model over the int8 rows
    G_rows (m, n), all T at once on the card: 10 causal rows a trait with
    N(0, 1) effects, a polygenic term over every row and noise, with h2
    spread evenly over 0.1-0.9 (trait 0 to trait T - 1)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    m, n = G_rows.shape
    Gd = torch.as_tensor(np.ascontiguousarray(G_rows),
                         device="cuda").float().T          # (n, m)
    B = np.zeros((m, T), np.float32)
    for t in range(T):
        B[rng.choice(m, 10, replace=False), t] = rng.normal(size=10)
    W = (rng.normal(size=(m, T)) / np.sqrt(m)).astype(np.float32)
    fixed = (Gd @ torch.as_tensor(B, device="cuda")).double().cpu().numpy()
    u = (Gd @ torch.as_tensor(W, device="cuda")).double().cpu().numpy()
    u = (u - u.mean(axis=0)) / u.std(axis=0)
    h2 = np.linspace(0.1, 0.9, T)
    e = rng.normal(size=(n, T))
    return (fixed + np.sqrt(h2) * u + np.sqrt(1.0 - h2) * e).T.copy()


def _check_no_jax() -> None:
    """The port runs without JAX and without the JAX package."""
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "mixmogam_tpu"))
    if bad:
        raise AssertionError(f"the port imported {bad[:5]}")


def _emma_phase(args, dev, kernels, launches) -> dict:
    """Phase 10: EMMA at BASELINE #2's shape (n = 1,300 inbred lines, ploidy
    1, M = 215,000) in float64 on the card, its split and rate, its parity
    with EMMAX (printed), and gates (a)-(d) against the float64 CPU path.
    Returns the genome, y, eigh and the call's result and wall."""
    import numpy as np
    import scipy.stats
    import torch

    from mixmogam_tpu_torch.data.simulate import (simulate_genotypes,
                                                  simulate_phenotype)
    from mixmogam_tpu_torch.models.emma import emma
    from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                    emmax_resident,
                                                    kinship_resident,
                                                    scale_k)
    from mixmogam_tpu_torch.ops.eigen import eigen_k
    from mixmogam_tpu_torch.oracle.kinship import vanraden_kinship

    n = 1_300
    # BASELINE #2's 215,000 rows, or --snps in a rehearsal (never below
    # 16,384)
    M = 215_000 if args.snps >= 215_000 else max(16_384, args.snps)
    ts = time.perf_counter()
    G = _draw_genotypes(n, M, seed=args.seed + 100)
    y, causal = simulate_phenotype(G[:16_384], h2=0.5, n_causal=5,
                                   causal_effect=1.0, seed=args.seed + 100)
    for k in kernels:
        k.launches = 0
    rg = ResidentGenome.from_source(G)
    K = scale_k(kinship_resident(rg))
    phi, U = eigen_k(torch.as_tensor(K, device=dev), host=False)
    torch.cuda.synchronize()
    run = {k.__name__: k.launches for k in kernels}
    print(f"EMMA genome n={n} M={M} (binary), K1 kinship and float64 eigh "
          f"on the card: {time.perf_counter() - ts:.3f} s; launches {run}",
          flush=True)
    if run["ibs_gram_packed"] != 1:
        raise AssertionError("phase 10's kinship did not launch K1 once")
    emma(rg.slice_rows(0, 256), y, eig_k=(phi, U))       # first-call costs
    torch.cuda.synchronize()
    ts = time.perf_counter()
    e = emma(rg, y, eig_k=(phi, U))
    wall = time.perf_counter() - ts
    for name, cnt in run.items():
        launches[name] += cnt
    tm = e["timings_s"]
    print(f"emma float64 on the card, n={n} M={M}: {wall:.3f} s = "
          f"{M / wall:,.0f} SNP-tests/s; rotation {tm['rotation']:.3f} s, "
          f"grid {tm['grid']:.3f} s, refine {tm['refine']:.3f} s "
          f"({tm['refine'] / wall:.2f} of the call), F {tm['f']:.3f} s, "
          f"p-values {tm['p_values']:.3f} s", flush=True)
    ps = e["ps"]
    if ps.shape != (M,) or not np.isfinite(ps).all() or (
            (ps < 0) | (ps > 1)).any() or not np.isfinite(
            e["deltas"][e["mask"]]).all():
        raise AssertionError("emma: malformed output")
    # BASELINE #2's parity summary against EMMAX at exact (printed)
    k3 = next(k for k in kernels if k.__name__ == "scan_stats")
    before = k3.launches
    ts = time.perf_counter()
    x = emmax_resident(rg, y, eig_k=(phi, U))
    scan_k3 = k3.launches - before
    launches["scan_stats"] += scan_k3
    lp_e, lp_x = -np.log10(e["ps"]), -np.log10(x["ps"])
    rho = scipy.stats.spearmanr(lp_e, lp_x).statistic
    hit_e, hit_x = set(np.flatnonzero(e["ps"] < 1e-5)), set(
        np.flatnonzero(x["ps"] < 1e-5))
    ld = np.log(e["deltas"][e["mask"]])
    print(f"   vs emmax_resident exact ({time.perf_counter() - ts:.3f} s, K3 "
          f"launches {scan_k3}): Spearman rho of -log10 p {rho:.6f}, max "
          f"|d -log10 p| {np.abs(lp_e - lp_x).max():.4f}; p < 1e-5: EMMA "
          f"{len(hit_e)}, EMMAX {len(hit_x)}, both {len(hit_e & hit_x)}; "
          f"causal in EMMA's top 20: "
          f"{len(set(np.argsort(e['ps'])[:20]) & set(causal.tolist()))} of "
          f"{len(causal)}; per-SNP log delta min "
          f"{ld.min():.4f} / 5 % {np.quantile(ld, 0.05):.4f} / median "
          f"{np.median(ld):.4f} / 95 % {np.quantile(ld, 0.95):.4f} / max "
          f"{ld.max():.4f} (EMMAX's null {np.log(x['delta']):.4f})",
          flush=True)
    del x
    # (a) the card against the float64 CPU path on the first 2,048 rows
    ts = time.perf_counter()
    m = min(2_048, M)
    eig_cpu = (phi.cpu(), U.cpu())
    c = emma(G[:m], y, eig_k=eig_cpu, device="cpu")
    _emma_gate("(a) float64, card vs CPU", {k: v[:m] for k, v in e.items()
                                           if k != "timings_s"}, c, 1e-8)
    # (b) the LRT on the same rows
    lc = emma(rg.slice_rows(0, m), y, eig_k=(phi, U), test="lrt")
    lh = emma(G[:m], y, eig_k=eig_cpu, test="lrt", device="cpu")
    _emma_gate("(b) test='lrt', card vs CPU", lc, lh, 1e-8)
    # (d) float32 on the card: its drift, not gated
    f32 = emma(rg.slice_rows(0, m), y, eig_k=(phi, U), dtype=torch.float32)
    if not np.isfinite(f32["ps"]).all():
        raise AssertionError("(d) emma float32: non-finite p-values")
    both = f32["mask"] & c["mask"]
    flips = int((np.abs(np.log(f32["deltas"][both])
                        - np.log(c["deltas"][both])) > 0.2).sum())
    print(f"   (d) float32 on the card vs float64: max|dp| "
          f"{np.abs(f32['ps'] - c['ps']).max():.3e}, "
          f"{int((f32['mask'] != c['mask']).sum())} mask(s) differ, {flips} "
          f"SNP(s) with log delta more than one grid step (0.2) apart "
          f"(not gated)", flush=True)
    print(f"   gates (a), (b), (d): {time.perf_counter() - ts:.3f} s",
          flush=True)
    # (c) VanRaden's singular K (n = 256, seed 3; delta at its bound)
    Gv, _, _ = simulate_genotypes(256, 3_000, ploidy=1, seed=3)
    yv, _ = simulate_phenotype(Gv, h2=0.5, n_causal=4, seed=3)
    Kv = scale_k(vanraden_kinship(Gv.astype(np.float64), ploidy=1))
    eigv = eigen_k(Kv)
    _emma_gate("(c) VanRaden's singular K, card vs CPU",
               emma(Gv, yv, eig_k=eigv),
               emma(Gv, yv, eig_k=eigv, device="cpu"), 1e-8)
    return dict(rg=rg, y=y, eig=(phi, U), res=e, wall=wall)


def _emma_gate(label, card, cpu, p_tol) -> None:
    """Identical masks, max |dp| <= p_tol, max |d log delta| <= 1e-6 over
    the unmasked SNPs."""
    import numpy as np

    nm = int((card["mask"] != cpu["mask"]).sum())
    dp = float(np.abs(card["ps"] - cpu["ps"]).max())
    mk = cpu["mask"]
    dld = float(np.abs(np.log(card["deltas"][mk])
                       - np.log(cpu["deltas"][mk])).max()) if mk.any() else 0.0
    j = int(np.argmax(np.abs(card["ps"] - cpu["ps"])))
    print(f"   {label}: {len(mk)} SNPs, {nm} mask(s) differ, max|dp| "
          f"{dp:.3e}, max|d log delta| {dld:.3e} (largest |dp| at SNP {j}: "
          f"log delta {np.log(card['deltas'][j]):.9f} on the card, "
          f"{np.log(cpu['deltas'][j]):.9f} on the CPU)", flush=True)
    if nm or dp > p_tol or dld > 1e-6:
        raise AssertionError(f"emma {label}: outside the gate")


def _class_phase(args, dev, kernels, launches, main, facade, files, tmp,
                 counts, tiles) -> None:
    """Phase 11: linear_model, anova and kruskal_wallis on phase 4's
    resident genome; the class tests and emmax_anova on the card against
    the float64 CPU path at n = 2,048 x 8,192; run_gwas methods emma, lm,
    anova and kw from phase 6's PLINK fileset."""
    import numpy as np
    import torch

    from mixmogam_tpu_torch.data.simulate import (simulate_genotypes,
                                                  simulate_phenotype)
    from mixmogam_tpu_torch.models.emma import emma
    from mixmogam_tpu_torch.models.emmax import emmax, emmax_anova
    from mixmogam_tpu_torch.models.linear import (_class_sums_packed, anova,
                                                  kruskal_wallis,
                                                  linear_model)
    from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                    kinship_resident,
                                                    scale_k, subdivide_tile)
    from mixmogam_tpu_torch.oracle.kinship import vanraden_kinship
    from mixmogam_tpu_torch.utils.caching import cached_kinship

    rg, y = main["rg"], main["y"]
    full_tiles = -(-rg.M // rg.tile)
    walls = {}
    for fn, want in ((linear_model, counts(scan_stats=full_tiles)),
                     (anova, counts()), (kruskal_wallis, counts())):
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        ts = time.perf_counter()
        r = fn(rg, y)
        wall = time.perf_counter() - ts
        run = {k.__name__: k.launches for k in kernels}
        for name, cnt in run.items():
            launches[name] += cnt
        ps = r["ps"]
        print(f"{fn.__name__} on the resident genome, n={rg.n} M={rg.M}: "
              f"{wall:.3f} s = {rg.M / wall:,.0f} SNP-tests/s; launches "
              f"{run}; min p {ps.min():.3e}", flush=True)
        if run != want:
            raise AssertionError(f"{fn.__name__}: launches {run}, expected "
                                 f"{want}")
        if ps.shape != (rg.M,) or not np.isfinite(ps).all() or (
                (ps < 0) | (ps > 1)).any():
            raise AssertionError(f"{fn.__name__}: malformed p-values")
        walls[fn.__name__] = wall
        # kept for phase 18 (e)'s mesh= calls
        main.setdefault("cls11", {})[fn.__name__] = dict(
            res=r, wall=wall, k3=run["scan_stats"])
    # the class sums alone (anova's [1, y, y^2] and KW's [1, ranks]: the
    # indicator products over the packed rows), against each whole call
    for name, cols in (("anova", 3), ("kruskal_wallis", 2)):
        W = torch.ones((rg.n, cols), dtype=torch.float64, device=dev)
        torch.cuda.synchronize()
        ts = time.perf_counter()
        _class_sums_packed(rg.packed, W, rg.n, rg.M, subdivide_tile(rg.tile),
                           rg.ploidy + 1)
        torch.cuda.synchronize()
        alone = time.perf_counter() - ts
        print(f"   {name}'s class sums alone ({cols} weight columns): "
              f"{alone:.3f} s = {alone / walls[name]:.2f} of its call",
              flush=True)

    # the card against the float64 CPU path, n = 2,048 x 8,192
    ts = time.perf_counter()
    nd, Md = 2_048, 8_192
    Gd, _, _ = simulate_genotypes(nd, Md, ploidy=2, missing_rate=0.02,
                                  seed=args.seed + 110)
    Gd[0] = 1                              # every sample heterozygous
    yd, _ = simulate_phenotype(np.where(Gd < 0, 0, Gd), h2=0.5, n_causal=5,
                               seed=args.seed + 110)
    for fn in (anova, kruskal_wallis):
        a, b = fn(Gd, yd), fn(Gd, yd, device="cpu")
        nm = int(((a["ps"] < 1) != (b["ps"] < 1)).sum())
        dp = float(np.abs(a["ps"] - b["ps"]).max())
        print(f"   {fn.__name__} (diploid, 2 % missing calls), card vs CPU "
              f"float64: {nm} validity mask(s) differ, max|dp| {dp:.3e}",
              flush=True)
        if nm or dp > 1e-8:
            raise AssertionError(f"{fn.__name__}: card and CPU disagree")
    Kd = scale_k(kinship_resident(ResidentGenome.from_source(Gd),
                                  dtype=torch.float64))
    a = emmax_anova(Gd, yd, K=Kd)
    b = emmax_anova(Gd, yd, K=Kd, device="cpu")
    _pair_gate("emmax_anova ploidy 2 (2 % missing calls)", a, b, 1e-5)
    if a["dof1"][0] != 0 or a["mask"][0] or b["dof1"][0] != 0:
        raise AssertionError("the all-heterozygous SNP's I1 was not masked")
    print("   the all-heterozygous SNP: d1 = 0, masked, on the card and the "
          "CPU", flush=True)
    Gb, _, _ = simulate_genotypes(nd, Md, ploidy=1, seed=args.seed + 111)
    yb, _ = simulate_phenotype(Gb, h2=0.5, n_causal=5, seed=args.seed + 111)
    Kb = scale_k(kinship_resident(ResidentGenome.from_source(Gb)))
    a = emmax_anova(Gb, yb, K=Kb)
    b = emmax(Gb, yb, K=Kb, tile=4096)
    same = all(np.array_equal(a[k], b[k]) for k in ("ps", "f_stats", "mask"))
    print(f"   emmax_anova ploidy 1 vs emmax: bit-equal {same}", flush=True)
    if not same:
        raise AssertionError("emmax_anova at ploidy 1 differs from emmax")
    Gv, _, _ = simulate_genotypes(256, 3_000, ploidy=2, seed=3)
    yv, _ = simulate_phenotype(Gv, h2=0.5, n_causal=4, seed=3)
    Kv = scale_k(vanraden_kinship(Gv.astype(np.float64), ploidy=2))
    a = emmax_anova(Gv, yv, K=Kv)
    b = emmax_anova(Gv, yv, K=Kv, device="cpu")
    _pair_gate(f"emmax_anova ploidy 2, VanRaden's K (delta "
               f"{b['delta']:.3e})", a, b, 1e-4)
    print(f"   card vs CPU checks: {time.perf_counter() - ts:.3f} s",
          flush=True)

    # run_gwas from phase 6's PLINK fileset, each held to its direct call
    def direct(fn, **kw):
        return lambda g2, y2: fn(g2, y2, **kw)

    out = facade("emma", files + (os.path.join(tmp, "emma"),),
                 lambda g2, y2: emma(g2, y2, K=cached_kinship(g2, "ibs"),
                                     tile=16_384),
                 lambda g2: counts(ibs_gram_packed=1), method="emma")
    print(f"   emma timings_s "
          f"{json.dumps({k: round(v, 3) for k, v in out['scan']['timings_s'].items()})}",
          flush=True)
    facade("lm", files + (os.path.join(tmp, "lm"),),
           direct(linear_model, tile=16_384),
           lambda g2: counts(scan_stats=tiles(g2)), method="lm")
    facade("anova", files + (os.path.join(tmp, "anova"),), direct(anova),
           lambda g2: counts(), method="anova")
    facade("kw", files + (os.path.join(tmp, "kw"),), direct(kruskal_wallis),
           lambda g2: counts(), method="kw")


def _pair_gate(label, card, cpu, p_tol) -> None:
    import numpy as np

    nm = int((card["mask"] != cpu["mask"]).sum())
    dp = float(np.abs(card["ps"] - cpu["ps"]).max())
    print(f"   {label}, card float32 vs CPU float64: {nm} mask(s) differ, "
          f"max|dp| {dp:.3e}", flush=True)
    if nm or dp > p_tol:
        raise AssertionError(f"{label}: card and CPU disagree")


def _gxe_drift(a, b) -> tuple:
    """(masks that differ over mask and mask_inter, max |dp| over the three
    p fields) of two emmax_gxe results."""
    import numpy as np

    nm = sum(int((a[k] != b[k]).sum()) for k in ("mask", "mask_inter"))
    return nm, max(float(np.abs(a[k] - b[k]).max())
                   for k in ("marginal_ps", "inter_ps", "joint_ps"))


#: the tiers each drift table holds, beside 'exact' (the 'c' spellings
#: run their tier's kernel)
_DRIFT_TIERS = ("int8x2", "int8x3", "int8x4", "bf16", "bf16x2", "bf16x3",
                "high")


def _check_tf32_off(after: str) -> None:
    """TF32 still off after a call: the 'high' tier's bf16 products leave
    the float32 GEMMs at full fp32 (ops/__init__.py's pin)."""
    import torch

    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError(f"TF32 was switched on after {after}")


def _rule_entry(dp: float) -> float:
    """The smallest one-significant-digit value at least twice dp: the
    rule that sets ops/scan.py's TIER_P_DRIFT and GXE_P_DRIFT from the
    largest max |dp| a tier showed."""
    import math

    v = 2.0 * dp
    if v <= 0.0:
        return 0.0
    e = math.floor(math.log10(v))
    m = math.ceil(v / 10.0 ** e - 1e-9)
    if m >= 10:
        m, e = 1, e + 1
    return float(f"{m}e{e}")


def _drift_table(label, runs, table) -> dict:
    """Print each tier's max |dp| against exact on each fixture beside its
    table entry and the rule's value; runs: {fixture: {tier: (max |dp|,
    masks that differ)}}. Returns {tier: largest max |dp|}."""
    worst = {}
    for tier in _DRIFT_TIERS:
        cells = [f"{fx} {runs[fx][tier][0]:.3e}"
                 + (f" ({runs[fx][tier][1]} masks differ)"
                    if runs[fx][tier][1] else "") for fx in runs]
        worst[tier] = max(runs[fx][tier][0] for fx in runs)
        print(f"   {label} drift {tier} vs exact, max|dp|: "
              f"{'; '.join(cells)}; largest {worst[tier]:.3e}; entry "
              f"{table.get(tier, float('nan')):g} (2x rounded up to one "
              f"digit: {_rule_entry(worst[tier]):g})", flush=True)
    return worst


#: phase 3: the imputed tiles the 'high' products are held on, each drawn
#: from args.seed + one of these (its genotypes, its noise and its trait)
_HIGH_DRAWS = (11, 12, 13)


def _high_products(null, G1, dev, rows: int, n: int, seed: int) -> None:
    """Phase 3's check of the 'high' tier (no kernel of its own: bf16
    library products with float32 outputs, ops/rotate.py::rotate_high,
    then the exact tier's mask and K3) on one tile of integer rows (G1,
    two products over all n) and on three tiles of imputed rows (the
    seeds args.seed + _HIGH_DRAWS: g * 0.97 + 0.01 + U(-0.01, 0.01) of
    the genotype model's rows, each with its own trait; three products a
    chunk of ops/rotate.py::HIGH_CHUNK samples), against its plain version
    on the card (ops/scan.py::apply_rotation_high: the same bf16 splits,
    each product in float64, summed in float32; then scan_stats_plain):
    the products within float32's bound of their float64 values (n 2^-24
    of sum |g u|), K3 on them within its limits, and the whole within the
    kernels' limits (f rtol / atol 1e-4, masks, beta atol 1e-5), beta
    printed beside the exact tier's fp32 GEMM's own reach. The products
    are timed beside the exact tier's fp32 GEMM on the same rows and
    beside their bound."""
    import dataclasses

    import torch

    from mixmogam_tpu_torch.ops.hopper_scan import scan_stats_plain
    from mixmogam_tpu_torch.ops.rotate import HIGH_CHUNK, rotate_high
    from mixmogam_tpu_torch.ops.scan import (apply_rotation_high,
                                             build_rotated_null,
                                             emmax_scan_stats,
                                             outside_design)

    def tiles():
        yield "integer", torch.as_tensor(G1, device=dev), null
        for d in _HIGH_DRAWS:
            gd = torch.Generator(device=dev).manual_seed(seed + d)
            G8 = torch.as_tensor(_draw_genotypes(n, rows, seed=seed + d),
                                 device=dev)
            yd = torch.randn(n, generator=gd, device=dev)
            noise = torch.rand(G8.shape, generator=gd, device=dev)
            yield (f"imputed (seed {seed + d})",
                   G8.float() * 0.97 + 0.01 + (noise - 0.5) * 0.02,
                   dataclasses.replace(null, y=yd))
            del G8, noise

    for kind, Gt, nl in tiles():
        rot = build_rotated_null(nl, matmul_precision="high")
        keep = outside_design(Gt.float(), rot.X0, rot.X0p)

        def plain(X):
            return torch.where(keep[None, :], scan_stats_plain(
                X, rot.sd, rot.y_res, rot.Q0, rot.rss0, rot.dof), 0.0)

        # the products against their float64 values on the same splits
        Xc = rotate_high(Gt, rot.high, torch.float32)
        X64 = apply_rotation_high(Gt, rot.high, torch.float64)
        mag = apply_rotation_high(Gt.abs(), rot.high.abs(), torch.float64)
        ratio = float(((Xc.double() - X64).abs()
                       / mag.clamp_min(1e-300)).max())
        del X64, mag
        if ratio > n * 2.0 ** -24:
            raise AssertionError(f"'high' {kind} rows: the products' float32 "
                                 f"sums off by {ratio:.3e} of sum |g u|")
        got = emmax_scan_stats(Gt, rot)
        k3err = _check_stats(f"'high' {kind} rows: K3 on the products", got,
                             plain(Xc))
        del Xc
        ref = plain(apply_rotation_high(Gt, rot.high, torch.float32))
        # the exact tier's fp32 GEMM (then K3) against the same kind of
        # plain construction, float64 products of the unsplit operands
        ex = emmax_scan_stats(Gt, dataclasses.replace(rot, high=None))
        db_ex = float((ex[1] - plain((Gt.double() @ rot.U.double())
                                     .float())[1]).abs().max())
        del ex
        err = _check_stats(f"'high' {kind} rows", got, ref)
        dbeta = float((got[1] - ref[1]).abs().max())
        ms = _cuda_ms(lambda: rotate_high(Gt, rot.high, torch.float32))
        gemm = _cuda_ms(lambda: Gt.float() @ rot.U)
        whole = _cuda_ms(lambda: emmax_scan_stats(Gt, rot))
        pms = _cuda_ms(lambda: apply_rotation_high(Gt, rot.high,
                                                   torch.float32))
        passes = 2 if Gt.dtype == torch.int8 else 3
        chunks = ("one product a pass" if Gt.dtype == torch.int8 else
                  f"{-(-n // HIGH_CHUNK)} chunks of {HIGH_CHUNK} samples a "
                  f"pass")
        bnd = _bound(2.0 * passes * rows * n * n, "bf16", Gt, rot.high,
                     torch.empty((rows, n)))
        print(f"'high' {kind} rows n={n} rows={rows}: the {passes} bf16 "
              f"products ({chunks}), float32 sums vs float64 on the same "
              f"splits: max |d| / sum|g u| {ratio:.3e} (n u = "
              f"{n * 2.0 ** -24:.3e}); K3 on them vs plain: max|df| "
              f"{k3err:.3e}; products + mask + K3 vs the plain version: "
              f"max|df| {err:.3e}, max|dbeta| {dbeta:.3e} (gate 1e-5; the "
              f"exact tier's fp32 GEMM vs its float64 products: "
              f"{db_ex:.3e}); the products {ms:.3f} ms (bound "
              f"{bnd['bound_ms']:.3f} ms by {bnd['bound_by']}), the exact "
              f"tier's fp32 GEMM {gemm:.3f} ms, products + mask + K3 "
              f"{whole:.3f} ms, plain {pms:.3f} ms", flush=True)
        del got, keep, ref, rot, Gt
    _check_tf32_off("the 'high' products")


def _main_path_drift(args, rg, phi, U, y, res) -> dict:
    """Every tier against exact on phase 4's genome under four fixtures:
    the intercept-only design (res: phase 4's calls), a design of 20
    columns, one of 128, and VanRaden's singular K of the same genome with
    delta at its bound (y in the span of K's 100 leading eigenvectors,
    drawn as N(0, K) there, with no noise). Returns {fixture:
    {tier: (max |dp|, masks that differ)}}; every call's wall printed."""
    import numpy as np
    import torch

    from mixmogam_tpu_torch.models.resident import (emmax_resident,
                                                    kinship_resident,
                                                    scale_k)
    from mixmogam_tpu_torch.ops.eigen import eigen_k

    n = rg.n
    rng = np.random.default_rng(args.seed + 60)
    fixtures = {"intercept": (y, None, (phi, U))}
    for q in (20, 128):
        fixtures[f"{q} columns"] = (
            y, np.column_stack([np.ones(n), rng.normal(size=(n, q - 1))]),
            (phi, U))
    ts = time.perf_counter()
    # float64 products: float32 sums leave the zero eigenvalue along the
    # intercept at -7.7e-4, which bounds delta from below instead
    Kv = scale_k(kinship_resident(rg, method="vanraden",
                                  dtype=torch.float64))
    phi_v, U_v = eigen_k(torch.as_tensor(Kv, device=rg.device), host=False)
    top = torch.argsort(phi_v)[-100:]
    z = torch.as_tensor(np.random.default_rng(args.seed + 61).normal(
        size=100), device=rg.device)
    y_v = (U_v[:, top] @ (torch.sqrt(phi_v[top]) * z)).cpu().numpy()
    print(f"VanRaden K of phase 4's genome (f64 products on the card) and "
          f"its eigh: {time.perf_counter() - ts:.3f} s; smallest "
          f"eigenvalue {float(phi_v.min()):.3e}", flush=True)
    fixtures["singular K"] = (y_v, None, (phi_v, U_v))
    runs = {}
    for fx, (yf, X0f, eig) in fixtures.items():
        got = dict(res) if fx == "intercept" else {}
        walls = []
        for tier in ("exact",) + _DRIFT_TIERS:
            if tier in got:
                continue
            ts = time.perf_counter()
            got[tier] = emmax_resident(rg, yf, X0=X0f, eig_k=eig,
                                       precision=tier)
            walls.append(f"{tier} {time.perf_counter() - ts:.3f}")
        ex = got["exact"]
        q = 1 if X0f is None else X0f.shape[1]
        for tier, r in got.items():
            if r["dof"] != n - q - 1:
                raise AssertionError(f"{fx} {tier}: dof {r['dof']}")
        if fx == "singular K":
            d = ex["delta"]
            print(f"   singular K: delta {d:.6e} (the bound "
                  f"{np.exp(-10.0):.6e})", flush=True)
            if abs(d - np.exp(-10.0)) > 1e-6 * np.exp(-10.0):
                raise AssertionError("the singular-K fixture's delta is "
                                     "not at its bound")
        runs[fx] = {t: (float(np.abs(got[t]["ps"] - ex["ps"]).max()),
                        int((got[t]["mask"] != ex["mask"]).sum()))
                    for t in _DRIFT_TIERS}
        print(f"emmax_resident, {fx}: {'; '.join(walls)} s (null fit + "
              f"scan + p-values)", flush=True)
        del got, ex
        torch.cuda.empty_cache()
    return runs


def _gxe_gblup_phase(args, kernels, launches, main, facade, files, acc,
                     tmp, counts) -> None:
    """Phase 12: the GxE scan on phase 4's resident genome (E = 2) at
    exact, int8x3 and bf16x3; the card against the float64 CPU path and
    under VanRaden's singular K; gBLUP on phase 4's K and eigh; run_gwas
    emmax_gxe and the CLI's predict from phase 6's PLINK fileset."""
    import contextlib
    import io

    import numpy as np
    import torch

    from mixmogam_tpu_torch import cli
    from mixmogam_tpu_torch.data.parsers import parse_snp_data
    from mixmogam_tpu_torch.data.phenotype import PhenotypeData
    from mixmogam_tpu_torch.data.simulate import (simulate_genotypes,
                                                  simulate_phenotype)
    from mixmogam_tpu_torch.models.gblup import (_joint_kinship, gblup,
                                                 gblup_cv)
    from mixmogam_tpu_torch.models.gxe import emmax_gxe
    from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                    kinship_resident,
                                                    scale_k)
    from mixmogam_tpu_torch.ops.scan import GXE_P_DRIFT, rescore_p_cut
    from mixmogam_tpu_torch.oracle.kinship import vanraden_kinship
    from mixmogam_tpu_torch.utils.caching import cached_kinship

    # (a) GxE at full width: a N(0, 1) and a 0/1 environment, an
    # interaction planted at SNP 100 with the first
    rg, (phi, U), y, K = main["rg"], main["eig"], main["y"], main["K"]
    n, M = rg.n, rg.M
    rng = np.random.default_rng(args.seed + 120)
    env = np.column_stack([rng.normal(size=n), (rng.random(n) < 0.5) * 1.0])
    x = rg[100:101][0].astype(np.float64)
    y12 = y + 0.5 * (x - x.mean()) * env[:, 0]
    gx = {}
    for tier in ("exact",) + _DRIFT_TIERS:
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        ts = time.perf_counter()
        r = emmax_gxe(rg, y12, env, eig_k=(phi, U), precision=tier)
        wall = time.perf_counter() - ts
        run = {k.__name__: k.launches for k in kernels}
        tm = r["timings_s"]
        scan = tm["load"] + tm["rotation"] + tm["statistics"]
        print(f"emmax_gxe {tier}, E=2 n={n} M={M}: {wall:.3f} s; scan "
              f"{scan:.3f} s = {2 * M / scan:,.0f} GxE-tests/s (rotations "
              f"{tm['rotation']:.3f} s, statistics {tm['statistics']:.3f} "
              f"s, tiles' unpack {tm['load']:.3f} s, device time); nulls "
              f"{tm['nulls']:.3f} s; host p-values {tm['p_values']:.3f} s; "
              f"deltas {np.round(r['deltas'], 5).tolist()}; launches {run}",
              flush=True)
        if run != counts():
            raise AssertionError(f"emmax_gxe {tier}: kernel launches {run}")
        for k in ("marginal_ps", "inter_ps", "joint_ps"):
            ps = r[k]
            if ps.shape != (2, M) or not np.isfinite(ps).all() or (
                    (ps < 0) | (ps > 1)).any():
                raise AssertionError(f"emmax_gxe {tier}: {k} malformed")
        if int(np.argmin(r["inter_ps"][0])) != 100:
            raise AssertionError(f"emmax_gxe {tier}: the planted "
                                 "interaction is not the top hit")
        gx[tier] = r
        if tier in ("exact", "int8x3"):        # kept for phase 18 (e)
            main.setdefault("gxe12", dict(y=y12, env=env))[tier] = dict(
                res=r, wall=wall)
    hit = gx["exact"]["inter_ps"] <= 0.05 / M
    runs = {"E = 2": {t: _gxe_drift(gx[t], gx["exact"])[::-1]
                      for t in _DRIFT_TIERS}}
    _drift_table("GxE", runs, GXE_P_DRIFT)
    for tier in _DRIFT_TIERS:
        nm, dp = _gxe_drift(gx[tier], gx["exact"])
        # the rescore's contract: every interaction with exact p <= alpha/M
        # lies below the tier's cut (ops/scan.py::rescore_p_cut on GxE's
        # own drift table)
        cut = rescore_p_cut(M, tier, table=GXE_P_DRIFT)
        fast = gx[tier]["inter_ps"]
        worst = float(fast[hit].max()) if hit.any() else 0.0
        d_i = np.abs(fast - gx["exact"]["inter_ps"])
        at = np.unravel_index(int(np.argmax(d_i)), d_i.shape)
        print(f"   emmax_gxe {tier} vs exact: {nm} mask(s) differ, max|dp| "
              f"{dp:.3e}; interactions: max|dp| {float(d_i[at]):.3e} at "
              f"exact p {float(gx['exact']['inter_ps'][at]):.3e}; "
              f"{int(hit.sum())} with exact p <= 0.05/M "
              f"(per environment {hit.sum(axis=1).tolist()}), their largest "
              f"{tier} p {worst:.3e} vs the rescore cut {cut:.3e}: "
              f"{'below' if worst <= cut else 'ABOVE'}", flush=True)
        if (nm or dp > GXE_P_DRIFT[tier] or worst > cut
                or (tier in ("int8x3", "bf16x3") and dp > 1e-4)):
            raise AssertionError(f"emmax_gxe {tier} disagrees with exact")
    del gx
    torch.cuda.empty_cache()

    # (b) the card (float32) against the float64 CPU path
    ts = time.perf_counter()
    Gb, _, _ = simulate_genotypes(2_048, 4_096, ploidy=1,
                                  seed=args.seed + 121)
    yb, _ = simulate_phenotype(Gb, h2=0.5, n_causal=5, seed=args.seed + 121)
    rb = np.random.default_rng(args.seed + 121)
    eb = np.column_stack([rb.normal(size=2_048),
                          (rb.random(2_048) < 0.5) * 1.0])
    Kb = scale_k(kinship_resident(ResidentGenome.from_source(Gb)))
    nm, dp = _gxe_drift(emmax_gxe(Gb, yb, eb, K=Kb, precision="exact"),
                        emmax_gxe(Gb, yb, eb, K=Kb, precision="exact",
                                  device="cpu"))
    print(f"   emmax_gxe exact, card f32 vs CPU f64 (n=2048, M=4096, E=2): "
          f"{nm} mask(s) differ, max|dp| {dp:.3e} "
          f"({time.perf_counter() - ts:.3f} s)", flush=True)
    if nm or dp > 1e-5:
        raise AssertionError("emmax_gxe: card and CPU disagree")

    # (c) VanRaden's singular K with delta at its bound
    Gv, _, _ = simulate_genotypes(256, 3_000, ploidy=1, seed=3)
    yv, _ = simulate_phenotype(Gv, h2=0.5, n_causal=4, seed=3)
    Kv = scale_k(vanraden_kinship(Gv.astype(np.float64), ploidy=1))
    rv = np.random.default_rng(3)
    ev = np.column_stack([rv.normal(size=256), (rv.random(256) < 0.5) * 1.0])
    ref_v = emmax_gxe(Gv, yv, ev, K=Kv, precision="exact", device="cpu")
    for tier in ("exact", "int8x3", "bf16x3"):
        nm, dp = _gxe_drift(emmax_gxe(Gv, yv, ev, K=Kv, precision=tier),
                            ref_v)
        print(f"   emmax_gxe VanRaden K, deltas "
              f"{np.round(ref_v['deltas'], 8).tolist()} (the bound), {tier} "
              f"on the card vs CPU f64: {nm} mask(s) differ, max|dp| "
              f"{dp:.3e}", flush=True)
        if nm or dp > 1e-4:
            raise AssertionError(f"emmax_gxe {tier} under a singular K "
                                 "disagrees with float64")

    # (d) gBLUP on phase 4's K and eigh, in float64 on the card
    torch.cuda.synchronize()
    ts = time.perf_counter()
    m = gblup(y, eig_k=(phi, U))
    t_fit = time.perf_counter() - ts
    ts = time.perf_counter()
    rel = m.reliability()
    t_rel = time.perf_counter() - ts
    ts = time.perf_counter()
    cv = gblup_cv(None, y, n_folds=5, seed=args.seed, K_all=K)
    t_cv = time.perf_counter() - ts
    print(f"gblup n={n}: fit {t_fit:.3f} s (h2 "
          f"{m.pseudo_heritability:.4f}); reliability() {t_rel:.3f} s (mean "
          f"{rel.mean():.4f}); gblup_cv 5 folds (an eigh of "
          f"{n - n // 5} a fold) {t_cv:.3f} s, r {cv['r']:.4f}, mse "
          f"{cv['mse']:.4f}", flush=True)
    if (not np.isfinite(m.u_hat).all() or not ((rel >= 0) & (rel <= 1)).all()
            or not np.isfinite(cv["y_hat"]).all() or not cv["r"] > 0):
        raise AssertionError("gblup at full width: malformed output")
    ts = time.perf_counter()
    K2, y2 = K[:2_048, :2_048], y[:2_048]
    a, b = gblup(y2, K=K2), gblup(y2, K=K2, device="cpu")
    du = float(np.abs(a.u_hat - b.u_hat).max() / np.abs(b.u_hat).max())
    rb_ = b.reliability()
    dr = float(np.abs(a.reliability() - rb_).max() / np.abs(rb_).max())
    print(f"   gblup on 2,048 samples, card vs CPU f64: u_hat {du:.3e}, "
          f"reliability {dr:.3e} of their scale "
          f"({time.perf_counter() - ts:.3f} s)", flush=True)
    if du > 1e-8 or dr > 1e-8:
        raise AssertionError("gblup: card and CPU disagree")

    # (e) run_gwas emmax_gxe from phase 6's PLINK fileset and a phenotype
    # CSV holding the trait and the environment
    ph = PhenotypeData.from_arrays(1, "trait", acc, y)
    ph.add_phenotype(2, "env", acc, env[:, 0])
    pheno = os.path.join(tmp, "pheno_gxe.csv")
    ph.write_to_file(pheno)
    env_of = dict(zip(acc, env[:, 0]))

    def direct_gxe(g2, y2):
        r = emmax_gxe(g2, y2, np.array([env_of[a_] for a_ in g2.accessions]),
                      K=cached_kinship(g2, "ibs"))
        r["ps"] = r["inter_ps"]
        return r

    facade("emmax_gxe", (files[0], pheno, os.path.join(tmp, "gxe")),
           direct_gxe, lambda g2: counts(ibs_gram_packed=1),
           method="emmax_gxe", env_pid=2)

    # (f) the CLI's predict from the same files (the card: no --device),
    # its CSV held to the direct gblup / gblup_cv call
    gd2, yp, _ = parse_snp_data(files[0], data_format="plink"
                                ).coordinate_with_phenotype(
        PhenotypeData.parse_phenotype_file(pheno), 1)
    for folds in ("0", "5"):
        out = os.path.join(tmp, f"predict{folds}.csv")
        for k in kernels:
            k.launches = 0
        ts = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            rc = cli.main(["predict", files[0], pheno, "--data-format",
                           "plink", "--folds", folds, "-o", out])
        wall = time.perf_counter() - ts
        run = {k.__name__: k.launches for k in kernels}
        for name, cnt in run.items():
            launches[name] += cnt
        summary = json.loads(buf.getvalue())
        ref = (gblup(yp, K=_joint_kinship(gd2, "ibs")).u_hat if folds == "0"
               else gblup_cv(gd2, yp, n_folds=5, seed=0)["y_hat"])
        with open(out) as f:
            head = f.readline().strip()
            rows = [line.strip().split(",") for line in f]
        got = np.array([float(r_[2]) for r_ in rows])
        dv = float(np.abs(got - ref).max())
        fit = {k: v for k, v in summary.items()
               if k in ("r", "mse", "h2", "delta")}
        print(f"cli predict --folds {folds} (n={summary['n']}, "
              f"m={summary['m']}): {wall:.3f} s; {json.dumps(fit)}; "
              f"launches {run}; CSV vs the direct call max|d| {dv:.3e}",
              flush=True)
        if (rc != 0 or run != counts(ibs_gram_packed=1) or dv > 1e-12
                or [r_[0] for r_ in rows] != list(gd2.accessions)
                or head.split(",")[2] != ("genetic_value" if folds == "0"
                                          else "y_hat_cv")):
            raise AssertionError(f"cli predict --folds {folds} disagrees "
                                 "with the direct call or its launches")


def _perm_gate(label, got, ref, dof) -> None:
    """Every permutation's max F (back from its min p, both sorted) within
    rtol 1e-4 and the threshold within 1e-4 relative."""
    import numpy as np
    import scipy.stats

    fa, fb = (scipy.stats.f.isf(r["min_ps"], 1, dof) for r in (got, ref))
    df = float(np.abs(fa / fb - 1.0).max())
    dt = abs(got["threshold"] / ref["threshold"] - 1.0)
    print(f"   {label}: max F rtol {df:.3e}, threshold {dt:.3e} relative",
          flush=True)
    if df > 1e-4 or dt > 1e-4:
        raise AssertionError(f"{label}: disagree")


def _two_snp_gate(label, got, ref, p_tol) -> None:
    """Identical masks (the p = 1 positions) and max |dp| <= p_tol on
    cond_ps and inter_ps."""
    import numpy as np

    nm = sum(int(((got[k] == 1.0) != (ref[k] == 1.0)).sum())
             for k in ("cond_ps", "inter_ps"))
    dp = max(float(np.abs(got[k] - ref[k]).max())
             for k in ("cond_ps", "inter_ps"))
    print(f"   {label}: {nm} mask(s) differ, max|dp| {dp:.3e}", flush=True)
    if nm or dp > p_tol:
        raise AssertionError(f"{label}: disagree")


def _perm_two_snp_phase(args, kernels, launches, main, counts) -> None:
    """Phase 13: the permutation test (P = 128, three tiers) and the two-SNP
    scan (the top 16 hits of phase 4's exact scan) on phase 4's resident
    genome and eigh; each against the float64 CPU path at n = 2,048 and
    under VanRaden's singular K."""
    import numpy as np
    import torch

    from mixmogam_tpu_torch.data.simulate import (simulate_genotypes,
                                                  simulate_phenotype)
    from mixmogam_tpu_torch.models.permutation import emmax_perm_test
    from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                    kinship_resident,
                                                    scale_k, subdivide_tile)
    from mixmogam_tpu_torch.models.twosnp import emmax_two_snps
    from mixmogam_tpu_torch.oracle.kinship import vanraden_kinship

    rg, (phi, U), y = main["rg"], main["eig"], main["y"]
    n, M = rg.n, rg.M

    def run(fn, *a, **kw):
        """fn's result, wall and kernel launches (added to the script's)."""
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        ts = time.perf_counter()
        r = fn(*a, **kw)
        wall = time.perf_counter() - ts
        cnt = {k.__name__: k.launches for k in kernels}
        for name, c in cnt.items():
            launches[name] += c
        return r, wall, cnt

    # (a) the permutation test, P = 128, at full width and each tier
    P = 128
    perm = {}
    for tier in ("exact", "int8x3", "bf16x3"):
        r, wall, cnt = run(emmax_perm_test, rg, y, eig_k=(phi, U),
                           num_perm=P, precision=tier)
        tm = r["timings_s"]
        scan = tm["load"] + tm["rotation"] + tm["product"] + tm["epilogue"]
        print(f"emmax_perm_test {tier}, P={P} n={n} M={M}: {wall:.3f} s; "
              f"scan {scan:.3f} s = {P * M / scan:,.0f} perm-scan-tests/s "
              f"(rotations {tm['rotation']:.3f} s, P-column products "
              f"{tm['product']:.3f} s, max-F epilogue {tm['epilogue']:.3f} "
              f"s = {tm['epilogue'] / scan:.3f} of the scan, tiles' unpack "
              f"{tm['load']:.3f} s, device time); null {tm['null']:.3f} s; "
              f"p-values {tm['p_values']:.3f} s; threshold "
              f"{r['threshold']:.4e}; launches {cnt}", flush=True)
        if cnt != counts():
            raise AssertionError(f"emmax_perm_test {tier}: launches {cnt}")
        if r["min_ps"].shape != (P,) or not np.isfinite(r["min_ps"]).all() \
                or not 0.0 < r["threshold"] < 0.05:
            raise AssertionError(f"emmax_perm_test {tier}: malformed")
        perm[tier] = r
        if tier in ("exact", "int8x3"):        # kept for phase 18 (e)
            main.setdefault("perm13", {})[tier] = dict(res=r, wall=wall)
    for tier in ("int8x3", "bf16x3"):
        _perm_gate(f"emmax_perm_test {tier} vs exact", perm[tier],
                   perm["exact"], n - 2)
    del perm
    torch.cuda.empty_cache()

    # the card (float32) against the float64 CPU path at n = 2,048
    ts = time.perf_counter()
    Gb, _, _ = simulate_genotypes(2_048, 8_192, ploidy=1,
                                  seed=args.seed + 130)
    yb, _ = simulate_phenotype(Gb, h2=0.5, n_causal=5, seed=args.seed + 130)
    yb = yb + 0.8 * Gb[100] * Gb[200]
    Kb = scale_k(kinship_resident(ResidentGenome.from_source(Gb)))
    _perm_gate("emmax_perm_test exact, card f32 vs CPU f64 (n=2048, "
               "M=8192, P=16)", emmax_perm_test(Gb, yb, K=Kb, num_perm=16,
                                                precision="exact"),
               emmax_perm_test(Gb, yb, K=Kb, num_perm=16, precision="exact",
                               device="cpu"),
               2_046)
    # VanRaden's singular K with delta at its bound, every tier
    Gv, _, _ = simulate_genotypes(256, 3_000, ploidy=1, seed=3)
    yv, _ = simulate_phenotype(Gv, h2=0.5, n_causal=4, seed=3)
    Kv = scale_k(vanraden_kinship(Gv.astype(np.float64), ploidy=1))
    rgv = ResidentGenome.from_source(Gv, tile=1_024)
    ref_v = emmax_perm_test(Gv, yv, K=Kv, num_perm=16, precision="exact",
                            device="cpu")
    for tier in ("exact", "int8x3", "bf16x3"):
        _perm_gate(f"emmax_perm_test VanRaden K, delta {ref_v['delta']:.4e} "
                   f"(the bound), {tier} on the card vs CPU f64",
                   emmax_perm_test(rgv, yv, K=Kv, num_perm=16,
                                   precision=tier), ref_v, 254)
    print(f"   ({time.perf_counter() - ts:.3f} s)", flush=True)

    # (b) the two-SNP scan on phase 4's top 4 hits: K3 once a focal SNP a
    # tile, and no other kernel
    r, wall, cnt = run(emmax_two_snps, rg, y, eig_k=(phi, U),
                       from_result={"ps": main["ps"]}, top_k=4)
    tiles = -(-M // subdivide_tile(rg.tile, 8_192))
    tm = r["timings_s"]
    scan = sum(tm[k] for k in ("load", "rotation", "conditional",
                               "interaction"))
    A = len(r["focal_idx"])
    print(f"emmax_two_snps, A={A} focal SNPs (phase 4's top hits) n={n} "
          f"M={M}: {wall:.3f} s; scan {scan:.3f} s = {A * M / scan:,.0f} "
          f"SNP-pairs/s (rotations {tm['rotation']:.3f} s, K3 conditional "
          f"scans with their masks {tm['conditional']:.3f} s, pairwise "
          f"statistics {tm['interaction']:.3f} s, tiles' unpack "
          f"{tm['load']:.3f} s, device time); eigh + nulls "
          f"{tm['null']:.3f} s; host p-values {tm['p_values']:.3f} s; "
          f"launches {cnt} ({A} x {tiles} tiles)", flush=True)
    if cnt != counts(scan_stats=A * tiles) or A != 4:
        raise AssertionError(f"emmax_two_snps: launches {cnt}")
    for k in ("cond_ps", "inter_ps"):
        ps = r[k]
        if ps.shape != (A, M) or not np.isfinite(ps).all() or (
                (ps < 0) | (ps > 1)).any():
            raise AssertionError(f"emmax_two_snps: {k} malformed")
    own = r["cond_ps"][np.arange(A), r["focal_idx"]]
    if not (own == 1.0).all():
        raise AssertionError("emmax_two_snps: a focal SNP's own cond_p "
                             "is not 1")
    main["two13"] = dict(res=r, wall=wall, k3=cnt["scan_stats"])
    del r
    torch.cuda.empty_cache()

    # the card against the float64 CPU path at n = 2,048, 4 focal SNPs
    # (with the per-focal REML too), and under the singular K
    ts = time.perf_counter()
    focal = [100, 1_000, 4_000, 8_000]
    for refit in (False, True):
        kw = dict(K=Kb, focal_idx=focal, refit_delta_per_focal=refit)
        _two_snp_gate(f"emmax_two_snps, card f32 vs CPU f64 (n=2048, "
                      f"M=8192, A=4, refit_delta_per_focal={refit})",
                      emmax_two_snps(Gb, yb, **kw),
                      emmax_two_snps(Gb, yb, device="cpu", **kw), 1e-5)
    kw = dict(K=Kv, focal_idx=[0, 1_000, 2_999])
    _two_snp_gate("emmax_two_snps VanRaden K (the bound), card f32 vs CPU "
                  "f64", emmax_two_snps(rgv, yv, **kw),
                  emmax_two_snps(Gv, yv, device="cpu", **kw), 1e-4)
    print(f"   ({time.perf_counter() - ts:.3f} s)", flush=True)


def _spectrum_compat_phase(args, kernels, launches, main) -> None:
    """Phase 14: the spectrum REML (projected_spectrum, fit_null_model
    method='spectrum', h2_profile_ci), the class facade (compat.py) on
    phase 4's K and resident genome, and the examples run on the card."""
    import numpy as np
    import torch

    from mixmogam_tpu_torch import oracle
    from mixmogam_tpu_torch.compat import LinearMixedModel, lm_step_wise
    from mixmogam_tpu_torch.data.simulate import (simulate_genotypes,
                                                  simulate_phenotype)
    from mixmogam_tpu_torch.examples import EXAMPLES
    from mixmogam_tpu_torch.models.emmax import emmax
    from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                    kinship_resident,
                                                    scale_k)
    from mixmogam_tpu_torch.ops.eigen import projected_spectrum
    from mixmogam_tpu_torch.ops.reml import (NullModel, esp_to_refine_iters,
                                             fit_null_model, h2_profile_ci,
                                             reml_from_spectrum)

    dev = torch.device("cuda")
    rg, (phi, U), y, K = main["rg"], main["eig"], main["y"], main["K"]
    n = rg.n
    ones = np.ones((n, 1))

    def wall(fn, *a, **kw):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        r = fn(*a, **kw)
        torch.cuda.synchronize()
        return r, time.perf_counter() - ts

    # n = 2,048 fixtures for the card-vs-CPU gates
    Gb, _, _ = simulate_genotypes(2_048, 8_192, ploidy=1,
                                  seed=args.seed + 140)
    yb, _ = simulate_phenotype(Gb, h2=0.5, n_causal=5, seed=args.seed + 140)
    Kb = scale_k(kinship_resident(ResidentGenome.from_source(Gb)))
    Xb = np.column_stack([np.ones(2_048), np.random.default_rng(
        args.seed + 140).normal(size=2_048)])

    # (a) the projected eigh on the card against host LAPACK at n = 2,048
    (xa, Va), ta = wall(projected_spectrum, Kb, Xb)
    (xh, Vh), th = wall(projected_spectrum, Kb, Xb, host=True, device="cpu")
    dxi = float((xa.cpu() - xh).abs().max())
    dP = float(((Va @ Va.T).cpu() - Vh @ Vh.T).abs().max())
    print(f"projected_spectrum n=2048 q=2: card (cuSOLVER f64) {ta:.3f} s, "
          f"host LAPACK {th:.3f} s; max|dxi| {dxi:.3e} "
          f"({dxi / float(xh.abs().max()):.3e} of max xi), projectors "
          f"max|d| {dP:.3e}", flush=True)
    if dxi > 1e-9 * float(xh.abs().max()) or dP > 1e-9:
        raise AssertionError("projected_spectrum: card and host disagree")
    del Va, Vh
    # the card's REML and ML, both methods, against the float64 numpy /
    # scipy oracle (its own LAPACK eighs, brentq to 1e-12) at n = 2,048.
    # The gates (|d log delta| <= 1e-10, |d ll| <= 1e-12 |ll|) are meant
    # to be ones a float32 eigh fails: its reading on the card is printed
    # beside them
    ts = time.perf_counter()
    eR, eK = oracle.eigen_R(Kb, Xb), oracle.eigen_K(Kb)
    ref = {False: oracle.reml(yb, Xb, eig_R=eR, esp=1e-12),
           True: oracle.ml(yb, Xb, Kb, eig_K=eK, eig_R=eR, esp=1e-12)}
    print(f"float64 oracle REML and ML n=2048 (host): "
          f"{time.perf_counter() - ts:.3f} s", flush=True)
    del eR, eK

    def off(fit, o):
        return (abs(float(fit.log_delta) - o["log_delta"]),
                abs(float(fit.ll) - o["ll"]) / abs(o["ll"]))

    for ml in (False, True):
        for method in ("explicit", "spectrum"):
            d_ld, d_ll = off(fit_null_model(yb, Xb, K=Kb, ml=ml,
                                            method=method,
                                            dtype=torch.float64), ref[ml])
            print(f"   fit_null_model {'ML' if ml else 'REML'} {method} "
                  f"(card f64) vs oracle: |d log delta| {d_ld:.3e}, "
                  f"|d ll| {d_ll:.3e} relative (h2 "
                  f"{ref[ml]['pseudo_heritability']:.6f})", flush=True)
            if d_ld > 1e-10 or d_ll > 1e-12:
                raise AssertionError(f"fit_null_model ml={ml} {method} "
                                     "differs from the float64 oracle")
    d_ld, d_ll = off(fit_null_model(yb, Xb, K=Kb, dtype=torch.float64,
                                    eigh_dtype=np.float32), ref[False])
    print(f"   (a float32 eigh on the card, REML: |d log delta| "
          f"{d_ld:.3e}, |d ll| {d_ll:.3e} relative)", flush=True)
    # spectrum against explicit, both on the card, on phase 4's K
    Kd = torch.as_tensor(K, device=dev)
    (xi, V), t_eigh = wall(projected_spectrum, Kd, ones)
    eta2 = (V.T @ torch.as_tensor(y, device=dev)) ** 2
    del V
    _, t_opt = wall(reml_from_spectrum, eta2, xi)
    del xi, eta2
    spec, t_spec = wall(fit_null_model, y, ones, K=Kd, eig_k=(phi, U),
                        method="spectrum", dtype=torch.float64)
    expl, t_expl = wall(fit_null_model, y, ones, eig_k=(phi, U),
                        dtype=torch.float64)
    d_ld = abs(float(spec.log_delta) - float(expl.log_delta))
    d_h2 = abs(float(spec.pseudo_heritability)
               - float(expl.pseudo_heritability))
    print(f"n={n}: the projected eigh alone {t_eigh:.3f} s; "
          f"reml_from_spectrum alone {t_opt:.3f} s; fit_null_model "
          f"spectrum {t_spec:.3f} s, explicit {t_expl:.3f} s; "
          f"|d log delta| {d_ld:.3e}, |d h2| {d_h2:.3e} (h2 "
          f"{float(expl.pseudo_heritability):.6f})", flush=True)
    if d_ld > 1e-6 or d_h2 > 1e-9:
        raise AssertionError("spectrum and explicit REML disagree")
    del spec, Kd
    torch.cuda.empty_cache()

    # (b) h2_profile_ci on the card against the CPU in float64
    nb = fit_null_model(yb, Xb, K=Kb, dtype=torch.float64)
    cb = NullModel(**{k: (v.cpu() if isinstance(v, torch.Tensor) else v)
                      for k, v in vars(nb).items()})
    ci_a, t_ci_a = wall(h2_profile_ci, nb)
    ci_b, t_ci_b = wall(h2_profile_ci, cb)
    d_ci = max(abs(ci_a[0] - ci_b[0]), abs(ci_a[1] - ci_b[1]))
    ci, t_ci = wall(h2_profile_ci, expl)
    print(f"h2_profile_ci n=2048: card {t_ci_a:.3f} s, CPU {t_ci_b:.3f} s, "
          f"ends max|d| {d_ci:.3e}; n={n} (phase 4's null): "
          f"[{ci[0]:.4f}, {ci[1]:.4f}] in {t_ci:.3f} s", flush=True)
    if d_ci > 1e-8 or not ci[0] <= float(expl.pseudo_heritability) <= ci[1]:
        raise AssertionError("h2_profile_ci: card and CPU disagree")

    # (c) the class facade on phase 4's K and resident genome
    lmm = LinearMixedModel(y)               # no device=: the card
    if lmm.device.type != "cuda":
        raise AssertionError(f"LinearMixedModel on {lmm.device}")
    lmm.add_random_effect(K)
    reml, t_reml = wall(lmm.get_expedited_REMLE)
    # a pass-through check: the facade's esp = 1e-6 gives 18 bisection
    # steps, so fit_null_model called with those on phase 4's eigh must
    # give the same log delta (the REML itself is held to the oracle in (a))
    fit4 = fit_null_model(y, ones, eig_k=(phi, U), dtype=torch.float64,
                          refine_iters=esp_to_refine_iters(1e-6))
    d_ld = abs(reml["log_delta"] - float(fit4.log_delta))
    print(f"LinearMixedModel(y).add_random_effect(K) n={n}: "
          f"get_expedited_REMLE (eigh + REML) {t_reml:.3f} s; |d log "
          f"delta| vs fit_null_model on phase 4's eigh with the facade's "
          f"18 steps (pass-through) {d_ld:.3e}", flush=True)
    if d_ld > 1e-9:
        raise AssertionError("compat REML differs from fit_null_model")
    for tier, kname in (("exact", "scan_stats"),
                        ("int8x3", "rotate_scan_int8_packed"),
                        ("bf16x3", "rotate_scan_bf16_packed")):
        lmm.emmax_f_test(rg, precision=tier)       # warm
        for k in kernels:
            k.launches = 0
        res, t_c = wall(lmm.emmax_f_test, rg, precision=tier)
        cnt = {k.__name__: k.launches for k in kernels}
        for name, c in cnt.items():
            launches[name] += c
        ref, t_d = wall(emmax, rg, y, eig_k=lmm._eig_k, X0=lmm.X,
                        precision=tier)
        dp = float(np.abs(res["ps"] - ref["ps"]).max())
        print(f"   emmax_f_test {tier}: {t_c:.3f} s (direct emmax "
              f"{t_d:.3f} s), max|dp| vs direct {dp:.3e}, launches {cnt}",
              flush=True)
        if dp > 1e-12 or cnt[kname] <= 0 or (
                tier != "exact" and cnt["scan_stats"]):
            raise AssertionError(f"compat emmax_f_test {tier} off")
    del lmm, res, ref
    torch.cuda.empty_cache()
    # get_estimates and lm_step_wise, card against CPU float64, n = 2,048
    est = {}
    for d in (None, "cpu"):
        m = LinearMixedModel(yb, device=d)
        m.add_random_effect(Kb)
        m.add_factor(Xb[:, 1])
        m.add_factor(Gb[100])
        est[d], t = wall(m.get_estimates)
        print(f"   get_estimates on {m.device}: {t:.3f} s", flush=True)
    d_b = float(np.abs(est[None]["betas"] - est["cpu"]["betas"]).max()
                / np.abs(est["cpu"]["betas"]).max())
    sw = {d: wall(lm_step_wise, Gb, yb, max_steps=3, device=d)
          for d in (None, "cpu")}
    cof = {d: [s["cofactors"] for s in r[0]["steps"]]
           for d, r in sw.items()}
    print(f"get_estimates n=2048 card vs CPU f64: betas max|d| {d_b:.3e} "
          f"relative; lm_step_wise 3 steps: card {sw[None][1]:.3f} s, CPU "
          f"{sw['cpu'][1]:.3f} s, the largest model's cofactors "
          f"{max(cof[None], key=len)} (CPU {max(cof['cpu'], key=len)})",
          flush=True)
    if d_b > 1e-8 or cof[None] != cof["cpu"]:
        raise AssertionError("compat card vs CPU disagree")

    # (d) every ported scenario of the examples on the card, default size
    ts = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ex_") as out:
        r = subprocess.run(
            [sys.executable, "-m", "mixmogam_tpu_torch.examples", "--out",
             out], capture_output=True, text=True, timeout=900,
            env={**os.environ, "MIXMOGAM_LOGLEVEL": "WARNING"})
    for line in r.stdout.splitlines():
        if line.startswith("[example]"):
            print("   " + line, flush=True)
    print(f"python -m mixmogam_tpu_torch.examples (every ported scenario, "
          f"default size): {time.perf_counter() - ts:.3f} s, exit "
          f"{r.returncode}", flush=True)
    ran = sum(line.startswith("[example]") for line in r.stdout.splitlines())
    # streaming_at_scale's part (a): the streamed scan with checkpoints
    streamed = "streamed scan min p" in r.stdout
    print(f"   streaming_at_scale part (a) ran: {streamed}", flush=True)
    if r.returncode != 0 or ran != len(EXAMPLES) or not streamed:
        print(r.stdout[-3000:], r.stderr[-3000:], file=sys.stderr)
        raise AssertionError(f"the examples failed ({ran} of "
                             f"{len(EXAMPLES)} ran)")


class _SeededRows:
    """A lazy (M, n) int8 source of binary genotypes: rows [s, e) are drawn
    on access, 256 rows a block, each block from its own generator seeded
    by (seed, block), so any process reads the same genome and none holds
    a copy of it (phase 15(b)'s subprocess)."""

    BLOCK = 256

    def __init__(self, M: int, n: int, seed: int):
        import numpy as np

        self.shape = (M, n)
        self.dtype = np.dtype(np.int8)
        self.seed = seed

    def __getitem__(self, key):
        import numpy as np

        s, e, step = key.indices(self.shape[0])
        if step != 1:
            raise IndexError("step-1 row slices only")
        b0, b1, B = s // self.BLOCK, -(-e // self.BLOCK), self.BLOCK
        rows = np.concatenate([
            np.random.default_rng([self.seed, b]).integers(
                0, 2, (B, self.shape[1]), dtype=np.int8)
            for b in range(b0, max(b1, b0 + 1))])
        return rows[s - b0 * B:e - b0 * B]


_KILL_WORKER = """
import sys
import numpy as np
import torch
sys.path.insert(0, {root!r})
from chip_smoke import _SeededRows
from mixmogam_tpu_torch.models.streaming import emmax_streamed
z = np.load({npz!r})
eig = (torch.as_tensor(z["phi"], device="cuda"),
       torch.as_tensor(z["U"], device="cuda"))
emmax_streamed(_SeededRows({M}, {n}, {seed}), z["y"], eig_k=eig,
               tile={tile}, checkpoint_dir={ck!r})
"""


def _stream_phase(args, kernels, launches, main, G, files, tmp) -> None:
    """Phase 15: the streamed scan (emmax_streamed) at BASELINE #3's shape,
    kill and resume, imputed dosages past the in-core budget, the streamed
    multi-trait route and the CLI's --stream on / --checkpoint-dir."""
    import contextlib
    import glob
    import io
    import signal

    import numpy as np
    import torch

    from mixmogam_tpu_torch import cli
    from mixmogam_tpu_torch.api import run_gwas
    from mixmogam_tpu_torch.models import source as source_mod
    from mixmogam_tpu_torch.models.emmax import emmax
    from mixmogam_tpu_torch.models.multitrait import emmax_multi_trait
    from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                    emmax_resident)
    from mixmogam_tpu_torch.models.streaming import emmax_streamed
    from mixmogam_tpu_torch.ops.hopper_scan import (k3_operand,
                                                    rotate_scan_bf16_packed,
                                                    rotate_scan_int8_packed,
                                                    scan_operand, scan_stats)
    from mixmogam_tpu_torch.ops.pack2 import unpack_2bit_device
    from mixmogam_tpu_torch.ops.reml import fit_null_model
    from mixmogam_tpu_torch.ops.scan import (FRACTIONAL_P_DRIFT,
                                             build_rotated_null)

    dev = torch.device("cuda")
    (phi, U), y = main["eig"], main["y"]
    M, n = G.shape
    eig = (phi, U)

    def run(fn, *a, **kw):
        """fn(*a, **kw) with the kernels' counts from 0: (result, counts,
        seconds); the counts join the kernels line."""
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        ts = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - ts
        cnt = {k.__name__: k.launches for k in kernels}
        for name, c in cnt.items():
            launches[name] += c
        return out, cnt, dt

    # (a0) the 'high' tier streamed (K3 a tile behind its three bf16
    # passes) against emmax_resident on phase 4's genome, bit for bit at
    # the same tile: 8,192 rows, the resident route's scan tile at 'high'
    # (subdivide_tile(16,384, 8,192))
    hr, cnt_r, dt_r = run(emmax_resident, main["rg"], y, eig_k=eig,
                          precision="high")
    hs, cnt_s, dt_s = run(emmax, G, y, eig_k=eig, stream=True, tile=8_192,
                          precision="high")
    same = [k for k in ("ps", "f_stats", "betas", "mask")
            if not np.array_equal(hs[k], hr[k])]
    print(f"(a0) emmax stream=True high, M={M}, tile 8192: {dt_s:.3f} s = "
          f"{M / dt_s:,.0f} SNP-tests/s; launches {cnt_s}; vs "
          f"emmax_resident high ({dt_r:.3f} s, launches {cnt_r}): "
          f"{'bit-equal' if not same else 'differs in ' + str(same)}",
          flush=True)
    tiles_h = -(-M // 8_192)
    if (same or cnt_s["scan_stats"] != tiles_h
            or cnt_r["scan_stats"] != tiles_h):
        raise AssertionError("(a0) the streamed 'high' scan is not the "
                             "resident one")
    del hr, hs

    # (a) BASELINE #3's shape: n x 4M, int8, phase 4's genome first
    tile_a = 32_768
    Mb = 4 * M
    ts = time.perf_counter()
    Gb = np.empty((Mb, n), dtype=np.int8)
    Gb[:M] = G
    for k in range(1, 4):
        _draw_genotypes(n, M, seed=args.seed + 150 + k, out=Gb[k * M:])
    print(f"(a) the source (not the system): {Mb} x {n} int8 on the host "
          f"({Gb.nbytes / 1e9:.2f} GB), rows past {M} drawn on the card: "
          f"{time.perf_counter() - ts:.3f} s", flush=True)
    # the two host-side rates that could bound the pipeline, alone
    rows = min(tile_a, Mb)
    pin = torch.empty((rows, n), dtype=torch.int8, pin_memory=True)
    gpu = torch.empty((rows, n), dtype=torch.int8, device=dev)
    ts = time.perf_counter()
    for r in range(3):
        np.copyto(pin.numpy(), Gb[r * rows:(r + 1) * rows])
    cp_s = (time.perf_counter() - ts) / 3
    h2d_ms = _cuda_ms(lambda: gpu.copy_(pin, non_blocking=True))
    print(f"   alone, a {rows}-row tile ({pin.numel() / 1e6:.1f} MB): host "
          f"copy into a pinned buffer {cp_s * 1e3:.3f} ms = "
          f"{pin.numel() / cp_s / 1e9:.2f} GB/s; its H2D copy "
          f"{h2d_ms:.3f} ms = {pin.numel() / h2d_ms / 1e6:.2f} GB/s",
          flush=True)
    del pin, gpu
    kname = {"exact": "scan_stats", "int8x3": "rotate_scan_int8_packed",
             "bf16x3": "rotate_scan_bf16_packed"}
    streamed = {}
    n_tiles = -(-Mb // tile_a)
    for tier in ("exact", "int8x3", "bf16x3"):
        st, cnt, dt = run(emmax, Gb, y, eig_k=eig, stream=True, tile=tile_a,
                          precision=tier)
        ss = st["stream_stats"]
        print(f"   emmax stream=True {tier}, M={Mb}: {dt:.3f} s = "
              f"{Mb / dt:,.0f} SNP-tests/s (the scan loop {ss['scan_s']:.3f}"
              f" s = {Mb / ss['scan_s']:,.0f}); H2D {ss['h2d_bytes']:,} B = "
              f"{ss['h2d_bytes'] / ss['scan_s'] / 1e9:.2f} GB/s over the "
              f"loop; waited on the prep thread {ss['prep_wait_s']:.3f} s; "
              f"the card busy {ss['busy_s']:.3f} s = "
              f"{ss['busy_s'] / ss['scan_s']:.3f} of the loop; launches "
              f"{cnt}", flush=True)
        want = {k: (n_tiles if k == kname[tier] else 0) for k in cnt}
        if cnt != want or ss["tiles"] != n_tiles or ss["restored"]:
            raise AssertionError(f"streamed {tier}: launches {cnt}, "
                                 f"tabled {want}")
        streamed[tier] = (st["ps"], st["mask"])
        del st
    ts = time.perf_counter()
    rgb = ResidentGenome.from_source(Gb, tile=tile_a)
    torch.cuda.synchronize()
    print(f"   the same rows packed resident (tile {tile_a}): "
          f"{time.perf_counter() - ts:.3f} s", flush=True)
    null = fit_null_model(y, np.ones((n, 1)), eig_k=eig, device=dev,
                          dtype=torch.float32)
    for tier in ("exact", "int8x3", "bf16x3"):
        ts = time.perf_counter()
        ref = emmax_resident(rgb, y, eig_k=eig, precision=tier)
        dt = time.perf_counter() - ts
        ps, mask = streamed[tier]
        nm = int((mask != ref["mask"]).sum())
        dp = float(np.abs(ps - ref["ps"]).max())
        # the tier's kernel alone on one 32,768-row tile (a timing: not
        # counted)
        rot = build_rotated_null(null, None if tier == "exact" else tier)
        p = rgb.packed[:rows]
        if tier == "exact":
            Xr = unpack_2bit_device(p, n).float() @ rot.U
            op = k3_operand(rot)
            ms = _cuda_ms(lambda: scan_stats(Xr, rot.sd, rot.y_res, rot.Q0,
                                             rot.rss0, rot.dof, operand=op))
            del Xr
        else:
            fn = (rotate_scan_int8_packed if tier == "int8x3"
                  else rotate_scan_bf16_packed)
            W = ((rot.planes, rot.w_scale) if tier == "int8x3"
                 else (rot.parts,))
            op = scan_operand(rot)
            r0, d0 = float(rot.rss0), float(rot.dof)
            ms = _cuda_ms(lambda: fn(p, n, *W, rot.y_res, rot.scan_q0, r0,
                                     d0, operand=op))
        print(f"   {tier}: streamed vs emmax_resident ({dt:.3f} s): {nm} "
              f"mask(s) differ, max|dp| {dp:.3e}; {kname[tier]} alone on "
              f"a {rows}-row tile: {ms:.3f} ms", flush=True)
        if nm or dp > 1e-6:
            raise AssertionError(f"streamed {tier} disagrees with resident")
        del ref, rot
    del rgb, streamed, Gb
    torch.cuda.empty_cache()

    # (b) kill and resume: a lazy source drawn from a seed, n samples
    Mk, tile_k = 16 * 4_096, 4_096
    src = _SeededRows(Mk, n, args.seed + 160)
    ck = os.path.join(tmp, "kill_ck")
    npz = os.path.join(tmp, "eig.npz")
    np.savez(npz, phi=phi.cpu().numpy(), U=U.cpu().numpy(), y=y)
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, "-c", _KILL_WORKER.format(
            root=root, npz=npz, M=Mk, n=n, seed=args.seed + 160,
            tile=tile_k, ck=ck)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 300
        while len(glob.glob(os.path.join(ck, "tile_*[0-9].npz"))) < 3:
            if proc.poll() is not None or time.time() > deadline:
                raise AssertionError(f"(b) no 3 tile files before the "
                                     f"worker's end or the deadline: "
                                     f"{proc.communicate()[1][-2000:]}")
            time.sleep(0.02)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    os.remove(npz)
    on_disk = len(glob.glob(os.path.join(ck, "tile_*[0-9].npz")))
    resumed, cnt, dt_r = run(emmax_streamed, src, y, eig_k=eig,
                             tile=tile_k, checkpoint_dir=ck)
    clean, _, dt_c = run(emmax_streamed, src, y, eig_k=eig, tile=tile_k)
    (mpath,) = glob.glob(os.path.join(ck, "manifest_*.json"))
    with open(mpath, "r+b") as f:
        f.truncate(os.path.getsize(mpath) // 2)
    cut, _, _ = run(emmax_streamed, src, y, eig_k=eig, tile=tile_k,
                    checkpoint_dir=ck)
    rs, cs = resumed["stream_stats"], cut["stream_stats"]
    d_r = float(np.abs(resumed["ps"] - clean["ps"]).max())
    d_c = float(np.abs(cut["ps"] - clean["ps"]).max())
    print(f"(b) SIGKILL with {on_disk} of {rs['tiles']} tile files on disk "
          f"(n={n}, M={Mk}, {tile_k}-row tiles drawn from a seed on "
          f"access): the resume restored {rs['restored']} and scanned "
          f"{rs['scanned']} ({dt_r:.3f} s; uninterrupted {dt_c:.3f} s), max"
          f"|dp| vs uninterrupted {d_r:.3e}; the manifest cut to half its "
          f"bytes: restored {cs['restored']} from the tile files, max|dp| "
          f"{d_c:.3e}; K3 launches on the resume {cnt['scan_stats']}",
          flush=True)
    if (not 3 <= rs["restored"] < rs["tiles"] or d_r > 1e-12 or d_c > 1e-12
            or cs["restored"] != cs["tiles"]
            or cnt["scan_stats"] != rs["scanned"]):
        raise AssertionError("(b) kill and resume off")
    del resumed, clean, cut

    # (c) imputed dosages past the in-core budget: float32 in [0, 2], 1 %
    # NaN, drawn on the card
    Mc = 9 * M // 8
    ts = time.perf_counter()
    Gf = np.empty((Mc, n), dtype=np.float32)
    g = torch.Generator(device=dev).manual_seed(args.seed + 170)
    for s in range(0, Mc, 16_384):
        x = 2.0 * torch.rand((min(16_384, Mc - s), n), generator=g,
                             device=dev)
        x[torch.rand(x.shape, generator=g, device=dev) < 0.01] = np.nan
        Gf[s:s + x.shape[0]] = x.cpu().numpy()
    del x
    print(f"(c) the source (not the system): {Mc} x {n} float32 dosages, 1 "
          f"% NaN ({Gf.nbytes / 1e9:.2f} GB): {time.perf_counter() - ts:.3f}"
          f" s", flush=True)
    st, cnt, dt = run(emmax, Gf, y, eig_k=eig, precision="exact")
    ss = st.get("stream_stats")
    if ss is None:
        raise AssertionError("(c) emmax did not route to the streamed scan")
    head = 32_768
    ref, _, dt_i = run(emmax, Gf[:head], y, eig_k=eig, stream=False)
    nm = int((st["mask"][:head] != ref["mask"]).sum())
    dp = float(np.abs(st["ps"][:head] - ref["ps"]).max())
    print(f"   emmax (stream=None: routed to the streamed scan), M={Mc}: "
          f"{dt:.3f} s = {Mc / dt:,.0f} SNP-tests/s; {ss['tiles']} tiles; "
          f"H2D {ss['h2d_bytes']:,} B = "
          f"{ss['h2d_bytes'] / ss['scan_s'] / 1e9:.2f} GB/s; waited on the "
          f"prep thread {ss['prep_wait_s']:.3f} s of {ss['scan_s']:.3f}; "
          f"busy {ss['busy_s'] / ss['scan_s']:.3f}; launches {cnt}; rows "
          f"[0, {head}) vs emmax stream=False ({dt_i:.3f} s): {nm} mask(s) "
          f"differ, max|dp| {dp:.3e}", flush=True)
    if nm or dp > 1e-6 or cnt["scan_stats"] != ss["tiles"]:
        raise AssertionError("(c) imputed dosages off")
    # the bf16x3 tier on these dosages: streamed through the float route
    # (the bf16 products by the parts of U', then K3 a tile) on the first
    # Mx rows (a cut of depth for the script's clock), held to the in-core
    # float route on rows [0, 32,768) and to the streamed exact scan
    Mx = min(2 * head, Mc)
    sb, cnt, dt = run(emmax, Gf[:Mx], y, eig_k=eig, stream=True,
                      precision="bf16x3")
    ss = sb.get("stream_stats") or {}
    rb, _, dt_i = run(emmax, Gf[:head], y, eig_k=eig, stream=False,
                      precision="bf16x3")
    nm = int((sb["mask"][:head] != rb["mask"]).sum())
    dp = float(np.abs(sb["ps"][:head] - rb["ps"]).max())
    nx = int((sb["mask"] != st["mask"][:Mx]).sum())
    dx = float(np.abs(sb["ps"] - st["ps"][:Mx]).max())
    sst = {k: (round(v, 3) if isinstance(v, float) else v)
           for k, v in ss.items()}
    print(f"   emmax bf16x3 (stream=True), the first M={Mx} rows: {dt:.3f} "
          f"s = {Mx / dt:,.0f} SNP-tests/s; stream_stats {json.dumps(sst)}"
          f"; launches {cnt}; rows [0, {head}) vs the in-core float route "
          f"({dt_i:.3f} s): {nm} mask(s) differ, max|dp| {dp:.3e}; vs the "
          f"streamed exact scan: {nx} mask(s) differ, max|dp| {dx:.3e} "
          f"(FRACTIONAL_P_DRIFT {FRACTIONAL_P_DRIFT['bf16x3']:g})",
          flush=True)
    if (not ss or cnt["scan_stats"] != ss["tiles"]
            or cnt["rotate_scan_bf16_packed"] or nm or dp > 1e-6 or nx
            or dx > FRACTIONAL_P_DRIFT["bf16x3"]):
        raise AssertionError("(c) bf16x3 on imputed dosages off")
    del sb, rb

    # (d) multi-trait, T = 8, on (c)'s source: trait 0 is (c)'s phenotype
    T = 8
    Y = np.vstack([y[None], _draw_traits(G[:16_384], T - 1,
                                         args.seed + 180)])
    # on (c)'s first Md rows, which the budget of one byte streams: the
    # route past the in-core budget, cut in depth for the script's clock
    Md = min(2 * head, Mc)
    reads = []
    host_tile = source_mod.host_tile
    source_mod.host_tile = lambda *a: reads.append(a[1]) or host_tile(*a)
    try:
        mt, cnt, dt = run(emmax_multi_trait, Gf[:Md], Y, eig_k=eig,
                          stream_budget_bytes=1)
    finally:
        source_mod.host_tile = host_tile
    tiles_d = -(-Md // 16_384)
    mi, _, dt_i = run(emmax_multi_trait, Gf[:head], Y, eig_k=eig,
                      stream_budget_bytes=1 << 62)
    d_in = float(np.abs(mt["ps"][:, :head] - mi["ps"]).max())
    nm = int((mt["mask"][:, :head] != mi["mask"]).sum())
    d_one = float(np.abs(mt["ps"][0] - st["ps"][:Md]).max())
    print(f"(d) emmax_multi_trait T={T} on (c)'s first {Md} rows, "
          f"stream_budget_bytes=1: {dt:.3f} s = "
          f"{T * Md / dt:,.0f} SNP-trait tests/s; timings_s "
          f"{json.dumps({k: round(v, 3) for k, v in mt['timings_s'].items()})}"
          f"; {len(reads)} tiles read from the host (streamed); launches "
          f"{cnt}; rows [0, {head}) vs the in-core multi-trait scan "
          f"({dt_i:.3f} s): {nm} mask(s) differ, max|dp| {d_in:.3e}; trait 0"
          f" vs (c)'s single-trait streamed scan: max|dp| {d_one:.3e}",
          flush=True)
    if (len(reads) != tiles_d or cnt["scan_stats"] != T * tiles_d or nm
            or d_in > 1e-6 or d_one > 1e-5):
        raise AssertionError("(d) the streamed multi-trait scan off")
    del Gf, st, ref, mt, mi
    torch.cuda.empty_cache()

    # (e) the CLI on phase 6's PLINK fileset: --stream on --checkpoint-dir
    ck = os.path.join(tmp, "cli_ck")
    prefix = os.path.join(tmp, "cli_stream")
    argv = ["run", files[0], files[1], "--data-format", "plink", "-o",
            prefix, "--no-plots", "--stream", "on", "--checkpoint-dir", ck]
    said = []
    for _ in range(2):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc, cnt, dt = run(cli.main, argv)
        said.append((rc, cnt, dt, buf.getvalue()))
    ref = run_gwas(files[0], files[1], data_format="plink", plots=False)
    g2 = ref["genotype"]
    want = {(int(c), int(p)): v for c, p, v in zip(
        g2.chromosomes, g2.positions, ref["scan"]["ps"])}
    got = _read_ranked_csv(prefix + ".pvals.csv")
    dp = max(abs(got[k] - v) for k, v in want.items())
    tiles_e = -(-g2.num_snps // 16_384)
    for i, (rc, cnt, dt, out) in enumerate(said):
        print(f"(e) cli run --stream on --checkpoint-dir, run {i + 1}: exit "
              f"{rc}, {dt:.3f} s, launches {cnt}: "
              f"{out.strip().splitlines()[-1]}", flush=True)
    print(f"   the CSV vs run_gwas emmax on the same fileset: max|dp| "
          f"{dp:.3e} over {len(want)} SNPs", flush=True)
    if (any(r[0] != 0 for r in said) or sorted(got) != sorted(want)
            or dp > 1e-6
            or f"{tiles_e} scanned, 0 restored" not in said[0][3]
            or f"0 scanned, {tiles_e} restored" not in said[1][3]
            or said[0][1]["scan_stats"] != tiles_e
            or said[1][1]["scan_stats"] != 0):
        raise AssertionError("(e) the CLI's streamed run off")


def _tair10_chromosomes(m: int):
    """Chromosome codes 1-5 for m rows in proportion to the Arabidopsis
    TAIR10 chromosome lengths (the facade genome of phases 6 and 16)."""
    import numpy as np

    tair10_mb = np.array([30.43, 19.70, 23.46, 18.59, 26.98])
    ends = np.round(np.cumsum(tair10_mb) / tair10_mb.sum() * m).astype(int)
    return np.repeat(np.arange(1, 6), np.diff(np.r_[0, ends]))


def _write_genotype_text(f, G, prefixes, sep: bytes, codes: bytes,
                         chunk: int = 4_096) -> int:
    """Write the rows `prefix call<sep>call...<newline>` of the int8 rows G
    to the binary file f, one byte a call: codes[g + 1] for g = -1
    (missing), 0, 1, 2. Vectorised with numpy a chunk of rows at a time;
    returns the bytes written."""
    import numpy as np

    lut = np.frombuffer(codes, dtype=np.uint8)
    n = G.shape[1]
    total = 0
    for s in range(0, G.shape[0], chunk):
        g = np.asarray(G[s:s + chunk])
        body = np.empty((g.shape[0], 2 * n), dtype=np.uint8)
        body[:, 0::2] = lut[g.astype(np.int16) + 1]
        body[:, 1::2] = sep[0]
        body[:, -1] = ord("\n")
        flat = memoryview(body.reshape(-1))
        data = b"".join(part for i in range(g.shape[0]) for part in (
            prefixes[s + i], flat[2 * n * i:2 * n * (i + 1)]))
        f.write(data)
        total += len(data)
    return total


def _host_data_phase(args, kernels, launches, main, G, files, tmp,
                     acc) -> None:
    """Phase 16: the host data plane (native.py's C++ parsers and the
    packed cache) at full width: a dosage CSV, a VCF and a VCF.gz parsed
    natively and held to their source rows and to the Python route,
    run_gwas from CSV and VCF held to the same call from the PLINK
    fileset, and ResidentGenome.from_source's cache on phase 4's genome."""
    import gzip
    from unittest import mock

    import numpy as np
    import torch

    from mixmogam_tpu_torch import api, native
    from mixmogam_tpu_torch.data import vcf as vcf_mod
    from mixmogam_tpu_torch.data.parsers import parse_snp_data
    from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                    emmax_resident)

    if not native.available():
        raise AssertionError(
            "the host library did not build or load here, so the data "
            "layer would run its Python route:\n" + native.BUILD_LOG)
    print(f"host library: {native.get_lib()._name}", flush=True)
    M, n = G.shape
    if int(G[:min(M, 65_536)].max()) > 1:
        raise AssertionError("phase 16 writes haploid calls: the genome "
                             "must be binary")
    Mf = min(args.facade_snps, M)
    Ma, Mv, Mz, Mp = (min(r, M) for r in (32_768, 16_384, 8_192, 256))
    Mpy = min(512, Mf)                   # the Python route's facade rows
    # the facade genome's layout for the first Mf rows, chromosome 5 after
    chrom = np.r_[_tair10_chromosomes(Mf),
                  np.full(Ma - Mf, 5)].astype(np.int32)
    pos = (np.arange(Ma, dtype=np.int64) + 1) * 100

    def python_route():
        return mock.patch.object(native, "get_lib", lambda: None)

    def same_rows(label, gd, rows):
        if not (np.array_equal(gd.matrix, G[:rows])
                and np.array_equal(gd.chromosomes, chrom[:rows])
                and np.array_equal(gd.positions, pos[:rows])
                and gd.accessions == acc and gd.ploidy == 1):
            raise AssertionError(f"{label}: not the source's rows")

    def write_csv(path, rows):
        with open(path, "wb") as f:
            f.write(("Chromosome,Position," + ",".join(acc)
                     + "\n").encode())
            _write_genotype_text(f, G[:rows], [
                f"{c},{p},".encode() for c, p in zip(chrom, pos[:rows])],
                b",", b"-012")
        return os.path.getsize(path)

    def write_vcf(path, rows):
        opener = ((lambda: gzip.open(path, "wb", compresslevel=1))
                  if path.endswith(".gz") else (lambda: open(path, "wb")))
        with opener() as f:
            f.write(("##fileformat=VCFv4.2\n##FORMAT=<ID=GT,Number=1,"
                     'Type=String,Description="Genotype">\n#CHROM\tPOS\tID'
                     "\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                     + "\t".join(acc) + "\n").encode())
            text = _write_genotype_text(f, G[:rows], [
                f"{c}\t{p}\trs{p}\tA\tC\t.\t.\t.\tGT\t".encode()
                for c, p in zip(chrom, pos[:rows])], b"\t", b".01")
        return text, os.path.getsize(path)

    def timed(fn, *a, **kw):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - ts

    # (a) a dosage CSV at full width
    big = os.path.join(tmp, "big.csv")
    size, dt = timed(write_csv, big, Ma)
    print(f"(a) wrote a dosage CSV of {Ma} x {n} ({size / 1e9:.3f} GB) with "
          f"numpy: {dt:.3f} s (set-up, not the system)", flush=True)
    gd, dt = timed(parse_snp_data, big)
    lib_s = timed(native.parse_dosage_csv, big)[1]
    print(f"   parse_snp_data, native route: {dt:.3f} s = "
          f"{size / dt / 1e9:.3f} GB/s; native.parse_dosage_csv alone "
          f"{lib_s:.3f} s", flush=True)
    same_rows("(a) the native CSV parse", gd, Ma)
    del gd
    os.remove(big)
    fcsv = os.path.join(tmp, "facade.csv")
    write_csv(fcsv, Mf)
    gd_nat = timed(parse_snp_data, fcsv)[0]
    same_rows("(a) the native CSV parse of the facade rows", gd_nat, Mf)

    # (b) VCF, plain and gzip
    for path, rows in ((os.path.join(tmp, "big.vcf"), Mv),
                       (os.path.join(tmp, "big.vcf.gz"), Mz)):
        (text, size), dt = timed(write_vcf, path, rows)
        kind = "VCF.gz" if path.endswith(".gz") else "VCF"
        print(f"(b) wrote a {kind} of {rows} x {n} ({text / 1e9:.3f} GB of "
              f"text, {size / 1e9:.3f} GB on disk) with numpy: {dt:.3f} s "
              f"(set-up)", flush=True)
        gd, dt = timed(vcf_mod.read_vcf, path)
        lib_s = timed(native.parse_vcf, path, n)[1]
        print(f"   read_vcf, native route: {dt:.3f} s = "
              f"{text / dt / 1e9:.3f} GB/s of text ({size / dt / 1e9:.3f} "
              f"GB/s of file); native.parse_vcf alone {lib_s:.3f} s",
              flush=True)
        same_rows(f"(b) read_vcf {kind}", gd, rows)
        del gd
        (rgv, meta), dt = timed(vcf_mod.read_vcf_packed, path)
        ref = ResidentGenome.from_source(G[:rows])
        print(f"   read_vcf_packed -> ResidentGenome on the card: {dt:.3f} "
              f"s = {text / dt / 1e9:.3f} GB/s of text", flush=True)
        if not (torch.equal(rgv.packed, ref.packed) and rgv.M == rows
                and rgv.n == n and rgv.ploidy == 1 and not rgv.has_missing
                and np.array_equal(meta["chromosomes"], chrom[:rows])
                and np.array_equal(meta["positions"], pos[:rows])
                and meta["accessions"] == acc):
            raise AssertionError(f"(b) read_vcf_packed {kind} is not "
                                 "from_source of the same rows")
        del rgv, ref
        os.remove(path)
    small = os.path.join(tmp, "first.vcf")
    write_vcf(small, Mp)
    with python_route():
        gd, dt = timed(vcf_mod.read_vcf, small)
    same_rows("(b) read_vcf, Python route", gd, Mp)
    t_nat_v = timed(vcf_mod.read_vcf, small)[1]
    print(f"   read_vcf of the first {Mp} rows: Python route {dt:.3f} s, "
          f"native {t_nat_v:.3f} s; both equal to the source", flush=True)
    os.remove(small)
    del gd

    # (c) the facade from CSV and from VCF, held to the PLINK fileset
    fvcf = os.path.join(tmp, "facade.vcf.gz")
    write_vcf(fvcf, Mf)

    def gwas(label, path, fmt, **kw):
        for k in kernels:
            k.launches = 0
        out, dt = timed(api.run_gwas, path, files[1], data_format=fmt,
                        plots=False, **kw)
        cnt = {k.__name__: k.launches for k in kernels}
        for name, c in cnt.items():
            launches[name] += c
        tm = {k: round(v, 3) for k, v in out["timings"].items()}
        print(f"(c) run_gwas {label}: {dt:.3f} s; timings_s "
              f"{json.dumps(tm)}; launches {cnt}", flush=True)
        return out["scan"], cnt

    def held(label, got, ref, what="the PLINK call"):
        dp = float(np.abs(got["ps"] - ref["ps"]).max())
        same = np.array_equal(got["mask"], ref["mask"])
        print(f"   {label} vs {what}: max|dp| {dp:.3e}, masks "
              f"{'equal' if same else 'differ'}", flush=True)
        if dp > 1e-12 or not same:
            raise AssertionError(f"(c) {label} disagrees with {what}")

    seen = {}
    parse = api.parse_snp_data

    def timed_parse(*a, **kw):
        seen["gd"], seen["s"] = timed(parse, *a, **kw)
        return seen["gd"]

    for tier, path, fmt, kernel in (
            ("exact", fcsv, "binary", "scan_stats"),
            ("int8x3", fcsv, "binary", "rotate_scan_int8_packed"),
            ("bf16x3", fvcf, "vcf", "rotate_scan_bf16_packed")):
        # the genome is binary: PLINK's fileset reads as diploid unless
        # told, the CSV and VCF infer ploidy 1; every call is told 1
        kw = {"ploidy": 1} if tier == "exact" else {"precision": tier,
                                                    "ploidy": 1}
        ref, _ = gwas(f"{tier} from the PLINK fileset", files[0], "plink",
                      **kw)
        kind = "VCF.gz" if fmt == "vcf" else "CSV"
        got, cnt = gwas(f"{tier} from the {kind}", path, fmt, **kw)
        held(f"{tier} from the {kind}", got, ref)
        if cnt["ibs_gram_packed"] != 1 or cnt[kernel] <= 0:
            raise AssertionError(f"(c) {tier} from the {kind}: launches "
                                 f"{cnt}")
        if tier == "exact":
            # the Python route on the facade CSV's first Mpy rows, held to
            # the native route on that file (the kinship is of its rows)
            head = os.path.join(tmp, "facade_head.csv")
            hsize = write_csv(head, Mpy)
            t_nat = timed(parse_snp_data, head)[1]
            nat, _ = gwas(f"exact from the CSV's first {Mpy} rows", head,
                          fmt, **kw)
            with python_route(), mock.patch.object(api, "parse_snp_data",
                                                   timed_parse):
                py, _ = gwas(f"exact from the CSV's first {Mpy} rows, "
                             "Python route", head, fmt, **kw)
            held("exact from the CSV's first rows, Python route", py, nat,
                 "the native route's call")
            same_rows("(c) the Python CSV parse", seen["gd"], Mpy)
            print(f"   parse_snp_data of the {Mpy}-row CSV "
                  f"({hsize / 1e6:.1f} MB): Python route {seen['s']:.3f} s,"
                  f" native {t_nat:.3f} s; both equal to the source",
                  flush=True)
            os.remove(head)
    os.remove(fcsv)
    os.remove(fvcf)
    del gd_nat, seen

    # (d) the packed cache on phase 4's genome
    rg0, y = main["rg"], main["y"]
    cp = os.path.join(tmp, "genome.packed")
    for label, src, kw in (
            ("cold (hash, pack, write)", G, {}),
            ("warm, validated (hash, read, upload)", G, {}),
            ("warm, trust_cache=True (read, upload)", G,
             {"trust_cache": True}),
            ("G=None (read, upload)", None, {})):
        packs = ResidentGenome.packs
        rgc, dt = timed(ResidentGenome.from_source, src, cache_path=cp, **kw)
        grew = ResidentGenome.packs - packs
        print(f"(d) from_source {label}: {dt:.3f} s; packs +{grew}",
              flush=True)
        if not (torch.equal(rgc.packed, rg0.packed)
                and (rgc.M, rgc.n, rgc.ploidy, rgc.has_missing)
                == (rg0.M, rg0.n, rg0.ploidy, rg0.has_missing)
                and grew == (1 if label.startswith("cold") else 0)):
            raise AssertionError(f"(d) {label}: not phase 4's packed rows, "
                                 f"or packs +{grew}")
    print(f"   cache files: {os.path.getsize(cp) / 1e6:.1f} MB packed, "
          f"{M} x {n}", flush=True)
    for k in kernels:
        k.launches = 0
    r = emmax_resident(rgc, y, eig_k=main["eig"], precision="int8x3")
    cnt = {k.__name__: k.launches for k in kernels}
    for name, c in cnt.items():
        launches[name] += c
    dp = float(np.abs(r["ps"] - main["ps_int8x3"]).max())
    print(f"   emmax_resident int8x3 on the cached genome vs phase 4's: "
          f"max|dp| {dp:.3e}; launches {cnt}", flush=True)
    if dp != 0.0 or cnt["rotate_scan_int8_packed"] <= 0:
        raise AssertionError("(d) the cached genome's int8x3 scan differs")
    del rgc, r
    # the same shape with other content: one row's first 8 calls flipped
    with open(cp + ".json") as f:
        hash0 = json.load(f)["src_hash"]
    j = M // 2
    row = G[j].copy()
    G[j, :8] = 1 - G[j, :8]
    try:
        packs = ResidentGenome.packs
        rgx, dt = timed(ResidentGenome.from_source, G, cache_path=cp)
        want = G[j].copy()
    finally:
        G[j] = row
    with open(cp + ".json") as f:
        hash1 = json.load(f)["src_hash"]
    print(f"(d) same shape, other content: {dt:.3f} s; packs "
          f"+{ResidentGenome.packs - packs}; src_hash {hash0} -> {hash1}",
          flush=True)
    if (ResidentGenome.packs - packs != 1 or hash1 == hash0
            or not np.array_equal(rgx[j:j + 1][0], want)
            or torch.equal(rgx.packed, rg0.packed)):
        raise AssertionError("(d) a cache of other content was reused")
    del rgx
    os.remove(cp)
    os.remove(cp + ".json")
    torch.cuda.empty_cache()


def _imputed_rows(G_rows, seed: int, out=None):
    """The imputed form of int8 genotype rows, drawn on the card from a
    seed: g * 0.97 + 0.01 + U(-0.01, 0.01), 1 % NaN, float32 on the host
    (written into `out` when given)."""
    import numpy as np
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    m, n = G_rows.shape
    out = np.empty((m, n), dtype=np.float32) if out is None else out
    for s in range(0, m, 16_384):
        x = torch.as_tensor(np.ascontiguousarray(G_rows[s:s + 16_384]),
                            device="cuda").float()
        x = x * 0.97 + 0.01 + (torch.rand(x.shape, generator=g,
                                          device="cuda") * 0.02 - 0.01)
        x[torch.rand(x.shape, generator=g, device="cuda") < 0.01] = np.nan
        out[s:s + x.shape[0]] = x.cpu().numpy()
    return out


def _write_ds_vcf(path: str, Gf, chrom, acc) -> None:
    """A VCF whose only FORMAT field is DS: each dosage with 3 decimals,
    '.' for NaN."""
    import numpy as np

    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                "FILTER\tINFO\tFORMAT\t" + "\t".join(acc) + "\n")
        for j, row in enumerate(Gf):
            toks = np.char.mod("%.3f", row)
            toks[np.isnan(row)] = "."
            f.write(f"{chrom[j]}\t{100 * (j + 1)}\t.\tA\tC\t.\t.\t.\tDS\t"
                    + "\t".join(toks.tolist()) + "\n")


class _LogLines(logging.Handler):
    """The messages a logger emits while attached (LOCO's per-chromosome
    lines), to be printed on stdout beside the call they belong to."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _fractional_phase(args, kernels, launches, main, G, tmp, acc) -> None:
    """Phase 17: imputed (fractional) dosages at full width: the bf16
    tiers' float route in core against exact and against the float64 CPU
    path, LOCO's host route, and run_gwas from a DS VCF."""
    import numpy as np
    import torch

    from mixmogam_tpu_torch import api
    from mixmogam_tpu_torch.data.simulate import (simulate_genotypes,
                                                  simulate_phenotype)
    from mixmogam_tpu_torch.models import loco as loco_mod
    from mixmogam_tpu_torch.models.emmax import emmax
    from mixmogam_tpu_torch.models.loco import emmax_loco, loco_kinships
    from mixmogam_tpu_torch.models.resident import scale_k
    from mixmogam_tpu_torch.ops.eigen import eigen_k_on
    from mixmogam_tpu_torch.ops.hopper_scan import scan_stats
    from mixmogam_tpu_torch.ops.kinship import kinship
    from mixmogam_tpu_torch.ops.reml import fit_null_model
    from mixmogam_tpu_torch.ops.rotate import (float_rotation, rotate_high,
                                               rotate_tile, scan_float_rows)
    from mixmogam_tpu_torch.ops.scan import (FRACTIONAL_P_DRIFT,
                                             apply_rotation,
                                             build_rotated_null,
                                             emmax_scan_stats,
                                             rescore_p_cut)
    from mixmogam_tpu_torch.utils.caching import cached_kinship

    dev = torch.device("cuda")
    (phi, U), y = main["eig"], main["y"]
    n = G.shape[1]

    def run(fn, *a, **kw):
        """fn(*a, **kw) with the kernels' counts from 0: (result, counts,
        seconds); the counts join the kernels line."""
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        ts = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - ts
        cnt = {k.__name__: k.launches for k in kernels}
        for name, c in cnt.items():
            launches[name] += c
        return out, cnt, dt

    def k3_only(cnt, want):
        return cnt == {k.__name__: (want if k is scan_stats else 0)
                       for k in kernels}

    # (a) in core at M = 32,768: exact and the three bf16 tiers
    Ma, tile = min(32_768, G.shape[0]), 16_384
    ts = time.perf_counter()
    Gf = _imputed_rows(G[:Ma], args.seed + 190)
    print(f"(a) the source (not the system): {Ma} x {n} imputed float32 "
          f"dosages of phase 4's genome, 1 % NaN ({Gf.nbytes / 1e9:.2f} GB),"
          f" drawn on the card: {time.perf_counter() - ts:.3f} s",
          flush=True)
    tiles_a = -(-Ma // tile)
    ex, cnt, dt = run(emmax, Gf, y, eig_k=(phi, U), stream=False,
                      precision="exact")
    print(f"   emmax exact, stream=False, M={Ma}: {dt:.3f} s = "
          f"{Ma / dt:,.0f} SNP-tests/s; launches {cnt}", flush=True)
    if not k3_only(cnt, tiles_a):
        raise AssertionError(f"(a) exact: launches {cnt}")
    null = fit_null_model(y, np.ones((n, 1)), eig_k=(phi, U), device=dev,
                          dtype=torch.float32)
    rot = build_rotated_null(null)
    Gt = torch.as_tensor(np.nan_to_num(Gf[:tile], nan=0.5), device=dev)
    for tier in ("bf16x3", "bf16x2", "bf16", "high"):
        r, cnt, dt = run(emmax, Gf, y, eig_k=(phi, U), stream=False,
                         precision=tier)
        nm = int((r["mask"] != ex["mask"]).sum())
        dp = float(np.abs(r["ps"] - ex["ps"]).max())
        if tier == "high":
            # the exact tier's route: U' and each float32 row split into
            # bf16 hi + lo, three products (ops/rotate.py::rotate_high)
            rot_h = build_rotated_null(null, matmul_precision="high")
            rot_ms = _cuda_ms(lambda: rotate_high(Gt, rot_h.high,
                                                  torch.float32))
            k3_ms = _cuda_ms(lambda: emmax_scan_stats(Gt, rot_h)) - rot_ms
            del rot_h
            _check_tf32_off("emmax high on imputed dosages")
        else:
            srot = float_rotation(U, np.ones((n, 1)), tier, torch.float32,
                                  dev)
            rot_ms = _cuda_ms(lambda: rotate_tile(Gt, srot))
            k3_ms = _cuda_ms(lambda: scan_float_rows(Gt, srot, rot)) - rot_ms
            del srot
        print(f"   emmax {tier}, stream=False, M={Ma}: {dt:.3f} s = "
              f"{Ma / dt:,.0f} SNP-tests/s; a {tile}-row tile alone: the "
              f"bf16 rotation {rot_ms:.3f} ms, the mask and K3 "
              f"{k3_ms:.3f} ms (x {tiles_a} tiles: {rot_ms * tiles_a:.1f} "
              f"+ {k3_ms * tiles_a:.1f} ms); launches {cnt}; vs exact: "
              f"{nm} mask(s) differ, max|dp| {dp:.3e} (FRACTIONAL_P_DRIFT "
              f"{FRACTIONAL_P_DRIFT[tier]:g})", flush=True)
        if (not k3_only(cnt, tiles_a) or nm
                or dp > FRACTIONAL_P_DRIFT[tier]):
            raise AssertionError(f"(a) {tier} off")
        del r
    r, cnt, dt = run(emmax, Gf, y, eig_k=(phi, U), stream=False,
                     precision="bf16x3", rescore_top=1_024)
    hits = np.flatnonzero(ex["ps"] <= 0.05 / Ma)
    idx = r["rescored_idx"]
    missed = np.setdiff1d(hits, idx)
    dr = float(np.abs(r["ps"][idx] - ex["ps"][idx]).max())
    cut = rescore_p_cut(Ma, "bf16x3", fractional=True)
    print(f"   bf16x3 with rescore_top=1,024: {dt:.3f} s; rescored "
          f"{len(idx)} SNPs (the cut {cut:.4g}); {len(hits)} SNPs with "
          f"exact p <= 0.05/M, {len(missed)} of "
          f"them not rescored; rescored vs exact max|dp| {dr:.3e}; "
          f"launches {cnt}", flush=True)
    if len(missed) or dr > 1e-12 or len(hits) == 0:
        raise AssertionError("(a) the rescore is not threshold-complete")
    del r, Gt, ex
    torch.cuda.empty_cache()

    # (b) the same route at n = 2,048 against the float64 CPU path, and
    # the bf16 products' float32 sums against their float64 values
    nb, Mb = 2_048, 2_048
    Gb, _, _ = simulate_genotypes(nb, Mb, ploidy=1, seed=args.seed + 191)
    yb, _ = simulate_phenotype(Gb, h2=0.5, n_causal=5, seed=args.seed + 191)
    Gbf = _imputed_rows(Gb, args.seed + 192)
    imp = np.where(np.isnan(Gbf), np.nanmean(Gbf, axis=1, keepdims=True),
                   Gbf).astype(np.float64)
    # one float64 eigenbasis (host LAPACK) for both sides
    eigb = eigen_k_on(scale_k(kinship(Gbf, ploidy=1)), "cpu")
    for tier in ("bf16x3", "bf16x2", "bf16", "high"):
        a, cnt, _ = run(emmax, Gbf, yb, eig_k=eigb, precision=tier,
                        stream=False)
        b = emmax(Gbf, yb, eig_k=eigb, precision=tier, stream=False,
                  device="cpu")
        nm = int((a["mask"] != b["mask"]).sum())
        dp = float(np.abs(a["ps"] - b["ps"]).max())
        print(f"(b) emmax {tier}, card f32 vs CPU f64 (n={nb}, M={Mb}): {nm} "
              f"mask(s) differ, max|dp| {dp:.3e}; launches {cnt}",
              flush=True)
        if nm or dp > 1e-5 or not k3_only(cnt, 1):
            raise AssertionError(f"(b) {tier} card vs CPU off")
    srot = float_rotation(eigb[1], np.ones((nb, 1)), "bf16x3",
                          torch.float32, dev)
    Gt = torch.as_tensor(imp[:1_024], dtype=torch.float32, device=dev)
    got = rotate_tile(Gt, srot).double().cpu()
    parts = srot.W.cpu()
    ref = apply_rotation(Gt.cpu().double(), parts, None, torch.float64)
    mag = apply_rotation(Gt.cpu().double().abs(), parts.abs(), None,
                         torch.float64)
    ratio = float(((got - ref).abs() / mag.clamp_min(1e-300)).max())
    print(f"   the bf16x3 products' float32 sums (1,024 x {nb} rows) vs "
          f"the float64 products of the same bf16 operands: max |d| / "
          f"sum|g w| {ratio:.3e} (float32 rounding allows n u = "
          f"{nb * 2.0 ** -24:.3e}; a bf16 partial sum would give ~4e-3)",
          flush=True)
    if ratio > nb * 2.0 ** -24:
        raise AssertionError("(b) the bf16 products do not sum in float32")
    del srot, Gt, got, ref, mag, parts, imp

    # (d) LOCO on the fractional source in 2 chromosomes (TAIR10's 2-5
    # merged), cut to 16,384 rows and 2 chromosomes for the script's clock
    # (three calls of an eigh and a gram a chromosome)
    Md = min(16_384, Ma)
    chrom = np.minimum(_tair10_chromosomes(Md), 2)
    ranges = loco_mod._chrom_ranges(chrom)
    tiles_d = sum(-(-(e - s) // tile) for _, s, e in ranges)
    # the per-chromosome lines: an earlier phase may have raised the
    # logger's level, so it is set here for these calls and put back
    log = logging.getLogger("mixmogam_tpu_torch.loco")
    level = log.level
    log.setLevel(logging.INFO)
    out = {}
    for label, kw in (("exact IBS", dict(precision="exact")),
                      ("bf16x3 IBS", dict(precision="bf16x3")),
                      ("exact VanRaden", dict(method="vanraden",
                                              precision="exact"))):
        h = _LogLines()
        log.addHandler(h)
        try:
            r, cnt, dt = run(emmax_loco, Gf[:Md], y, chromosomes=chrom, **kw)
        finally:
            log.removeHandler(h)
        print(f"(d) emmax_loco {label}, fractional M={Md} ({len(ranges)} "
              f"chromosomes): {dt:.3f} s = {Md / dt:,.0f} SNP-tests/s; "
              f"launches {cnt}", flush=True)
        for line in h.lines:
            print(f"   {line}", flush=True)
        ps = r["ps"]
        if (not k3_only(cnt, tiles_d) or ps.shape != (Md,)
                or not np.isfinite(ps).all()):
            raise AssertionError(f"(d) LOCO {label} off")
        out[label] = r
    log.setLevel(level)
    dl = float(np.abs(out["bf16x3 IBS"]["ps"] - out["exact IBS"]["ps"]).max())
    nm = int((out["bf16x3 IBS"]["mask"] != out["exact IBS"]["mask"]).sum())
    print(f"   LOCO bf16x3 vs exact: {nm} mask(s) differ, max|dp| {dl:.3e}",
          flush=True)
    if nm or dl > FRACTIONAL_P_DRIFT["bf16x3"]:
        raise AssertionError("(d) LOCO bf16x3 disagrees with exact")
    del out
    # the float route's kinships on phase 6's integer genome, cast to
    # float32, against the resident route's (K1 / K4); chromosomes 3-5
    # merged into one (each kinship costs a d2h and host algebra of n^2)
    Mf = min(args.facade_snps, G.shape[0])
    chf = np.minimum(_tair10_chromosomes(Mf), 3)
    ts = time.perf_counter()
    host = loco_mod._HostRows(G[:Mf].astype(np.float32), None, "ibs", dev)
    rf = loco_mod._chrom_ranges(chf)
    kf = loco_mod._recombine(*host.total(rf), rf, host.kinship, True)
    t_f = time.perf_counter() - ts
    kr, cnt, t_r = run(loco_kinships, G[:Mf], chf)
    dk = max(float(np.abs(kf[c] - kr[c]).max()) for c in kr)
    print(f"   loco_kinships on phase 6's genome (M={Mf}): the float route "
          f"(float32 matmuls) {t_f:.3f} s vs the resident route "
          f"{t_r:.3f} s (launches {cnt}): max|dK| {dk:.3e}", flush=True)
    if dk > 1e-6 or cnt["ibs_gram_packed"] != 1:
        raise AssertionError("(d) the float route's kinships disagree")
    del kf, kr, host

    # (e) the facade from a DS VCF of imputed dosages
    Me = min(256, Ma)
    che = np.repeat([1, 2], [Me // 2, Me - Me // 2])
    vcf = os.path.join(tmp, "imputed.vcf")
    ts = time.perf_counter()
    _write_ds_vcf(vcf, Gf[:Me], che, acc)
    pheno = os.path.join(tmp, "pheno17.csv")
    with open(pheno, "w") as f:
        f.write("ecotype_id,trait\n")
        f.writelines(f"{a},{float(v)!r}\n" for a, v in zip(acc, y))
    print(f"(e) wrote a DS VCF of {Me} x {n} imputed dosages "
          f"({os.path.getsize(vcf) / 1e6:.1f} MB): "
          f"{time.perf_counter() - ts:.3f} s", flush=True)
    for kw in (dict(method="emmax_loco"),
               dict(method="emmax", precision="bf16x3")):
        res, cnt, dt = run(api.run_gwas, vcf, pheno, data_format="vcf_ds",
                           plots=False, **kw)
        g2, y2 = res["genotype"], res["y"]
        if kw["method"] == "emmax_loco":
            ref = emmax_loco(g2, y2)
        else:
            ref = emmax(g2, y2, K=cached_kinship(g2, "ibs", device=dev),
                        precision="bf16x3")
        dp = float(np.abs(res["scan"]["ps"] - ref["ps"]).max())
        tm = {k: round(v, 3) for k, v in res["timings"].items()}
        print(f"   run_gwas {kw} from the DS VCF: {dt:.3f} s (timings_s "
              f"{json.dumps(tm)}); M={g2.num_snps} {type(g2).__name__} "
              f"{g2.matrix.dtype}; "
              f"launches {cnt}; vs the direct call on its rows: max|dp| "
              f"{dp:.3e}", flush=True)
        if (dp > 1e-12 or cnt["scan_stats"] <= 0
                or np.array_equal(g2.matrix, np.round(g2.matrix))):
            raise AssertionError(f"(e) run_gwas {kw} off")
    os.remove(vcf)
    del Gf
    torch.cuda.empty_cache()


#: phase 18 (b): one rank of a gloo world on the card, a subprocess
_P18_HEAD = r"""
import datetime, json, pickle, sys, time
import numpy as np
sys.path.insert(0, {repo!r})
import torch
import torch.distributed as dist
from mixmogam_tpu_torch.models.emma import emma
from mixmogam_tpu_torch.models.emmax import emmax_anova
from mixmogam_tpu_torch.models.gxe import emmax_gxe
from mixmogam_tpu_torch.models.linear import (anova, kruskal_wallis,
                                              linear_model)
from mixmogam_tpu_torch.models.loco import emmax_loco
from mixmogam_tpu_torch.models.multitrait import emmax_multi_trait
from mixmogam_tpu_torch.models.permutation import emmax_perm_test
from mixmogam_tpu_torch.models.resident import ResidentGenome
from mixmogam_tpu_torch.models.stepwise import emmax_step_wise
from mixmogam_tpu_torch.models.twosnp import emmax_two_snps
from mixmogam_tpu_torch.ops.hopper_kinship import (ibs_gram_packed,
                                                   ibs_gram_tri_packed)
from mixmogam_tpu_torch.ops.hopper_scan import (rotate_scan_bf16_packed,
                                                rotate_scan_int8_packed,
                                                scan_stats)
from mixmogam_tpu_torch.models.emmax import emmax
from mixmogam_tpu_torch.ops.reml import esp_to_refine_iters, fit_null_model
from mixmogam_tpu_torch.ops.rotate import rotate_tile
from mixmogam_tpu_torch.ops.scan import build_rotated_null
from mixmogam_tpu_torch.parallel import (distributed_emmax,
                                         distributed_emmax_resident,
                                         distributed_kinship, make_mesh)
from mixmogam_tpu_torch.parallel import distributed as pd
from mixmogam_tpu_torch.parallel.mesh import all_reduce
from mixmogam_tpu_torch.parallel.multihost import host_snp_range

rank, world = int(sys.argv[1]), int(sys.argv[2])
dist.init_process_group("gloo", init_method="file://" + {store!r},
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=300))
mesh = make_mesh()                    # no devices=: the card
G = np.load({d!r} + "/G.npy", mmap_mode="r")
y = np.load({d!r} + "/y.npy")
phi = torch.as_tensor(np.load({d!r} + "/phi.npy"), device=mesh.device)
U = torch.as_tensor(np.load({d!r} + "/U.npy"), device=mesh.device)
# which gloo collectives take CUDA tensors in this torch (the port moves
# them through the host under gloo either way: parallel/mesh.py)
probe = {{}}
for name, fn in (("all_reduce", lambda t: dist.all_reduce(t)),
                 ("broadcast", lambda t: dist.broadcast(t, 0)),
                 ("all_gather", lambda t: dist.all_gather(
                     [torch.empty_like(t) for _ in range(world)], t))):
    try:
        fn(torch.ones(4, device=mesh.device))
        probe[name] = "works"
    except Exception as e:
        probe[name] = f"raises {{type(e).__name__}}"
kernels = (ibs_gram_packed, ibs_gram_tri_packed, rotate_scan_int8_packed,
           rotate_scan_bf16_packed, scan_stats)
for k in kernels:
    k.launches = 0
walls, out = {{}}, {{}}
"""

#: phase 18 (b): the rank's scans over its 'snp' mesh of two
_P18_SCANS = r"""
ts = time.perf_counter()
out["K"] = distributed_kinship(G, mesh)
walls["kinship"] = time.perf_counter() - ts
ts = time.perf_counter()
rgh = ResidentGenome.from_source(G, upload=False)
walls["pack on the host"] = time.perf_counter() - ts
for tier, rb in {rb!r}.items():
    for name, fn, src in (("", distributed_emmax, G),
                          ("res_", distributed_emmax_resident, rgh)):
        ts = time.perf_counter()
        r = fn(src, y, eig_k=(phi, U), mesh=mesh, rotate_in_bf16=rb)
        walls[name + tier] = time.perf_counter() - ts
        for k in ("ps", "mask", "f_stats", "betas"):
            out[name + tier + "_" + k] = r[k]
# LOCO on n = 2,048: the rows packed on the host at a 2,048-row tile
Gl = np.load({d!r} + "/Gl.npy")
rgl = ResidentGenome.from_source(Gl, tile=2_048, upload=False)
ts = time.perf_counter()
r = emmax_loco(rgl, np.load({d!r} + "/yl.npy"),
               chromosomes=np.load({d!r} + "/chl.npy"), mesh=mesh)
walls["emmax_loco"] = time.perf_counter() - ts
for k in ("ps", "mask", "f_stats", "betas"):
    out["loco_" + k] = r[k]
# the same rows at chromosome bounds off the tile, one chromosome across
# the ranks' boundary: its tiles start at that boundary on rank 1
ts = time.perf_counter()
r = emmax_loco(rgl, np.load({d!r} + "/yl.npy"),
               chromosomes=np.load({d!r} + "/chl_off.npy"), mesh=mesh)
walls["emmax_loco, bounds off the tile"] = time.perf_counter() - ts
for k in ("ps", "mask", "f_stats", "betas"):
    out["loco_off_" + k] = r[k]
# the campaign scans (ROADMAP item 16c's first half) on the same rows
ts = time.perf_counter()
sw = emmax_step_wise(G, y, eig_k=(phi, U), max_steps=3, mesh=mesh)
walls["emmax_step_wise"] = time.perf_counter() - ts
Y4 = np.load({d!r} + "/Y4.npy")
for name, src, tier in (("mt_exact", G, "exact"), ("mt_int8x3", G, "int8x3"),
                        ("mt_res_exact", rgh, "exact"),
                        ("mt_high", G, "high")):
    ts = time.perf_counter()
    r = emmax_multi_trait(src, Y4, eig_k=(phi, U), precision=tier, mesh=mesh)
    walls["emmax_multi_trait " + name[3:]] = time.perf_counter() - ts
    for k in ("ps", "mask", "f_stats", "betas"):
        out[name + "_" + k] = r[k]
ts = time.perf_counter()
r = emma(G, y, eig_k=(phi, U), mesh=mesh)
walls["emma"] = time.perf_counter() - ts
for k in ("ps", "mask", "f_stats", "betas"):
    out["emma_" + k] = r[k]
# the remaining scans (ROADMAP item 16c's second half) on the same rows:
# each rank's shard of the host-only container, two-SNP's and
# emmax_anova's rows of the host sources
for name, fn in (("lm", linear_model), ("anova", anova),
                 ("kw", kruskal_wallis)):
    ts = time.perf_counter()
    r = fn(rgh, y, mesh=mesh)
    walls[fn.__name__] = time.perf_counter() - ts
    for k, v in r.items():
        out[name + "_" + k] = v
y12, env = np.load({d!r} + "/y12.npy"), np.load({d!r} + "/env.npy")
for tier in ("exact", "int8x3", "high"):
    ts = time.perf_counter()
    r = emmax_gxe(rgh, y12, env, eig_k=(phi, U), precision=tier, mesh=mesh)
    walls["emmax_gxe " + tier] = time.perf_counter() - ts
    for k in {gxe_keys!r}:
        out["gxe_" + tier + "_" + k] = r[k]
    ts = time.perf_counter()
    r = emmax_perm_test(rgh, y, eig_k=(phi, U), num_perm=128,
                        precision=tier, mesh=mesh)
    walls["emmax_perm_test " + tier] = time.perf_counter() - ts
    for k in ("min_ps", "threshold"):
        out["perm_" + tier + "_" + k] = r[k]
ts = time.perf_counter()
r = emmax_two_snps(G, y, eig_k=(phi, U),
                   focal_idx=np.load({d!r} + "/focal.npy"), mesh=mesh)
walls["emmax_two_snps"] = time.perf_counter() - ts
for k in ("cond_ps", "inter_ps"):
    out["two_" + k] = r[k]
ts = time.perf_counter()
r = emmax_anova(np.load({d!r} + "/D.npy", mmap_mode="r"), y,
                eig_k=(phi, U), mesh=mesh)
walls["emmax_anova"] = time.perf_counter() - ts
for k in ("ps", "mask", "f_stats", "dof1", "dof2"):
    out["ea_" + k] = r[k]
"""

#: phase 18 (b): the 'sample' tensor-parallel scan on the same ranks as a
#: (1, 2) mesh (_tp_gates holds it to one device)
_P18_TP = r"""
# ---- the 'sample' tensor-parallel scan (ROADMAP item 16d-i): the same two
# ranks as a (1, 2) mesh, on the first {mt} rows (one tile) ----
tp_mesh = make_mesh((1, 2))
Gt = np.ascontiguousarray(G[:{mt}])
rgt = ResidentGenome.from_source(Gt, upload=False)
tp_walls, tp_bytes = {{}}, {{}}


def timed(name, fn):
    all_reduce.bytes = 0
    torch.cuda.synchronize()
    ts = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    tp_walls[name] = time.perf_counter() - ts
    tp_bytes[name] = all_reduce.bytes
    return r


launches_before_tp = {{k.__name__: k.launches for k in kernels}}
for k in kernels:
    k.launches = 0
out["tp_K"] = timed("distributed_kinship",
                    lambda: distributed_kinship(Gt, tp_mesh))
for tier, rb in {rb!r}.items():
    for name, fn, src in (("", distributed_emmax, Gt),
                          ("res_", distributed_emmax_resident, rgt)):
        r = timed(fn.__name__ + " " + tier, lambda: fn(
            src, y, eig_k=(phi, U), mesh=tp_mesh, rotate_in_bf16=rb))
        for k in ("ps", "mask", "f_stats", "betas"):
            out["tp_" + name + tier + "_" + k] = r[k]
r = timed("emmax(mesh=) int8x3", lambda: emmax(
    Gt, y, eig_k=(phi, U), mesh=tp_mesh, precision="int8x3"))
for k in ("ps", "mask", "f_stats", "betas"):
    out["tp_route_" + k] = r[k]
tp_launches = {{k.__name__: k.launches for k in kernels}}
# each rank's block of the rotation at each tier; at int8x3 the tile's
# plane products summed over 'sample' against one device's whole-row
# torch._int_mm products, from this rank's own single-device null
X0 = np.ones((Gt.shape[1], 1))
n_pad, b0, b1 = pd.sample_blocks(Gt.shape[1], tp_mesh)
w_blocks, planes_equal = {{}}, None
for tier, rb in {rb!r}.items():
    tpn, _ = pd._tp_null(tp_mesh, mesh.device, torch.float32, y, X0, None,
                         (phi, U), rb or None, False, 100, -10.0, 10.0, 1e-6,
                         True, n_pad, b0, b1)
    w_blocks[tier] = list(tpn.W.W.shape)
    if tier == "int8x3":
        Gb = torch.from_numpy(Gt[:, b0:b1]).to(mesh.device)
        sums = [all_reduce(rotate_tile(Gb, tpn.W, plane=i), tp_mesh,
                           axis="sample") for i in range(3)]
        null = fit_null_model(y, X0, eig_k=(phi, U), refine_iters=
                              esp_to_refine_iters(1e-6, 100, -10.0, 10.0),
                              host_eigh=True, device=mesh.device,
                              dtype=torch.float32)
        planes = build_rotated_null(null, rotate_dtype="int8x3").planes
        Gd = torch.from_numpy(Gt).to(mesh.device)
        planes_equal = [bool(torch.equal(a, torch._int_mm(
            Gd, p.t().contiguous().t()))) for a, p in zip(sums, planes)]
        del Gb, sums, planes, Gd
    del tpn
# ---- the campaign entry points on the same (1, 2) mesh (ROADMAP item
# 16d-ii): stepwise and multi-trait on the same rows (multi-trait exact in
# core, int8x3 over the host-only container), LOCO on the n = 2,048
# fixture; the counts set to 0 just before each call and read just after
camp_launches = {{}}


def counted(name, fn, into=camp_launches):
    for k in kernels:
        k.launches = 0
    r = timed(name, fn)
    into[name] = {{k.__name__: k.launches for k in kernels}}
    return r


tp_sw = counted("emmax_step_wise", lambda: emmax_step_wise(
    Gt, y, eig_k=(phi, U), max_steps={sw_steps}, mesh=tp_mesh))
for name, src, tier in (("mt_exact", Gt, "exact"),
                        ("mt_int8x3", rgt, "int8x3"), ("mt_high", Gt, "high")):
    r = counted("emmax_multi_trait " + tier, lambda: emmax_multi_trait(
        src, Y4[:{mt_traits}], eig_k=(phi, U), precision=tier, mesh=tp_mesh))
    for k in ("ps", "mask", "f_stats", "betas"):
        out["tp_" + name + "_" + k] = r[k]
r = counted("emmax_loco", lambda: emmax_loco(
    rgl, np.load({d!r} + "/yl.npy"), chromosomes=np.load({d!r} + "/chl.npy"),
    mesh=tp_mesh))
for k in ("ps", "mask", "f_stats", "betas"):
    out["tp_loco_" + k] = r[k]
tp_loco_deltas = {{str(c): v["delta"] for c, v in r["loco"].items()}}
# ---- the remaining entry points on the same (1, 2) mesh (ROADMAP item
# 16d-iii), on the first {ms} rows: GxE, the permutation test, two-SNP and
# emmax_anova's diploid test rotate by their block of the rotation's rows,
# the binary emmax_anova goes through emmax(mesh=), the class tests
# replicate over 'sample'; the counts set to 0 just before each call ----
rest_launches = {{}}
Gs = Gt[:{ms}]
for tier, top in (("exact", 0), ("int8x3", {gxe_top}), ("high", 0)):
    r = counted("emmax_gxe " + tier, lambda: emmax_gxe(
        Gs, y12, env, eig_k=(phi, U), precision=tier, rescore_top=top,
        mesh=tp_mesh), rest_launches)
    for k in {gxe_keys!r} + ("f_inter",):
        out["tpr_gxe_" + tier + "_" + k] = r[k]
    for e, idx in enumerate(r["rescored_idx"]):
        out[f"tpr_gxe_{{tier}}_rescored{{e}}"] = idx
r = counted("emmax_perm_test", lambda: emmax_perm_test(
    Gs, y, eig_k=(phi, U), num_perm=128, mesh=tp_mesh), rest_launches)
for k in ("min_ps", "threshold"):
    out["tpr_perm_" + k] = r[k]
# 'high' on this axis: the permutation test refuses it, as the JAX package
# does (in core it takes no tier; a container refuses the 'sample' axis)
perm_high = {{}}
for name, src in (("in core", Gs), ("container", rgt)):
    try:
        emmax_perm_test(src, y, eig_k=(phi, U), num_perm=128,
                        precision="high", mesh=tp_mesh)
        perm_high[name] = "ran"
    except ValueError as e:
        perm_high[name] = str(e)
r = counted("emmax_two_snps", lambda: emmax_two_snps(
    Gs, y, eig_k=(phi, U), focal_idx=np.load({d!r} + "/focal_tp.npy"),
    mesh=tp_mesh), rest_launches)
for k in ("cond_ps", "inter_ps"):
    out["tpr_two_" + k] = r[k]
for name, src in (("binary", Gs), ("diploid", np.load(
        {d!r} + "/D.npy", mmap_mode="r")[:{ms}])):
    r = counted("emmax_anova " + name, lambda: emmax_anova(
        src, y, eig_k=(phi, U), mesh=tp_mesh), rest_launches)
    for k in ("ps", "mask", "f_stats") + (("dof1", "dof2") if name ==
                                          "diploid" else ()):
        out[f"tpr_ea_{{name}}_{{k}}"] = r[k]
for name, fn in (("lm", linear_model), ("anova", anova),
                 ("kw", kruskal_wallis)):
    r = counted(fn.__name__, lambda: fn(Gs, y, mesh=tp_mesh), rest_launches)
    for k, v in r.items():
        out["tpr_" + name + "_" + k] = v
"""

#: phase 18 (b): the train step on both meshes of the same ranks and a
#: world of one in rank 0's process, then the dry run on the (2, 1) mesh
#: (_step_gates holds them)
_P18_STEP = r"""
# ---- distributed_train_step (ROADMAP item 16e) on the (2, 1) and (1, 2)
# meshes of the two ranks, with phase 9's first {mt_traits} traits; in rank
# 0's process a world of one (no process group); then the JAX dry run's
# phases on the (2, 1) mesh ----
from mixmogam_tpu_torch.parallel import distributed_train_step
from mixmogam_tpu_torch.parallel.dryrun import dryrun_rank
from mixmogam_tpu_torch.parallel.mesh import Mesh
step_launches, step_split = {{}}, {{}}
calls = [("snp", mesh), ("tp", tp_mesh)]
if rank == 0:
    calls.append(("one", Mesh((1, 1), None, None, 0, 1, mesh.device)))
for name, m in calls:
    r = counted("distributed_train_step " + name,
                lambda: distributed_train_step(m, G, Y4[:{mt_traits}],
                                               top_k={top}), step_launches)
    step_split[name] = {{k: round(v, 4) for k, v in r["timings_s"].items()}}
    for k in ("top_f", "top_idx", "deltas", "K"):
        out["step_" + name + "_" + k] = r[k]
ts = time.perf_counter()
dry_line = dryrun_rank(mesh)
dry_wall = time.perf_counter() - ts
"""

_P18_TAIL = r"""
print(json.dumps({{"rank": rank, "device": str(mesh.device),
                   "backend": mesh.backend,
                   "tp": {{"mesh": [list(tp_mesh.shape), tp_mesh.snp_index,
                                    tp_mesh.sample_index],
                           "step": {{"launches": step_launches,
                                     "split_s": step_split,
                                     "walls_s": {{k: round(v, 3) for k, v in
                                                  tp_walls.items()
                                                  if "train_step" in k}},
                                     "dryrun": dry_line,
                                     "dryrun_s": round(dry_wall, 3)}},
                           "walls_s": {{k: round(v, 3)
                                        for k, v in tp_walls.items()}},
                           "reduced_bytes": tp_bytes,
                           "launches": tp_launches,
                           "w_blocks": w_blocks,
                           "plane_sums_equal": planes_equal,
                           "campaign_launches": camp_launches,
                           "rest_launches": rest_launches,
                           "perm_high": perm_high,
                           "loco_deltas": tp_loco_deltas}},
                   "rows": host_snp_range(G.shape[0], world, rank),
                   "resident rows": host_snp_range(
                       rgh.M, world, rank, tile=rgh.tile),
                   "shard uploads": ResidentGenome.uploads,
                   "walls_s": {{k: round(v, 3) for k, v in walls.items()}},
                   "launches": launches_before_tp,
                   "gloo_on_cuda_tensors": probe}}), flush=True)
if rank == 0:
    np.savez({d!r} + "/out.npz", **out)
    with open({d!r} + "/sw.pkl", "wb") as f:
        pickle.dump({{"sw": sw, "tp_sw": tp_sw}}, f)
# no rank tears its group down while another still works (a gloo peer that
# exits first can abort the other's teardown)
dist.barrier()
dist.destroy_process_group()
"""
_P18_RANK = _P18_HEAD + _P18_SCANS + _P18_TP + _P18_STEP + _P18_TAIL

_P18_TIERS = {"exact": False, "int8x3": "int8x3", "bf16x3": "bf16x3"}
#: phase 18 (b): max |dp| of emmax_loco(mesh=) against one device's call at
#: chromosome bounds off the tile, where a chromosome split across ranks is
#: tiled from the rank boundary and the exact tier's float32 GEMMs sum in
#: other shapes (phase 13 (b)'s bound for float32 against float64 p-values)
LOCO_OFF_TILE_TOL = 1e-5


def _p18_gate(label, got, ref, tol=1e-12) -> None:
    """Identical masks and max |dp| <= tol; says whether bit-equal."""
    import numpy as np

    nm = int((got["mask"] != ref["mask"]).sum())
    dp = float(np.abs(got["ps"] - ref["ps"]).max())
    same = all(np.array_equal(got[k], ref[k])
               for k in ("ps", "mask", "f_stats", "betas"))
    print(f"   {label}: {nm} mask(s) differ, max|dp| {dp:.3e}, "
          f"{'bit-equal' if same else 'not bit-equal'} (ps, mask, f_stats, "
          f"betas)", flush=True)
    if nm or dp > tol:
        raise AssertionError(f"{label}: the distributed call disagrees")


def _resident_mesh_phase(kernels, launches, main, G, mesh, Kr):
    """Phase 18 (c), in (a)'s world of one over NCCL: the sharded resident
    scan over a host-only container of phase 4's genome and
    emmax_loco(mesh=) on phase 6's rows, each held bit-equal to its
    single-device call, K1-K5 each launched. Returns the container (its
    shard kept) for (d)."""
    import numpy as np
    import torch

    from mixmogam_tpu_torch.models.emmax import emmax
    from mixmogam_tpu_torch.models.loco import emmax_loco
    from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                    emmax_resident)
    from mixmogam_tpu_torch.parallel import distributed_kinship

    rg, (phi, U), y = main["rg"], main["eig"], main["y"]
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    ts = time.perf_counter()
    rgh = ResidentGenome.from_source(G, upload=False)
    pack = time.perf_counter() - ts
    mem1 = torch.cuda.memory_allocated()
    print(f"(c) from_source(upload=False), n={rgh.n} M={rgh.M}: {pack:.3f} "
          f"s on the host ({rgh.nbytes_packed / 1e6:.1f} MB packed); "
          f"memory_allocated {mem0} -> {mem1} bytes", flush=True)
    if mem1 != mem0 or not rgh.on_host:
        raise AssertionError("(c) upload=False took device memory")
    if not np.array_equal(rgh.host_packed, rg.host_packed):
        raise AssertionError("(c) the host packing differs from the card's")
    for k in kernels:
        k.launches = 0
    walls, res, ups = [], {}, []
    for tier in _P18_TIERS:
        for again in ("first", "again"):
            u0 = ResidentGenome.uploads
            torch.cuda.synchronize()
            ts = time.perf_counter()
            res[tier] = emmax(rgh, y, eig_k=(phi, U), mesh=mesh,
                              precision=tier)
            walls.append(f"emmax(mesh=) {tier} {again} "
                         f"{time.perf_counter() - ts:.3f}")
            ups.append(ResidentGenome.uploads - u0)
    ts = time.perf_counter()
    Kh = distributed_kinship(rgh, mesh)
    walls.append(f"distributed_kinship {time.perf_counter() - ts:.3f}")
    lo = main["loco6"]
    ts = time.perf_counter()
    rl = emmax_loco(lo["G"], lo["y"], chromosomes=lo["chrom"], mesh=mesh)
    torch.cuda.synchronize()
    walls.append(f"emmax_loco(mesh=) exact {time.perf_counter() - ts:.3f}")
    run = {k.__name__: k.launches for k in kernels}
    print(f"(c) {'; '.join(walls)} s; shard uploads a call {ups}; "
          f"launches {run}", flush=True)
    for name, cnt in run.items():
        launches[name] += cnt
        if cnt <= 0:
            raise AssertionError(f"(c) the resident mesh path never "
                                 f"launched {name}")
    if ups != [1, 0, 0, 0, 0, 0]:
        raise AssertionError(f"(c) shard uploads {ups}, not 1 then none")
    # the single-device calls, after the counts were read
    for tier in _P18_TIERS:
        ts = time.perf_counter()
        ref = emmax_resident(rg, y, eig_k=(phi, U), precision=tier)
        _p18_gate(f"(c) emmax(host-only container, mesh=) {tier} vs "
                  f"emmax_resident ({time.perf_counter() - ts:.3f} s)",
                  res[tier], ref)
    print(f"   distributed_kinship(container) vs kinship_resident: "
          f"{'bit-equal' if np.array_equal(Kh, Kr) else 'NOT equal'}",
          flush=True)
    if not np.array_equal(Kh, Kr):
        raise AssertionError("(c) the container's kinship is not bit-equal")
    _p18_gate(f"(c) emmax_loco(mesh=) vs phase 6's emmax_loco exact "
              f"({lo['wall']:.3f} s), M={lo['G'].num_snps}, "
              f"{len(set(lo['chrom'].tolist()))} chromosomes",
              rl, lo["exact"])
    if rl["loco"] != lo["exact"]["loco"]:
        raise AssertionError("(c) LOCO's per-chromosome nulls differ")
    del res, rl
    main.pop("loco6")
    return rgh


def _bit_equal(label, got, ref, keys) -> None:
    """Phase 18 (d)'s gate: every array of `keys` bit-equal to the
    single-device call's; the masks and max |dp| printed."""
    import numpy as np

    nm = int((got["mask"] != ref["mask"]).sum())
    dp = float(np.abs(got["ps"] - ref["ps"]).max())
    bad = [k for k in keys if not np.array_equal(got[k], ref[k])]
    print(f"   {label}: {nm} mask(s) differ, max|dp| {dp:.3e}, "
          f"{'bit-equal' if not bad else f'NOT bit-equal in {bad}'} "
          f"({', '.join(keys)})", flush=True)
    if bad:
        raise AssertionError(f"{label}: not bit-equal to one device")


def _same_path(label, got, ref, rtol=0.0) -> None:
    """Two stepwise results: the same path of cofactors, min_p SNPs and
    selections, and min_p, the criteria and the cofactor re-tests within
    rtol (0: bit-equal)."""
    import numpy as np

    if ([(s["phase"], s["cofactors"], s["min_p_snp"]) for s in got["steps"]]
            != [(s["phase"], s["cofactors"], s["min_p_snp"])
                for s in ref["steps"]]
            or got["selected"] != ref["selected"]):
        raise AssertionError(f"{label}: another path or selection")
    worst = 0.0
    for a, b in zip(got["steps"], ref["steps"]):
        for k in ("min_p", "bic", "ebic", "mbic", "delta", "cofactor_ps"):
            x, y = np.asarray(a[k], float), np.asarray(b[k], float)
            if not np.array_equal(np.isnan(x), np.isnan(y)):
                worst = np.inf           # a value on one side only
                continue
            ok = ~np.isnan(y)            # min_p is NaN past the forward scans
            d = np.abs(x[ok] - y[ok]) / np.maximum(np.abs(y[ok]), 1e-300)
            worst = max(worst, float(d.max(initial=0.0)))
    print(f"   {label}: the same {len(ref['steps'])} steps, path "
          f"{[s['min_p_snp'] for s in ref['steps'] if s['min_p_snp'] >= 0]}"
          f" and selections; max relative difference {worst:.3e} (min_p, "
          f"criteria, delta, cofactor re-tests)", flush=True)
    if worst > rtol:
        raise AssertionError(f"{label}: differs from one device")


def _campaign_mesh_phase(kernels, launches, main, G, mesh, rgh) -> None:
    """Phase 18 (d), in (a)'s world of one over NCCL: item 16c's first half
    at full width, each call bit-equal to the single-device result that
    phase 8, 9 or 10 kept, its wall beside that phase's, K3's launches
    equal to the single-device counts."""
    import torch

    from mixmogam_tpu_torch.models.emma import emma
    from mixmogam_tpu_torch.models.multitrait import emmax_multi_trait
    from mixmogam_tpu_torch.models.stepwise import emmax_step_wise

    k3 = next(k for k in kernels if k.__name__ == "scan_stats")

    def timed(fn):
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        ts = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - ts
        run = {k.__name__: k.launches for k in kernels}
        for name, cnt in run.items():
            launches[name] += cnt
        return r, wall, run["scan_stats"]

    (phi, U), y = main["eig"], main["y"]
    sw = main.pop("sw8")
    r, wall, n3 = timed(lambda: emmax_step_wise(G, y, eig_k=(phi, U),
                                                max_steps=10, mesh=mesh))
    print(f"(d) emmax_step_wise(mesh=) on phase 4's host genome, 10 steps "
          f"({r['timings_s']['route']}): {wall:.3f} s (phase 8's "
          f"single-device call {sw['wall']:.3f} s); rotation "
          f"{r['timings_s']['rotate']:.3f} s; K3 launches {n3} (phase 8: "
          f"{sw['k3']})", flush=True)
    _same_path("(d) emmax_step_wise(mesh=) vs phase 8's stored call", r,
               sw["res"])
    if n3 != sw["k3"]:
        raise AssertionError("(d) stepwise: K3 launched another count")
    del r
    torch.cuda.empty_cache()
    mt = main["mt9"]            # its traits stay for (b)
    keys = ("ps", "f_stats", "betas", "mask", "deltas")
    for tier, src, what in (("exact", main["rg"], "phase 4's resident genome"),
                            ("int8x3", main["rg"],
                             "phase 4's resident genome"),
                            ("exact", rgh, "(c)'s host-only container")):
        r, wall, n3 = timed(lambda: emmax_multi_trait(
            src, mt["Y"], eig_k=(phi, U), precision=tier, mesh=mesh))
        print(f"(d) emmax_multi_trait(mesh=) {tier}, T={mt['Y'].shape[0]}, "
              f"over {what}: {wall:.3f} s (phase 9's single-device call "
              f"{mt[tier]['wall']:.3f} s); K3 launches {n3} (phase 9: "
              f"{mt['k3']})", flush=True)
        _bit_equal(f"(d) emmax_multi_trait(mesh=) {tier} vs phase 9's", r,
                   mt[tier], keys)
        if n3 != mt["k3"]:
            raise AssertionError("(d) multi-trait: K3 launched another "
                                 "count")
        del r
    del mt["exact"], mt["int8x3"]
    torch.cuda.empty_cache()
    em = main.pop("emma10")
    r, wall, n3 = timed(lambda: emma(em["rg"], em["y"], eig_k=em["eig"],
                                     mesh=mesh))
    tm = r["timings_s"]
    print(f"(d) emma(mesh=) float64, n={em['rg'].n} M={em['rg'].M}: "
          f"{wall:.3f} s (phase 10's single-device call {em['wall']:.3f} "
          f"s); rotation {tm['rotation']:.3f} s, grid {tm['grid']:.3f} s, "
          f"refine {tm['refine']:.3f} s; kernel launches {n3} (EMMA runs "
          f"none)", flush=True)
    _bit_equal("(d) emma(mesh=) vs phase 10's", r, em["res"],
               ("ps", "f_stats", "betas", "mask", "deltas", "lls"))
    del r, em
    torch.cuda.empty_cache()


#: the GxE results phase 18 holds to one device's
_GXE_KEYS = ("marginal_ps", "inter_ps", "joint_ps", "mask", "mask_inter")


def _equal_arrays(label, got, ref, keys, tol=0.0) -> None:
    """Phase 18's gate for results other than (ps, mask): each array of
    `keys` within tol of the single-device call's (masks equal; tol 0:
    bit-equal), the largest difference and bit-equality printed."""
    import numpy as np

    worst = max(float(np.abs(np.asarray(got[k], np.float64)
                             - np.asarray(ref[k], np.float64)).max(
                                 initial=0.0)) for k in keys)
    bad = [k for k in keys if not np.array_equal(got[k], ref[k])]
    print(f"   {label}: max|d| {worst:.3e}, "
          f"{'bit-equal' if not bad else f'not bit-equal in {bad}'} "
          f"({', '.join(keys)})", flush=True)
    if worst > tol or (tol == 0.0 and bad):
        raise AssertionError(f"{label}: differs from one device")


def _remaining_mesh_phase(args, kernels, launches, main, mesh):
    """Phase 18 (e), in (a)'s world of one over NCCL: item 16c's second
    half at full width, each call bit-equal to the single-device result
    that phase 11, 12 or 13 kept (no single-device call run again), its
    wall beside that phase's, K3's launches equal to that phase's;
    emmax_anova's diploid test on a genome of n x 32,768 drawn here,
    held to a single-device call on the same rows. Returns that genome
    and its single-device result for (b)."""
    import torch

    from mixmogam_tpu_torch.models.emmax import emmax_anova
    from mixmogam_tpu_torch.models.gxe import emmax_gxe
    from mixmogam_tpu_torch.models.linear import (anova, kruskal_wallis,
                                                  linear_model)
    from mixmogam_tpu_torch.models.permutation import emmax_perm_test
    from mixmogam_tpu_torch.models.twosnp import emmax_two_snps

    def timed(fn):
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        ts = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - ts
        run = {k.__name__: k.launches for k in kernels}
        for name, cnt in run.items():
            launches[name] += cnt
        return r, wall, run

    def k3_as(label, run, want):
        if run["scan_stats"] != want or any(
                c for k, c in run.items() if k != "scan_stats"):
            raise AssertionError(f"(e) {label}: launches {run}, K3 {want} "
                                 "expected and no other kernel")

    rg, eig, y = main["rg"], main["eig"], main["y"]
    n, M = rg.n, rg.M
    keys = {"linear_model": ("ps", "f_stats", "mask", "betas", "var_perc"),
            "anova": ("ps", "f_stats", "dof1", "dof2"),
            "kruskal_wallis": ("ps", "stats")}
    cls = main.pop("cls11")
    for fn in (linear_model, anova, kruskal_wallis):
        kept = cls[fn.__name__]
        r, wall, run = timed(lambda: fn(rg, y, mesh=mesh))
        print(f"(e) {fn.__name__}(mesh=) on phase 4's resident genome, "
              f"n={n} M={M}: {wall:.3f} s (phase 11's single-device call "
              f"{kept['wall']:.3f} s); launches {run}", flush=True)
        k3_as(fn.__name__, run, kept["k3"])
        _equal_arrays(f"(e) {fn.__name__}(mesh=) vs phase 11's", r,
                      kept["res"], keys[fn.__name__])
    gx = main["gxe12"]          # its trait and environments stay for (b)
    for tier in ("exact", "int8x3"):
        r, wall, run = timed(lambda: emmax_gxe(
            rg, gx["y"], gx["env"], eig_k=eig, precision=tier, mesh=mesh))
        print(f"(e) emmax_gxe(mesh=) {tier}, E=2, n={n} M={M}: {wall:.3f} s "
              f"(phase 12's single-device call {gx[tier]['wall']:.3f} s); "
              f"launches {run}", flush=True)
        k3_as("emmax_gxe", run, 0)
        _equal_arrays(f"(e) emmax_gxe(mesh=) {tier} vs phase 12's", r,
                      gx[tier]["res"], _GXE_KEYS)
    del gx["exact"], gx["int8x3"], r
    perm = main.pop("perm13")
    for tier in ("exact", "int8x3"):
        r, wall, run = timed(lambda: emmax_perm_test(
            rg, y, eig_k=eig, num_perm=128, precision=tier, mesh=mesh))
        print(f"(e) emmax_perm_test(mesh=) {tier}, P=128, n={n} M={M}: "
              f"{wall:.3f} s (phase 13's single-device call "
              f"{perm[tier]['wall']:.3f} s); launches {run}", flush=True)
        k3_as("emmax_perm_test", run, 0)
        _equal_arrays(f"(e) emmax_perm_test(mesh=) {tier} vs phase 13's", r,
                      perm[tier]["res"], ("min_ps", "threshold"))
    # the first 2 of phase 13's focal SNPs (its top hits, in p order): each
    # focal SNP's rows are its own, so they equal phase 13's first 2 rows
    two = main.pop("two13")
    A = len(two["res"]["focal_idx"])
    Ae = min(2, A)
    r, wall, run = timed(lambda: emmax_two_snps(
        rg, y, eig_k=eig, from_result={"ps": main["ps"]}, top_k=Ae,
        mesh=mesh))
    print(f"(e) emmax_two_snps(mesh=), A={Ae} (phase 4's top hits), n={n} "
          f"M={M}: {wall:.3f} s (phase 13's single-device call at A={A} "
          f"{two['wall']:.3f} s); K3 launches {run['scan_stats']} (phase "
          f"13: {two['k3']} at A={A})", flush=True)
    k3_as("emmax_two_snps", run, two["k3"] * Ae // A)
    _equal_arrays(f"(e) emmax_two_snps(mesh=) vs phase 13's first {Ae}", r,
                  {k: two["res"][k][:Ae]
                   for k in ("focal_idx", "cond_ps", "inter_ps")},
                  ("focal_idx", "cond_ps", "inter_ps"))
    del two, r
    torch.cuda.empty_cache()
    # emmax_anova's diploid test on n x 16,384 drawn here, 2 % missing
    ts = time.perf_counter()
    D = _draw_genotypes(n, 16_384, ploidy=2, missing_rate=0.02,
                        seed=args.seed + 180)
    print(f"(e) a diploid genome n={n} M={D.shape[0]}, 2 % missing calls, "
          f"drawn (not the system): {time.perf_counter() - ts:.3f} s",
          flush=True)
    ref, w1, run1 = timed(lambda: emmax_anova(D, y, eig_k=eig))
    r, wall, run = timed(lambda: emmax_anova(D, y, eig_k=eig, mesh=mesh))
    print(f"(e) emmax_anova(mesh=) ploidy 2, n={n} M={D.shape[0]}: "
          f"{wall:.3f} s (the single-device call {w1:.3f} s); launches "
          f"{run}", flush=True)
    k3_as("emmax_anova", run, 0)
    _equal_arrays("(e) emmax_anova(mesh=) vs the single-device call", r, ref,
                  ("ps", "mask", "f_stats", "dof1", "dof2"))
    if r["mask"].sum() < 0.9 * D.shape[0]:
        raise AssertionError("(e) emmax_anova: most SNPs masked")
    return D, ref


#: phase 18 (b)'s (1, 2) mesh: max |dp| of the 'sample' route against one
#: device's emmax_resident. int8x3 and bf16x3 take their TIER_P_DRIFT
#: entries (the card's drift of the tier against exact). The exact tier's
#: entry is 0 (it is the reference); its partial products are float32 GEMMs
#: summed over 'sample', which moves p as float32 sums in other shapes do:
#: LOCO_OFF_TILE_TOL's bound (phase 13 (b): float32 against float64)
def _tp_tol(tier: str) -> float:
    from mixmogam_tpu_torch.ops.scan import TIER_P_DRIFT

    return LOCO_OFF_TILE_TOL if tier == "exact" else TIER_P_DRIFT[tier]


def _tp_gates(tps, z, refs, Gt, n, kernels, launches) -> None:
    """Phase 18 (b)'s 'sample' tensor-parallel scan on a (1, 2) mesh of the
    two gloo ranks, on the rows Gt (one tile): each rank's walls, bytes
    reduced and launches (K3's added to the kernels line); each rank holds
    its (n / 2, n) block of U' / the planes / the parts; the int8x3 plane
    products summed over 'sample' bit-equal to one device's whole-row
    torch._int_mm products; distributed_kinship bit-equal to one device;
    distributed_emmax and distributed_emmax_resident at exact / int8x3 /
    bf16x3 against one device's emmax_resident on the same rows (masks
    equal, p within _tp_tol); emmax(mesh=) the same as distributed_emmax."""
    import numpy as np

    from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                    kinship_resident)

    Mt = Gt.shape[0]
    for r, tp in enumerate(tps):
        print(f"   (b) (1, 2) mesh, rank {r} at {tp['mesh']}: walls "
              f"{tp['walls_s']} s; bytes the rank reduced a call "
              f"{tp['reduced_bytes']}; launches {tp['launches']}; its "
              f"blocks of the rotation {tp['w_blocks']}; int8x3 plane sums "
              f"bit-equal to one device's {tp['plane_sums_equal']}",
              flush=True)
        want = {"exact": [n // 2, n], "int8x3": [3, n // 2, n],
                "bf16x3": [3, n // 2, n]}
        if tp["w_blocks"] != want:
            raise AssertionError(f"(b) rank {r} holds {tp['w_blocks']} of "
                                 f"the rotation, not {want}")
        if tp["plane_sums_equal"] != [True] * 3:
            raise AssertionError("(b) the int8x3 plane sums are not "
                                 "bit-equal to one device's")
        if tp["launches"]["scan_stats"] <= 0:
            raise AssertionError("(b) the 'sample' route never launched "
                                 "scan_stats")
        for k in kernels:
            launches[k.__name__] += tp["launches"][k.__name__]
    ts = time.perf_counter()
    Kt = kinship_resident(ResidentGenome.from_source(Gt))
    same = np.array_equal(z["tp_K"], Kt)
    print(f"   (b) (1, 2) distributed_kinship vs kinship_resident, M={Mt} "
          f"({time.perf_counter() - ts:.3f} s): "
          f"{'bit-equal' if same else 'NOT equal'}", flush=True)
    if not same:
        raise AssertionError("(b) the (1, 2) integer kinship is not "
                             "bit-equal")
    keys = ("ps", "mask", "f_stats", "betas")
    for tier, ref in refs.items():
        ref = {k: ref[k][:Mt] for k in keys}
        for name in ("", "res_"):
            _p18_gate(f"(b) (1, 2) distributed_emmax"
                      f"{'_resident' if name else ''} {tier} vs "
                      f"emmax_resident, n={n} M={Mt} (tol {_tp_tol(tier)})",
                      {k: z[f"tp_{name}{tier}_{k}"] for k in keys}, ref,
                      tol=_tp_tol(tier))
    _p18_gate("(b) (1, 2) emmax(mesh=) int8x3 vs distributed_emmax int8x3",
              {k: z[f"tp_route_{k}"] for k in keys},
              {k: z[f"tp_int8x3_{k}"] for k in keys})


#: phase 18 (b)'s campaign entry points on the (1, 2) mesh: stepwise's
#: forward steps and multi-trait's traits
_P18_TP_STEPS, _P18_TP_TRAITS = 3, 4
#: phase 18's train step: its top_k (the JAX step's default)
_P18_TOP = 8


def _train_step_phase(kernels, launches, main, G, mesh, Kr) -> None:
    """Phase 18 (a)'s train step (ROADMAP item 16e), in the world of one
    over NCCL at full width: distributed_train_step on phase 4's host
    genome and phase 9's T = 50 traits, top_k _P18_TOP; its wall, its
    split (timings_s) and its launches (K1 once, K3 once a trait a tile
    and nothing else, added to the kernels line). Gates: K bit-equal to
    phase 4's integer gram over M (kinship_resident, Kr); against phase 9's
    emmax_multi_trait at the exact tier on the same rows and traits, which
    shares none of the step's null (its eigh of scale_k(K) = K / c, c =
    mean(diag(K)), its explicit REML a trait): each delta within 1e-6
    relative of c times phase 9's (scaling K by 1/c scales delta by 1/c;
    phase 9's REML stops at esp 1e-6, 18 bisections of a 0.2-wide bracket
    in log delta, within 3.8e-7 of the optimum, the step's 32 within
    2.3e-11), top_idx its top F (ties to the lower row), top_f within 1e-4
    relative of those F; and the first and last traits' deltas within
    1e-10 of fit_null_model(method='spectrum'), the step's arithmetic one
    trait at a time (each its own eigh of S(K+I)S: two, not T, to keep the
    clock)."""
    import numpy as np
    import torch

    from mixmogam_tpu_torch.models.multitrait import _default_tile
    from mixmogam_tpu_torch.ops.reml import fit_null_model
    from mixmogam_tpu_torch.parallel import distributed_train_step

    mt = main["mt9"]
    Y = mt["Y"]
    T, n = Y.shape
    M = G.shape[0]
    tiles = -(-M // _default_tile(n, 1 << 28))
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    ts = time.perf_counter()
    r = distributed_train_step(mesh, G, Y, top_k=_P18_TOP)
    torch.cuda.synchronize()
    wall = time.perf_counter() - ts
    run = {k.__name__: k.launches for k in kernels}
    for name, cnt in run.items():
        launches[name] += cnt
    tm = r["timings_s"]
    print(f"(a) distributed_train_step, T={T} n={n} M={M}, top_k "
          f"{_P18_TOP}: {wall:.3f} s; split (s): kinship "
          f"{tm['kinship']:.3f}, eigh + spectrum {tm['eigh_spectrum']:.3f}, "
          f"REML ({T} batched) {tm['reml']:.3f}, nulls + rotation operand "
          f"{tm['nulls']:.3f}, broadcast {tm['broadcast']:.3f}, rotation "
          f"(load + design mask + fp32 GEMM, CUDA events) "
          f"{tm['rotation']:.3f}, K3 (CUDA events) {tm['k3']:.3f}, top-k + "
          f"gather {tm['topk_gather']:.3f}; launches {run}", flush=True)
    want = {k.__name__: 0 for k in kernels}
    want.update(ibs_gram_packed=1, scan_stats=T * tiles)
    if run != want:
        raise AssertionError(f"(a) train step: launches {run}, expected K1 "
                             f"once and K3 {T} x {tiles}")
    if (r["top_f"].shape != (T, _P18_TOP) or not np.isfinite(
            r["top_f"]).all() or not (r["top_f"] > 0).all()):
        raise AssertionError("(a) train step: malformed top_f")
    same = np.array_equal(r["K"], Kr)
    print(f"   K vs phase 4's integer gram / M: "
          f"{'bit-equal' if same else 'NOT equal'}", flush=True)
    if not same:
        raise AssertionError("(a) train step: K is not bit-equal")
    ref = float(np.mean(np.diag(Kr))) * mt["exact"]["deltas"]
    dd = float(np.max(np.abs(r["deltas"] - ref) / ref))
    ts = time.perf_counter()
    one = {t: float(fit_null_model(Y[t], np.ones((n, 1)), K=Kr,
                                   method="spectrum").delta)
           for t in (0, T - 1)}
    d1 = max(abs(r["deltas"][t] - v) / v for t, v in one.items())
    print(f"   deltas vs phase 9's exact multi-trait null x mean(diag(K)): "
          f"max rel {dd:.3e}; traits 0 and {T - 1} vs fit_null_model("
          f"method='spectrum'): max rel {d1:.3e} "
          f"({time.perf_counter() - ts:.3f} s)", flush=True)
    if dd > 1e-6 or d1 > 1e-10:
        raise AssertionError("(a) train step: deltas off the REML")
    f9 = mt["exact"]["f_stats"]
    order = np.stack([np.lexsort((np.arange(M), -f9[t]))[:_P18_TOP]
                      for t in range(T)])
    ref_f = np.take_along_axis(f9, order, axis=1)
    idx_same = np.array_equal(r["top_idx"], order)
    df = float(np.max(np.abs(r["top_f"] - ref_f) / ref_f))
    print(f"   top_idx vs phase 9's exact multi-trait top F: "
          f"{'equal' if idx_same else 'NOT equal'}; top_f max rel {df:.3e}",
          flush=True)
    if not idx_same or df > 1e-4:
        raise AssertionError("(a) train step: the top-k differs from "
                             "phase 9's multi-trait scan")


def _step_gates(tps, z, Kb, M, T, n, kernels, launches) -> None:
    """Phase 18 (b)'s train step and dry run: on each rank the train step's
    split, launches (K1 once a call where the rank holds rows, K3 T x its
    tiles; added to the kernels line) and the dry run's summary line; the
    (2, 1), (1, 2) and world-of-one results bit-equal (top_f, top_idx,
    deltas, K), K bit-equal to one device's integer gram of the M rows
    (Kb)."""
    import numpy as np

    from mixmogam_tpu_torch.models.multitrait import _default_tile
    from mixmogam_tpu_torch.parallel.multihost import host_snp_range

    tile = _default_tile(n, 1 << 28)
    for r, tp in enumerate(tps):
        st = tp["step"]
        print(f"   (b) rank {r}: distributed_train_step walls "
              f"{st['walls_s']} s, split {st['split_s']}, launches "
              f"{st['launches']}; dryrun_rank on the (2, 1) mesh "
              f"{st['dryrun_s']:.3f} s: {st['dryrun']}", flush=True)
        for call, run in st["launches"].items():
            lo, hi = ((0, M) if call.endswith(" one")
                      else host_snp_range(M, 2, r, tile=tile))
            rows_tiles = -(-(hi - lo) // tile)
            if (run["ibs_gram_packed"] != int(hi > lo)
                    or run["scan_stats"] != T * rows_tiles):
                raise AssertionError(f"(b) rank {r}, {call}: launches "
                                     f"{run}")
            for k in kernels:
                launches[k.__name__] += run[k.__name__]
        if not st["dryrun"].startswith("dryrun_multichip OK"):
            raise AssertionError(f"(b) rank {r}: the dry run failed")
    for key in ("top_f", "top_idx", "deltas", "K"):
        ref = z[f"step_one_{key}"]
        for name in ("snp", "tp"):
            if not np.array_equal(z[f"step_{name}_{key}"], ref):
                raise AssertionError(f"(b) train step on the {name} mesh: "
                                     f"{key} differs from a world of one")
    if not np.array_equal(z["step_one_K"], Kb):
        raise AssertionError("(b) train step: K is not the integer gram")
    print("   (b) distributed_train_step on (2, 1), (1, 2) and a world of "
          "one: top_f, top_idx, deltas and K bit-equal; K bit-equal to "
          "kinship_resident", flush=True)


def _tp_campaign_gates(tps, z, tp_sw, loco_ref, Gt, y, eig, Y, kernels,
                       launches) -> None:
    """Phase 18 (b)'s campaign entry points on the (1, 2) 'sample' mesh
    (ROADMAP item 16d-ii), each held to its one-device call: stepwise on
    the rows Gt (the same path, cofactors and selections, its re-fits'
    criteria and delta within rtol 1e-12: rank 0 fits them as one device
    does; each step's min_p within _tp_tol('exact'): its sums meet over
    'sample'); multi-trait exact and 'high' in core and int8x3 over the
    host-only container (masks equal, p within _tp_tol of the tier, 'high'
    within bf16x3's; int8x3's f_stats bit-equal, its plane sums meeting in
    integers); LOCO on the n = 2,048 fixture (masks equal, p within
    _tp_tol('exact'), each chromosome's delta within rtol 1e-12). Each
    rank's walls, bytes reduced and launches a call; K1 / K4 (LOCO's
    kinships on rank 0) and K3 launched, and added to the kernels line."""
    import numpy as np

    from mixmogam_tpu_torch.models.multitrait import emmax_multi_trait
    from mixmogam_tpu_torch.models.resident import ResidentGenome
    from mixmogam_tpu_torch.models.stepwise import emmax_step_wise

    calls = list(tps[0]["campaign_launches"])
    for r, tp in enumerate(tps):
        cl = tp["campaign_launches"]
        print(f"   (b) (1, 2) mesh, rank {r}, campaign entry points: walls "
              f"{ {c: tp['walls_s'][c] for c in calls} } s; bytes the rank "
              f"reduced {[tp['reduced_bytes'][c] for c in calls]}; "
              f"launches {cl}", flush=True)
        need = {"emmax_multi_trait exact": ("scan_stats",),
                "emmax_multi_trait int8x3": ("scan_stats",),
                "emmax_multi_trait high": ("scan_stats",),
                "emmax_loco": ("scan_stats",) + (
                    ("ibs_gram_packed", "ibs_gram_tri_packed") if r == 0
                    else ()),
                "emmax_step_wise": ("scan_stats",) if r == 0 else ()}
        for call, names in need.items():
            for name in names:
                if cl[call][name] <= 0:
                    raise AssertionError(f"(b) rank {r}'s {call} on the "
                                         f"(1, 2) mesh never launched {name}")
        for c in calls:
            for k in kernels:
                launches[k.__name__] += cl[c][k.__name__]
    n, Mt = Gt.shape[1], Gt.shape[0]
    ts = time.perf_counter()
    ref = emmax_step_wise(Gt, y, eig_k=eig, max_steps=_P18_TP_STEPS)
    _same_path(f"(b) (1, 2) emmax_step_wise(mesh=) vs emmax_step_wise, "
               f"{_P18_TP_STEPS} steps, n={n} M={Mt} "
               f"({time.perf_counter() - ts:.3f} s)",
               {**tp_sw, "steps": [dict(s, min_p=np.nan)
                                   for s in tp_sw["steps"]]},
               {**ref, "steps": [dict(s, min_p=np.nan)
                                 for s in ref["steps"]]}, rtol=1e-12)
    dp = max(abs(a["min_p"] - b["min_p"])
             for a, b in zip(tp_sw["steps"], ref["steps"])
             if np.isfinite(b["min_p"]))
    print(f"   (b) (1, 2) emmax_step_wise(mesh=): max |d min_p| {dp:.3e} "
          f"(tol {_tp_tol('exact')})", flush=True)
    if not dp <= _tp_tol("exact"):
        raise AssertionError("(b) the (1, 2) stepwise scans disagree")
    keys = ("ps", "mask", "f_stats", "betas")
    T = Y.shape[0]
    for tier, src in (("exact", Gt),
                      ("int8x3", ResidentGenome.from_source(Gt)),
                      ("high", Gt)):
        ts = time.perf_counter()
        ref = emmax_multi_trait(src, Y, eig_k=eig, precision=tier)
        got = {k: z[f"tp_mt_{tier}_{k}"] for k in keys}
        tol = _tp_tol("bf16x3" if tier == "high" else tier)
        _p18_gate(f"(b) (1, 2) emmax_multi_trait(mesh=) {tier} vs "
                  f"emmax_multi_trait, T={T} n={n} M={Mt} "
                  f"({time.perf_counter() - ts:.3f} s; tol {tol})", got,
                  ref, tol=tol)
        if tier == "int8x3" and not np.array_equal(got["f_stats"],
                                                   ref["f_stats"]):
            raise AssertionError("(b) the (1, 2) int8x3 multi-trait f_stats "
                                 "are not bit-equal to one device's")
    _p18_gate(f"(b) (1, 2) emmax_loco(mesh=) vs emmax_loco, the n=2,048 "
              f"fixture (tol {_tp_tol('exact')})",
              {k: z[f"tp_loco_{k}"] for k in keys}, loco_ref,
              tol=_tp_tol("exact"))
    for r, tp in enumerate(tps):
        for c, v in loco_ref["loco"].items():
            got = tp["loco_deltas"][str(c)]
            if abs(got - v["delta"]) > 1e-12 * abs(v["delta"]):
                raise AssertionError(f"(b) rank {r}'s (1, 2) LOCO delta of "
                                     f"chromosome {c}: {got} vs "
                                     f"{v['delta']}")


#: phase 18 (b)'s remaining entry points on the (1, 2) mesh (item 16d-iii):
#: their rows (the first 4,096 of the mesh's 16,384: at 8,192, on an
#: NVIDIA H100 80GB HBM3 at 700 W, they added 34 s to phase 18 and the
#: script took 1,100 s, so cut to keep its clock), GxE's exact rescore at
#: int8x3 and two-SNP's focal SNPs
_P18_TP_REST_ROWS, _P18_TP_GXE_TOP, _P18_TP_FOCAL = 4_096, 64, 2


def _tp_rest_gates(tps, z, Gs, Ds, y, gx, eig, focal, kernels,
                   launches) -> None:
    """Phase 18 (b)'s remaining entry points on the (1, 2) 'sample' mesh
    (ROADMAP item 16d-iii), on the rows Gs (Ds: the diploid test's), each
    held to its one-device call on the card on the same rows, its wall
    beside that call's: emmax_gxe (E = 2) at exact (masks equal, p within
    _tp_tol('exact')) and at int8x3 with an exact rescore of its top
    _P18_TP_GXE_TOP interactions (the same rows rescored; off them every
    statistic bit-equal, its int8 plane sums meeting in integers; the
    rescored rows within _tp_tol('exact'); p within GXE_P_DRIFT['int8x3'])
    and at 'high' (masks equal, p within _tp_tol('bf16x3'));
    emmax_perm_test (P = 128; min_ps and the threshold within
    _tp_tol('exact'); at 'high' the JAX package's refusal on both ranks,
    in core and over a container); emmax_two_snps (A = 2; p within
    _tp_tol('exact'), the same p = 1 rows; K3 A x tiles a rank); emmax_anova
    binary (through emmax(mesh=): masks equal, p within _tp_tol('exact'), K3
    launched) and
    diploid (masks, dof1 and dof2 equal, p within _tp_tol('exact'));
    linear_model (K3 a tile on every rank), anova and kruskal_wallis
    bit-equal (the 'sample' axis replicates them). Each rank's walls,
    bytes reduced and launches printed, and added to the kernels line."""
    import numpy as np
    import torch

    from mixmogam_tpu_torch.models.emmax import emmax_anova
    from mixmogam_tpu_torch.models.gxe import emmax_gxe
    from mixmogam_tpu_torch.models.linear import (anova, kruskal_wallis,
                                                  linear_model)
    from mixmogam_tpu_torch.models.permutation import emmax_perm_test
    from mixmogam_tpu_torch.models.twosnp import emmax_two_snps
    from mixmogam_tpu_torch.ops.scan import GXE_P_DRIFT

    n, Ms = Gs.shape[1], Gs.shape[0]
    A = len(focal)
    tiles = {"emmax_two_snps": -(-Ms // 8_192), "linear_model":
             -(-Ms // 8_192)}
    for r, tp in enumerate(tps):
        rl = tp["rest_launches"]
        print(f"   (b) (1, 2) mesh, rank {r}, the remaining entry points "
              f"on {Ms} rows: walls { {c: tp['walls_s'][c] for c in rl} } "
              f"s; bytes the rank reduced "
              f"{ {c: tp['reduced_bytes'][c] for c in rl} }; launches {rl}",
              flush=True)
        for call, run in rl.items():
            k3 = run["scan_stats"]
            want = (A * tiles[call] if call == "emmax_two_snps" else
                    tiles[call] if call == "linear_model" else None)
            if any(c for k, c in run.items() if k != "scan_stats"):
                raise AssertionError(f"(b) rank {r}'s {call}: launches "
                                     f"{run}, no kernel but K3 expected")
            if call == "emmax_anova binary":
                if k3 <= 0:
                    raise AssertionError(f"(b) rank {r}'s {call} never "
                                         "launched scan_stats")
            elif k3 != (want or 0):
                raise AssertionError(f"(b) rank {r}'s {call}: K3 {k3}, "
                                     f"{want or 0} expected")
            for k in kernels:
                launches[k.__name__] += run[k.__name__]
    walls = tps[0]["walls_s"]

    def one(label, fn):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        ref = fn()
        torch.cuda.synchronize()
        print(f"   (b) (1, 2) {label}: mesh rank 0 {walls[label]:.3f} s, one "
              f"device {time.perf_counter() - ts:.3f} s", flush=True)
        return ref

    tol = _tp_tol("exact")
    keys = _GXE_KEYS + ("f_inter",)
    for tier, top in (("exact", 0), ("int8x3", _P18_TP_GXE_TOP),
                      ("high", 0)):
        ref = one(f"emmax_gxe {tier}", lambda: emmax_gxe(
            Gs, gx["y"], gx["env"], eig_k=eig, precision=tier,
            rescore_top=top))
        got = {k: z[f"tpr_gxe_{tier}_{k}"] for k in keys}
        if tier != "int8x3":
            # 'high' is held as bf16x3 is on this axis: its products'
            # float32 sums meet over 'sample'
            tt = tol if tier == "exact" else _tp_tol("bf16x3")
            _equal_arrays(f"(b) (1, 2) emmax_gxe(mesh=) {tier} vs "
                          f"emmax_gxe, E=2 n={n} M={Ms} (tol {tt})", got,
                          ref, _GXE_KEYS, tol=tt)
            continue
        off = np.ones_like(ref["mask"])
        for e, idx in enumerate(ref["rescored_idx"]):
            if not np.array_equal(np.sort(z[f"tpr_gxe_{tier}_rescored{e}"]),
                                  np.sort(idx)):
                raise AssertionError("(b) the (1, 2) int8x3 GxE rescored "
                                     "other rows than one device")
            off[e, idx] = False
        _equal_arrays(f"(b) (1, 2) emmax_gxe(mesh=) int8x3, off its "
                      f"{int((~off).sum())} rescored rows, vs emmax_gxe",
                      {k: got[k][off] for k in keys},
                      {k: ref[k][off] for k in keys}, keys)
        _equal_arrays(f"(b) (1, 2) emmax_gxe(mesh=) int8x3, its rescored "
                      f"rows (exact tier; tol {tol})",
                      {k: got[k][~off] for k in _GXE_KEYS},
                      {k: ref[k][~off] for k in _GXE_KEYS}, _GXE_KEYS,
                      tol=tol)
        _equal_arrays(f"(b) (1, 2) emmax_gxe(mesh=) int8x3, all rows (tol "
                      f"GXE_P_DRIFT {GXE_P_DRIFT['int8x3']})", got, ref,
                      _GXE_KEYS, tol=GXE_P_DRIFT["int8x3"])
    ref = one("emmax_perm_test", lambda: emmax_perm_test(
        Gs, y, eig_k=eig, num_perm=128))
    _equal_arrays(f"(b) (1, 2) emmax_perm_test(mesh=) vs emmax_perm_test, "
                  f"P=128 (tol {tol})",
                  {k: z[f"tpr_perm_{k}"] for k in ("min_ps", "threshold")},
                  ref, ("min_ps", "threshold"), tol=tol)
    why = {"in core": "tiered permutation sweeps need a ResidentGenome",
           "container": "resident permutation shards 'snp' only"}
    for r, tp in enumerate(tps):
        for src, msg in why.items():
            if msg not in tp["perm_high"][src]:
                raise AssertionError(f"(b) rank {r}'s (1, 2) emmax_perm_test "
                                     f"at 'high' {src}: "
                                     f"{tp['perm_high'][src]!r}, not the "
                                     f"JAX package's refusal")
    print(f"   (b) (1, 2) emmax_perm_test(mesh=) at 'high' refused on both "
          f"ranks, in core and over a container: "
          f"{tps[0]['perm_high']}", flush=True)
    ref = one("emmax_two_snps", lambda: emmax_two_snps(
        Gs, y, eig_k=eig, focal_idx=focal))
    got = {k: z[f"tpr_two_{k}"] for k in ("cond_ps", "inter_ps")}
    _equal_arrays(f"(b) (1, 2) emmax_two_snps(mesh=) vs emmax_two_snps, "
                  f"A={A} (tol {tol})", got, ref, ("cond_ps", "inter_ps"),
                  tol=tol)
    for k in got:
        if not np.array_equal(got[k] == 1.0, ref[k] == 1.0):
            raise AssertionError(f"(b) the (1, 2) two-SNP {k} mask differs")
    for name, src, ks in (("binary", Gs, ("ps", "mask", "f_stats")),
                          ("diploid", Ds, ("ps", "mask", "f_stats", "dof1",
                                           "dof2"))):
        ref = one(f"emmax_anova {name}", lambda: emmax_anova(src, y,
                                                             eig_k=eig))
        got = {k: z[f"tpr_ea_{name}_{k}"] for k in ks}
        _equal_arrays(f"(b) (1, 2) emmax_anova(mesh=) {name} vs emmax_anova "
                      f"(tol {tol}, masks and dofs equal)", got, ref,
                      ("ps", "mask") + ks[3:], tol=tol)
    for name, fn, ks in (
            ("lm", linear_model, ("ps", "f_stats", "mask", "betas",
                                  "var_perc")),
            ("anova", anova, ("ps", "f_stats", "dof1", "dof2")),
            ("kw", kruskal_wallis, ("ps", "stats"))):
        ref = one(fn.__name__, lambda: fn(Gs, y))
        _equal_arrays(f"(b) (1, 2) {fn.__name__}(mesh=) vs {fn.__name__}, "
                      "replicated", {k: z[f"tpr_{name}_{k}"] for k in ks},
                      ref, ks)


def _parallel_phase(args, kernels, launches, main, G, tmp) -> None:
    """Phase 18: parallel/'s data-parallel core on the card. (a) A world of
    one over NCCL (a file store) at full width: distributed_kinship against
    kinship_resident (bit-equal), distributed_emmax at exact / int8x3 /
    bf16x3 against emmax_resident, K1 / K3 / K2 / K5 launched, then the
    train step (_train_step_phase); (c) in that group, the sharded resident
    scan and emmax_loco(mesh=) (_resident_mesh_phase); (b) two gloo ranks
    sharing the card, subprocesses, on the first 32,768 rows, held to the
    single-device calls by the same gates, then as a (1, 2) 'sample' mesh
    (_tp_gates, then _step_gates, _tp_campaign_gates and _tp_rest_gates
    for the other entry points)."""
    import pickle

    import numpy as np
    import torch
    import torch.distributed as dist

    from mixmogam_tpu_torch.models.emma import emma
    from mixmogam_tpu_torch.models.gxe import emmax_gxe
    from mixmogam_tpu_torch.models.linear import (anova, kruskal_wallis,
                                                  linear_model)
    from mixmogam_tpu_torch.models.loco import emmax_loco
    from mixmogam_tpu_torch.models.multitrait import emmax_multi_trait
    from mixmogam_tpu_torch.models.permutation import emmax_perm_test
    from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                    emmax_resident,
                                                    kinship_resident)
    from mixmogam_tpu_torch.models.stepwise import emmax_step_wise
    from mixmogam_tpu_torch.models.twosnp import emmax_two_snps
    from mixmogam_tpu_torch.parallel import (distributed_emmax,
                                             distributed_kinship, make_mesh)

    rg, (phi, U), y = main["rg"], main["eig"], main["y"]
    n, M = rg.n, rg.M

    def counts():
        return {k.__name__: k.launches for k in kernels}

    # (a) a world of one over NCCL
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", init_method="file://" + os.path.join(tmp, "p18_store"),
        rank=0, world_size=1)
    try:
        mesh = make_mesh()
        print(f"(a) make_mesh(): shape {mesh.shape}, backend "
              f"{mesh.backend}, rank {mesh.rank} of {mesh.world}, device "
              f"{mesh.device}", flush=True)
        if mesh.backend != "nccl" or mesh.device.type != "cuda":
            raise AssertionError("(a) not an NCCL mesh on the card")
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        ts = time.perf_counter()
        Kd = distributed_kinship(G, mesh)
        walls = [f"distributed_kinship {time.perf_counter() - ts:.3f}"]
        dists = {}
        for tier, rb in _P18_TIERS.items():
            ts = time.perf_counter()
            dists[tier] = distributed_emmax(G, y, eig_k=(phi, U), mesh=mesh,
                                            rotate_in_bf16=rb)
            walls.append(f"distributed_emmax {tier} "
                         f"{time.perf_counter() - ts:.3f}")
        run = counts()
        print(f"(a) n={n} M={M}: {'; '.join(walls)} s; launches {run}",
              flush=True)
        for name in ("ibs_gram_packed", "scan_stats",
                     "rotate_scan_int8_packed", "rotate_scan_bf16_packed"):
            if run[name] <= 0:
                raise AssertionError(f"(a) the distributed path never "
                                     f"launched {name}")
        for name, cnt in run.items():
            launches[name] += cnt
        # the single-device calls, after the counts were read
        ts = time.perf_counter()
        Kr = kinship_resident(rg)
        print(f"   distributed_kinship vs kinship_resident "
              f"({time.perf_counter() - ts:.3f} s): max|dK| "
              f"{float(np.abs(Kd - Kr).max()):.3e}, "
              f"{'bit-equal' if np.array_equal(Kd, Kr) else 'NOT equal'}",
              flush=True)
        if not np.array_equal(Kd, Kr):
            raise AssertionError("(a) the integer kinship is not bit-equal")
        del Kd
        for tier in _P18_TIERS:
            ts = time.perf_counter()
            ref = emmax_resident(rg, y, eig_k=(phi, U), precision=tier)
            _p18_gate(f"distributed_emmax {tier} vs emmax_resident "
                      f"({time.perf_counter() - ts:.3f} s)", dists[tier], ref)
        del dists, ref
        _train_step_phase(kernels, launches, main, G, mesh, Kr)
        torch.cuda.empty_cache()
        rgh = _resident_mesh_phase(kernels, launches, main, G, mesh, Kr)
        del Kr
        _campaign_mesh_phase(kernels, launches, main, G, mesh, rgh)
        del rgh
        D, ea_ref = _remaining_mesh_phase(args, kernels, launches, main,
                                          mesh)
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    # (b) two gloo ranks sharing the card, on the first 32,768 rows; LOCO
    # on n = 2,048 x 8,192 rows, its chromosomes on rank 0, across both
    # ranks and on rank 1 (a 2,048-row tile: [0, 4,096) on rank 0), bounds
    # on the tile (bit-equal) and off it (chl_off: [3,000, 5,500) across
    # the ranks, tiled from 4,096 on rank 1, so the exact tier's GEMMs take
    # other shapes than one device's: held to LOCO_OFF_TILE_TOL)
    Mb = min(32_768, M)
    nl, Ml = min(2_048, n), min(8_192, M)
    chl = np.repeat([1, 2, 3], [Ml // 4, Ml // 2, Ml - 3 * (Ml // 4)])
    chl_off = np.repeat([1, 2, 3], [3_000, 2_500, Ml - 5_500])
    d = os.path.join(tmp, "p18")
    os.makedirs(d, exist_ok=True)
    ts = time.perf_counter()
    np.save(os.path.join(d, "G.npy"), G[:Mb])
    np.save(os.path.join(d, "y.npy"), y)
    np.save(os.path.join(d, "phi.npy"), phi.double().cpu().numpy())
    np.save(os.path.join(d, "U.npy"), U.double().cpu().numpy())
    Gl = np.ascontiguousarray(G[:Ml, :nl])
    np.save(os.path.join(d, "Gl.npy"), Gl)
    np.save(os.path.join(d, "yl.npy"), y[:nl])
    np.save(os.path.join(d, "chl.npy"), chl)
    np.save(os.path.join(d, "chl_off.npy"), chl_off)
    Y4 = main.pop("mt9")["Y"][:4]
    np.save(os.path.join(d, "Y4.npy"), Y4)
    gx = main["gxe12"]
    np.save(os.path.join(d, "y12.npy"), gx["y"])
    np.save(os.path.join(d, "env.npy"), gx["env"])
    focal = np.argsort(main["ps"][:Mb], kind="stable")[:4]
    np.save(os.path.join(d, "focal.npy"), focal)
    np.save(os.path.join(d, "D.npy"), D)
    Ms = min(_P18_TP_REST_ROWS, Mb)
    focal_tp = np.argsort(main["ps"][:Ms], kind="stable")[:_P18_TP_FOCAL]
    np.save(os.path.join(d, "focal_tp.npy"), focal_tp)
    print(f"(b) the ranks' inputs written (not the system): "
          f"{time.perf_counter() - ts:.3f} s", flush=True)
    Mt = min(16_384, Mb)
    src = _P18_RANK.format(repo=os.path.dirname(os.path.abspath(__file__)),
                           store=os.path.join(d, "store"), d=d,
                           rb=_P18_TIERS, gxe_keys=_GXE_KEYS, mt=Mt,
                           sw_steps=_P18_TP_STEPS, mt_traits=_P18_TP_TRAITS,
                           ms=Ms, gxe_top=_P18_TP_GXE_TOP, top=_P18_TOP)
    ts = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", src, str(r), "2"],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    wall = time.perf_counter() - ts
    for r, (p, o) in enumerate(zip(procs, outs)):
        print(f"   rank {r} (rc {p.returncode}): {o.strip()[-2000:]}",
              flush=True)
    if any(p.returncode != 0 for p in procs):
        raise AssertionError("(b) a gloo rank failed")
    print(f"(b) two gloo ranks on one card, n={n} M={Mb}: {wall:.3f} s "
          f"from spawn to exit (two interpreters' start-up included)",
          flush=True)
    tps = [json.loads(next(ln for ln in reversed(o.splitlines())
                           if ln.startswith('{"rank"')))["tp"] for o in outs]
    z = np.load(os.path.join(d, "out.npz"))
    rgb = ResidentGenome.from_source(G[:Mb])
    Kb = kinship_resident(rgb)
    print(f"   distributed_kinship vs kinship_resident: "
          f"{'bit-equal' if np.array_equal(z['K'], Kb) else 'NOT equal'}",
          flush=True)
    if not np.array_equal(z["K"], Kb):
        raise AssertionError("(b) the integer kinship is not bit-equal")
    refs = {}
    for tier in _P18_TIERS:
        ref = refs[tier] = emmax_resident(rgb, y, eig_k=(phi, U),
                                          precision=tier)
        for name in ("", "res_"):
            _p18_gate(f"(b) distributed_emmax{'_resident' if name else ''} "
                      f"{tier} vs emmax_resident",
                      {k: z[f"{name}{tier}_{k}"]
                       for k in ("ps", "mask", "f_stats", "betas")}, ref)
    _tp_gates(tps, z, refs, G[:Mt], n, kernels, launches)
    _step_gates(tps, z, Kb, Mb, _P18_TP_TRAITS, n, kernels, launches)
    ts = time.perf_counter()
    loco_ref = emmax_loco(ResidentGenome.from_source(Gl, tile=2_048),
                          y[:nl], chromosomes=chl)
    _p18_gate(f"(b) emmax_loco(mesh=) vs emmax_loco, n={nl} M={Ml} "
              f"({time.perf_counter() - ts:.3f} s)",
              {k: z[f"loco_{k}"] for k in ("ps", "mask", "f_stats",
                                           "betas")}, loco_ref)
    with open(os.path.join(d, "sw.pkl"), "rb") as f:
        sws = pickle.load(f)
    _tp_campaign_gates(tps, z, sws["tp_sw"], loco_ref, G[:Mt], y, (phi, U),
                       Y4[:_P18_TP_TRAITS], kernels, launches)
    _tp_rest_gates(tps, z, G[:Ms], D[:Ms], y, main["gxe12"], (phi, U),
                   focal_tp, kernels, launches)
    ts = time.perf_counter()
    ref = emmax_loco(ResidentGenome.from_source(Gl, tile=2_048), y[:nl],
                     chromosomes=chl_off)
    _p18_gate(f"(b) emmax_loco(mesh=) vs emmax_loco, bounds off the tile "
              f"{np.flatnonzero(np.diff(chl_off)) + 1} "
              f"({time.perf_counter() - ts:.3f} s)",
              {k: z[f"loco_off_{k}"] for k in ("ps", "mask", "f_stats",
                                               "betas")}, ref,
              tol=LOCO_OFF_TILE_TOL)
    # the campaign scans against their single-device calls on the same rows
    ts = time.perf_counter()
    ref = emmax_step_wise(rgb, y, eig_k=(phi, U), max_steps=3)
    _same_path(f"(b) emmax_step_wise(mesh=) vs emmax_step_wise "
               f"({time.perf_counter() - ts:.3f} s)", sws["sw"], ref,
               rtol=1e-12)
    for name, src, tier in (("mt_exact", rgb, "exact"),
                            ("mt_int8x3", rgb, "int8x3"),
                            ("mt_res_exact", rgb, "exact"),
                            ("mt_high", rgb, "high")):
        ts = time.perf_counter()
        ref = emmax_multi_trait(src, Y4, eig_k=(phi, U), precision=tier)
        _p18_gate(f"(b) emmax_multi_trait(mesh=) {name[3:]} vs "
                  f"emmax_multi_trait, T=4 ({time.perf_counter() - ts:.3f} "
                  f"s)", {k: z[f"{name}_{k}"] for k in ("ps", "mask",
                                                        "f_stats", "betas")},
                  ref)
    ts = time.perf_counter()
    ref = emma(G[:Mb], y, eig_k=(phi, U))
    _p18_gate(f"(b) emma(mesh=) vs emma, n={n} M={Mb} "
              f"({time.perf_counter() - ts:.3f} s)",
              {k: z[f"emma_{k}"] for k in ("ps", "mask", "f_stats",
                                           "betas")}, ref)
    # the remaining scans against their single-device calls on the rows
    for name, fn, keys in (
            ("lm", linear_model, ("ps", "f_stats", "mask", "betas")),
            ("anova", anova, ("ps", "f_stats", "dof1", "dof2")),
            ("kw", kruskal_wallis, ("ps", "stats"))):
        ts = time.perf_counter()
        ref = fn(rgb, y)
        _equal_arrays(f"(b) {fn.__name__}(mesh=) vs {fn.__name__} "
                      f"({time.perf_counter() - ts:.3f} s)",
                      {k: z[f"{name}_{k}"] for k in keys}, ref, keys,
                      tol=1e-12)
    gx = main.pop("gxe12")
    for tier in ("exact", "int8x3", "high"):
        ts = time.perf_counter()
        ref = emmax_gxe(rgb, gx["y"], gx["env"], eig_k=(phi, U),
                        precision=tier)
        _equal_arrays(f"(b) emmax_gxe(mesh=) {tier} vs emmax_gxe "
                      f"({time.perf_counter() - ts:.3f} s)",
                      {k: z[f"gxe_{tier}_{k}"] for k in _GXE_KEYS}, ref,
                      _GXE_KEYS, tol=1e-12)
        ts = time.perf_counter()
        ref = emmax_perm_test(rgb, y, eig_k=(phi, U), num_perm=128,
                              precision=tier)
        _equal_arrays(f"(b) emmax_perm_test(mesh=) {tier} vs "
                      f"emmax_perm_test ({time.perf_counter() - ts:.3f} s)",
                      {k: z[f"perm_{tier}_{k}"] for k in ("min_ps",
                                                         "threshold")},
                      ref, ("min_ps", "threshold"), tol=1e-12)
    ts = time.perf_counter()
    ref = emmax_two_snps(G[:Mb], y, eig_k=(phi, U), focal_idx=focal)
    _equal_arrays(f"(b) emmax_two_snps(mesh=) vs emmax_two_snps, A=4 "
                  f"({time.perf_counter() - ts:.3f} s)",
                  {k: z[f"two_{k}"] for k in ("cond_ps", "inter_ps")}, ref,
                  ("cond_ps", "inter_ps"), tol=1e-12)
    keys = ("ps", "mask", "f_stats", "dof1", "dof2")
    _equal_arrays("(b) emmax_anova(mesh=) vs (e)'s single-device call",
                  {k: z[f"ea_{k}"] for k in keys}, ea_ref, keys, tol=1e-12)
    del rgb, z, D
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--samples", type=int, default=10_240)
    ap.add_argument("--snps", type=int, default=262_144)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--facade-snps", type=int, default=8_192,
                    help="SNP rows of phases 6, 7 and 9's facade (LOCO and "
                         "the facade): the host data layer decodes, gathers "
                         "and filters the int8 matrix with numpy, seconds "
                         "for each 8,192 rows; LOCO's wall hardly depends "
                         "on it")
    args = ap.parse_args(argv)

    # ---- 1. device check ------------------------------------------------
    t0 = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    import numpy as np
    # the p-values' scipy.stats takes seconds to import: load it here, not
    # inside the first timed emmax call
    import scipy.stats  # noqa: F401

    from mixmogam_tpu_torch import api
    from mixmogam_tpu_torch.data.genotype import GenotypeData
    from mixmogam_tpu_torch.data.phenotype import PhenotypeData
    from mixmogam_tpu_torch.data.plink import write_plink
    from mixmogam_tpu_torch.data.simulate import (simulate_genotypes,
                                                  simulate_phenotype)
    from mixmogam_tpu_torch.models.emmax import emmax
    from mixmogam_tpu_torch.models.loco import emmax_loco, loco_kinships
    from mixmogam_tpu_torch.models.multitrait import (_trait_nulls,
                                                      emmax_multi_trait,
                                                      rotate_tile,
                                                      shared_rotation)
    from mixmogam_tpu_torch.models.stepwise import emmax_step_wise
    from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                    emmax_resident,
                                                    design_mask_packed,
                                                    emmax_scan_packed,
                                                    kinship_resident,
                                                    row_means_packed,
                                                    scale_k, subdivide_tile)
    from mixmogam_tpu_torch.ops import _build
    from mixmogam_tpu_torch.ops.eigen import eigen_k
    from mixmogam_tpu_torch.ops.hopper_kinship import (
        ibs_gram_packed, ibs_gram_packed_plain, ibs_gram_tri_packed,
        ibs_gram_tri_packed_plain)
    from mixmogam_tpu_torch.ops.hopper_scan import (
        rotate_scan_bf16_packed, rotate_scan_bf16_packed_plain,
        k3_operand, prepare_k3_operand, rotate_scan_int8_packed,
        rotate_scan_int8_packed_plain, scan_operand, scan_stats,
        scan_stats_plain)
    from mixmogam_tpu_torch.ops.pack2 import unpack_2bit_device
    from mixmogam_tpu_torch.ops.reml import NullModel, fit_null_model
    from mixmogam_tpu_torch.ops.scan import (TIER_P_DRIFT, build_rotated_null,
                                             design_basis, outside_design,
                                             project_design)
    from mixmogam_tpu_torch.utils.caching import cached_kinship

    _check_no_jax()
    dev = torch.device("cuda")
    _phase("1 device check", t0)

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    from concurrent.futures import ThreadPoolExecutor

    from mixmogam_tpu_torch import native

    def build_host():
        ts = time.perf_counter()
        native.get_lib()
        return time.perf_counter() - ts

    with ThreadPoolExecutor(max_workers=1) as ex:
        host = ex.submit(build_host)     # g++ beside the five nvcc
        built = _build.build_all(("ibs_gram", "ibs_gram_tri",
                                  "rotate_scan_int8", "rotate_scan_bf16",
                                  "scan_stats"))
        host_s = host.result()
    if native.available():
        print(f"built the host library (csrc/host/*.cpp, g++) in "
              f"{host_s:.3f} s", flush=True)
    else:
        print(f"the host library did not build ({host_s:.3f} s):\n"
              f"{native.BUILD_LOG}", file=sys.stderr, flush=True)
    for name, sec in built.items():
        print(f"built {name}.cu in {sec:.3f} s", flush=True)
        for line in _build.BUILD_LOG.get(name, "").splitlines():
            if ("registers" in line or "spill" in line or "error" in line
                    or "Performance Loss" in line):
                print(f"  ptxas {name}: {line.strip()}", file=sys.stderr)
    _phase("2 build", t0)

    # ---- 3. kernels vs plain versions on the card -------------------------
    t0 = time.perf_counter()
    # the kernels see the main path's widths: all n samples, and one
    # resident tile of SNP rows
    n, M = args.samples, args.snps
    rows = min(16_384, M)
    report = {}
    for ploidy in (1, 2):
        Gc = _draw_genotypes(n, rows, ploidy=ploidy,
                             seed=args.seed + 10 + ploidy)
        rgc = ResidentGenome.from_source(Gc, device=dev, ploidy=ploidy)
        S = ibs_gram_packed(rgc.packed, n, rows, ploidy)
        S_ref = ibs_gram_packed_plain(rgc.packed, n, rows, ploidy)
        if not torch.equal(S, S_ref):
            raise AssertionError(
                f"K1 ploidy {ploidy}: not bit-equal ("
                f"{int((S != S_ref).sum())} entries differ)")
        ms = _cuda_ms(lambda: ibs_gram_packed(rgc.packed, n, rows, ploidy))
        pms = _cuda_ms(lambda: ibs_gram_packed_plain(rgc.packed, n, rows,
                                                     ploidy))
        print(f"K1 ibs_gram_packed ploidy {ploidy} n={n} rows={rows}: "
              f"bit-equal, kernel {ms:.3f} ms, plain {pms:.3f} ms",
              flush=True)
        bnd = _bound(_gram_ops(n, rows, ploidy), "int8", rgc.packed, S)
        print(f"   bound {bnd['bound_ms']:.3f} ms by {bnd['bound_by']}",
              flush=True)
        if ploidy == 1:
            Zt = torch.as_tensor(Gc, device=dev).T.contiguous()
            lms = _int_mm_ms(Zt, "K1")
            print(f"   torch._int_mm(Z^T, Z), full square, n={n} "
                  f"rows={rows}: {lms} ms", flush=True)
            report["ibs_gram_packed"] = dict(max_abs_err=0.0, ms=ms,
                                             plain_ms=pms, library_ms=lms,
                                             **bnd)
        # K4 over a row range that starts and ends inside a tile; it must
        # equal its plain version and K1 over the same rows
        s3, e3 = rows // 5 + 3, rows - 123
        S4 = ibs_gram_tri_packed(rgc.packed, n, s3, e3, ploidy)
        S4_ref = ibs_gram_tri_packed_plain(rgc.packed, n, s3, e3, ploidy)
        sub = rgc.slice_rows(s3, e3)
        S1_sub = ibs_gram_packed(sub.packed, n, sub.M, ploidy)
        if not (torch.equal(S4, S4_ref) and torch.equal(S4, S1_sub)):
            raise AssertionError(
                f"K4 ploidy {ploidy} rows [{s3}, {e3}): not bit-equal ("
                f"{int((S4 != S4_ref).sum())} entries differ from the "
                f"plain version, {int((S4 != S1_sub).sum())} from K1)")
        ms = _cuda_ms(lambda: ibs_gram_tri_packed(rgc.packed, n, s3, e3,
                                                  ploidy))
        pms = _cuda_ms(lambda: ibs_gram_tri_packed_plain(rgc.packed, n, s3,
                                                         e3, ploidy))
        print(f"K4 ibs_gram_tri_packed ploidy {ploidy} n={n} rows "
              f"[{s3}, {e3}): bit-equal (and to K1 on those rows), kernel "
              f"{ms:.3f} ms, plain {pms:.3f} ms", flush=True)
        bnd = _bound(_gram_ops(n, e3 - s3, ploidy), "int8",
                     rgc.packed[s3:e3], S4)
        print(f"   bound {bnd['bound_ms']:.3f} ms by {bnd['bound_by']}",
              flush=True)
        if ploidy == 1:
            lms = _int_mm_ms(Zt[:, s3:e3].contiguous(), "K4")
            print(f"   torch._int_mm(Z^T, Z), full square, rows "
                  f"[{s3}, {e3}): {lms} ms", flush=True)
            report["ibs_gram_tri_packed"] = dict(max_abs_err=0.0, ms=ms,
                                                 plain_ms=pms,
                                                 library_ms=lms, **bnd)
            G1, rg1 = Gc, rgc
            del Zt
        del sub, S1_sub, S4, S4_ref
    # K1 and K4 again where the row pitch is no multiple of 4 bytes (the
    # kernels' byte loads), n ends inside a tile and the rows inside a stage
    nr, mr = 2_042, 3_001
    for ploidy in (1, 2):
        Gr = _draw_genotypes(nr, mr, ploidy=ploidy,
                             seed=args.seed + 30 + ploidy)
        rgr = ResidentGenome.from_source(Gr, ploidy=ploidy)
        sr, er = mr // 7 + 1, mr - 70
        Sr = ibs_gram_packed(rgr.packed, nr, mr, ploidy)
        S4r = ibs_gram_tri_packed(rgr.packed, nr, sr, er, ploidy)
        if not (torch.equal(Sr, ibs_gram_packed_plain(rgr.packed, nr, mr,
                                                      ploidy))
                and torch.equal(S4r, ibs_gram_tri_packed_plain(
                    rgr.packed, nr, sr, er, ploidy))
                and torch.equal(S4r, ibs_gram_packed(
                    rgr.packed[sr:er], nr, er - sr, ploidy))
                and torch.equal(Sr, ibs_gram_tri_packed(rgr.packed, nr, 0,
                                                        mr, ploidy))):
            raise AssertionError(f"K1/K4 ploidy {ploidy} n={nr} rows={mr}: "
                                 "not bit-equal")
        ms = _cuda_ms(lambda: ibs_gram_packed(rgr.packed, nr, mr, ploidy))
        msw = _cuda_ms(lambda: ibs_gram_packed(
            rgr.packed[:, :508].contiguous(), 2_032, mr, ploidy))
        print(f"K1/K4 ploidy {ploidy} n={nr} (pitch {rgr.packed.shape[1]}) "
              f"rows={mr}, K4 rows [{sr}, {er}): bit-equal to plain and to "
              f"each other; K1 {ms:.3f} ms with byte loads, {msw:.3f} ms "
              f"with 32-bit loads at n=2032", flush=True)
    del Gr, rgr, Sr, S4r
    # a rotated null at the main path's width: random orthonormal U
    g = torch.Generator(device=dev).manual_seed(args.seed)
    U, _ = torch.linalg.qr(torch.randn(n, n, generator=g, device=dev))
    phi = torch.sort(torch.rand(n, generator=g, device=dev) * 2.0,
                     descending=True).values
    yv = torch.randn(n, generator=g, device=dev)
    one = torch.ones((), device=dev)
    null = NullModel(phi=phi, U=U, delta=one, log_delta=0 * one, ll=one,
                     sigma_g2=one, sigma_e2=one, pseudo_heritability=one / 2,
                     y=yv, X0=torch.ones((n, 1), device=dev))
    # K2 and K5 take all rows in one launch of 256-row blocks, on the main
    # path several to an SM: the least launch of that kind, one block an SM
    srows = min(args.snps, 256 * torch.cuda.get_device_properties(
        dev).multi_processor_count)
    Gs = _draw_genotypes(n, srows, seed=args.seed + 40)
    packed_s = ResidentGenome.from_source(Gs, tile=256,
                                          device=dev).packed[:srows]
    # the unpacked rows for the library's products: the share of cuBLAS's
    # rate that the fused kernels reach (the port never calls these)
    G8 = torch.as_tensor(Gs, device=dev)
    Gb = G8.to(torch.bfloat16)
    # K2 at the fast tier and at the fp32-grade one (the report's row); the
    # operand is prepared once per rotated null, as on the main path, so
    # the time is the kernel's alone
    for tier in ("int8x2", "int8x3"):
        rot8 = build_rotated_null(null, rotate_dtype=tier)
        # the main path's operands: the folded W'' and no Q0 columns
        a8 = (packed_s, n, rot8.planes, rot8.w_scale, rot8.y_res,
              rot8.scan_q0, rot8.rss0, rot8.dof)
        ts = time.perf_counter()
        op8 = scan_operand(rot8)
        torch.cuda.synchronize()
        prep_s = time.perf_counter() - ts
        got = rotate_scan_int8_packed(*a8, operand=op8)
        if not torch.equal(got, rotate_scan_int8_packed(*a8)):
            raise AssertionError(f"K2 {tier}: a second launch (operand "
                                 "prepared on the spot) is not bit-equal")
        err = _check_stats(f"K2 {tier}", got,
                           rotate_scan_int8_packed_plain(*a8))
        ms = _cuda_ms(lambda: rotate_scan_int8_packed(*a8, operand=op8))
        pms = _cuda_ms(lambda: rotate_scan_int8_packed_plain(*a8))
        # a product of rows x n x n multiply-adds for each plane; the
        # epilogue's few operations a row are left out
        nplanes = rot8.planes.shape[0]
        bnd = _bound(2.0 * nplanes * srows * n * n, "int8",
                     *(t for t in a8 if isinstance(t, torch.Tensor)),
                     torch.empty((4, srows)))
        planes_t = [p_.t().contiguous().t() for p_ in rot8.planes]
        lms = _library_ms(lambda: [torch._int_mm(G8, p_) for p_ in planes_t],
                     f"{nplanes} x torch._int_mm(G_s8, P_p)")
        print(f"   products alone through the library, unpacked rows: "
              f"{nplanes} x torch._int_mm(G_s8, P_p) {lms} ms; operand "
              f"prepared once in {prep_s * 1e3:.1f} ms", flush=True)
        print(f"K2 rotate_scan_int8_packed {tier} n={n} rows={srows}: "
              f"max|df| {err:.3e}, kernel {ms:.3f} ms "
              f"({ms * 16_384 / srows:.3f} ms per 16,384 rows), plain "
              f"{pms:.3f} ms, bound {bnd['bound_ms']:.3f} ms by "
              f"{bnd['bound_by']}", flush=True)
        if tier == "int8x3":
            report["rotate_scan_int8_packed"] = dict(
                max_abs_err=err, ms=ms, plain_ms=pms, library_ms=None, **bnd)
        del planes_t, op8, rot8, a8
    # K5 at each bf16 tier, then bf16x3 on a genome with 2 % missing
    # genotypes (per-row means, rounded to bf16 in the kernel)
    Gm = _draw_genotypes(n, srows, missing_rate=0.02, seed=args.seed + 20)
    rgm = ResidentGenome.from_source(Gm, tile=256, device=dev)
    mu = row_means_packed(rgm.packed, n, 16_384, torch.float32)[:srows]
    errs = []
    for tier in ("bf16", "bf16x2", "bf16x3", "bf16x3 missing"):
        rotb = build_rotated_null(null, tier.split()[0])
        a5 = (packed_s, n, rotb.parts, rotb.y_res, rotb.scan_q0, rotb.rss0,
              rotb.dof, None)
        if tier.endswith("missing"):
            a5 = (rgm.packed[:srows],) + a5[1:-1] + (mu,)
        ts = time.perf_counter()
        op5 = scan_operand(rotb)
        torch.cuda.synchronize()
        prep_s = time.perf_counter() - ts
        got = rotate_scan_bf16_packed(*a5, operand=op5)
        if not torch.equal(got, rotate_scan_bf16_packed(*a5)):
            raise AssertionError(f"K5 {tier}: a second launch (operand "
                                 "prepared on the spot) is not bit-equal")
        ref = rotate_scan_bf16_packed_plain(*a5)
        errs.append(_check_stats(f"K5 {tier}", got, ref))
        dbeta = float((got[1] - ref[1]).abs().max())
        ms = _cuda_ms(lambda: rotate_scan_bf16_packed(*a5, operand=op5))
        pms = _cuda_ms(lambda: rotate_scan_bf16_packed_plain(*a5))
        # one product of rows x n x n multiply-adds for each bf16 part
        nparts = rotb.parts.shape[0]
        bnd = _bound(2.0 * nparts * srows * n * n, "bf16",
                     *(t for t in a5 if isinstance(t, torch.Tensor)),
                     torch.empty((4, srows)))
        if not tier.endswith("missing"):
            lms = _library_ms(lambda: [Gb @ p_ for p_ in rotb.parts],
                         f"{nparts} x (G_bf16 @ P_p)")
            print(f"   products alone through the library, unpacked rows: "
                  f"{nparts} x (G_bf16 @ P_p) {lms} ms; operand prepared "
                  f"once in {prep_s * 1e3:.1f} ms", flush=True)
        print(f"K5 rotate_scan_bf16_packed {tier} n={n} rows={srows}: "
              f"max|df| {errs[-1]:.3e}, max|dbeta| {dbeta:.3e}, kernel "
              f"{ms:.3f} ms ({ms * 16_384 / srows:.3f} ms per 16,384 rows), "
              f"plain {pms:.3f} ms, bound {bnd['bound_ms']:.3f} ms by "
              f"{bnd['bound_by']}", flush=True)
        if tier == "bf16x3":
            report["rotate_scan_bf16_packed"] = dict(ms=ms, plain_ms=pms,
                                                     library_ms=None, **bnd)
        del op5
    report["rotate_scan_bf16_packed"]["max_abs_err"] = max(errs)
    del G8, Gb, got, ref
    del a5, rotb, rgm, Gm, mu, Gs, packed_s
    # K3 at every width class of its one kernel: the exact tier's q = 1
    # (the report's row), a covariate design's q = 11 or 20, stepwise's
    # growing designs, the TPU kernel's QPAD of 128; on the rotated rows of
    # a real tile
    rot = build_rotated_null(null)
    Xr = torch.as_tensor(G1, device=dev).float() @ rot.U
    for q in (1, 2, 4, 8, 11, 16, 20, 32, 64, 128):
        Qq = (rot.Q0 if q == 1 else
              torch.linalg.qr(torch.randn(n, q, generator=g, device=dev))[0])
        yq = rot.y_res - Qq @ (Qq.T @ rot.y_res)
        aq = (Xr, rot.sd, yq, Qq, float(yq @ yq), float(n - q - 1))
        # the operand prepared once, as the scans keep it with their null:
        # the time is the kernel's alone
        opq = prepare_k3_operand(*aq[1:])
        got = scan_stats(*aq, operand=opq)
        if not (torch.equal(got, scan_stats(*aq, operand=opq))
                and torch.equal(got, scan_stats(*aq))):
            raise AssertionError(f"K3 q={q}: two launches differ, or the "
                                 "operand prepared on the spot gives others")
        errq = _check_stats(f"K3 scan_stats q={q}", got,
                            scan_stats_plain(*aq))
        msq = _cuda_ms(lambda: scan_stats(*aq, operand=opq))
        # a row's dot products with y_res and the q columns of Q0, and its
        # sum of squares: 2 n (2 + q) float32 operations
        bq = _bound(2.0 * rows * n * (2 + q), "fp32", Xr, rot.sd, yq, Qq,
                    torch.empty((4, rows)))
        # PR 7's two paths at these widths (PERF.md section 6)
        pr7 = {1: 0.292, 2: 0.289, 4: 0.331, 8: 0.476, 11: 1.539,
               16: 1.524, 64: 2.717, 128: 2.443}.get(q)
        print(f"K3 scan_stats q={q} n={n} rows={rows}: max|df| {errq:.3e}, "
              f"bit-equal on repeat, kernel {msq:.3f} ms"
              f"{f' (PR 7: {pr7})' if pr7 else ''}, bound "
              f"{bq['bound_ms']:.3f} ms by {bq['bound_by']}", flush=True)
        if q == 1:
            pms = _cuda_ms(lambda: scan_stats_plain(*aq))
            report["scan_stats"] = dict(max_abs_err=errq, ms=msq,
                                        plain_ms=pms, library_ms=None, **bq)
            print(f"   plain {pms:.3f} ms", flush=True)
    a3 = (rot.sd, rot.y_res, rot.Q0, rot.rss0, rot.dof)
    # one row (stepwise's re-tests) and a pitch of 8,168 bytes (n = 2,042)
    _check_stats("K3 m=1", scan_stats(Xr[7:8], *a3),
                 scan_stats_plain(Xr[7:8], *a3))
    Xo = torch.randn(3_001, 2_042, generator=g, device=dev)
    Qo = torch.linalg.qr(torch.randn(2_042, 20, generator=g,
                                     device=dev))[0]
    so = torch.rand(2_042, generator=g, device=dev) + 0.5
    yo = torch.randn(2_042, generator=g, device=dev)
    yo = yo - Qo @ (Qo.T @ yo)
    ao = (so, yo, Qo, float(yo @ yo), 2_021.0)
    _check_stats("K3 n=2042", scan_stats(Xo, *ao), scan_stats_plain(Xo, *ao))
    print("K3 m=1 and n=2,042 (an 8,168-byte pitch), q=20: within the kernel "
          "tolerances", flush=True)
    try:
        scan_stats(Xr, rot.sd, rot.y_res, torch.zeros((n, 129), device=dev),
                   rot.rss0, rot.dof)
    except ValueError:
        pass
    else:
        raise AssertionError("K3 took 129 columns of Q0")
    del Xr, Xo, a3, aq, rot
    _high_products(null, G1, dev, rows, n, args.seed)
    del null, U, rg1, rgc, G1, Gc, S, S_ref, got
    torch.cuda.empty_cache()
    _phase("3 kernels vs plain", t0)

    # ---- 4. main path at full width --------------------------------------
    t0 = time.perf_counter()
    ts = time.perf_counter()
    G = _draw_genotypes(n, M, seed=args.seed)
    y, causal = simulate_phenotype(G[:16_384], h2=0.6, n_causal=10,
                                   causal_effect=1.0, seed=args.seed)
    print(f"draw {M} x {n} genotypes (uniform draws on the card) and the "
          f"phenotype: {time.perf_counter() - ts:.3f} s", flush=True)
    kernels = (ibs_gram_packed, ibs_gram_tri_packed, rotate_scan_int8_packed,
               rotate_scan_bf16_packed, scan_stats)
    for k in kernels:
        k.launches = 0
    ts = time.perf_counter()
    rg = ResidentGenome.from_source(G)          # no device=: the card
    torch.cuda.synchronize()
    print(f"pack + upload: {time.perf_counter() - ts:.3f} s "
          f"({rg.nbytes_packed / 1e6:.1f} MB packed)", flush=True)
    ts = time.perf_counter()
    K = scale_k(kinship_resident(rg))
    print(f"kinship_resident (K1) + scale_k: "
          f"{time.perf_counter() - ts:.3f} s", flush=True)
    ts = time.perf_counter()
    phi, U = eigen_k(torch.as_tensor(K, device=dev), host=False)
    torch.cuda.synchronize()
    print(f"eigh on the card (float64, n={n}): "
          f"{time.perf_counter() - ts:.3f} s", flush=True)
    fits = []
    for _ in range(2):      # the first pays the process's first REML
        ts = time.perf_counter()
        null = fit_null_model(y, np.ones((n, 1)), eig_k=(phi, U), device=dev,
                              dtype=torch.float32)
        fits.append(time.perf_counter() - ts)
    print(f"fit_null_model: {fits[0]:.3f} s, again {fits[1]:.3f} s "
          f"(h2 {float(null.pseudo_heritability):.4f})", flush=True)
    res = {}
    pr7_rate = {"exact": 237_211, "int8x3": 2_394_025, "bf16x3": 1_172_266}
    for tier in ("exact", "int8x3", "bf16x3", "high"):
        # 'high': the exact tier's route, its rotation in three bf16
        # passes, scanned at the JAX package's tile for its matmul tiers
        rot = build_rotated_null(
            null, None if tier in ("exact", "high") else tier,
            matmul_precision="high" if tier == "high" else None)
        stile = rg.tile if tier != "high" else subdivide_tile(rg.tile, 8_192)
        torch.cuda.synchronize()
        ts = time.perf_counter()
        emmax_scan_packed(rg.packed, rot, n, stile)
        torch.cuda.synchronize()
        dt_scan = time.perf_counter() - ts
        k3_before = scan_stats.launches
        ts = time.perf_counter()
        res[tier] = emmax_resident(rg, y, eig_k=(phi, U), precision=tier)
        dt_all = time.perf_counter() - ts
        k3_call = scan_stats.launches - k3_before
        pr7 = (f"PR 7: {pr7_rate[tier]:,}" if tier in pr7_rate
               else f"K3 launches a call {k3_call}, {stile}-row tiles")
        print(f"scan {tier}: {dt_scan:.3f} s = {M / dt_scan:,.0f} "
              f"SNP-tests/s ({pr7}); emmax_resident "
              f"{tier} (null fit + scan + p-values): {dt_all:.3f} s",
              flush=True)
        if tier == "high":
            _check_tf32_off("emmax_resident high")
            if k3_call != -(-M // stile):
                raise AssertionError(f"emmax_resident high: K3 launched "
                                     f"{k3_call} times")
        if tier == "int8x3":
            # the fast tiers' mask of the rows inside col(X0), alone: one
            # pass over the packed genome (unpack, f32, outside_design)
            design_mask_packed(rg.packed, rot, n, rg.tile)
            torch.cuda.synchronize()
            ts = time.perf_counter()
            design_mask_packed(rg.packed, rot, n, rg.tile)
            torch.cuda.synchronize()
            dt_mask = time.perf_counter() - ts
            print(f"   the mask pass alone (inside the int8x3 scan above): "
                  f"{dt_mask:.3f} s, {dt_mask / dt_scan:.2f} of that scan",
                  flush=True)
        del rot
    launches = {k.__name__: k.launches for k in kernels}
    for name, cnt in launches.items():
        if cnt <= 0 and name != "ibs_gram_tri_packed":
            raise AssertionError(f"main path never launched {name}")
    # K1 alone over the whole genome (after the counts were read: this
    # launch is a timing, not part of the path)
    k1_ms = _cuda_ms(lambda: ibs_gram_packed(rg.packed, n, M, rg.ploidy),
                     reps=2)
    bnd = _bound(_gram_ops(n, rg.packed.shape[0], rg.ploidy), "int8",
                 rg.packed, torch.empty((n, n), dtype=torch.int32))
    print(f"K1 over the whole genome (n={n}, M={M}): {k1_ms:.3f} ms a "
          f"launch, bound {bnd['bound_ms']:.3f} ms by {bnd['bound_by']}",
          flush=True)
    ex = res["exact"]
    for tier, r in res.items():
        ps = r["ps"]
        if ps.shape != (M,) or not np.isfinite(ps).all() or (
                (ps < 0) | (ps > 1)).any():
            raise AssertionError(f"{tier}: p-values malformed")
        if r["dof"] != n - 2:
            raise AssertionError(f"{tier}: dof {r['dof']} != {n - 2}")
    dps = {t: float(np.abs(res[t]["ps"] - ex["ps"]).max())
           for t in ("int8x3", "bf16x3", "high")}
    top = set(np.argsort(ex["ps"])[:20].tolist())
    hits = len(top & set(causal.tolist()))
    print(f"int8x3 vs exact: max|dp| {dps['int8x3']:.3e}; bf16x3 vs exact: "
          f"max|dp| {dps['bf16x3']:.3e}; high vs exact: max|dp| "
          f"{dps['high']:.3e}; causal SNPs among the exact top "
          f"20: {hits} of {len(causal)}", flush=True)
    if max(dps.values()) > 1e-4 or hits < 3:
        raise AssertionError("main path results off")
    # every tier against exact on four fixtures (the intercept-only
    # design above, 20 and 128 design columns, VanRaden's singular K with
    # delta at its bound): the card's own drift table, ops/scan.py's
    # TIER_P_DRIFT, and each tier held to its entry with exact's masks
    runs = _main_path_drift(args, rg, phi, U, y, res)
    _drift_table("main path", runs, TIER_P_DRIFT)
    bad = [(fx, t, dp, nm) for fx in runs for t, (dp, nm) in runs[fx].items()
           if nm or dp > TIER_P_DRIFT[t]
           or (t in ("int8x3", "bf16x3") and dp > 1e-4)]
    if bad:
        raise AssertionError(f"tiers past their TIER_P_DRIFT entry or with "
                             f"other masks than exact: {bad}")
    # G and y stay for phase 6's files; the resident genome and eigh(K)
    # for phase 8
    main = dict(rg=rg, eig=(phi, U), y=y, K=K, ps=ex["ps"],
                ps_int8x3=res["int8x3"]["ps"])
    del null, res, ex
    torch.cuda.empty_cache()
    _phase("4 main path", t0)

    # ---- 5. end-to-end accuracy vs the float64 CPU path -------------------
    t0 = time.perf_counter()
    na, Ma = 2_048, 8_192
    Ga, _, _ = simulate_genotypes(na, Ma, ploidy=1, seed=args.seed + 1)
    ya, _ = simulate_phenotype(Ga, h2=0.5, n_causal=5, seed=args.seed + 1)
    # no device= means the card: pack, gram (K1) and scan there; the
    # float64 reference asks for the CPU
    rga = ResidentGenome.from_source(Ga)
    if rga.device.type != "cuda":
        raise AssertionError(f"default device is {rga.device}, not the card")
    k1_before = ibs_gram_packed.launches
    Ka = scale_k(kinship_resident(rga))
    if ibs_gram_packed.launches != k1_before + 1:
        raise AssertionError("phase 5's kinship did not launch K1")
    eig = eigen_k(Ka)
    a = emmax(Ga, ya, eig_k=eig, precision="exact")
    b = emmax(Ga, ya, eig_k=eig, precision="exact", device="cpu")
    dpa = float(np.abs(a["ps"] - b["ps"]).max())
    print(f"emmax exact, card f32 vs CPU f64 (n={na}, M={Ma}): "
          f"max|dp| {dpa:.3e}", flush=True)
    if dpa > 1e-5 or not np.array_equal(a["mask"], b["mask"]):
        raise AssertionError("card vs CPU p-values disagree")
    _phase("5 accuracy vs CPU float64", t0)

    # ---- 6. LOCO at full width: from files through the facade, and direct -
    t0 = time.perf_counter()
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)
    # run_gwas's own phase lines (utils/profiling.py sets its logger up
    # when first imported): each call's timings are printed below
    import mixmogam_tpu_torch.utils.profiling  # noqa: F401
    logging.getLogger("mixmogam_tpu_torch").setLevel(logging.WARNING)
    logging.getLogger("mixmogam_tpu_torch.loco").setLevel(logging.INFO)
    Mf = min(args.facade_snps, M)
    acc = [f"acc{i}" for i in range(n)]

    def facade(label, files, direct, expect, **kw):
        """One run_gwas call from files on the card, held to `direct` (the
        port's scan entry point on the call's own filtered rows, y and K)
        and to the launch counts `expect(result)`."""
        for k in kernels:
            k.launches = 0
        ResidentGenome.packs = 0
        out = api.run_gwas(files[0], files[1], data_format="plink",
                           plots=False, out_prefix=files[2], **kw)
        run = {k.__name__: k.launches for k in kernels}
        packs = ResidentGenome.packs
        for name, cnt in run.items():
            launches[name] += cnt
        g2, ps = out["genotype"], out["scan"]["ps"]
        with open(out["files"]["summary"]) as f:
            timings = json.load(f)["timings_s"]
        print(f"run_gwas {label} on {torch.cuda.get_device_name(0)}: "
              f"n={g2.num_samples} M={g2.num_snps} ploidy={g2.ploidy} "
              f"timings_s {json.dumps(timings)}", flush=True)
        route = ("in-core (the genome packed once, for the kinship)"
                 if packs == 1 and kw.get("method") != "emmax_loco"
                 else f"resident (the genome packed {packs} time(s))"
                 if packs else "in-core (no packing, no kinship)")
        print(f"   route: {route}; launches {run}", flush=True)
        if packs == 2:
            ts = time.perf_counter()
            ResidentGenome.from_source(g2)
            torch.cuda.synchronize()
            print(f"   one packing of these rows (pack + upload + the packed "
                  f"rows' read-back), timed alone: "
                  f"{time.perf_counter() - ts:.3f} s", flush=True)
        if ps.shape != (g2.num_snps,) or not np.isfinite(ps).all() or (
                (ps < 0) | (ps > 1)).any():
            raise AssertionError(f"run_gwas {label}: p-values malformed")
        want = expect(g2)
        if run != want:
            raise AssertionError(f"run_gwas {label}: launches {run}, "
                                 f"tabled {want}")
        ts = time.perf_counter()
        ref = direct(g2, out["y"])
        dp = float(np.abs(ps - ref["ps"]).max())
        on_disk = _read_ranked_csv(out["files"]["pvals"])
        back = np.array([on_disk[(int(c), int(p_))] for c, p_ in
                         zip(g2.chromosomes, g2.positions)])
        dcsv = float(np.abs(back - ps).max())
        print(f"   vs the direct call on the same rows, y and K: max|dp| "
              f"{dp:.3e}; CSV read back: max|dp| {dcsv:.3e} over "
              f"{len(on_disk)} rows ({time.perf_counter() - ts:.3f} s)",
              flush=True)
        if dp > 1e-12 or dcsv != 0.0 or len(on_disk) != g2.num_snps:
            raise AssertionError(f"run_gwas {label} disagrees with the "
                                 "direct path or with its own CSV")
        return out

    def loco_ranges(g2):
        c = g2.chromosomes
        cuts = np.flatnonzero(np.diff(c)) + 1
        return list(zip(np.r_[0, cuts].tolist(), np.r_[cuts, len(c)].tolist()))

    def tiles(g2, ranges=None):
        ranges = ranges or [(0, g2.num_snps)]
        return sum(-(-(e - s) // 16_384) for s, e in ranges)

    def counts(**kw):
        return {**{k.__name__: 0 for k in kernels}, **kw}

    loco = {}

    def loco_direct(tier, scan_kernel):
        """emmax_loco on the facade call's own rows, packed once and kept
        on the card: the direct LOCO path, its launches counted."""
        for k in kernels:
            k.launches = 0
        ts = time.perf_counter()
        r = emmax_loco(loco["rg"], loco["y"], chromosomes=loco["chrom"],
                       precision=tier)
        torch.cuda.synchronize()
        run = {k.__name__: k.launches for k in kernels}
        print(f"emmax_loco {tier} (M={loco['rg'].M}): "
              f"{time.perf_counter() - ts:.3f} s; launches {run}", flush=True)
        if (run["ibs_gram_tri_packed"] != 5 or run["ibs_gram_packed"] != 1
                or run[scan_kernel.__name__] <= 0):
            raise AssertionError(f"LOCO {tier}: launches {run}")
        for name, cnt in run.items():
            launches[name] += cnt
        ps = r["ps"]
        if ps.shape != (loco["rg"].M,) or not np.isfinite(ps).all() or (
                (ps < 0) | (ps > 1)).any():
            raise AssertionError(f"LOCO {tier}: p-values malformed")
        return r

    def loco_exact_on(g2, y2):
        loco.update(rg=ResidentGenome.from_source(g2), y=y2,
                    chrom=np.asarray(g2.chromosomes))
        ts = time.perf_counter()
        loco["exact"] = loco_direct("exact", scan_stats)
        # phase 18 (c) holds emmax_loco(mesh=) on these rows to this call
        main["loco6"] = dict(G=g2, y=y2, chrom=loco["chrom"],
                             exact=loco["exact"],
                             wall=time.perf_counter() - ts)
        return loco["exact"]

    # phases 6, 7 and 9 read these files: the directory goes when the
    # script ends (or, after a failed phase, when the interpreter exits)
    tmpdir = tempfile.TemporaryDirectory()
    tmp = tmpdir.name
    ts = time.perf_counter()
    # the first Mf rows, in 5 chromosomes of TAIR10's proportions
    gd = GenotypeData(G[:Mf], _tair10_chromosomes(Mf),
                      np.arange(1, Mf + 1) * 100, acc, ploidy=1)
    prefix = os.path.join(tmp, "cohort")
    write_plink(prefix, gd)
    pheno = os.path.join(tmp, "pheno.csv")
    PhenotypeData.from_arrays(1, "trait", acc, y).write_to_file(pheno)
    bed_mb = os.path.getsize(prefix + ".bed") / 1e6
    print(f"wrote {prefix}.bed/.bim/.fam ({bed_mb:.1f} MB) and the "
          f"phenotype CSV: {time.perf_counter() - ts:.3f} s (M={Mf})",
          flush=True)
    del gd                  # G stays: phase 15's source starts with it
    files = (prefix + ".bed", pheno)
    # the facade's LOCO call, held to the direct exact call on its rows;
    # then the bf16x3 tier on the same rows against that exact call
    facade("emmax_loco exact", files + (os.path.join(tmp, "loco"),),
           loco_exact_on,
           lambda g2: counts(ibs_gram_packed=1,
                             ibs_gram_tri_packed=len(loco_ranges(g2)),
                             scan_stats=tiles(g2, loco_ranges(g2))),
           method="emmax_loco")
    rg, chrom = loco["rg"], loco["chrom"]
    cuts = np.flatnonzero(np.diff(chrom)) + 1
    print(f"LOCO chromosome starts {cuts.tolist()} of {rg.M} rows (tile "
          f"{rg.tile})", flush=True)
    if len(cuts) != 4 or (cuts % rg.tile == 0).any():
        raise AssertionError(f"LOCO needs 5 chromosomes with no boundary "
                             f"on a tile: {cuts.tolist()}")
    loco["bf16x3"] = loco_direct("bf16x3", rotate_scan_bf16_packed)
    dpl = float(np.abs(loco["bf16x3"]["ps"] - loco["exact"]["ps"]).max())
    deltas = [round(v["delta"], 6)
              for v in loco["exact"]["loco"].values()]
    print(f"LOCO bf16x3 vs exact: max|dp| {dpl:.3e}; deltas {deltas}",
          flush=True)
    if dpl > 1e-4:
        raise AssertionError("LOCO bf16x3 disagrees with exact")
    # K_loco of the middle chromosome against the direct gram over the
    # other rows; its neighbours are merged to a side each, so three
    # kinships are built for the one that is read
    ts = time.perf_counter()
    s_c, e_c = int(cuts[1]), int(cuts[2])
    sides = np.repeat([0, 1, 2], [s_c, e_c - s_c, rg.M - e_c])
    K_c = loco_kinships(rg, sides)[1]
    rest = torch.cat([rg.packed[:s_c], rg.packed[e_c:rg.M]])
    rg_rest = ResidentGenome(rest, rest.shape[0], n, rg.ploidy, rg.tile,
                             False)
    dk = float(np.abs(K_c - scale_k(kinship_resident(rg_rest))).max())
    print(f"K_loco identity, chromosome 3: max|d| {dk:.3e} "
          f"({time.perf_counter() - ts:.3f} s)", flush=True)
    if dk > 1e-12:
        raise AssertionError("K_loco differs from the direct gram")
    del rg, rg_rest, rest, K_c
    loco.clear()
    torch.cuda.empty_cache()
    _check_no_jax()
    _phase("6 LOCO", t0)

    # ---- 7. the facade: files -> run_gwas -> ranked CSV ---------------
    t0 = time.perf_counter()
    logging.getLogger("mixmogam_tpu_torch.loco").setLevel(logging.WARNING)

    def direct_emmax(precision):
        def fn(g2, y2):
            K2 = cached_kinship(g2, "ibs")
            return emmax(g2, y2, K=K2, precision=precision)
        return fn

    facade("emmax exact", files + (os.path.join(tmp, "exact"),),
           direct_emmax(None),
           lambda g2: counts(ibs_gram_packed=1, scan_stats=tiles(g2)))
    facade("emmax int8x3", files + (os.path.join(tmp, "int8x3"),),
           direct_emmax("int8x3"),
           lambda g2: counts(ibs_gram_packed=1, rotate_scan_int8_packed=1),
           precision="int8x3")
    facade("emmax bf16x3", files + (os.path.join(tmp, "bf16x3"),),
           direct_emmax("bf16x3"),
           lambda g2: counts(ibs_gram_packed=1, rotate_scan_bf16_packed=1),
           precision="bf16x3")
    facade("emmax high", files + (os.path.join(tmp, "high"),),
           direct_emmax("high"),
           lambda g2: counts(ibs_gram_packed=1, scan_stats=tiles(g2)),
           precision="high")
    _check_tf32_off("run_gwas emmax high")

    # missing calls and the VanRaden kinship: float32 matmuls on the
    # card against the float64 CPU path, from the same files
    ts = time.perf_counter()
    nm, Mm = 2_048, 4_096
    Gm, chm, pom = simulate_genotypes(nm, Mm, ploidy=2, missing_rate=0.02,
                                      seed=args.seed + 50)
    ym, _ = simulate_phenotype(Gm, h2=0.5, n_causal=5, seed=args.seed + 50)
    accm = [f"m{i}" for i in range(nm)]
    pm = os.path.join(tmp, "missing")
    write_plink(pm, GenotypeData(Gm, chm, pom, accm, ploidy=2))
    phm = os.path.join(tmp, "pheno_m.csv")
    PhenotypeData.from_arrays(1, "trait", accm, ym).write_to_file(phm)
    for km in ("ibs", "vanraden"):
        for k in kernels:
            k.launches = 0
        kw = dict(data_format="plink", plots=False, kinship_method=km)
        a = api.run_gwas(pm + ".bed", phm, **kw)
        if ibs_gram_packed.launches:
            raise AssertionError(f"{km} with missing calls launched K1")
        b = api.run_gwas(pm + ".bed", phm, device="cpu", **kw)
        g2 = a["genotype"]
        if not (g2.matrix < 0).any() or g2.ploidy != 2:
            raise AssertionError("the missing-call fileset lost its "
                                 "missing calls or its ploidy")
        dK = float(np.abs(cached_kinship(g2, km)
                          - cached_kinship(g2, km, device="cpu")).max())
        dp = float(np.abs(a["scan"]["ps"] - b["scan"]["ps"]).max())
        timings = {k: round(v, 3) for k, v in a["timings"].items()}
        print(f"run_gwas kinship_method={km}, 2 % missing calls, "
              f"n={g2.num_samples} M={g2.num_snps}: card float32 vs CPU "
              f"float64 max|dK| {dK:.3e}, max|dp| {dp:.3e}; card "
              f"timings_s {json.dumps(timings)}", flush=True)
        if dK > 1e-5 or dp > 1e-4 or not np.array_equal(
                a["scan"]["mask"], b["scan"]["mask"]):
            raise AssertionError(f"{km}: card and CPU disagree")
    # LOCO's float kinships (VanRaden over these missing calls) in
    # float64 on the card: K_loco of the middle chromosome against the
    # direct kinship over the other chromosomes' rows
    ch_m = np.asarray(g2.chromosomes)
    c_mid = np.unique(ch_m)[len(np.unique(ch_m)) // 2]
    K_v = loco_kinships(ResidentGenome.from_source(g2), ch_m,
                        method="vanraden", dtype=torch.float64)[c_mid]
    rest = ResidentGenome.from_source(g2.matrix[ch_m != c_mid],
                                      ploidy=g2.ploidy)
    dk = float(np.abs(K_v - scale_k(kinship_resident(
        rest, method="vanraden", dtype=torch.float64))).max())
    print(f"VanRaden K_loco identity over missing calls (float64 on the "
          f"card), chromosome {c_mid}: max|d| {dk:.3e}", flush=True)
    if dk > 1e-12:
        raise AssertionError("VanRaden K_loco differs from the direct "
                             "kinship")
    print(f"missing-call and VanRaden runs: "
          f"{time.perf_counter() - ts:.3f} s", flush=True)

    # VanRaden's K with delta at its lower bound: the float32 scan at each
    # tier against the float64 CPU path (ROADMAP Queue 3's repaired
    # faults: exact by the projected U, int8x3 and bf16x3 by the folded W'')
    ts = time.perf_counter()
    Gv, chv, pov = simulate_genotypes(256, 3_000, ploidy=1, seed=3)
    accv = [f"s{i}" for i in range(256)]
    yv, _ = simulate_phenotype(Gv, h2=0.5, n_causal=4, seed=3)
    gv, pv = os.path.join(tmp, "v.csv"), os.path.join(tmp, "v_p.csv")
    GenotypeData(Gv, chv, pov, accv, ploidy=1).write_csv(gv)
    PhenotypeData.from_arrays(1, "t", accv, yv).write_to_file(pv)
    kv = dict(kinship_method="vanraden", plots=False)
    ref_v = api.run_gwas(gv, pv, precision="exact", device="cpu",
                         **kv)["scan"]
    for tier in ("exact", "int8x3", "bf16x3"):
        sv = api.run_gwas(gv, pv, precision=tier, **kv)["scan"]
        diff = sv["mask"] != ref_v["mask"]
        dpv = np.abs(sv["ps"] - ref_v["ps"])
        print(f"VanRaden K, delta {ref_v['delta']:.3e} (its bound), "
              f"{tier} on the card vs float64 CPU: {int(diff.sum())} "
              f"mask(s) differ, max|dp| {dpv.max():.3e}, where the "
              f"masks agree {dpv[~diff].max():.3e}", flush=True)
        if diff.any() or dpv.max() > 1e-4:
            raise AssertionError(f"the float32 {tier} scan under a "
                                 "singular K disagrees with float64")
    print(f"singular-K runs: {time.perf_counter() - ts:.3f} s",
          flush=True)

    # stepwise through the facade, from phase 6's PLINK fileset
    for k in kernels:
        k.launches = 0
    sw_out = api.run_gwas(files[0], files[1], data_format="plink",
                          method="emmax_stepwise", num_steps=3,
                          plots=False, out_prefix=os.path.join(tmp, "sw"))
    run = {k.__name__: k.launches for k in kernels}
    for name, cnt in run.items():
        launches[name] += cnt
    with open(sw_out["files"]["summary"]) as f:
        timings = json.load(f)["timings_s"]
    sel = {k: v["cofactors"] for k, v in
           sw_out["scan"]["stepwise"]["selected"].items()}
    print(f"run_gwas emmax_stepwise (3 steps) n={n} "
          f"M={sw_out['genotype'].num_snps}: timings_s "
          f"{json.dumps(timings)}; selected {json.dumps(sel)}; "
          f"launches {run}", flush=True)
    if run["scan_stats"] <= 0 or sw_out["scan"]["ps"] is not None:
        raise AssertionError("run_gwas emmax_stepwise: no K3 launch")

    # LOCO with the VanRaden kinship on the same rows
    ts = time.perf_counter()
    gd_f = sw_out["genotype"]
    rg_f = ResidentGenome.from_source(gd_f)
    ch_f = np.asarray(gd_f.chromosomes)
    for k in kernels:
        k.launches = 0
    lv = emmax_loco(rg_f, sw_out["y"], chromosomes=ch_f,
                    method="vanraden")
    run = {k.__name__: k.launches for k in kernels}
    for name, cnt in run.items():
        launches[name] += cnt
    print(f"emmax_loco vanraden (M={rg_f.M}): "
          f"{time.perf_counter() - ts:.3f} s; launches {run}; deltas "
          f"{[round(v['delta'], 6) for v in lv['loco'].values()]}",
          flush=True)
    if (run["scan_stats"] <= 0 or not np.isfinite(lv["ps"]).all()
            or lv["ps"].shape != (rg_f.M,)):
        raise AssertionError("LOCO vanraden: malformed")
    del rg_f, sw_out, gd_f
    torch.cuda.empty_cache()
    _check_no_jax()
    _phase("7 facade", t0)

    # ---- 8. stepwise MLMM at full width -----------------------------------
    t0 = time.perf_counter()
    sw = {}
    for route, kw in (("stored", dict(max_steps=10)),
                      ("over budget", dict(max_steps=3,
                                           rot_budget_bytes=1 << 30))):
        for k in kernels:
            k.launches = 0
        ts = time.perf_counter()
        r = emmax_step_wise(main["rg"], main["y"], eig_k=main["eig"], **kw)
        wall = time.perf_counter() - ts
        run = {k.__name__: k.launches for k in kernels}
        for name, cnt in run.items():
            launches[name] += cnt
        tm = r["timings_s"]
        print(f"stepwise {route} ({tm['route']}, {kw['max_steps']} steps, "
              f"n={n} M={M}): {wall:.3f} s; rotation {tm['rotate']:.3f} s; "
              f"scan a step {np.mean(tm['scan']):.3f} s (host p-values "
              f"included); K3 launches {run['scan_stats']}; path "
              f"{[s['min_p_snp'] for s in r['steps'] if s['min_p_snp'] >= 0]}"
              f"; selected ebic {r['selected']['ebic']['cofactors']}",
              flush=True)
        if run["scan_stats"] <= 0:
            raise AssertionError(f"stepwise {route}: K3 never launched")
        sw[route] = r
        if route == "stored":
            # phase 18 (d) holds emmax_step_wise(mesh=) to this call
            main["sw8"] = dict(res=r, wall=wall, k3=run["scan_stats"])
    fa = [s for s in sw["stored"]["steps"] if s["phase"] == "forward"][:3]
    fb = [s for s in sw["over budget"]["steps"]
          if s["phase"] == "forward"][:3]
    if [s["min_p_snp"] for s in fa] != [s["min_p_snp"] for s in fb]:
        raise AssertionError("the stepwise routes chose other cofactors")
    rel = max(abs(a["min_p"] - b["min_p"]) / b["min_p"]
              for a, b in zip(fa, fb))
    print(f"stored vs over-budget: the same 3 cofactors, forward min_p "
          f"{[s['min_p'] for s in fa]} and {[s['min_p'] for s in fb]}, "
          f"within rtol {rel:.3e}", flush=True)
    if rel > 1e-4:
        raise AssertionError("the stepwise routes' min_p disagree")
    del sw
    torch.cuda.empty_cache()
    # the card (float32) against the float64 CPU path
    ts = time.perf_counter()
    Gs, _, _ = simulate_genotypes(1_024, 8_192, ploidy=1, seed=args.seed + 8)
    ys, _ = simulate_phenotype(Gs, h2=0.6, n_causal=4, seed=args.seed + 8)
    Ks = scale_k(kinship_resident(ResidentGenome.from_source(Gs)))
    a = emmax_step_wise(Gs, ys, K=Ks, max_steps=3, save_scans=True)
    b = emmax_step_wise(Gs, ys, K=Ks, max_steps=3, save_scans=True,
                        device="cpu")
    pa, pb = a["steps"][0]["scan_ps"], b["steps"][0]["scan_ps"]
    dps = float(np.abs(pa - pb).max())
    print(f"stepwise card f32 vs CPU f64 (n=1024, M=8192, 3 steps): path "
          f"{[s['cofactors'] for s in a['steps']]}; step 0 max|dp| "
          f"{dps:.3e} ({time.perf_counter() - ts:.3f} s)", flush=True)
    if ([s["cofactors"] for s in a["steps"]]
            != [s["cofactors"] for s in b["steps"]]
            or a["selected"] != b["selected"] or dps > 1e-5
            or not np.array_equal(pa < 1.0, pb < 1.0)):
        raise AssertionError("stepwise: card and CPU disagree")
    _check_no_jax()
    _phase("8 stepwise", t0)

    # ---- 9. multi-trait at full width -------------------------------------
    t0 = time.perf_counter()
    rg, (phi, U) = main["rg"], main["eig"]
    T9 = 50
    ts = time.perf_counter()
    Y9 = _draw_traits(rg[0:16_384], T9, seed=args.seed + 90)
    print(f"draw {T9} traits (h2 0.1-0.9) from the first 16,384 rows: "
          f"{time.perf_counter() - ts:.3f} s", flush=True)
    tiles9 = -(-M // rg.tile)
    U64 = U.double()                    # phase 4's float64 eigenvectors
    X0_9 = torch.ones((n, 1), dtype=torch.float64, device=dev)
    Up9 = project_design(U64, X0_9)[0]
    Gt9 = unpack_2bit_device(rg.packed[:rg.tile], n)
    X0d, X0p = design_basis(X0_9, dev, torch.float32)
    mt = {}
    for tier in ("exact", "int8x3", "bf16x3"):
        for k in kernels:
            k.launches = 0
        ts = time.perf_counter()
        r = emmax_multi_trait(rg, Y9, eig_k=(phi, U), precision=tier)
        wall = time.perf_counter() - ts
        run = {k.__name__: k.launches for k in kernels}
        for name, cnt in run.items():
            launches[name] += cnt
        if run != counts(scan_stats=T9 * tiles9):
            raise AssertionError(f"multi-trait {tier}: launches {run}, "
                                 f"expected K3 {T9} x {tiles9} and no other")
        ps = r["ps"]
        if (ps.shape != (T9, M) or not np.isfinite(ps).all()
                or ((ps < 0) | (ps > 1)).any() or r["dof"] != n - 2):
            raise AssertionError(f"multi-trait {tier}: malformed output")
        # the shared rotation, the design mask and one trait's K3 launch on
        # one tile alone (after the counts were read)
        rot9 = shared_rotation(Up9, None if tier == "exact" else tier,
                               torch.float32)
        rot_ms = _cuda_ms(lambda: rotate_tile(Gt9, rot9))
        mask_ms = _cuda_ms(lambda: outside_design(Gt9.float(), X0d, X0p))
        Xr9 = rotate_tile(Gt9, rot9)
        null9 = _trait_nulls(phi.float(), (U64.T @ torch.as_tensor(
            Y9[:1].T, device=dev)).T, U64.T @ X0_9, r["deltas"][:1],
            torch.float32)[0]
        op9 = k3_operand(null9)
        k3_ms = _cuda_ms(lambda: scan_stats(Xr9, null9.sd, null9.y_res,
                                            null9.Q0, null9.rss0, null9.dof,
                                            operand=op9))
        tm = r["timings_s"]
        print(f"multi-trait {tier}, T={T9} n={n} M={M}: {wall:.3f} s; REML "
              f"({T9} fits) {tm['reml']:.3f} s; scan {tm['scan']:.3f} s = "
              f"{T9 * M / tm['scan']:,.0f} SNP-tests/s; p-values "
              f"{tm['p_values']:.3f} s; K3 launches {run['scan_stats']}",
              flush=True)
        print(f"   a tile alone: rotation {rot_ms:.3f} ms (x {tiles9} = "
              f"{rot_ms * tiles9 / 1e3 / tm['scan']:.2f} of the scan), "
              f"design mask {mask_ms:.3f} ms, K3 {k3_ms:.3f} ms a launch (x "
              f"{T9 * tiles9} = {k3_ms * T9 * tiles9 / 1e3 / tm['scan']:.2f}"
              f" of the scan)", flush=True)
        # three traits against the single-trait scan at the same tier
        for t in (0, T9 // 2, T9 - 1):
            ts = time.perf_counter()
            one = emmax_resident(rg, Y9[t], eig_k=(phi, U), precision=tier)
            nm = int((one["mask"] != r["mask"][t]).sum())
            dpt = float(np.abs(one["ps"] - r["ps"][t]).max())
            print(f"   trait {t} (h2 {0.1 + 0.8 * t / (T9 - 1):.2f}, delta "
                  f"{r['deltas'][t]:.4g}) vs emmax_resident {tier}: {nm} "
                  f"mask(s) differ, max|dp| {dpt:.3e} "
                  f"({time.perf_counter() - ts:.3f} s)", flush=True)
            if nm or dpt > 1e-5:
                raise AssertionError(f"multi-trait {tier}, trait {t}: "
                                     "differs from the single-trait scan")
        mt[tier] = r
        if tier in ("exact", "int8x3"):
            # phase 18 (d) holds emmax_multi_trait(mesh=) to these calls
            main.setdefault("mt9", dict(Y=Y9, k3=T9 * tiles9))[tier] = dict(
                wall=wall, **{k: r[k] for k in ("ps", "f_stats", "betas",
                                                "mask", "deltas")})
        del rot9, Xr9, null9, op9
    for tier in ("int8x3", "bf16x3"):
        nm = int((mt[tier]["mask"] != mt["exact"]["mask"]).sum())
        dpt = float(np.abs(mt[tier]["ps"] - mt["exact"]["ps"]).max())
        print(f"multi-trait {tier} vs exact: {nm} mask(s) differ, max|dp| "
              f"{dpt:.3e}", flush=True)
        if nm or dpt > 1e-4:
            raise AssertionError(f"multi-trait {tier} disagrees with exact")
    del mt, Up9, U64, Gt9, rg
    torch.cuda.empty_cache()
    # missingness groups on the card against the float64 CPU path
    ts = time.perf_counter()
    ns9, ms9 = 2_048, 4_096
    Gs9, _, _ = simulate_genotypes(ns9, ms9, ploidy=1, seed=args.seed + 91)
    Ys9 = _draw_traits(Gs9, 8, seed=args.seed + 92)
    rng9 = np.random.default_rng(args.seed + 93)
    Ys9[2:4, rng9.permutation(ns9)[:60]] = np.nan
    Ys9[5, rng9.permutation(ns9)[:25]] = np.nan
    rgs9 = ResidentGenome.from_source(Gs9)
    Ks9 = scale_k(kinship_resident(rgs9))
    before = scan_stats.launches
    a = emmax_multi_trait(rgs9, Ys9, K=Ks9, precision="exact")
    k3 = scan_stats.launches - before
    b = emmax_multi_trait(Gs9, Ys9, K=Ks9, precision="exact", device="cpu")
    nm = int((a["mask"] != b["mask"]).sum())
    dps9 = float(np.abs(a["ps"] - b["ps"]).max())
    print(f"multi-trait with two missing-phenotype patterns (n={ns9}, "
          f"M={ms9}, T=8, dof {a['dof'].tolist()}): card float32 vs CPU "
          f"float64 {nm} mask(s) differ, max|dp| {dps9:.3e}; K3 launches "
          f"{k3} ({time.perf_counter() - ts:.3f} s)", flush=True)
    if nm or dps9 > 1e-5 or k3 != 8 or not np.array_equal(a["dof"],
                                                          b["dof"]):
        raise AssertionError("multi-trait groups: card and CPU disagree")
    del rgs9, a, b
    # the facade from phase 6's PLINK fileset and a 4-trait phenotype CSV
    ts = time.perf_counter()
    ph9 = PhenotypeData()
    for t in range(4):
        ph9.add_phenotype(t + 1, f"trait{t + 1}", acc, Y9[t])
    pheno9 = os.path.join(tmp, "pheno4.csv")
    ph9.write_to_file(pheno9)
    for k in kernels:
        k.launches = 0
    out9 = api.run_gwas_multi(files[0], pheno9, batched=True,
                              data_format="plink", plots=False,
                              out_prefix=os.path.join(tmp, "multi"))
    run = {k.__name__: k.launches for k in kernels}
    for name, cnt in run.items():
        launches[name] += cnt
    g9 = out9[1]["genotype"]
    wall9 = time.perf_counter() - ts
    ts = time.perf_counter()
    ref9 = emmax_multi_trait(g9, np.stack([out9[p_]["y"] for p_ in out9]),
                             K=cached_kinship(g9, "ibs"))
    dp9 = max(float(np.abs(out9[p_]["scan"]["ps"] - ref9["ps"][t]).max())
              for t, p_ in enumerate(out9))
    dcsv9 = 0.0
    for p_, o in out9.items():
        on_disk = _read_ranked_csv(o["files"]["pvals"])
        back = np.array([on_disk[(int(c), int(q_))] for c, q_ in
                         zip(g9.chromosomes, g9.positions)])
        dcsv9 = max(dcsv9, float(np.abs(back - o["scan"]["ps"]).max()))
    print(f"run_gwas_multi batched, 4 traits, n={g9.num_samples} "
          f"M={g9.num_snps}: {wall9:.3f} s; launches {run}; vs the direct "
          f"emmax_multi_trait on the same rows, Y and K: max|dp| {dp9:.3e}; "
          f"CSVs read back: max|dp| {dcsv9:.3e} "
          f"({time.perf_counter() - ts:.3f} s)", flush=True)
    if (dp9 > 1e-12 or dcsv9 != 0.0 or sorted(out9) != [1, 2, 3, 4]
            or run != counts(ibs_gram_packed=1,
                             scan_stats=4 * tiles(g9))):
        raise AssertionError("run_gwas_multi batched disagrees with the "
                             "direct call, its CSVs or its launches")
    del out9, ref9, g9
    torch.cuda.empty_cache()
    _check_no_jax()
    _phase("9 multi-trait", t0)

    # ---- 10. EMMA at BASELINE #2's shape ----------------------------------
    t0 = time.perf_counter()
    # phase 18 (d) holds emma(mesh=) to this phase's call
    main["emma10"] = _emma_phase(args, dev, kernels, launches)
    _check_no_jax()
    _phase("10 EMMA", t0)

    # ---- 11. the class tests ----------------------------------------------
    t0 = time.perf_counter()
    _class_phase(args, dev, kernels, launches, main, facade, files, tmp,
                 counts, tiles)
    torch.cuda.empty_cache()
    _check_no_jax()
    _phase("11 class tests", t0)

    # ---- 12. gBLUP and GxE --------------------------------------------------
    t0 = time.perf_counter()
    _gxe_gblup_phase(args, kernels, launches, main, facade, files, acc, tmp,
                     counts)
    torch.cuda.empty_cache()
    _check_no_jax()
    _phase("12 gBLUP and GxE", t0)

    # ---- 13. the permutation test and the two-SNP scan --------------------
    t0 = time.perf_counter()
    _perm_two_snp_phase(args, kernels, launches, main, counts)
    torch.cuda.empty_cache()
    _check_no_jax()
    _phase("13 permutation and two-SNP", t0)

    # ---- 14. the spectrum REML, the class facade and the examples --------
    t0 = time.perf_counter()
    _spectrum_compat_phase(args, kernels, launches, main)
    torch.cuda.empty_cache()
    _check_no_jax()
    _phase("14 spectrum REML, compat and the examples", t0)

    # ---- 15. the streamed scan --------------------------------------------
    t0 = time.perf_counter()
    _stream_phase(args, kernels, launches, main, G, files, tmp)
    torch.cuda.empty_cache()
    _check_no_jax()
    _phase("15 the streamed scan", t0)

    # ---- 16. the host data plane --------------------------------------------
    t0 = time.perf_counter()
    _host_data_phase(args, kernels, launches, main, G, files, tmp, acc)
    torch.cuda.empty_cache()
    _check_no_jax()
    _phase("16 the host data plane", t0)

    # ---- 17. imputed (fractional) dosages -----------------------------------
    t0 = time.perf_counter()
    _fractional_phase(args, kernels, launches, main, G, tmp, acc)
    torch.cuda.empty_cache()
    _check_no_jax()
    _phase("17 imputed dosages", t0)

    # ---- 18. the data-parallel core (parallel/) ----------------------------
    t0 = time.perf_counter()
    _parallel_phase(args, kernels, launches, main, G, tmp)
    tmpdir.cleanup()
    del main
    torch.cuda.empty_cache()
    _check_no_jax()
    _phase("18 the data-parallel core", t0)

    for k in kernels:
        report[k.__name__]["launches"] = launches[k.__name__]
    meta = {
        "ibs_gram_packed": ("cuda", "mixmogam_tpu_torch/csrc/ibs_gram.cu",
                            "mixmogam_tpu/ops/pallas_kinship.py:60"),
        "rotate_scan_int8_packed": (
            "cuda", "mixmogam_tpu_torch/csrc/rotate_scan_int8.cu",
            "mixmogam_tpu/ops/pallas_scan.py:369"),
        "scan_stats": ("cuda", "mixmogam_tpu_torch/csrc/scan_stats.cu",
                       "mixmogam_tpu/ops/pallas_scan.py:108"),
        "ibs_gram_tri_packed": (
            "cuda", "mixmogam_tpu_torch/csrc/ibs_gram_tri.cu",
            "mixmogam_tpu/ops/pallas_kinship.py:112"),
        "rotate_scan_bf16_packed": (
            "cuda", "mixmogam_tpu_torch/csrc/rotate_scan_bf16.cu",
            "mixmogam_tpu/ops/pallas_scan.py:221"),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": meta[name][0], "source": meta[name][1],
         "replaces": meta[name][2], "launches": r["launches"],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for name, r in report.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
