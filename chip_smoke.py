#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port, `larvanet_tpu_torch`.

    python3 chip_smoke.py        # from the repo root, on a machine with one H100
    python3 chip_smoke.py --phase parallel   # the build and phase 20 alone


It drives the port's main paths on the card, serving and validating
EDSR-baseline x4 and the LarvaNet family (the flagship LarvaNet 2x16, and
LarvaNet_w64 on the fused ResBlocks) and training EDSR-baseline x4 and the
flagship, then serving, running and training the MSRR family (phase 15),
TreeNet, REGO-Net and REGO-serial (phase 16), the EBRN and HRSR
families (phase 17) and MAMNet and IMDN (phase 18), then exporting, serving
and validating serving artifacts and the full-frame forwards (phase 19),
then the parallel package (phase 20: spatial halo sharding, data-parallel
serving and training, NCCL, channel TP, directory checkpoints, on a mesh
that repeats the one card, and over distinct cards where there are 2 or
more), and fails (exit code != 0, no result line) if any phase fails.
EDSR serves on its default route, the collapsed linear tail
(ops/collapsed_tail.py: the trunk's 34 convs on conv3x3, the tail as one
5x5 conv, 4 side and 4 corner operators on conv_kxk; the CLIs make the
route, probing the tail once, inside the counted runs of phases 6, 7 and
10); phases 8, 11d and 13 train EDSR on the plain tail
(--collapsed_tail_train 0), whose counts they keep, and phase 14 trains it
on the default, collapsed route:

 1. device: CUDA must be available; prints nvidia-smi's name and power limit.
 2. build: compiles every kernel of the path from larvanet_tpu_torch/csrc/
    with nvcc for sm_90a, all sources at once, and prints the seconds.
 3. kernels: holds each kernel against its plain PyTorch version on the
    card at every conv shape of the x4 forward, for a batch of 4 LR tiles
    of 192x192 and one ragged 339x510 frame, in f32 (TF32 off) and bf16.
    Each call must take the conv kernel's path that X4_CONVS names and
    `path_for` agrees with: the narrow path for final_conv (F <= 8 with C a
    multiple of 16 up to 64), the tensor cores for C and F multiples of 16
    (bf16 on WMMA, f32 in split TF32), else the CUDA cores (X4_CONVS: the
    module's own tail, which the probes and the plain-tail phases run); at
    the narrow
    and tensor-core shapes the CUDA-core entry of the dtype is held and
    timed too, as the earlier kernel of the same function. Prints each
    shape's kernel, CUDA-core entry, plain-version and F.conv2d times and
    its bound at the dtype's peak; at the narrow shapes also x.sum(), one
    PyTorch read of x, as a yardstick of the bytes side. Every time in the
    script is the median of WINDOWS windows of TIMED_REPS calls (CUDA
    events, after WARMUP_REPS), printed with the windows' min-max; the
    times compared on one row are taken in turns, window by window, in
    the same call. The same again at LarvaNet's conv shapes (LARVANET_CONVS:
    3 -> 48, 48 -> 48 relu and none, w64's leg 64 -> 48, V2's merge 96 -> 48),
    summed over one LarvaNet 2x16 forward.
 3b. wino kernels: holds both fused Winograd ResBlock kernels (F(2,3) and
    F(4,3)) against their plain version at EDSR-baseline's ResBlock (C = 64)
    for the same two geometries, f32 and bf16 (res_weight 1.0, and 0.1 on
    the ragged frame). Each call must take the path `path_for` names, the
    tensor-core entry in both dtypes (f32 in split TF32); the CUDA-core
    entry of the dtype is held and timed too, as the earlier kernel of the
    same function. Prints each one's kernel, CUDA-core entry,
    plain-version and cuDNN ResBlock times (two F.conv2d, ReLU, add; in
    turns, as in phase 3) and its bound beside the direct ResBlock's.
 4. serve: EDSR-baseline x4 at full width (64 features, 16 ResBlocks),
    random weights from SEED with final_conv rescaled so the output spans
    the pixel range (see fit_output_range), saved as a .pth; the port's HTTP server
    (build_service + make_server) in this process with --dynamic_batch 2,
    once with --serving_dtype f32 and once with bf16. After /healthz
    turns 200, the launch counters are zeroed and four PNG frames are
    POSTed (two of one geometry, held so they form one batch, and two of
    other sizes, one odd); the counters are read right after and must
    show PATH_LAUNCHES and KXK_LAUNCHES per forward (the collapsed tail;
    LarvaNet: no conv_kxk). Every response must have the x4
    geometry; at least MIN_INSIDE of the plain-version forward's pixels
    must lie strictly inside (0, 255), so the clamp hides nothing. f32:
    the response must lie within 1 uint8 level of that forward, and the
    unclamped forward through the kernels within FWD_RTOL of it. bf16:
    the response within 1 level of the kernels' own forward, and that
    unclamped forward within BF16_FWD_RTOL of the plain bf16 forward (the
    same route, every conv3x3 and conv_kxk call in its plain version).
 4b. serve LarvaNet: the same for the flagship LarvaNet 2x16 (48 features,
    random weights from SEED as the family draws them, saved as the port
    module's state_dict): 67 conv3x3 launches per forward, 66 on the tensor
    cores and the head on the CUDA cores. The trunk adds little to the
    interpolated base, so the unclamped forward is held relative to the
    residual (the forward minus its base), not to the output.
 5. forward: times the whole x4 forward on the batch of 4 x 192x192 LR
    tiles, f32 and bf16 (CUDA events), on the collapsed tail through the
    conv3x3 and conv_kxk kernels and under --wino_trunk 2 and 4 (whose tail
    is baked too), to set the kernels' share against it. The counters are
    zeroed before one forward of each route and read after it: the
    default's PATH_LAUNCHES; under --wino_trunk 2 conv3x3 launches by path
    (WINO_CONV_PATH_LAUNCHES) and 16 fused launches, all 16 on the tensor
    cores (WINO_PATH_LAUNCHES); 4 conv_kxk launches (1 + 3 grouped) on every route; the
    bf16 forward must lie within BF16_FWD_RTOL of the same route with the
    plain fused ResBlock in place of the kernel. Each timed forward's
    device time is split by torch.profiler's kernel records: convs, fused
    ResBlocks, other kernels, idle (`breakdown_line`).
 5b. forward LarvaNet: the same for LARVANET_ROUTES, each route set up by
    the CLI's `maybe_wino_trunk`: LarvaNet 2x16 on the default route and
    under --wino_trunk 2 (JAX's notice, the same 67 direct launches, the
    same output bit for bit); LarvaNet_w64 2x16 (67 launches; under
    --wino_trunk 2 and 4, 3 conv3x3 and 32 fused launches, held within
    WINO_FWD_RTOL / BF16_FWD_RTOL of the plain fused ResBlock's route,
    relative to the residual); LarvaLeg --leg 1 (35 launches).
 6. validate: the port's validate CLI in this process on a DIV2K-layout
    set written by the port's PNG encoder (4 LR frames of even width and,
    for the standard path only, one of odd width), EDSR-baseline x4 as in
    phase 4, with --wino_trunk 0, 2 and 4, f32. The counters are zeroed
    before each run and read after: 34 conv3x3 launches per forward for
    0; 2 conv3x3 and 16 fused launches per forward for 2 and 4; 4 conv_kxk
    launches per forward on each; the probes of the tail (PROBE_LAUNCHES)
    once a run; the conv3x3 launches by path as phases 4 and 5 count them.
    The collapsed tail bakes the same kernel in every run. Each image's
    PSNR under 2 and 4 must lie within VALIDATE_PSNR_TOL of 0's,
    and the unclamped f32 forward through each fused kernel within
    WINO_FWD_RTOL of the conv3x3 forward.
 6b. validate LarvaNet_w64 2x16 on the same set, --wino_trunk 0, 2 and 4:
    67 conv3x3 launches per forward for 0; 3 conv3x3 and 32 fused for 2
    and 4; each image's PSNR under 2 and 4 within VALIDATE_PSNR_TOL of 0's.
 7. runtime: the port's runtime CLI at the DIV2K x4 LR size 339x510,
    --wino_trunk 0, 2 and 4 in f32 and bf16: ms per frame and LR-MP/s,
    and each run's launches by path (one narrow conv3x3 launch a forward);
    then LarvaNet 2x16, --wino_trunk 0 and 2 (67 launches a forward).
 8. train: EDSR-baseline x4 at full width trained through the kernels, f32,
    on the plain tail (--collapsed_tail_train 0; validate --collapsed_tail 0),
    batch 16 of 48x48 LR patches, on a DIV2K-layout set of 8 `photo` frames
    (LR 96x128) written by the port's PNG encoder. One batch's loss and
    gradients through the kernels are held against the same autograd
    Function with the plain versions inside (LOSS_RTOL; every parameter's
    gradient within GRAD_RTOL of its tensor's largest |g|). The counters are
    zeroed around one train step: 37 forward conv3x3 launches, 36 dgrad
    launches (conv3x3 on the rotated kernel) and 37 wgrad launches, by path
    (TRAIN_LAUNCHES). The step's median ms (CUDA events around train_step)
    and its device split (forward convs, dgrad convs, wgrad, optimizer and
    other kernels, idle). The train CLI for 20 steps (--save_freq 10), whose
    loss at step 20 must be below step 1's; again with --restore_path latest
    from step 10 to 20, whose losses must repeat the first run's bit for
    bit; validate on model_20.pth, whose frames must be the trained
    forward's. Then the wgrad kernel at each of the step's shapes
    (TRAIN_WGRAD), on its path and on its CUDA-core entries, and the conv
    kernel at the dgrad shapes no forward has (TRAIN_DGRAD), each against
    its plain version and timed in turns with it and cuDNN's gradient
    (conv2d_weight / conv2d_input, TF32 off).
 8b. train LarvaNet: the flagship LarvaNet 2x16 (1,414,656 parameters)
    trained at the JAX train_larva CLI's defaults (batch 16 of 48x48 LR
    patches, f32, AdamW at lr 4e-4) on phase 8's set: the multi-exit loss
    and its gradients held against the plain versions as in phase 8; one
    counted step (LARVA_TRAIN_LAUNCHES: 69 forward, 68 dgrad and 69 wgrad
    launches); the step's median ms and device split. train_larva for
    LARVA_TRAIN_STEPS steps with a --val_volume of LARVA_VAL_STEPS steps
    and LARVA_VAL_FRAMES validation frames, the schedule set to halve the
    lr at each validation after step 1's: validation at steps 1, 5 and 10,
    model_step5_vol0G.pth and model_step10_vol0G.pth with their state
    files; again with --restore_path latest from step 5, whose losses,
    validation PSNR and lr, schedule, volume and weights must repeat the
    first run's bit for bit. train_larvaV2 on LarvaNetV2 2x4 for V2_STEPS
    steps, its launches counted over the run (the tail's 96 -> 48 merge's
    wgrad and 48 -> 96 dgrad on the tensor cores). Then phase 8's kernel
    half at LarvaNet's shapes (LARVA_TRAIN_WGRAD: wgrad 3 -> 48, 48 -> 48,
    64 -> 48 and 96 -> 48 at 48x48; LARVA_TRAIN_DGRAD: the conv at 48 ->
    96).
 10. full frame: EDSR-baseline x4 (fitted as in phase 4) and LarvaNet
    2x16 (as in phase 4b), f32, on one 339x510 `photo` frame. 10a: the
    reference's chop-forward (eval/tiling.py, --chop_overlap_size 20: four
    quadrants of 179 or 180 x 265), counted (4 forwards' launches by path)
    and held within FWD_RTOL of the same function with the plain versions
    inside (LarvaNet: relative to the residual), with its PSNR against the
    direct forward. 10b: TiledUpscaler at each model's exact tiling
    (FULL_FRAME_MODELS: half the overlap past the receptive radius; one
    batch of 54 or 40 tiles) held within FWD_RTOL of the direct forward; at
    the CLIs' 128 / 24 its max |d| and PSNR against it; on an 8K output's
    1080x1920 LR frame (209 tiles in chunks of 64) its peak memory, and the
    chunks of 64 held against chunks of 16; each counted. 10c: the x8
    self-ensemble of the f32 module (the transposed 510x339 frame among
    its orientations), counted (8 forwards) and held against its plain
    version. Each path's ms per frame (timed in turns with the direct
    forward, f32 and bf16; the self-ensemble f32) and peak memory.
    EDSR serves on the collapsed tail (4 conv_kxk launches a forward, 3 of them grouped, none
    in the self-ensemble of the module); its exact tiling equals the
    direct forward, and the 8K frame's chunks of 64 those of 16, bit for
    bit. 10d:
    validate on phase 6's set with --chop_forward, --tile_forward (48 /
    16; also under --wino_trunk 2 and 4 on the even frames) and
    --self_ensemble, each image's PSNR within VALIDATE_PSNR_TOL of the
    same run with the plain versions, the launches counted; serve in chop
    and tile mode, two frames POSTed, each reply within 1 uint8 level of
    get_sr's frame of the same mode; test on SynSetReal and DIV2K_val
    trees of photo frames in the realistic fixture's geometry
    (`write_test_set`) with and without --chop_forward, its --report_json
    read back. 10e: a .pth whose .state.pt holds an average
    unlike its weights: validate --ema writes the average's frames bit for
    bit.
 11. int8 (W8A8): 11a holds conv3x3_s8's two entries (conv_a: hin quantized
    as it is staged, act, requantize; conv_b: int8 in, dequantize, residual)
    in bf16 and f32 at every pair shape (S8_SHAPES) on the 4 x 192x192 batch
    and the 339x510 frame against their plain version: 0 values may differ.
    Each is timed in turns, as a CUDA graph of one call replayed (its own
    time) and through its wrapper, with its plain version, torch._int_mm on
    the same im2col GEMM (the unfold not timed), the port's bf16 conv3x3
    kernel and F.conv2d bf16 at the shape, beside its bound at the dense
    INT8 peak. Then both entries at S8_WIDE (1280->64 on 1 x 48x48, past
    what one code halo holds: the chunked plan) in both dtypes, held the
    same way and timed (replay, wrapper, plain) beside the bound.
    11b: EDSR-baseline x4 (fitted as in phase 4) and LarvaNet 2x16, routed
    by the CLIs' maybe_int8_trunk, calibrated on photo frames, on the 4 x
    192x192 photo batch: one forward's launches (INT8_LAUNCHES), each pair's
    captured input through the kernel's pair and the plain pair (0 values
    differ), the forward's PSNR against the plain int8 forward with the same
    scales (>= INT8_FWD_PSNR_DB; LarvaNet relative to the residual) and
    against the exact bf16 forward, timed in turns with it. 11c: serve
    --int8_trunk 1 --int8_calib_path (four POSTs, each reply within 1 level
    of the kernels' own forward, the odd frame on the exact route), validate
    --int8_trunk 1 --int8_report on phase 6's set, runtime --int8_trunk 1 at
    339x510 (EDSR and LarvaNet), get_sr and test on phase 10d's trees, each
    counted. 11d: --qat 1 on EDSR-baseline x4 and LarvaNet 2x16, batch 16 of
    48x48: loss and gradients held as phase 8b holds them (same_forward),
    then QAT_STEPS steps of the train CLI and a resume that repeats the last
    loss bit for bit (EDSR on the plain tail, --collapsed_tail_train 0).
 13. train flags (after phase 11, before the closing lines), on phase 8's set:
    13a --train_dtype bf16 on EDSR-baseline x4 at batch 16 x 48x48: the
    wgrad wrapper on bf16 x and g at every TRAIN_WGRAD shape
    (conv3x3_wgrad_bf16_tc on the tensor-core shapes) held against its
    plain version (GRAD_RTOL) and timed in turns with conv2d_weight in bf16,
    the f32 entry and the plain version, beside its bound at the bf16 peak;
    one bf16 step's loss and gradients against the plain dgrad and wgrad on
    the kernels' forward (BF16_TRAIN_LOSS_RTOL / BF16_TRAIN_GRAD_RTOL); one
    counted step (TRAIN_LAUNCHES, and BF16_WGRAD_LAUNCHES of the wgrad's
    bf16 calls); the bf16 and the f32 step timed and split in the same
    call; the train CLI for TRAIN_STEPS steps in bf16 with a bit-exact
    resume from the middle. 13b --remat 1: EDSR-baseline x4 and LarvaNet
    2x16 at batch 16 x REMAT_LR^2: loss and gradients equal --remat 0's bit
    for bit, the recomputed forwards counted (REMAT_EXTRA_FORWARDS), the
    peak memory of a step under both. 13c --device_pipeline DP_CHUNK: the
    MB resident, a counted chunk (DP_CHUNK steps' launches), ChunkRateMeter's
    steps/s, a chunk's and a host-loop step's idle share; train and
    train_larva (LarvaNet 2x16) for DP_STEPS steps with a bit-exact resume.
    13d --async_checkpoint 1: the files equal a synchronous save's tensors
    bit for bit. 13e --profile_dir: trace.json names the conv3x3 and wgrad
    kernels. 13f --widen_from: LarvaNet 2x16 widened into LarvaNet_w64 2x16
    computes the narrow forward within FWD_RTOL of its residual.
 14. the collapsed tail (after phase 13). 14a: conv_kxk at every shape of
    KXK_SHAPES (the main 5x5 conv of the x4, x2, x3 tails, their border
    operators, the x4 corners, the collapsed base's 3 -> 48 convs, the
    live tail's 48 -> 64 input gradient) on the 4 x 192x192 batch, the
    main conv at 339x510, and the border groups of KXK_GROUPS (the x4
    tail's as the forward launches them, the bicubic base's on the CUDA
    cores), f32 and bf16, each on its path, held against its plain version
    and timed in turns with it and F.conv2d (CUDA graph replays of one
    call, and the wrapper as issued) beside its bound; conv_kxk_wgrad at
    each shape of KXK_WGRAD (the live tail's 5x5 64 -> 48 on the tensor
    cores, the bicubic base's 5x5 3 -> 48 on the CUDA cores), batch 16 x
    48x48, the same way with conv2d_weight, two runs bit for bit;
    EDSR-baseline x2, x3 and x4 probed on the card:
    radius 2. 14b: EDSR-baseline x4 (fitted) on the collapsed route, f32
    and bf16, counted, held against the same route with the plain
    versions and against the plain tail's forward (COLLAPSED_PSNR_DB) and its probed
    kernel against the composed one (PROBE_STEPS), the
    forwards and the tails alone timed against the plain tail's with their
    device split; the --wino_trunk 2 and int8 forwards on the baked tail,
    counted and held. 14c: one EDSR-baseline x4 train step on the default
    route (the live collapsed tail, the loss before the shuffle): loss and
    gradients against the plain versions, counted (TRAIN_COLLAPSED_LAUNCHES,
    TRAIN_COLLAPSED_KXK), timed with its split against
    --collapsed_tail_train 0's; the train CLI for TRAIN_STEPS steps and a
    resume from the middle, bit for bit.
 15. the MSRR family (after phase 14), x4 at full width, random weights
    from SEED. 15a: dwconv3x3 (the depthwise kernel) at dwsr_reduced's 48
    channels on the 4 x 192x192 batch and a 339x510 frame and at MAMNet's
    CSD 64, f32 (TF32 off) and bf16, bit for bit with its plain version;
    its input gradient (the same entry, the taps rotated) bit for bit and
    dwconv3x3_wgrad within GRAD_RTOL, two runs bit for bit, at batch 16 x
    48x48; the tile each entry takes at each shape printed; each timed in
    turns as a CUDA graph replay (of the entry alone: its taps cast
    beforehand), through the wrapper, beside its plain version and F.conv2d
    / conv2d_input / conv2d_weight with groups = C (replayed) and its
    bound. 15b: conv3x3 with relu6 and
    leaky_relu(0.2) on the tensor-core (48 -> 48), CUDA-core (3 -> 48) and
    narrow (48 -> 3) paths against the plain version, each call on its
    path; conv3x3_s8's conv_a with both, bit for bit. 15c: msrr_reduced
    served through the HTTP server in f32 and bf16 (phase 4's checks, 65
    conv3x3 launches a forward); msrr_reduced, dwsr_reduced (1 conv3x3 + 64
    dwconv3x3 a forward), msrr and msrr_test (37 conv3x3, their last conv
    scaled by fit_residual) on the 4 x 192x192 batch in f32 and bf16:
    counted, held against the plain versions relative to the residual over
    the base, timed with their device split; msrr_reduced's int8 forward
    (64 s8 launches), held by PSNR, timed. 15d: msrr_reduced,
    msrr_reduced_relu6 and dwsr_reduced train steps at batch 16 x 48x48
    f32: loss and gradients against the plain dgrad and wgrad, counted
    (MSRR_TRAIN), timed; msrr_reduced through train_larva and the other two
    through train for MSRR_CLI_STEPS steps. 15e: test on msrr_test in its
    [0, 1] range on a SynSetReal tree, counted, the per-image PSNR printed.
 16. TreeNet and the REGOs (after phase 15), x4 at full width, random
    weights from SEED, each model's residual over its base fitted to a std
    of 30 (fit_branchy). 16a: conv3x3 at the shapes they bring
    (BRANCHY_CONVS: REGO's RESBlock conv1 64 -> 64 with leaky_relu(0.1),
    SRrecon 384 -> 48 and REGO-serial's merge 384 -> 64 over six channel
    chunks, TreeNet's head 3 -> 48 with leaky_relu(0.1)) at 4 x 192x192 and
    339x510, f32 and bf16, as phase 3 (the f32 bar scaled with the products
    summed, as 14a's); the 384-channel weight gradients (f32, and the bf16
    entry) and the 48 -> 384 / 64 -> 384 input gradients at 16 x 48x48, as
    phase 8's kernel half, against conv2d_weight / conv2d_input; REGO's
    s8 pair at 64 -> 64 (conv_a with leaky_relu(0.1), conv_b without a
    residual at res_weight 1 and 0.1) bit for bit, graph replays. 16b:
    TreeNet in f32 and REGO-Net in f32 and bf16 served through the HTTP
    server (phase 4's checks; 33 and 32 conv3x3 launches a forward); the x4
    forwards of TreeNet, REGO-Net and REGO-serial --num_regos 2 (63
    launches) on the 4 x 192x192 batch in f32 and bf16: counted, held
    against the plain versions relative to the residual, timed with their
    device split. 16c: TreeNet's and REGO-Net's --int8_trunk route (the
    CLIs' maybe_int8_trunk): 32 s8 + 1 conv3x3 and 30 s8 + 2 conv3x3 a
    forward, held to 11b's bar, timed. 16d: TreeNet --num_branches 2 and
    REGO-Net train steps at batch 16 x 48x48 f32 (gradients against the
    plain dgrad and wgrad, counted: 49 / 48 / 49 and 32 / 31 / 32 launches,
    timed with the split); train_larva on TreeNet (StepLR, model_<step>
    checkpoints) and train on REGO-Net for BRANCHY_CLI_STEPS steps;
    REGO-serial --num_regos 2 with --qat 1 (a counted step) and with
    --remat 1 --lr_domain_loss 1 (bit for bit with --remat 0, 60
    recomputed convs). 16e: validate_tree --pipeline_depth 1 and 2 (equal
    PSNRs) and state_dict_tree on phase 6's set, counted.
 17. The EBRN and HRSR families (after phase 16), x4 at full width, random
    weights from SEED, each residual over its base (the bilinear base, or
    ebrn's and ebrn_rm's inverse mean shift, the output then centred at
    mid-grey) fitted to a std of 30 (fit_sr_residual). 17a: conv3x3 at the
    shapes they bring, as phase 3 with 14a's scaled f32 bar: full EBRN's
    (EBRN_CONVS at one 192x192 LR tile, EBRN_LR: fe0 3 -> 256 and recon 640
    -> 3 on the CUDA cores, fe1 256 -> 64, the 64 -> 64 convs at the LR and
    HR size), ebrn_rm's upsample 640 -> 48 (ten channel chunks) and hrsr's
    3-channel HR convs at 4 x 192x192; the recon's 640 -> 3 weight gradient
    (narrow) and fe0's 3 -> 256 (CUDA cores), the 3 -> 640 and 48 -> 640
    input gradients at 16 x 48x48, as phase 8's kernel half; ebrn_rm's s8
    pair (conv_a with leaky_relu(0.05), conv_b without a residual) bit for
    bit, graph replays. 17b: ebrn_rm in f32 and bf16, ebrn, hrsr and
    hrsr_c3 in f32 served through the HTTP server (phase 4's checks); the
    forwards of ebrn_rm, hrsr and hrsr_c3 on the 4 x 192x192 batch in f32
    and bf16 and of full EBRN at EBRN_LR in f32 (it serves its f32 module
    under --serving_dtype bf16, as JAX does): counted (SR_MODELS: 31, 70,
    18, 65 conv3x3 launches), held against the plain versions relative to
    the residual, timed with their device split, full EBRN's 19 library
    projections replayed apart (projection_ms). 17c: the --int8_trunk route
    of ebrn_rm (20 s8 + 11 conv3x3), hrsr (8 + 10) and hrsr_c3 (64 + 1),
    held to 11b's bar, timed. 17d: ebrn_rm (its LR-domain route), full EBRN
    and hrsr_c3 --qat 1 train steps at batch 16 x 48x48 f32 (gradients
    against the plain dgrad and wgrad, counted: SR_TRAIN, timed with the
    split); train on ebrn_rm for SR_CLI_STEPS steps; train_schedule on hrsr
    (an epoch of one step, validation every 2: the plateau steps at 2, 4 and
    6 and halves the lr at 6), resumed from its step-2 checkpoint to the
    same validations and weights, bit for bit. 17e: validate (hrsr),
    get_sr (ebrn_rm), test (hrsr_c3) and runtime (full EBRN at 339x510),
    counted.
 18. MAMNet and IMDN (after phase 17), x4 at full width (64 features, 16
    MAMBlocks; 64 filters, 8 IMDBlocks), random weights from SEED, each
    residual over the inverse mean shift fitted by fit_sr_residual. 18a:
    IMDN's new conv3x3 shapes at leaky_relu(0.05) (IMDN_CONVS: 48 -> 64, 48
    -> 16, the upsample conv 64 -> 48 on the tensor cores and x3's 64 -> 27
    on the CUDA cores), as phase 3 with 14a's scaled f32 bar; its 48 -> 16
    and 48 -> 64 weight gradients and conv4's 16 -> 48 input gradient at 16
    x 48x48, as phase 8's kernel half; MAMNet's s8 pair (conv_a with relu,
    conv_b without a residual) bit for bit, graph replays (MAMNet's CSD,
    dwconv3x3 at C = 64, is 15a's). 18b: both served through the HTTP
    server in f32 and bf16 (phase 4's checks; MAMNet on the collapsed tail:
    34 conv3x3 + 4 conv_kxk a forward; IMDN 35); the forwards on the 4 x
    192x192 batch in f32 and bf16 on the CLIs' default route: counted
    (MI_MODELS; MAMNet's 16 dwconv3x3 launches, IMDN's 24 slice copies),
    held against the plain versions relative to the residual, timed with
    their device split; MAMNet's module graph (--packed_trunk 0, 37
    conv3x3) counted and held; MAMNet's --int8_trunk route (32 s8 + 2
    conv3x3 + 4 conv_kxk + 16 dwconv3x3) held to 11b's bar, timed; IMDN's
    slice copy timed beside its bound. 18c: one train step of each at batch
    16 x 48x48 f32 (MAMNet on its default route, the live collapsed tail
    and the loss before the shuffle): gradients against the plain dgrad and
    wgrad, counted (MI_TRAIN), timed with the split. 18d: validate and
    test (MAMNet; its tail probed inside the run), get_sr (IMDN), runtime
    (MAMNet at 339x510), train (IMDN, 2 steps, a checkpoint each) and
    psnr_trend over those two checkpoints, counted.
 19. Serving artifacts and the full-frame forwards (after phase 18). 19a:
    five artifacts exported on the card at 4 x 192x192 (utils/aot.py:
    EDSR-baseline x4 f32 and bf16 on the collapsed tail, EDSR with
    --int8_trunk in bf16, LarvaNet 2x16 bf16, MAMNet x4 f32), saved, loaded
    back onto the card (without the model zoo's help: the program carries
    its kernels as the registered ops of ops/library.py); each artifact's
    forward and its live route's counted (every kernel's launches, by path
    or entry, must be equal) and held bit for bit (max |d| 0), timed in
    turns with the device split; export s, MB and load s printed. 19b:
    `serve --artifact` of the EDSR f32 artifact in two fresh processes
    (direct: 8 requests at the exported geometry; --tile_forward: 2 on the
    339x510 frame), their pixels equal to the live server's, /info showing
    the artifact mode and no model zoo in sys.modules. 19c: validate
    --artifact --tile_forward within 1e-4 dB of validate --restore_path
    --tile_forward at the same tiles. 19d: the strip-batched and tile-scan
    forwards of EDSR bf16 on the 1080x1920 frame (halo 40 >= the receptive
    radius 36) equal to the direct frame, timed with peak memory beside
    TiledUpscaler's tiles and the chop. 19e: the 2-D Winograd EDSR forward
    (ops/winograd.py) in f32 against the module at JAX's bar.
 11b. Phase 20 (`parallel_phase`), each mesh's devices printed. 20a:
    EDSR-baseline x4 at full width on one 540x960 LR frame, its rows split
    4 ways (parallel/halo.py): at halo = the measured receptive radius (36)
    the f32 sharded forward against the full frame (FWD_RTOL) and bf16
    against the sharded plain convs (BF16_FWD_RTOL); at the default halo 32
    both against the sharded plain convs; 4 x 37 conv3x3 launches a sharded
    forward; sharded and full frame timed in turns. 20b: a 2-way
    use_data_parallel_eval of the collapsed route and of the int8 route,
    bit for bit with the single-device forward (34 conv3x3 + 4 conv_kxk, or
    32 s8, a shard); validate --tile_forward --dp_devices 2 and serve
    --dp_devices 2 (4 direct requests) frame for frame against the same
    CLIs without it. 20c: one 2-way data-parallel step of EDSR-baseline x4
    and of LarvaNet 2x16 against the single-device step (loss 1e-5,
    gradients GRAD_RTOL, parameters 2 lr), twice the step's launches. 20d:
    NCCL at world size 1 carrying 20c's EDSR step's all-reduce (two
    processes, one card each, on a machine of 2 cards or more). 20e:
    make_tp_spatial_forward on a 2 x 2 mesh, a 4-conv stack at C = 64,
    against the plain convs, each shard's conv path counted. 20f: the train
    CLI with --dp_devices 2 --orbax_checkpoint 1, sync and async: the resume
    from a directory repeats the run, the restored directory's forward
    equals the trained one.
 12. (last) prints the kernels JSON line, the nvidia-smi line, then the
    result line {"ok": true, "device": {...}}.

The kernels line reports, per kernel: its launches on the main paths that
run it, also by path (conv3x3: the served forwards of phases 4 and 4b,
f32 and bf16; the wino kernels: the counted forwards of phases 5 and 5b,
f32 and bf16, the validate runs of phases 6 and 6b and the runtime runs of
phase 7 with their --wino_trunk); summed over one x4 forward of the 4 x 192x192 f32 batch
(the 37 convs; the 16 ResBlocks), its time, its plain version's, the
library's (F.conv2d; the cuDNN ResBlock) and its bound; and the largest
f32 error of phase 3 or 3b, with the CUDA-core entries' sums beside them.
Each also gives the same sums in bf16; the conv3x3 line adds the sums
of its 35 tensor-core convs per dtype with their served launches (f32:
the split-TF32 entry), the narrow path's final_conv times in both
dtypes and geometries, and the sums over one LarvaNet 2x16 forward (its 67
convs) per dtype with their served launches.
The conv3x3 line's launches add phase 8's and 8b's counted train steps and
8b's train_larvaV2 run (their forward and dgrad launches, by path, and the
dgrad shapes' times under "train_step" and "larvanet_train"); the
conv3x3_wgrad line gives the same runs' wgrad launches by path, its times
summed over phase 8's step's 37 wgrads, with the CUDA-core entries' sum
beside them, and under "larvanet_train" the sums over one LarvaNet 2x16
step's 69 wgrads and each 48-channel shape's numbers. Phase 10's counted
runs add their launches to conv3x3's and the wino kernels' totals, and
give them by path under "full_frame". The conv3x3_s8 line gives its
launches by entry over phases 11b and 11c, the sums over one EDSR-baseline
int8 forward's 16 pairs at 4 x 192x192 (bf16, and f32 under "f32") with
their bound and yardsticks (library_ms is null: no PyTorch call computes
an int8 conv on CUDA), every shape's row of phase 11a, and under "wide"
11a's 1280->64 (the chunked plan; its launches are the phase's checks,
outside every model's path). The conv3x3 and conv3x3_wgrad lines add phase
13's counted bf16 step and device-pipeline chunk to their launches; the
conv3x3_wgrad line's "bf16" gives the bf16 step's wgrad sums (13a) with
the bf16 launches by path of its counted step. The conv_kxk line gives its
launches over the counted collapsed forwards of phases 4 to 14 and 14c's
train step (forward and input gradient), its sums over one collapsed x4
forward's 4 launches at 4 x 192x192 (f32; bf16 beside), every shape's row,
the probed radii and 14b's forward and tail times; the conv_kxk_wgrad line
the 5x5 64 -> 48 weight gradient's numbers and 14c's launch, with the
CUDA-core entry's 3 -> 48 under "cuda_core". conv_kxk's
launches count the grouped ones as "group_<path>", its sums are over a
forward's 4 launches (the main conv and 3 border groups), and both lines'
"ms" are CUDA graph replays of one call ("wrapper_ms" beside). The conv3x3
lines add 14c's counted step. Phase 15's counted runs add to the conv3x3
line (by path, under "msrr" with the new epilogues' errors and the
family's forward and step times), the conv3x3_wgrad line (15d's steps) and
the conv3x3_s8 line (15c's int8 forward); the dwconv3x3 line gives its
launches by entry ("forward", and "dgrad": the same entry as the input
gradient) over 15c and 15d, the call at dwsr_reduced x4's 4 x 192x192 x 48
(f32; bf16 beside, the dgrad at 16 x 48x48 under "dgrad") and every shape's
row; the dwconv3x3_wgrad line the weight gradient at 16 x 48x48 x 48 and
15d's launches. Phase 16's counted runs add to the conv3x3 line (by path,
and under "branchy_launches_by_path"; 16a's new shapes under "branchy",
the input gradients under "branchy_dgrad", the forwards' and steps' ms),
the conv3x3_wgrad line (16d's steps; the 384-channel shapes under
"branchy") and the conv3x3_s8 line (16c's forwards, their ms under
"branchy_int8_ms"). Phase 17's do the same under "ebrn_hrsr" (its new
conv shapes per model and dtype), "ebrn_hrsr_launches_by_path",
"ebrn_hrsr_dgrad", "ebrn_hrsr_forward_ms" and "ebrn_hrsr_train_step_ms"
in the conv3x3 line, "ebrn_hrsr" (the 640 -> 3 and 3 -> 256 shapes) in the
conv3x3_wgrad line, "ebrn_hrsr" (ebrn_rm's pair) and "ebrn_hrsr_int8_ms"
in the conv3x3_s8 line. Phase 18's do the same under "mamnet_imdn" (IMDN's
shapes), "mamnet_imdn_launches_by_path", "mamnet_imdn_dgrad",
"mamnet_imdn_forward_ms" and "mamnet_imdn_train_step_ms" in the conv3x3
line, "mamnet_imdn" in the conv3x3_wgrad line, "mamnet" (MAMNet's pair)
and "mamnet_int8_ms" in the conv3x3_s8 line; its MAMNet forwards and step
add to the dwconv3x3 lines (by entry under "mamnet_launches_by_entry") and
its collapsed forwards and step to the conv_kxk lines. Phase 19a's counted
forwards (each artifact's and its live route's) add to the conv3x3,
conv3x3_s8, conv_kxk and dwconv3x3 lines, which give them under
"artifact_launches"; the conv3x3 line gives phase 19's numbers under
"artifact". Phase 20's counted forwards add to the conv3x3 line (by path
under "parallel_launches", each part's times under "parallel"), its dp
steps to the conv3x3 and conv3x3_wgrad lines' train runs, its dp int8
forwards to the conv3x3_s8 line ("parallel_launches") and its collapsed
dp forwards to the conv_kxk line.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from unittest import mock

SEED = 0
WARMUP_REPS = 2
TIMED_REPS = 10
# timing windows of TIMED_REPS calls; a time is their median (3 windows keep
# the whole script, phase 20 included, well inside its clock)
WINDOWS = 3
# f32: the kernel and the plain version sum the same f32 products in another
# order; tools/pallas_check.py holds the TPU kernel to the same bar. The
# tensor-core entry's split-TF32 products drop a_lo b_lo, ~2^-22 of each
# product, below that order's own rounding; one TF32 product (~2^-11 of
# each) would miss the bar by an order of magnitude at C = 64.
F32_ATOL = 2e-4
# bf16: both see the same bf16 inputs and sum in f32, so the outputs differ by
# at most one bf16 rounding step of the value: 2^-7 relative, plus a floor for
# values near 0.
BF16_RTOL = 2.0 ** -7
BF16_ATOL = 1e-3
# fused Winograd ResBlock against its plain version, f32: the two sum the
# same f32 products in another order, as the conv does (F32_ATOL); F(4,3)'s
# B^T and A^T entries (up to 5 and 8) amplify that rounding, and the JAX
# package holds it to 5x the F(2,3) bar (tests/test_wino_pallas.py, 5e-4
# against 1e-4).
WINO_F32_ATOL = {2: F32_ATOL, 4: 5 * F32_ATOL}
# bf16, normwise: both round the point-product operands to bf16 from f32
# transforms summed in another order (the kernel contracts to FMA), so an
# operand next to a rounding boundary lands on neighbouring bf16 values,
# and A^T spreads that step over m output rows. Bar: two bf16 steps of the
# largest output.
WINO_BF16_RTOL = 2.0 ** -6
# the whole f32 forward, kernels against plain versions: 37 convs of
# errors like F32_ATOL's, relative to the largest output value
FWD_RTOL = 1e-4
# the whole bf16 forward, kernels against plain versions, normwise. Both
# forwards see the same bf16 operands at every conv and differ only in the
# order of each conv's f32 sums, so a conv's output moves by one bf16 step
# (2^-7 of its value at most) where its sum lies within that order's
# rounding (~1e-6 relative) of a rounding boundary: rare, but each such
# step is carried on by every later conv and the residual adds, and the
# last conv's output, the image, is itself bf16 (a step is 2^-8 to 2^-7 of
# the largest value). Bar: four bf16 steps of the largest output, 2^-5,
# twice the fused ResBlock's bar (WINO_BF16_RTOL) for a forward that
# rounds 37 times in a row.
BF16_FWD_RTOL = 2.0 ** -5
# conv3x3 launches per x4 forward by path (ops/conv3x3.py path_for) on the
# default route, the collapsed tail (the inference CLIs' --collapsed_tail
# 1), the same in both dtypes: first_conv (C = 3) on the CUDA cores, the 32
# trunk convs and after_res_conv on the tensor cores (f32 in split TF32);
# the tail runs on conv_kxk (KXK_LAUNCHES)
PATH_LAUNCHES = {"f32": {"cuda_core": 1, "tensor_core": 33, "narrow": 0},
                 "bf16": {"cuda_core": 1, "tensor_core": 33, "narrow": 0}}
# the module's own tail (--collapsed_tail 0, the x8 self-ensemble of the f32
# module, the probes' original tail): 37 convs, final_conv (64 -> 3) on the
# narrow path, the two upsample convs on the tensor cores
PLAIN_PATH_LAUNCHES = {"f32": {"cuda_core": 1, "tensor_core": 35, "narrow": 1},
                       "bf16": {"cuda_core": 1, "tensor_core": 35, "narrow": 1}}
# conv_kxk launches per x4 forward on the collapsed tail (ops/conv_kxk.py
# path_for), single and grouped ("group_" + path): the 5x5 64 -> 48 conv,
# then 3 grouped launches (top + bottom, left + right, the 4 corners), all
# of C = 64 on the tensor cores; NO_KXK: a route without the collapsed tail
KXK_LAUNCHES = {"cuda_core": 0, "tensor_core": 1, "group_cuda_core": 0, "group_tensor_core": 3}
NO_KXK = dict.fromkeys(KXK_LAUNCHES, 0)
# the conv3x3 launches of probing one EDSR-baseline x4 tail
# (ops/collapsed_tail.collapsed_edsr_tail: 9 calls of the original tail,
# whose 64 -> 256 convs take the tensor cores and final_conv the narrow
# path), where a CLI makes the route inside a counted run
PROBE_LAUNCHES = {"cuda_core": 0, "tensor_core": 18, "narrow": 9}
# the same for the 2 convs around the fused ResBlocks under --wino_trunk,
# whose tail is baked as JAX's is: first_conv, after_res_conv
WINO_CONV_PATH_LAUNCHES = {"f32": {"cuda_core": 1, "tensor_core": 1, "narrow": 0},
                           "bf16": {"cuda_core": 1, "tensor_core": 1, "narrow": 0}}
# fused ResBlock launches per x4 forward under --wino_trunk, by path
# (ops/wino_resblock.py path_for): both dtypes on the tensor cores (f32 in
# split TF32); the 5 convs around them go through conv3x3
WINO_PATH_LAUNCHES = {"f32": {"cuda_core": 0, "tensor_core": 16},
                      "bf16": {"cuda_core": 0, "tensor_core": 16}}
# the whole f32 forward through the wino kernels against the forward through
# the conv3x3 kernel: 16 ResBlocks whose Winograd and direct sums differ by
# errors like WINO_F32_ATOL's; the same relative bar as FWD_RTOL
WINO_FWD_RTOL = FWD_RTOL
# per-image PSNR of --wino_trunk 2|4 against --wino_trunk 0: the JAX CLI
# test's bar (tests/test_wino_cli.py). The two f32 forwards differ by ~1e-6
# of the output range, which rounds a pixel to another uint8 level with a
# probability near 1e-4 and moves a PSNR near 15 dB by ~1e-5 dB.
VALIDATE_PSNR_TOL = 1e-3
# validate's LR frames (even widths), and the odd-width frame that only the
# standard path scores (--wino_trunk needs an even width, as in JAX)
VALIDATE_LR = ((120, 160), (96, 128), (64, 96), (48, 64))
VALIDATE_ODD_LR = (67, 93)
# share of served pixels strictly inside (0, 255)
MIN_INSIDE = 0.9
# H100 SXM peaks (NVIDIA data sheet), HBM3 bandwidth. A bound takes the
# card's fastest f32-accurate rate for the dtype, whatever units a kernel's
# path happens to run on. bf16: the dense tensor cores, 989 TF/s. f32: the
# tensor cores' 495 TF/s of TF32 over the three TF32 products (split TF32)
# that one f32-accurate product takes, 165 TF/s, above the CUDA cores' 67.
PEAK_FLOPS = {"f32": 495e12 / 3, "bf16": 989e12, "s8": 1979e12}
PEAK_BYTES = 3.35e12
LR_BATCH = (4, 192, 192)
RAGGED = (1, 339, 510)
# (name, LR-size multiple of the conv's input, C, F, act, launches per x4
# forward, the conv3x3 path it takes in both dtypes)
X4_CONVS = (
    ("first_conv", 1, 3, 64, None, 1, "cuda_core"),
    ("res_block.body.0", 1, 64, 64, "relu", 16, "tensor_core"),
    ("res_block.body.2+after_res_conv", 1, 64, 64, None, 17, "tensor_core"),
    ("upsample.body.0", 1, 64, 256, None, 1, "tensor_core"),
    ("upsample.body.2", 2, 64, 256, None, 1, "tensor_core"),
    ("final_conv", 4, 64, 3, None, 1, "narrow"),
)
# the flagship LarvaNet: 2 modules of 16 ResBlocks, 48 features, x4
LARVANET_FLAGS = ["--num_modules", "2", "--num_blocks", "16,16"]
LARVANET_PARAMS = {"LarvaNet": 1414656, "LarvaNet_w64": 2494432}
# LarvaNet's conv shapes, all at the LR size, as X4_CONVS; launches per
# LarvaNet 2x16 forward: the head, 32 ResBlocks and the last leg's two convs
LARVANET_CONVS = (
    ("head.feature_extraction", 1, 3, 48, None, 1, "cuda_core"),
    ("res_blocks.body.0+leg.recon_block.0", 1, 48, 48, "relu", 33, "tensor_core"),
    ("res_blocks.body.2+leg.recon_block.2", 1, 48, 48, None, 33, "tensor_core"),
    ("w64 leg.recon_block.2", 1, 64, 48, None, 0, "tensor_core"),
    ("V2 tail.merge_conv", 1, 96, 48, None, 0, "tensor_core"),
)
# phase 8, training: EDSR-baseline x4 at the JAX train CLI's defaults (batch
# 16 of 48x48 LR patches, f32) on a DIV2K-layout set of TRAIN_FRAMES frames
# of TRAIN_LR, TRAIN_STEPS steps at the default learning rate, 1e-4 (from
# random weights the loss falls to about a quarter within them)
TRAIN_BATCH = 16
TRAIN_PATCH = 48
TRAIN_FRAMES = 8
TRAIN_LR = (96, 128)
TRAIN_STEPS = 20
# the train step through the kernels against the same step with the plain
# versions: the loss, relative; each parameter's gradient relative to its
# tensor's largest |g| (split-TF32 forwards and dgrads and f32 sums in
# another order, ~1e-5 of each conv's outputs; element-wise bars would not
# hold where an L1 gradient's sign flips inside that rounding). The wgrad
# kernel alone, and the conv kernel at the dgrad shapes, are held to the
# same gradient bar.
LOSS_RTOL = 1e-5
GRAD_RTOL = 2e-4
# the weight-gradient shapes of one train step: (name, multiple of the LR
# patch size, C, F, launches a step)
TRAIN_WGRAD = (
    ("first_conv", 1, 3, 64, 1),
    ("trunk+after_res", 1, 64, 64, 33),
    ("upsample.body.0", 1, 64, 256, 1),
    ("upsample.body.2", 2, 64, 256, 1),
    ("final_conv", 4, 64, 3, 1),
)
# the input-gradient convs no forward has: (name, size multiple, C of the
# output gradient, F = the forward's input channels); the trunk's 64 -> 64
# dgrad is the forward's shape
TRAIN_DGRAD = (
    ("upsample.body.0", 1, 256, 64),
    ("upsample.body.2", 2, 256, 64),
    ("final_conv", 4, 3, 64),
)
# launches of one train step by path: the 37 forward convs as a served
# forward takes them; 36 dgrads (none for first_conv, whose input needs no
# gradient): the 256 -> 64 and 64 -> 64 ones on the tensor cores,
# final_conv's 3 -> 64 on the CUDA cores; 37 wgrads (ops/conv3x3_wgrad.py
# path_for): the 35 64 -> 64 and 64 -> 256 on the tensor cores,
# final_conv's 64 -> 3 narrow, first_conv's 3 -> 64 on the CUDA cores
TRAIN_LAUNCHES = {"forward": {"cuda_core": 1, "tensor_core": 35, "narrow": 1},
                  "dgrad": {"cuda_core": 1, "tensor_core": 35, "narrow": 0},
                  "wgrad": {"tensor_core": 35, "narrow": 1, "cuda_core": 1}}
# phase 8b, training the flagship LarvaNet 2x16 at the JAX train_larva CLI's
# defaults (batch 16 of 48x48 LR patches, f32, AdamW at lr 4e-4) on phase
# 8's set. Launches of one step by path: 69 forward convs (the head's 3 -> 48
# on the CUDA cores, the 64 trunk and 4 leg convs, all 48 -> 48, on the
# tensor cores); 68 dgrads (none for the head); 69 wgrads (the 68 48 -> 48 on
# the tensor cores, the head's on the CUDA cores)
LARVA_TRAIN_LAUNCHES = {"forward": {"cuda_core": 1, "tensor_core": 68, "narrow": 0},
                        "dgrad": {"cuda_core": 0, "tensor_core": 68, "narrow": 0},
                        "wgrad": {"tensor_core": 68, "narrow": 0, "cuda_core": 1}}
# train_larva: LARVA_TRAIN_STEPS steps, a --val_volume of LARVA_VAL_STEPS
# steps, validation on LARVA_VAL_FRAMES frames of TRAIN_LR; --patience 0
# --cooldown 0 and a threshold no validation of the run beats, so that each
# validation after step 1's halves the lr and the resume has a schedule to
# repeat
LARVA_TRAIN_STEPS = 10
LARVA_VAL_STEPS = 5
LARVA_VAL_FRAMES = 2
LARVA_SCHEDULE = ["--patience", "0", "--cooldown", "0", "--threshold", "100"]
# train_larvaV2 on LarvaNetV2 2x4 for V2_STEPS steps, validated once (step
# 1) on the same frames. A step: 24 forward convs (head, 16 trunk, 4 leg, the
# tail's 96 -> 48 merge and its 2 recon convs), 23 dgrads (the merge's as 48
# -> 96) and 24 wgrads (the merge's 96 -> 48 among the tensor-core ones); a
# validation forward exits through the tail and runs no leg: 20 convs.
V2_FLAGS = ["--num_modules", "2", "--num_blocks", "4,4"]
V2_STEPS = 3
V2_STEP_LAUNCHES = {"forward": {"cuda_core": 1, "tensor_core": 23, "narrow": 0},
                    "dgrad": {"cuda_core": 0, "tensor_core": 23, "narrow": 0},
                    "wgrad": {"tensor_core": 23, "narrow": 0, "cuda_core": 1}}
V2_VAL_FORWARD = {"cuda_core": 1, "tensor_core": 19, "narrow": 0}
# the weight-gradient shapes of LarvaNet's training at 48x48 LR, batch 16,
# with their launches per flagship step, and the input-gradient shape no
# forward has (V2's merge, 48 -> 96)
LARVA_TRAIN_WGRAD = (
    ("head", 1, 3, 48, 1),
    ("trunk+legs 48->48", 1, 48, 48, 68),
    ("w64 leg.recon_block.2", 1, 64, 48, 0),
    ("V2 tail.merge_conv", 1, 96, 48, 0),
)
LARVA_TRAIN_DGRAD = (("V2 tail.merge_conv", 1, 48, 96),)
# conv3x3 launches per forward by shape (C, F, act), and fused ResBlock
# launches per forward, of each LarvaNet configuration and --wino_trunk
# route that the LarvaNet phases drive. A 48-channel trunk takes the direct
# convs under --wino_trunk as on the default route (JAX's notice); the
# 64-channel LarvaNet_w64 trunk takes 32 fused launches, and its head and
# leg the direct convs.
_LARVA48 = {(3, 48, None): 1, (48, 48, "relu"): 33, (48, 48, None): 33}
_W64 = {(3, 64, None): 1, (64, 64, "relu"): 33, (64, 64, None): 32, (64, 48, None): 1}
_W64_WINO = {(3, 64, None): 1, (64, 64, "relu"): 1, (64, 48, None): 1}
LARVANET_ROUTES = {
    "LarvaNet 2x16": ("LarvaNet", LARVANET_FLAGS, {0: (_LARVA48, 0), 2: (_LARVA48, 0)}),
    "LarvaNet_w64 2x16": ("LarvaNet_w64", LARVANET_FLAGS,
                          {0: (_W64, 0), 2: (_W64_WINO, 32), 4: (_W64_WINO, 32)}),
    "LarvaLeg 2x16 --leg 1": ("LarvaLeg", LARVANET_FLAGS + ["--leg", "1"], {0: (
        {(3, 48, None): 1, (48, 48, "relu"): 17, (48, 48, None): 17}, 0)}),
}
# the path of every conv shape above (ops/conv3x3.py path_for, both dtypes)
SHAPE_PATH = {(c, f, act): path for _, _, c, f, act, _, path in X4_CONVS + LARVANET_CONVS}


def conv_path_launches(shapes):
    """conv3x3 launches by path of one forward with `shapes` {(C, F, act): n}."""
    out = {"cuda_core": 0, "tensor_core": 0, "narrow": 0}
    for shape, n in shapes.items():
        out[SHAPE_PATH[shape]] += n
    return out


def fused_path_launches(n):
    """Fused ResBlock launches by path of one forward with n of them: all on
    the tensor cores (ops/wino_resblock.py path_for, both dtypes)."""
    return {"cuda_core": 0, "tensor_core": n}


# phase 10, full frames: each model's conv3x3 launches per forward by path,
# and its exact tiling (size, overlap): half the overlap exceeds the
# receptive radius, the deepest chain of 3x3 convs counted in LR pixels.
# EDSR-baseline x4: first_conv, 32 trunk convs, after_res_conv and
# upsample.body.0 at the LR size (35), upsample.body.2 at 2x (0.5) and
# final_conv at 4x (0.25): 35.75 -> 36, so 128 / 80 (half 40). LarvaNet
# 2x16: the head, 64 trunk convs and the last leg's 2 at the LR size (67)
# beside a bicubic base of radius 2: 192 / 144 (half 72).
FULL_FRAME_MODELS = {
    "EDSR-baseline x4": ("edsr", [], PATH_LAUNCHES["f32"], (128, 80)),
    "LarvaNet 2x16": ("LarvaNet", LARVANET_FLAGS, conv_path_launches(_LARVA48), (192, 144)),
}
# conv_kxk launches per forward of each, on its serving route (EDSR's
# collapsed tail), and conv3x3's per forward of its module (the x8
# self-ensemble runs the f32 module, EDSR's with its own tail)
FULL_FRAME_KXK = {"EDSR-baseline x4": KXK_LAUNCHES,
                  "LarvaNet 2x16": NO_KXK}
FULL_FRAME_MODULE = {"EDSR-baseline x4": PLAIN_PATH_LAUNCHES["f32"],
                     "LarvaNet 2x16": conv_path_launches(_LARVA48)}
FULL_FRAME_LR = RAGGED[1:]       # DIV2K x4 LR, 339x510: chop quadrants 179/180 x 265
CHOP_OVERLAP = 20                # the CLIs' default --chop_overlap_size
TILE_DEFAULT = (128, 24)         # the CLIs' default --tile_size / --tile_overlap
TILE_MAX_BATCH = 64              # TiledUpscaler's default
# the LR frame of an 8K output (7680x4320): 11 x 19 = 209 tiles at 128 / 24,
# four chunks (64, 64, 64, 17) at TILE_MAX_BATCH; held against chunks of 16,
# whose largest tensor is a quarter of the size (EDSR's upsample.body.2
# output: 64 x 256^2 x 256 f32 = 4.3 GB against 1.07 GB)
BIG_FRAME_LR = (1080, 1920)
BIG_FRAME_SMALL_BATCH = 16
# validate's tiles on phase 6's set (its frames are smaller than 128): 48 / 16
VALIDATE_TILE = ["--tile_size", "48", "--tile_overlap", "16"]
# the test CLI's benchmark frames, (LR h, LR w, truth extra h, extra w) in the
# range of the JAX package's realistic fixture (LR ~80 x 120): an odd width,
# and truth extras that fit_truth_to_output crops
TEST_FRAMES = ((80, 118, 0, 0), (75, 121, 0, 0), (86, 112, 2, 3), (72, 127, 0, 0))
# phase 11: the int8 pair's conv shapes (EDSR-baseline's ResBlock, LarvaNet's
# ResBlock and 2conv leg, LarvaNet_w64's narrowing leg conv), the calibration
# batch of photo frames, the launches of one int8 forward ({s8 entry: n},
# conv3x3 by path: EDSR's 2 exact convs in bf16 beside its baked tail's 9
# conv_kxk launches, LarvaNet's head), the PSNR
# bar against the plain int8 forward (JAX's own int8 bar,
# tests/test_packed_trunk.py:243) and the QAT CLI's steps
S8_SHAPES = (("EDSR-baseline 64->64", 64, 64), ("LarvaNet 48->48", 48, 48),
             ("LarvaNet_w64 leg 64->48", 64, 48))
INT8_CALIB = (2, 96, 128)
INT8_LAUNCHES = {"edsr": ({"conv_a": 16, "conv_b": 16},
                          {"cuda_core": 1, "tensor_core": 1, "narrow": 0}),
                 "LarvaNet": ({"conv_a": 33, "conv_b": 33},
                              {"cuda_core": 1, "tensor_core": 0, "narrow": 0})}
INT8_FWD_PSNR_DB = 55.0
QAT_STEPS = 3
# the profiled calls of every device split, forwards' and train steps'
# (phases 5, 8, 8b, 13, 14 and 19 included, for the script's clock): the
# profiler's host cost on a host-bound step (QAT: ~2.5 s a profiled call)
# is the phases' largest part
SPLIT_REPS = 3



def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_windows(torch, fns, windows=WINDOWS, reps=TIMED_REPS):
    """{name: (median, min, max)} ms per call of each callable in `fns`:
    `windows` windows of `reps` calls each (CUDA events), after
    WARMUP_REPS calls, the callables' windows taken in turns (a, b, c, a,
    b, c, ...), so that a drift of the clocks within the call hits each of
    them alike and one outlying window moves no median."""
    for fn in fns.values():
        for _ in range(WARMUP_REPS):
            fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = {name: [] for name in fns}
    for _ in range(windows):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / reps)
    return {name: (statistics.median(t), min(t), max(t)) for name, t in times.items()}


def spread(t) -> str:
    """'median ms [min-max]' of a time_windows entry."""
    return "%.4f ms [%.4f-%.4f]" % t


def bound_ms(n, h, w, c, f, dtype_name, kh=3, kw=3, pads=(1, 1, 1, 1)):
    """The least time of one kh x kw conv with `pads` (default SAME 3x3):
    bytes (x, kernel, outputs once; bias f32) over HBM bandwidth vs
    operations over the dtype's peak (PEAK_FLOPS)."""
    item = 4 if dtype_name == "f32" else 2
    ho, wo = h + pads[0] + pads[1] - kh + 1, w + pads[2] + pads[3] - kw + 1
    nbytes = item * (n * h * w * c + n * ho * wo * f + kh * kw * c * f) + 4 * f
    flops = 2 * n * ho * wo * kh * kw * c * f
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _conv_ok(torch, got, want, dname, f32_atol=F32_ATOL):
    """(within the bar, max |d|) of a conv output against its plain version;
    `f32_atol` the f32 bar (F32_ATOL unless the conv sums more products)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError("kernel gave %s %s, plain %s %s" % (
            tuple(got.shape), got.dtype, tuple(want.shape), want.dtype))
    diff = (got.float() - want.float()).abs()
    if dname == "f32":
        ok = float(diff.max()) <= f32_atol
    else:
        ok = bool((diff <= BF16_ATOL + BF16_RTOL * want.float().abs()).all())
    return ok and bool(torch.isfinite(got).all()), float(diff.max())


def kernel_phase(torch, convs=X4_CONVS, label="EDSR-baseline x4", scaled_bar=False,
                 geometries=(LR_BATCH, RAGGED), slope=0.1):
    """Phase 3 over `convs` (X4_CONVS, LARVANET_CONVS, 16a's BRANCHY_CONVS or
    17a's), whose launch counts are per forward of `label`. With
    `scaled_bar` (16a, 17a) the f32 bar grows with the products a value
    sums, as phase 14a's (F32_ATOL x 9 C / KXK_F32_TERMS, at least
    F32_ATOL): the fuse's C = 384 sums six times phase 3's. `geometries`:
    the (N, H, W) LR geometries, the first the one the per-forward sums are
    taken at; `slope` leaky_relu's (18a: IMDN's 0.05). Returns ({dtype: per-forward sums at the first geometry},
    {dtype: the same over the tensor-core convs}, {dtype: worst error},
    {dtype: the narrow path's numbers by geometry})."""
    import torch.nn.functional as F

    from larvanet_tpu_torch.ops import conv3x3
    from larvanet_tpu_torch.ops.conv3x3 import (conv3x3_bias_act,
                                                conv3x3_bias_act_reference, path_for)

    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "cuda_core_ms")
    sums = {d: dict.fromkeys(keys, 0.0) for d in dtypes}
    tc_sums = {d: dict.fromkeys(keys, 0.0) for d in dtypes}
    # final_conv on the narrow path, per dtype and geometry
    narrow = {d: {} for d in dtypes}
    bound_kind = {d: {} for d in dtypes}
    worst = {d: 0.0 for d in dtypes}
    for geometry in geometries:
        for name, mult, c, f, act, count, expected in convs:
            n, h, w = geometry[0], geometry[1] * mult, geometry[2] * mult
            x32 = torch.randn((n, h, w, c), generator=gen, device="cuda")
            k32 = 0.1 * torch.randn((3, 3, c, f), generator=gen, device="cuda")
            b32 = torch.randn((f,), generator=gen, device="cuda")
            for dname, dtype in dtypes.items():
                x = x32.to(dtype)
                path = path_for(c, f, dtype)
                if path != expected:
                    raise AssertionError("%s %s: path_for names %s, not %s"
                                         % (name, dname, path, expected))
                before = dict(conv3x3.LAUNCHES_BY_PATH)
                got = conv3x3_bias_act(x, k32, b32, act, slope=slope)
                torch.cuda.synchronize()  # a fault during the run shows here
                took = {p: conv3x3.LAUNCHES_BY_PATH[p] - before[p] for p in before}
                if took != {p: int(p == path) for p in before}:
                    raise AssertionError("%s %s: launches by path %s, expected one on %s"
                                         % (name, dname, took, path))
                want = conv3x3_bias_act_reference(x, k32, b32, act, slope)
                f32_bar = F32_ATOL * (max(1.0, 9 * c / KXK_F32_TERMS) if scaled_bar else 1.0)
                ok, err = _conv_ok(torch, got, want, dname, f32_bar)
                worst[dname] = max(worst[dname], err)
                if not ok:
                    raise AssertionError("%s %s %s: %s kernel disagrees with its plain "
                                         "version, max |d| = %g" % (
                                             name, dname, (n, h, w, c, f), path, err))
                w_oihw = k32.to(dtype).permute(3, 2, 0, 1).contiguous()
                x_nchw = x.permute(0, 3, 1, 2)  # channels_last view of NHWC
                b_lib = b32.to(dtype)
                stream = torch.cuda.current_stream().cuda_stream
                fns = {"kernel": lambda: conv3x3_bias_act(x, k32, b32, act, slope=slope),
                       "F.conv2d": lambda: F.conv2d(x_nchw, w_oihw, b_lib, padding=1),
                       "plain": lambda: conv3x3_bias_act_reference(x, k32, b32, act, slope)}
                err_cc = None
                if path != "cuda_core":
                    # the CUDA-core entry on the same inputs: the earlier kernel
                    cc = conv3x3._entry(dtype, "cuda_core")
                    got_cc = conv3x3._run(cc, x, k32, b32, act, stream, slope=slope)
                    torch.cuda.synchronize()
                    ok_cc, err_cc = _conv_ok(torch, got_cc, want, dname, f32_bar)
                    if not ok_cc:
                        raise AssertionError("%s %s: cuda_core kernel disagrees with its "
                                             "plain version, max |d| = %g" % (
                                                 name, dname, err_cc))
                    del got_cc
                    fns["cuda_core"] = lambda: conv3x3._run(cc, x, k32, b32, act, stream,
                                                            slope=slope)
                if path == "narrow":
                    # a yardstick of the bytes side: one PyTorch reduction that
                    # reads x once
                    fns["x.sum()"] = lambda: x.sum()
                t = time_windows(torch, fns)
                ms, lib, plain = t["kernel"][0], t["F.conv2d"][0], t["plain"][0]
                cc_ms = t["cuda_core"][0] if "cuda_core" in t else ms
                bound, by = bound_ms(n, h, w, c, f, dname)
                print("conv3x3 %-32s %-4s x=%s C=%d F=%d act=%s: %s kernel %s, %sF.conv2d %s, "
                      "plain %s, bound %.4f ms (%s), max|d| %.3g%s" % (
                          name, dname, (n, h, w), c, f, act, path, spread(t["kernel"]),
                          "cuda_core kernel %s (%s %.2fx faster), " % (
                              spread(t["cuda_core"]), path, cc_ms / ms)
                          if "cuda_core" in t else "", spread(t["F.conv2d"]),
                          spread(t["plain"]), bound, by, err,
                          "" if err_cc is None else ", cuda_core max|d| %.3g" % err_cc),
                      flush=True)
                if path == "narrow":
                    read = t["x.sum()"][0]
                    print("conv3x3 %-32s %-4s x=%s: x.sum() %s (%.3f TB/s), narrow kernel "
                          "%.3f TB/s of x" % (name, dname, (n, h, w), spread(t["x.sum()"]),
                                              x.numel() * x.element_size() / read / 1e9,
                                              x.numel() * x.element_size() / ms / 1e9),
                          flush=True)
                    narrow[dname]["%dx%dx%d" % (n, h, w)] = {
                        "ms": ms, "cuda_core_ms": cc_ms, "plain_ms": plain, "library_ms": lib,
                        "read_ms": read, "bound_ms": bound, "bound_by": by, "max_abs_err": err}
                if geometry == geometries[0]:
                    part = {"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bound,
                            "cuda_core_ms": cc_ms}
                    for total in (sums[dname],) + ((tc_sums[dname],)
                                                   if path == "tensor_core" else ()):
                        for k in keys:
                            total[k] += count * part[k]
                    bound_kind[dname][by] = bound_kind[dname].get(by, 0.0) + count * bound
                del x, got, want, fns
            del x32, k32, b32
            torch.cuda.empty_cache()
    n_tc = sum(row[5] for row in convs if row[6] == "tensor_core")
    for dname in dtypes:
        sums[dname]["bound_by"] = max(bound_kind[dname], key=bound_kind[dname].get)
        print("conv3x3 per %s forward at %s, %s: kernel %.4f ms, plain %.4f ms, F.conv2d "
              "%.4f ms, bound %.4f ms (%s), all-cuda_core kernel %.4f ms; its %d tensor-core "
              "convs: kernel %.4f ms, cuda_core entry %.4f ms, F.conv2d %.4f ms, bound %.4f ms"
              % (label, geometries[0], dname, sums[dname]["ms"], sums[dname]["plain_ms"],
                 sums[dname]["library_ms"], sums[dname]["bound_ms"], sums[dname]["bound_by"],
                 sums[dname]["cuda_core_ms"], n_tc, tc_sums[dname]["ms"],
                 tc_sums[dname]["cuda_core_ms"], tc_sums[dname]["library_ms"],
                 tc_sums[dname]["bound_ms"]), flush=True)
    return sums, tc_sums, worst, narrow


def wino_bound_ms(n, h, w, c, m, dtype_name):
    """The least time of one fused ResBlock: bytes (x read, out written, the
    two transformed weights read once; biases f32) over HBM bandwidth vs
    the kernel's own multiply-adds, 2 convs x (m + 2) * 3 / m C^2 per
    pixel, over the dtype's peak. m = 0: the direct ResBlock, 2 x 9 C^2."""
    item = 4 if dtype_name == "f32" else 2
    taps = 9 if m == 0 else (m + 2) * 3
    per_px = 9.0 if m == 0 else taps / m
    nbytes = item * (2 * n * h * w * c + 2 * taps * c * c) + 2 * 4 * c
    flops = 2 * n * h * w * 2 * per_px * c * c
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _wino_err(torch, got, want, m, dname):
    """(max |d|, bar, max |y|) of a fused ResBlock output against its plain
    version; raises on shape or dtype."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError("wino F(%d,3): kernel gave %s %s, plain %s %s"
                             % (m, tuple(got.shape), got.dtype, tuple(want.shape), want.dtype))
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    bar = WINO_F32_ATOL[m] if dname == "f32" else WINO_BF16_RTOL * scale
    if not bool(torch.isfinite(got).all()):
        err = float("inf")
    return err, bar, scale


def wino_phase(torch):
    """Phase 3b. Holds both fused Winograd ResBlock kernels against their
    plain version at EDSR-baseline's ResBlock (C = 64) for the LR batch
    and the ragged frame, f32 and bf16, res_weight 1.0 (and 0.1 on the
    ragged frame), and the dtype's CUDA-core entry beside the tensor-core
    one.
    Returns {m: ({dtype: per-forward sums at the LR batch}, {dtype: worst
    error})}."""
    import torch.nn.functional as F

    from larvanet_tpu_torch.ops import wino_resblock as wr
    from larvanet_tpu_torch.ops.wino_resblock import (
        entry_basis, h_transform_kernel, path_for, wino_resblock_transformed,
        wino_resblock_transformed_reference)

    c = 64
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    out = {}
    for m in (2, 4):
        sums = {d: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                    "cuda_core_ms": 0.0} for d in dtypes}
        worst = {d: 0.0 for d in dtypes}
        for geometry in (LR_BATCH, RAGGED):
            n, h, w = geometry
            init = 1.0 / 24  # the layers' init bound, 1/sqrt(9 C)
            x32 = torch.randn((n, h, w, c), generator=gen, device="cuda")
            k_a, k_b = (init * (2 * torch.rand((3, 3, c, c), generator=gen, device="cuda") - 1)
                        for _ in range(2))
            b_a, b_b = (init * (2 * torch.rand((c,), generator=gen, device="cuda") - 1)
                        for _ in range(2))
            for dname, dtype in dtypes.items():
                x = x32.to(dtype)
                path = path_for(dtype)
                u_a = h_transform_kernel(k_a, m).to(dtype)
                u_b = h_transform_kernel(k_b, m).to(dtype)
                # the basis as the forward caches it, in the entry's layout
                e_a, e_b = entry_basis(u_a, path), entry_basis(u_b, path)
                # the CUDA-core entry on the same inputs, the earlier kernel
                cc = wr._entry(m, dtype, "cuda_core")
                stream = torch.cuda.current_stream().cuda_stream
                rws = (1.0, 0.1) if geometry == RAGGED else (1.0,)
                for rw in rws:
                    before = dict(wr.LAUNCHES_BY_PATH)
                    got = wino_resblock_transformed(x, e_a, b_a, e_b, b_b, rw, m,
                                                    entry_layout=True)
                    torch.cuda.synchronize()  # a fault during the run shows here
                    took = {p: wr.LAUNCHES_BY_PATH[p] - before[p] for p in before}
                    if took != {p: int(p == path) for p in before}:
                        raise AssertionError("wino F(%d,3) %s: launches by path %s, expected "
                                             "one on %s" % (m, dname, took, path))
                    want = wino_resblock_transformed_reference(x, u_a, b_a, u_b, b_b, rw, m)
                    err, bar, scale = _wino_err(torch, got, want, m, dname)
                    worst[dname] = max(worst[dname], err)
                    print("wino F(%d,3) %-4s x=%s rw=%g: %s kernel max|d| %.3g vs plain "
                          "version (bar %.3g; max|y| %.3g; %d of %d values differ)"
                          % (m, dname, geometry, rw, path, err, bar, scale,
                             int((got.float() != want.float()).sum()), got.numel()),
                          flush=True)
                    if err > bar:
                        raise AssertionError("wino F(%d,3) %s %s rw=%g: %s kernel disagrees "
                                             "with its plain version, max |d| = %g"
                                             % (m, dname, geometry, rw, path, err))
                    got_cc = wr._run(cc, x, u_a, b_a, u_b, b_b, rw, m, stream)
                    torch.cuda.synchronize()
                    err_cc, _, _ = _wino_err(torch, got_cc, want, m, dname)
                    print("wino F(%d,3) %-4s x=%s rw=%g: cuda_core kernel max|d| %.3g"
                          % (m, dname, geometry, rw, err_cc), flush=True)
                    if err_cc > bar:
                        raise AssertionError("wino F(%d,3) %s: cuda_core kernel disagrees "
                                             "with its plain version, max |d| = %g"
                                             % (m, dname, err_cc))
                    del got, got_cc, want
                x_nchw = x.permute(0, 3, 1, 2)  # channels_last view of NHWC
                w_a = k_a.to(dtype).permute(3, 2, 0, 1).contiguous()
                w_b = k_b.to(dtype).permute(3, 2, 0, 1).contiguous()
                lb_a, lb_b = b_a.to(dtype), b_b.to(dtype)

                def library():
                    t = F.relu(F.conv2d(x_nchw, w_a, lb_a, padding=1))
                    return x_nchw + F.conv2d(t, w_b, lb_b, padding=1)

                fns = {"kernel": lambda: wino_resblock_transformed(
                           x, e_a, b_a, e_b, b_b, 1.0, m, entry_layout=True),
                       "cuDNN": library,
                       "plain": lambda: wino_resblock_transformed_reference(
                           x, u_a, b_a, u_b, b_b, 1.0, m),
                       "cuda_core": lambda: wr._run(cc, x, u_a, b_a, u_b, b_b, 1.0, m, stream)}
                t = time_windows(torch, fns)
                ms, lib, plain = t["kernel"][0], t["cuDNN"][0], t["plain"][0]
                cc_ms = t["cuda_core"][0]
                bound, by = wino_bound_ms(n, h, w, c, m, dname)
                direct, direct_by = wino_bound_ms(n, h, w, c, 0, dname)
                print("wino F(%d,3) %-4s x=%s C=%d: %s kernel %s (cuda_core kernel %s, %.2fx), "
                      "plain %s, cuDNN ResBlock %s, bound %.4f ms (%s), direct ResBlock bound "
                      "%.4f ms (%s)" % (
                          m, dname, geometry, c, path, spread(t["kernel"]),
                          spread(t["cuda_core"]), cc_ms / ms,
                          spread(t["plain"]), spread(t["cuDNN"]), bound, by, direct,
                          direct_by), flush=True)
                if geometry == LR_BATCH:
                    sd = sums[dname]
                    sd["ms"] += 16 * ms
                    sd["plain_ms"] += 16 * plain
                    sd["library_ms"] += 16 * lib
                    sd["bound_ms"] += 16 * bound
                    sd["bound_by"] = by
                    sd["cuda_core_ms"] += 16 * cc_ms
                del x
            del x32, k_a, k_b, b_a, b_b
            torch.cuda.empty_cache()
        for dname in dtypes:
            print("wino F(%d,3) per x4 forward (16 ResBlocks) at %s, %s: kernel %.4f ms, "
                  "plain %.4f ms, cuDNN ResBlocks %.4f ms, bound %.4f ms (%s), cuda_core "
                  "kernel %.4f ms" % (
                      m, LR_BATCH, dname, sums[dname]["ms"], sums[dname]["plain_ms"],
                      sums[dname]["library_ms"], sums[dname]["bound_ms"],
                      sums[dname]["bound_by"], sums[dname]["cuda_core_ms"]), flush=True)
        out[m] = (sums, worst)
    return out


def _http(url, data=None):
    req = urllib.request.Request(url, data=data, method="POST" if data else "GET")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def fit_output_range(torch, model, img_chw):
    """Rescale final_conv so the random model's output on `img_chw` has
    mean 128 and std 40 in every channel. Left as drawn, the random convs
    shrink the signal and the inverse mean shift puts nearly every pixel
    below 0, where the clamp to [0, 255] would hide any error of the
    forward. mean_inverse_shift stays the intended -mean."""
    module = model.module
    shift = module.mean_inverse_shift.bias
    f = model.upscale_device([img_chw], 4, uint8=False) - shift
    mean_f = f.mean((0, 1, 2))
    a = 40.0 / float(f.std())
    with torch.no_grad():
        module.final_conv.weight.mul_(a)
        module.final_conv.bias.copy_(a * (module.final_conv.bias - mean_f)
                                     + 128.0 - shift)


def photo(rng, h, w):
    """A CHW uint8 frame of smooth gradients plus noise, like a photo more
    than pure noise."""
    import numpy as np

    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255.0 / w, yy * 255.0 / h,
                     (xx + yy) * 127.0 / (h + w)])
    noisy = base + rng.normal(0, 12, (3, h, w))
    return np.clip(noisy, 0, 255).astype(np.uint8)


def save_edsr_baseline(torch, path, fit_frame, device="cuda"):
    """EDSR-baseline x4 at full width, random weights from SEED, final_conv
    fitted on `fit_frame` (fit_output_range), saved as a .pth."""
    from larvanet_tpu_torch.core.registry import get_model

    model = get_model("edsr")
    model.parse_args([])
    model.prepare([4], device=device, seed=SEED)
    n_params = model.num_parameters()
    if n_params != 1517571:
        raise AssertionError("EDSR-baseline x4 has %d parameters, not 1517571" % n_params)
    fit_output_range(torch, model, fit_frame)
    torch.save(model.module.state_dict(), path)


def save_larvanet(torch, path, name="LarvaNet", flags=LARVANET_FLAGS, device="cuda"):
    """A LarvaNet-family model x4 at full width, random weights from SEED
    (the family's 0.1-scaled Kaiming init), saved as the port module's own
    state_dict."""
    from larvanet_tpu_torch.core.registry import get_model

    model = get_model(name)
    model.parse_args(list(flags))
    model.prepare([4], device=device, seed=SEED)
    n_params = model.num_parameters()
    if n_params != LARVANET_PARAMS[name]:
        raise AssertionError("%s %s has %d parameters, not %d"
                             % (name, " ".join(flags), n_params, LARVANET_PARAMS[name]))
    torch.save(model.module.state_dict(), path)


def larvanet_base(torch, model, img_chw):
    """The base of `model`'s LarvaNet (or msrr_reduced, TreeNet, REGO, EBRN
    or HRSR) forward on one CHW frame, NHWC f32 (`sr_base`)."""
    x = model._input_to_device([img_chw]).to(model.compute_dtype)
    return sr_base(torch, model.module, x).float()[0]


def sr_base(torch, module, x):
    """The part of `module`'s x4 output on the NHWC batch `x` that is not
    its network's: the interpolated base (models/layers.interpolated_base
    on x in its dtype, as the forward takes it), or for ebrn, ebrn_rm,
    MAMNet and IMDN the inverse mean shift's constant, broadcast."""
    from larvanet_tpu_torch.models.imdn import IMDNModule
    from larvanet_tpu_torch.models.layers import interpolated_base
    from larvanet_tpu_torch.models.mamnet import MAMNetModule

    if (getattr(module, "bilinear_base", None) is False or hasattr(module, "recon_layer")
            or isinstance(module, (MAMNetModule, IMDNModule))):
        n, h, w, _ = x.shape
        return module.mean_inverse_shift.bias.to(x.dtype).expand(n, 4 * h, 4 * w, 3)
    method = ("bilinear" if getattr(module, "bilinear_base", False)
              else getattr(module, "interpolate", None) or module.base)
    return interpolated_base(x, 4, method)


def serve_phase(torch, device="cuda", dtype_name="f32", model_name="edsr"):
    """Phase 4 (EDSR-baseline x4), 4b (`model_name` a LarvaNet preset, at
    LARVANET_FLAGS), 15c (an MSRR_MODELS name at full width), 16b (a
    BRANCHY_MODELS name, its residual fitted by fit_branchy), 17b (an
    SR_MODELS name, its residual fitted by fit_sr_residual) or 18b (an
    MI_MODELS name, fitted the same way; MAMNet on the collapsed tail) with
    --serving_dtype `dtype_name`. Returns the conv3x3
    launches counted while serving, the same by path, and the served
    model."""
    import numpy as np

    from larvanet_tpu_torch.cli import serve
    from larvanet_tpu_torch.data import png
    from larvanet_tpu_torch.eval.metrics import psnr_rgb_device
    from larvanet_tpu_torch.ops import conv3x3
    from larvanet_tpu_torch.ops import conv_kxk as ck

    larva = model_name != "edsr"
    rng = np.random.default_rng(SEED)
    frames = [photo(rng, 120, 160), photo(rng, 120, 160), photo(rng, 67, 93),
              photo(rng, 96, 128)]
    label = "%s %s" % (model_name, dtype_name)
    with tempfile.TemporaryDirectory() as tmp:
        pth = os.path.join(tmp, "%s_x4.pth" % model_name)
        if model_name in MSRR_MODELS:
            save_msrr(torch, pth, model_name, device)
            model_flags = ["--model", model_name]
            per_forward = MSRR_MODELS[model_name][1]
            per_kxk = NO_KXK
        elif model_name in BRANCHY_MODELS:
            flags, _, per_forward = BRANCHY_MODELS[model_name]
            save_branchy(torch, pth, model_name, frames[0], device)
            model_flags = ["--model", model_name] + flags
            per_kxk = NO_KXK
        elif model_name in SR_MODELS:
            flags, _, per_forward = SR_MODELS[model_name]
            save_sr_model(torch, pth, model_name, frames[0], device)
            model_flags = ["--model", model_name] + flags
            per_kxk = NO_KXK
        elif model_name in MI_MODELS:
            _, per_forward, per_kxk, _ = MI_MODELS[model_name]
            save_mi_model(torch, pth, model_name, frames[0], device)
            model_flags = ["--model", model_name]
        elif larva:
            save_larvanet(torch, pth, model_name, LARVANET_FLAGS, device)
            model_flags = ["--model", model_name] + LARVANET_FLAGS
            per_forward = conv_path_launches(_LARVA48)
            per_kxk = NO_KXK
        else:
            save_edsr_baseline(torch, pth, frames[0], device)
            model_flags = ["--model", "edsr"]
            per_forward = PATH_LAUNCHES[dtype_name]  # the default collapsed tail
            per_kxk = KXK_LAUNCHES
        n_conv = sum(per_forward.values())

        args, remaining = serve.build_parser().parse_known_args(
            model_flags + ["--scales", "4", "--restore_path", pth,
                           "--device", device, "--dynamic_batch", "2",
                           "--serving_dtype", dtype_name])
        service = serve.build_service(args, remaining)
        httpd = serve.make_server(service, "127.0.0.1", 0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        url = "http://127.0.0.1:%d" % httpd.server_address[1]
        try:
            code, _ = _http(url + "/healthz")
            if code != 503:
                raise AssertionError("/healthz gave %d before warmup" % code)
            t0 = time.perf_counter()
            service.warmup(128, 128)
            print("serve %s: warmup took %.3f s" % (label, time.perf_counter() - t0))
            code, _ = _http(url + "/healthz")
            if code != 200:
                raise AssertionError("/healthz gave %d after warmup" % code)

            bodies = [png.encode(f.transpose(1, 2, 0)) for f in frames]
            replies = [None] * len(frames)
            wall = [0.0] * len(frames)

            def post(i):
                t = time.perf_counter()
                replies[i] = _http(url + "/upscale", bodies[i])
                wall[i] = time.perf_counter() - t

            conv3x3.reset_launches()
            ck.reset_launches()
            # hold the dispatch lock until both same-geometry requests wait,
            # so the server coalesces them into one batch of 2
            with service._lock:
                pair = [threading.Thread(target=post, args=(i,)) for i in (0, 1)]
                for t in pair:
                    t.start()
                deadline = time.perf_counter() + 60
                while service.info()["queue_depth"] < 2:
                    if time.perf_counter() > deadline:
                        raise AssertionError("the two requests never queued")
                    time.sleep(0.005)
            for t in pair:
                t.join(timeout=300)
            for i in (2, 3):
                post(i)
            launches, by_path = conv3x3.LAUNCHES, dict(conv3x3.LAUNCHES_BY_PATH)
            kxk_by_path = kxk_launches(ck)
            info = json.loads(_http(url + "/info")[1])
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=60)

        print("serve %s: /info num_requests=%d num_forwards=%d mean_batch_size=%s "
              "device_seconds=%s queue_wait_seconds=%s device_memory_mb=%s"
              % (label, info["num_requests"], info["num_forwards"],
                 info["mean_batch_size"],
                 info["device_seconds"], info["queue_wait_seconds"],
                 info["device_memory_mb"]))
        print("serve %s: client wall seconds per request: %s"
              % (label, ", ".join("%.4f" % s for s in wall)))
        if info["num_requests"] != 4 or info["num_forwards"] != 3:
            raise AssertionError("expected 4 requests in 3 forwards (one batch of "
                                 "2), /info says %s" % info)
        want = {p: k * info["num_forwards"] for p, k in per_forward.items()}
        if launches != n_conv * info["num_forwards"] or by_path != want:
            raise AssertionError("%s: conv3x3 kernel launched %d times (%s) for %d forwards, "
                                 "not %d each (%s)" % (label, launches, by_path,
                                                       info["num_forwards"], n_conv, want))
        print("serve %s: %d conv3x3 kernel launches for %d forwards (%d each): %s"
              % (label, launches, info["num_forwards"], n_conv, by_path))
        expect_kxk("serve %s" % label, kxk_by_path, per_kxk, info["num_forwards"])

        for i, (img, (code, body)) in enumerate(zip(frames, replies)):
            if code != 200:
                raise AssertionError("request %d: HTTP %d %r" % (i, code, body[:80]))
            got = png.decode(body, grey16="clip")
            h, w = img.shape[1:]
            if got.shape != (4 * h, 4 * w, 3):
                raise AssertionError("request %d: reply %s, not x4 of %s"
                                     % (i, got.shape, (h, w)))
            # the unclamped forward through the kernels, then the same
            # forward (the same route) with every conv in its plain version
            fwd = service.model.upscale_device([img], 4, uint8=False)[0]
            with plain_versions():
                ref = service.model.upscale_device([img], 4, uint8=False)[0]
            if not (torch.isfinite(ref).all() and torch.isfinite(fwd).all()):
                raise AssertionError("request %d: forward not finite" % i)
            fwd_err = float((fwd - ref).abs().max())
            rtol = FWD_RTOL if dtype_name == "f32" else BF16_FWD_RTOL
            # LarvaNet: relative to the residual, the forward minus its
            # interpolated base (the same in both forwards), which a fault
            # of the trunk would move by far more than the image's range
            # shows; EDSR: relative to the output
            magnitude = ref - larvanet_base(torch, service.model, img) if larva else ref
            fwd_bar = rtol * float(magnitude.abs().max())

            def u8(t):
                return torch.clamp(torch.round(t), 0, 255).to(torch.int16)

            ref_u8 = u8(ref)
            inside = float(((ref_u8 > 0) & (ref_u8 < 255)).float().mean())
            got_t = torch.from_numpy(got).to(ref.device).to(torch.int16)
            levels = int((got_t - ref_u8).abs().max())
            # f32: the reply against the plain forward; bf16, where the two
            # forwards may lie a few levels apart (BF16_FWD_RTOL): against
            # the kernels' own forward, and that forward against the plain one
            served = levels if dtype_name == "f32" else int((got_t - u8(fwd)).abs().max())
            psnr = float(psnr_rgb_device(got_t[None].float(), ref[None]))
            print("serve %s: request %d %dx%d -> %dx%d: %.4f of pixels inside (0, 255), "
                  "unclamped max |d| %.3g (bar %.3g%s), max %d uint8 level(s) from the "
                  "plain-version forward, %d from the kernels' forward, PSNR %.2f dB" % (
                      label, i, h, w, 4 * h, 4 * w, inside, fwd_err, fwd_bar,
                      "; residual max |y| %.3g" % float(magnitude.abs().max()) if larva else "",
                      levels, int((got_t - u8(fwd)).abs().max()), psnr))
            if inside < MIN_INSIDE:
                raise AssertionError("request %d: only %.4f of the pixels inside "
                                     "(0, 255)" % (i, inside))
            if fwd_err > fwd_bar or served > 1:
                raise AssertionError("request %d (%s): kernel forward disagrees with the "
                                     "plain forward" % (i, label))
    return launches, by_path, service.model


def _add(total, part):
    for k, v in part.items():
        total[k] = total.get(k, 0) + v


def forward_phase(torch, model, device="cuda"):
    """Phase 5. The whole x4 forward (`fwd_runtime`) on the LR batch of
    phase 3, in f32 and bf16, on the default route (the collapsed tail)
    through the conv3x3 and conv_kxk kernels and under each --wino_trunk
    route (whose tail is baked too): the denominator of the kernels' share
    of a forward. Each route's forward is counted (--wino_trunk 0: 34
    conv3x3 launches; 2 and 4: 2 conv3x3 and 16 fused launches; 4 conv_kxk
    launches on every route) and, under --wino_trunk in bf16, held against
    the same route with the plain fused ResBlock. Returns {m: fused
    launches by path in the counted forwards}."""
    from larvanet_tpu_torch.ops import conv3x3
    from larvanet_tpu_torch.ops import conv_kxk as ck
    from larvanet_tpu_torch.ops import wino_resblock as wr
    from larvanet_tpu_torch.ops.collapsed_tail import make_collapsed_edsr_forward
    from larvanet_tpu_torch.ops.wino_resblock import make_wino_edsr_forward

    n, h, w = LR_BATCH
    gen = torch.Generator(device=device).manual_seed(SEED)
    x = 255.0 * torch.rand((n, h, w, 3), generator=gen, device=device)
    launches = {2: {}, 4: {}}
    for name in ("f32", "bf16"):
        model.set_serving_dtype(name)
        for m in (0, 2, 4):
            model.set_route(make_wino_edsr_forward(model, m) if m
                            else make_collapsed_edsr_forward(model))
            conv3x3.reset_launches()
            ck.reset_launches()
            wr.reset_launches()
            got = model.fwd_runtime(x)
            if device == "cuda":
                torch.cuda.synchronize()
            conv, by_path = dict(conv3x3.LAUNCHES_BY_PATH), dict(wr.LAUNCHES_BY_PATH)
            print("forward %s --wino_trunk %d: conv3x3 launches by path %s, fused launches "
                  "by path %s" % (name, m, conv, by_path), flush=True)
            want_conv = (WINO_CONV_PATH_LAUNCHES if m else PATH_LAUNCHES)[name]
            want_fused = WINO_PATH_LAUNCHES[name] if m else fused_path_launches(0)
            if conv != want_conv or by_path != want_fused:
                raise AssertionError("forward %s --wino_trunk %d: %s conv3x3 and %s fused "
                                     "launches, not %s and %s" % (
                                         name, m, conv, by_path, want_conv, want_fused))
            expect_kxk("forward %s --wino_trunk %d" % (name, m), kxk_launches(ck),
                       KXK_LAUNCHES, 1)
            if m:
                _add(launches[m], by_path)
                if name == "bf16":
                    with mock.patch.object(wr, "wino_resblock_transformed",
                                           wr.wino_resblock_transformed_reference):
                        ref = model.fwd_runtime(x)
                    err = float((got - ref).abs().max())
                    bar = BF16_FWD_RTOL * float(ref.abs().max())
                    print("forward bf16 --wino_trunk %d: max |d| %.3g against the route with "
                          "the plain fused ResBlock (bar %.3g)" % (m, err, bar), flush=True)
                    if err > bar or not bool(torch.isfinite(got).all()):
                        raise AssertionError("forward bf16 --wino_trunk %d disagrees with the "
                                             "plain fused ResBlock's" % m)
                    del ref
            del got
            if device != "cuda":
                continue
            t = time_windows(torch, {"forward": lambda: model.fwd_runtime(x)})["forward"]
            print("forward: EDSR-baseline x4, %d x %dx%d LR, %s, --wino_trunk %d: %s per "
                  "forward, %.3f LR-MP/s; %s" % (
                      n, h, w, name, m, spread(t), n * h * w / 1e3 / t[0],
                      breakdown_line(torch, lambda: model.fwd_runtime(x), t[0])), flush=True)
    model.set_route(None)
    model.set_serving_dtype("f32")
    return launches


def larvanet_model(name, flags, device="cuda", pth=None):
    """A LarvaNet-family model x4 on `device`, random weights from SEED or
    restored from `pth`."""
    from larvanet_tpu_torch.core.registry import get_model

    model = get_model(name)
    model.parse_args(list(flags))
    model.prepare([4], device=device, seed=SEED)
    if pth is not None:
        model.restore(pth)
    return model


def device_breakdown(torch, fn, kinds=("conv3x3", "wino_resblock", "conv_kxk"),
                     reps=SPLIT_REPS):
    """The card's kernel time in one call of `fn`: (wall ms under the
    profiler, {each of `kinds`, "other": ms of kernels by name, a kernel
    going to the first kind its name holds}), from torch.profiler's CUDA
    kernel records over `reps` calls bracketed with CUDA events. The
    parts are None, not measured, when the profiler records no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
    parts = dict.fromkeys(kinds + ("other",), 0.0)
    for event in prof.key_averages():
        if event.device_type == DeviceType.CUDA:
            kind = next((k for k in kinds if k in event.key), "other")
            parts[kind] += event.self_device_time_total / 1e3 / reps
    return start.elapsed_time(end) / reps, (parts if sum(parts.values()) else None)


def breakdown_line(torch, fn, wall, kinds=("conv3x3", "wino_resblock", "conv_kxk")) -> str:
    """Where a call of `fn` that takes `wall` ms unprofiled spends the card's
    time: its kernels by name (device_breakdown) and idle, the rest of
    `wall` (one stream: kernels do not overlap). The profiler's own host
    work slows a host-bound call, so idle is taken against the unprofiled
    time; the profiled wall is printed beside it."""
    profiled, parts = device_breakdown(torch, fn, kinds)
    if parts is None:
        return "device breakdown not measured (the profiler recorded no kernel)"
    parts["idle"] = max(wall - sum(parts.values()), 0.0)
    return "of it %s (profiled wall %.4f ms)" % (", ".join(
        "%s %.4f ms (%.1f%%)" % (k, v, 100.0 * v / wall) for k, v in parts.items()), profiled)


def larvanet_forward_phase(torch, device="cuda"):
    """Phase 5b. The LarvaNet-family x4 forwards of LARVANET_ROUTES on the
    LR batch of phase 3, f32 and bf16, each --wino_trunk route set up by the
    CLI's own `maybe_wino_trunk`. One forward of each is counted (conv3x3
    launches by path, fused launches by path), then timed; under
    --wino_trunk a 48-channel trunk must give the default route's output
    bit for bit, and LarvaNet_w64 must lie within WINO_FWD_RTOL (f32) or
    BF16_FWD_RTOL (bf16) of the same route with the plain fused ResBlock,
    relative to the residual (the forward minus its base). Each timed
    forward's time is split by `breakdown_line`: the convs, the fused
    ResBlocks, the other kernels (the base among them) and idle.
    Returns {m: fused launches by path in the counted forwards}."""
    import argparse
    import contextlib
    import io as stdio

    from larvanet_tpu_torch.cli import common
    from larvanet_tpu_torch.models.layers import interpolated_base
    from larvanet_tpu_torch.ops import conv3x3
    from larvanet_tpu_torch.ops import wino_resblock as wr

    n, h, w = LR_BATCH
    gen = torch.Generator(device=device).manual_seed(SEED)
    x = 255.0 * torch.rand((n, h, w, 3), generator=gen, device=device)
    launches = {2: {}, 4: {}}
    base_done = set()
    for label, (name, flags, routes) in LARVANET_ROUTES.items():
        model = larvanet_model(name, flags, device)
        for dname in ("f32", "bf16"):
            model.set_serving_dtype(dname)
            base = interpolated_base(x.to(model.compute_dtype), 4,
                                     model.module.interpolate).float()
            if dname not in base_done and device == "cuda":
                base_done.add(dname)
                t = time_windows(torch, {"base": lambda: interpolated_base(
                    x.to(model.compute_dtype), 4, model.module.interpolate)})["base"]
                print("forward: bicubic base of %d x %dx%d LR, %s: %s" % (
                    n, h, w, dname, spread(t)), flush=True)
            default = None
            for m, (shapes, fused) in routes.items():
                model.set_route(None)
                notice = stdio.StringIO()
                with contextlib.redirect_stdout(notice):
                    common.maybe_wino_trunk(model, argparse.Namespace(model=name,
                                                                      wino_trunk=m))
                if notice.getvalue():
                    print("forward %s %s --wino_trunk %d: %s" % (
                        label, dname, m, notice.getvalue().strip().replace("\n", "; ")))
                conv3x3.reset_launches()
                wr.reset_launches()
                got = model.fwd_runtime(x)
                if device == "cuda":
                    torch.cuda.synchronize()
                conv, by_path = dict(conv3x3.LAUNCHES_BY_PATH), dict(wr.LAUNCHES_BY_PATH)
                want_conv, want_fused = conv_path_launches(shapes), fused_path_launches(fused)
                print("forward %s %s --wino_trunk %d: conv3x3 launches by path %s, fused "
                      "launches by path %s" % (label, dname, m, conv, by_path), flush=True)
                if conv != want_conv or by_path != want_fused:
                    raise AssertionError("forward %s %s --wino_trunk %d: %s conv3x3 and %s "
                                         "fused launches, not %s and %s" % (
                                             label, dname, m, conv, by_path, want_conv,
                                             want_fused))
                if m:
                    _add(launches[m], by_path)
                if not bool(torch.isfinite(got).all()):
                    raise AssertionError("forward %s %s --wino_trunk %d: not finite"
                                         % (label, dname, m))
                if m == 0:
                    default = got
                elif not fused:
                    if not torch.equal(got, default):
                        raise AssertionError("forward %s %s --wino_trunk %d: the 48-channel "
                                             "route differs from the default route"
                                             % (label, dname, m))
                else:
                    with mock.patch.object(wr, "wino_resblock_transformed",
                                           wr.wino_resblock_transformed_reference):
                        ref = model.fwd_runtime(x)
                    err = float((got - ref).abs().max())
                    rtol = WINO_FWD_RTOL if dname == "f32" else BF16_FWD_RTOL
                    residual = float((ref - base).abs().max())
                    bar = rtol * residual
                    print("forward %s %s --wino_trunk %d: max |d| %.3g against the route with "
                          "the plain fused ResBlock (bar %.3g; residual max |y| %.3g, output "
                          "max |y| %.3g)" % (label, dname, m, err, bar, residual,
                                             float(ref.abs().max())), flush=True)
                    if err > bar:
                        raise AssertionError("forward %s %s --wino_trunk %d disagrees with the "
                                             "plain fused ResBlock's" % (label, dname, m))
                    del ref
                del got
                if device != "cuda":
                    continue
                t = time_windows(torch, {"forward": lambda: model.fwd_runtime(x)})["forward"]
                print("forward: %s x4, %d x %dx%d LR, %s, --wino_trunk %d: %s per forward, "
                      "%.3f LR-MP/s; %s" % (
                          label, n, h, w, dname, m, spread(t), n * h * w / 1e3 / t[0],
                          breakdown_line(torch, lambda: model.fwd_runtime(x), t[0])),
                      flush=True)
            del default
        model.set_route(None)
        del model
    return launches


def write_validate_set(root):
    """Phase 6's DIV2K-layout set under `root`: VALIDATE_LR frames (even
    widths) in `all` and `even`, VALIDATE_ODD_LR in `all` only, each
    `photo` HR frame with its 4x4 box-mean LR."""
    import numpy as np

    from larvanet_tpu_torch.data import io

    rng = np.random.default_rng(SEED + 2)
    for i, (h, w) in enumerate(VALIDATE_LR + (VALIDATE_ODD_LR,)):
        hr = photo(rng, 4 * h, 4 * w)
        lr = np.round(hr.reshape(3, h, 4, w, 4).mean((2, 4))).astype(np.uint8)
        name = "%04d" % i
        sets = ("all",) if (h, w) == VALIDATE_ODD_LR else ("all", "even")
        for sub in sets:
            io.save_image_chw(hr, os.path.join(root, sub, "HR", name + ".png"))
            io.save_image_chw(lr, os.path.join(root, sub, "LR", "X4", "%sx4.png" % name))


def validate_phase(torch, device="cuda", model_name="edsr"):
    """Phase 6 (EDSR-baseline x4) or 6b (`model_name` "LarvaNet_w64" at
    LARVANET_FLAGS). The port's validate CLI on a small DIV2K-layout set,
    with --wino_trunk 0, 2 and 4 (EDSR: the default collapsed tail, which
    every route bakes; its probes run inside the counted run). Returns {m:
    fused launches by path in the m run}."""
    from larvanet_tpu_torch.cli import validate
    from larvanet_tpu_torch.core.registry import get_model
    from larvanet_tpu_torch.data import io
    from larvanet_tpu_torch.ops import conv3x3, wino_resblock
    from larvanet_tpu_torch.ops import conv_kxk as ck

    with tempfile.TemporaryDirectory() as tmp:
        write_validate_set(tmp)
        pth = os.path.join(tmp, "%s_x4.pth" % model_name)
        first_lr = io.load_image_u8(os.path.join(tmp, "even", "LR", "X4", "0000x4.png"))
        if model_name == "edsr":
            save_edsr_baseline(torch, pth, first_lr.transpose(2, 0, 1), device)
            model_flags = ["--model", "edsr"]
            # {m: (conv3x3 launches by path, fused launches by kernel) per forward}
            expect = {m: ((WINO_CONV_PATH_LAUNCHES if m else PATH_LAUNCHES)["f32"],
                          {k: (16 if k == m else 0) for k in (2, 4)}) for m in (0, 2, 4)}
            per_kxk, probes = KXK_LAUNCHES, 1
        else:
            save_larvanet(torch, pth, model_name, LARVANET_FLAGS, device)
            model_flags = ["--model", model_name] + LARVANET_FLAGS
            routes = LARVANET_ROUTES["%s 2x16" % model_name][2]
            expect = {m: (conv_path_launches(routes[m][0]),
                          {k: (routes[m][1] if k == m else 0) for k in (2, 4)})
                      for m in (0, 2, 4)}
            per_kxk, probes = NO_KXK, 0

        psnrs, wino_launches = {}, {}
        for m in (0, 2, 4):
            sub = "all" if m == 0 else "even"
            n_images = len(io.list_pngs(os.path.join(tmp, sub, "HR")))
            report = os.path.join(tmp, "report_%d.json" % m)
            conv3x3.reset_launches()
            ck.reset_launches()
            wino_resblock.reset_launches()
            t0 = time.perf_counter()
            validate.main(model_flags + ["--scales", "4", "--device", device,
                                         "--restore_path", pth,
                           "--data_input_path", os.path.join(tmp, sub, "LR"),
                           "--data_truth_path", os.path.join(tmp, sub, "HR"),
                           "--report_json", report, "--wino_trunk", str(m)])
            seconds = time.perf_counter() - t0
            conv, wino = conv3x3.LAUNCHES, dict(wino_resblock.LAUNCHES)
            conv_by_path = dict(conv3x3.LAUNCHES_BY_PATH)
            wino_by_path = dict(wino_resblock.LAUNCHES_BY_PATH)
            with open(report) as f:
                psnrs[m] = json.load(f)["scales"]["4"]["per_image"]
            want_by_path = {p: k * n_images + probes * PROBE_LAUNCHES[p]
                            for p, k in expect[m][0].items()}
            want_conv = sum(want_by_path.values())
            want_wino = expect[m][1]
            print("validate %s --wino_trunk %d: %d images in %.3f s; per forward %s conv3x3 "
                  "launches, %s F(2,3) and %s F(4,3) launches; PSNRs %s" % (
                      model_name, m, n_images, seconds, conv / n_images, wino[2] / n_images,
                      wino[4] / n_images,
                      ", ".join("%s %.4f" % kv for kv in sorted(psnrs[m].items()))))
            if conv != want_conv or conv_by_path != want_by_path or any(
                    wino[k] != want_wino[k] * n_images for k in (2, 4)):
                raise AssertionError("validate %s --wino_trunk %d: %d conv3x3 (%s) and %s "
                                     "wino launches for %d forwards and %d tail probes, not %d "
                                     "(%s) and %s each" % (
                                         model_name, m, conv, conv_by_path, wino, n_images,
                                         probes, want_conv, want_by_path, want_wino))
            expect_kxk("validate %s --wino_trunk %d" % (model_name, m), kxk_launches(ck),
                       per_kxk, n_images)
            if m:
                wino_launches[m] = wino_by_path
                deltas = [abs(psnrs[m][k] - psnrs[0][k]) for k in psnrs[m]]
                print("validate %s --wino_trunk %d: max |dPSNR| %.3g dB against "
                      "--wino_trunk 0 (bar %g)" % (model_name, m, max(deltas),
                                                   VALIDATE_PSNR_TOL))
                if len(deltas) != len(VALIDATE_LR) or max(deltas) > VALIDATE_PSNR_TOL:
                    raise AssertionError("validate %s --wino_trunk %d: PSNRs %s, --wino_trunk "
                                         "0: %s" % (model_name, m, psnrs[m], psnrs[0]))
        if model_name != "edsr":
            return wino_launches

        # the unclamped f32 forward through each wino kernel against the
        # forward through the conv3x3 kernel, both on the same baked tail
        from larvanet_tpu_torch.ops.collapsed_tail import make_collapsed_edsr_forward
        from larvanet_tpu_torch.ops.wino_resblock import make_wino_edsr_forward

        model = get_model("edsr")
        model.parse_args([])
        model.prepare([4], device=device, seed=SEED)
        model.restore(pth)
        img = first_lr.transpose(2, 0, 1)
        direct = make_collapsed_edsr_forward(model)
        model.set_route(direct)
        ref = model.upscale_device([img], 4, uint8=False)
        for m in (2, 4):
            model.set_route(make_wino_edsr_forward(model, m))
            got = model.upscale_device([img], 4, uint8=False)
            model.set_route(direct)
            err = float((got - ref).abs().max())
            bar = WINO_FWD_RTOL * float(ref.abs().max())
            print("validate: unclamped f32 forward through F(%d,3) vs the conv3x3 forward: "
                  "max |d| %.3g (bar %.3g)" % (m, err, bar))
            if err > bar or not torch.isfinite(got).all():
                raise AssertionError("the F(%d,3) forward disagrees with the conv3x3 "
                                     "forward" % m)
    return wino_launches


def runtime_phase(torch, device="cuda", model_name="edsr"):
    """Phase 7 (EDSR-baseline x4, every --wino_trunk) or 7b (`model_name` a
    LarvaNet preset at LARVANET_FLAGS, its --wino_trunk routes in
    LARVANET_ROUTES). The port's runtime CLI at the DIV2K x4 LR size, f32
    and bf16, with each run's launches by path (EDSR: the default collapsed
    tail, probed inside the counted run; its conv_kxk launches give the
    forwards). Returns {m: fused launches by path under --wino_trunk m}."""
    from larvanet_tpu_torch.cli import runtime
    from larvanet_tpu_torch.ops import conv3x3
    from larvanet_tpu_torch.ops import conv_kxk as ck
    from larvanet_tpu_torch.ops import wino_resblock as wr

    n, h, w = RAGGED
    launches = {2: {}, 4: {}}
    if model_name == "edsr":
        model_flags, label = ["--model", "edsr"], "EDSR-baseline x4"
        # {dtype: {m: (conv3x3 launches by path, fused launches by path) per forward}}
        expect = {d: {m: ((WINO_CONV_PATH_LAUNCHES if m else PATH_LAUNCHES)[d],
                          WINO_PATH_LAUNCHES[d] if m else fused_path_launches(0))
                      for m in (0, 2, 4)} for d in ("f32", "bf16")}
        per_kxk, probes = KXK_LAUNCHES, 1
    else:
        label = "%s 2x16" % model_name
        model_flags = ["--model", model_name] + LARVANET_ROUTES[label][1]
        expect = {d: {m: (conv_path_launches(shapes), fused_path_launches(fused))
                      for m, (shapes, fused) in LARVANET_ROUTES[label][2].items()}
                  for d in ("f32", "bf16")}
        per_kxk, probes = None, 0
    for dtype_name in ("f32", "bf16"):
        for m, (per_conv, per_fused) in expect[dtype_name].items():
            conv3x3.reset_launches()
            ck.reset_launches()
            wr.reset_launches()
            mean_s, mps = runtime.main(model_flags + [
                "--scales", "4", "--device", device, "--input_height", str(h),
                "--input_width", str(w), "--num_warmup", "2", "--num_iters", str(TIMED_REPS),
                "--wino_trunk", str(m), "--serving_dtype", dtype_name])
            conv, wino = dict(conv3x3.LAUNCHES_BY_PATH), dict(wr.LAUNCHES_BY_PATH)
            print("runtime: %s, %dx%d LR, %s, --wino_trunk %d: %.4f ms per frame, %.3f "
                  "LR-MP/s; launches conv3x3 %s, fused %s" % (
                      label, h, w, dtype_name, m, 1e3 * mean_s, mps, conv, wino), flush=True)
            kxk = kxk_launches(ck)
            forwards = (kxk["tensor_core"] // per_kxk["tensor_core"] if per_kxk
                        else sum(conv.values()) // sum(per_conv.values()))
            want_conv = {p: k * forwards + probes * PROBE_LAUNCHES[p]
                         for p, k in per_conv.items()}
            want_fused = {p: k * forwards for p, k in per_fused.items()}
            if forwards == 0 or conv != want_conv or wino != want_fused:
                raise AssertionError("runtime %s %s --wino_trunk %d: launches conv3x3 %s and "
                                     "fused %s, not %s and %s" % (
                                         label, dtype_name, m, conv, wino, want_conv,
                                         want_fused))
            if per_kxk:
                expect_kxk("runtime %s %s --wino_trunk %d" % (label, dtype_name, m), kxk,
                           per_kxk, forwards)
            if m:
                _add(launches[m], wino)
    return launches


def wgrad_bound_ms(n, h, w, c, f):
    """The least time of one weight and bias gradient in f32: x and g read
    once, dW and db written once, over HBM bandwidth vs its 2 N H W 9 C F
    operations (and N H W F for db) over the f32 peak (PEAK_FLOPS)."""
    nbytes = 4 * (n * h * w * (c + f) + 9 * c * f + f)
    flops = 2 * n * h * w * 9 * c * f + n * h * w * f
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS["f32"]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def train_kernel_phase(torch, wgrad_shapes=TRAIN_WGRAD, dgrad_shapes=TRAIN_DGRAD,
                       label="EDSR-baseline x4"):
    """Phase 8's kernel half (8b's with LarvaNet's shapes): the wgrad kernel
    at every (C, F, size) of a train step (TRAIN_WGRAD), and the conv
    kernel at the dgrad shapes no forward has (TRAIN_DGRAD), each held
    against its plain version on the card and timed in turns with it and
    cuDNN's gradient (torch.nn.grad.conv2d_weight / conv2d_input, TF32
    off), beside its bound. The wgrad kernel runs on its shape's path and,
    as the earlier kernel of the same function, on its CUDA-core entries;
    both are held to the plain version and timed in the same turns. Returns
    ({"ms", "cuda_core_ms", "plain_ms", "library_ms", "bound_ms"} summed
    over one `label` train step's wgrad launches (the shapes' counts), its
    bound's kind, the largest wgrad |d| and |d| / max |dW| of either entry,
    {name: dgrad numbers}, {name: the wgrad shape's numbers})."""
    from larvanet_tpu_torch.ops import conv3x3_wgrad as wg
    from larvanet_tpu_torch.ops.conv3x3 import (conv3x3_bias_act,
                                                conv3x3_bias_act_reference, dgrad_kernel,
                                                path_for)

    n = TRAIN_BATCH
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    keys = ("ms", "cuda_core_ms", "plain_ms", "library_ms", "bound_ms")
    sums = dict.fromkeys(keys, 0.0)
    kinds = {}
    shapes = {}
    worst_abs = worst_rel = 0.0
    for name, mult, c, f, count in wgrad_shapes:
        h = w = TRAIN_PATCH * mult
        x = torch.randn((n, h, w, c), generator=gen, device="cuda")
        g = torch.randn((n, h, w, f), generator=gen, device="cuda") / (n * h * w)
        path = wg.path_for(c, f)
        want_w, want_b = wg.conv3x3_wgrad_reference(x, g)
        errs = {}
        for which, entry in (("kernel", path), ("cuda_core", "cuda_core")):
            dw, db = wg.conv3x3_wgrad(x, g, path=entry)
            torch.cuda.synchronize()  # a fault during the run shows here
            err = max(float((dw - want_w).abs().max()), float((db - want_b).abs().max()))
            rel = max(float((dw - want_w).abs().max() / want_w.abs().max()),
                      float((db - want_b).abs().max() / want_b.abs().max()))
            worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
            if rel > GRAD_RTOL or not bool(torch.isfinite(dw).all()):
                raise AssertionError("wgrad %s: the %s entry disagrees with its plain version, "
                                     "max |d| / max |dW| = %g" % (name, entry, rel))
            errs[which] = (err, rel)
        x_nchw, g_nchw = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        t = time_windows(torch, {
            "kernel": lambda: wg.conv3x3_wgrad(x, g),
            "cuda_core": lambda: wg.conv3x3_wgrad(x, g, path="cuda_core"),
            "conv2d_weight": lambda: torch.nn.grad.conv2d_weight(x_nchw, (f, c, 3, 3), g_nchw,
                                                                 padding=1),
            "plain": lambda: wg.conv3x3_wgrad_reference(x, g)})
        bound, by = wgrad_bound_ms(n, h, w, c, f)
        print("wgrad %-18s x=%s C=%d F=%d (%s path): kernel %s, cuda_core entry %s, "
              "conv2d_weight %s, plain %s, bound %.4f ms (%s), max|d| %.3g (%.3g of max |dW|), "
              "cuda_core entry %.3g (%.3g), %d a step" % (
                  name, (n, h, w), c, f, path, spread(t["kernel"]), spread(t["cuda_core"]),
                  spread(t["conv2d_weight"]), spread(t["plain"]), bound, by,
                  *errs["kernel"], *errs["cuda_core"], count), flush=True)
        part = {"ms": t["kernel"][0], "cuda_core_ms": t["cuda_core"][0],
                "plain_ms": t["plain"][0], "library_ms": t["conv2d_weight"][0],
                "bound_ms": bound}
        shapes[name] = dict(part, path=path, bound_by=by, max_abs_err=errs["kernel"][0],
                            max_rel_err=errs["kernel"][1])
        for k in keys:
            sums[k] += count * part[k]
        kinds[by] = kinds.get(by, 0.0) + count * bound
        del x, g, dw, db, want_w, want_b
        torch.cuda.empty_cache()
    dgrad = {}
    for name, mult, c, f in dgrad_shapes:
        h = w = TRAIN_PATCH * mult
        g = torch.randn((n, h, w, c), generator=gen, device="cuda")
        # the forward's HWIO kernel, F -> C, at phase 3's output scale
        k_fwd = 0.05 * torch.randn((3, 3, f, c), generator=gen, device="cuda")
        k = dgrad_kernel(k_fwd)
        zero = torch.zeros(f, device="cuda")
        got = conv3x3_bias_act(g, k, zero, None, dgrad=True)
        torch.cuda.synchronize()
        want = conv3x3_bias_act_reference(g, k, zero, None)
        # a gradient, held as the train step's are: relative to its largest
        # value (at C = 256 the split-TF32 sums run 2,304 terms, four times
        # phase 3's, and their truncation error grows with them)
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        if rel > GRAD_RTOL or not bool(torch.isfinite(got).all()):
            raise AssertionError("dgrad %s: the conv kernel disagrees with its plain version, "
                                 "max |d| / max |dx| = %g" % (name, rel))
        w_oihw = k_fwd.permute(3, 2, 0, 1).contiguous()  # the forward's (C, F, 3, 3)
        g_nchw = g.permute(0, 3, 1, 2)
        t = time_windows(torch, {
            "kernel": lambda: conv3x3_bias_act(g, k, zero, None, dgrad=True),
            "conv2d_input": lambda: torch.nn.grad.conv2d_input((n, f, h, w), w_oihw, g_nchw,
                                                               padding=1),
            "plain": lambda: conv3x3_bias_act_reference(g, k, zero, None)})
        bound, by = bound_ms(n, h, w, c, f, "f32")
        path = path_for(c, f, torch.float32)
        print("dgrad %-18s g=%s C=%d F=%d (%s path): kernel %s, conv2d_input %s, plain %s, "
              "bound %.4f ms (%s), max|d| %.3g (%.3g of max |dx|)" % (
                  name, (n, h, w), c, f, path, spread(t["kernel"]), spread(t["conv2d_input"]),
                  spread(t["plain"]), bound, by, err, rel), flush=True)
        dgrad[name] = {"path": path, "ms": t["kernel"][0], "plain_ms": t["plain"][0],
                       "library_ms": t["conv2d_input"][0], "bound_ms": bound, "bound_by": by,
                       "max_abs_err": err, "max_rel_err": rel}
        del g, k, k_fwd, got, want
        torch.cuda.empty_cache()
    print("wgrad per %s train step (%d launches), f32: kernel %.4f ms, cuda_core entries "
          "%.4f ms, plain %.4f ms, conv2d_weight %.4f ms, bound %.4f ms" % (
              label, sum(shape[-1] for shape in wgrad_shapes), sums["ms"],
              sums["cuda_core_ms"], sums["plain_ms"], sums["library_ms"], sums["bound_ms"]),
          flush=True)
    return sums, max(kinds, key=kinds.get), worst_abs, worst_rel, dgrad, shapes


def write_train_set(root, rng, n_frames, lr_size):
    """A DIV2K-layout train set by the port's PNG encoder: `photo` HR frames
    and their 4x4 box means as LR."""
    import numpy as np

    from larvanet_tpu_torch.data import io

    h, w = lr_size
    for i in range(n_frames):
        hr = photo(rng, 4 * h, 4 * w)
        lr = np.round(hr.reshape(3, h, 4, w, 4).mean((2, 4))).astype(np.uint8)
        io.save_image_chw(hr, os.path.join(root, "HR", "%04d.png" % i))
        io.save_image_chw(lr, os.path.join(root, "LR", "X4", "%04dx4.png" % i))


def check_train_grads(torch, model, x, t, label, batch, patch, same_forward=False,
                      loss_rtol=None, grad_rtol=None):
    """One batch's loss and gradients through the kernels against the same
    autograd Function with the plain versions inside, from the same weights
    and batch: the loss within LOSS_RTOL, every parameter's gradient within
    GRAD_RTOL of its tensor's largest |g|. With `same_forward` (phase 8b)
    the gradients are held against the plain dgrad and wgrad run on the
    kernels' forward: the forward's rounding (split TF32) puts a few ReLU
    pre-activations of the trunk on the other side of 0, and each such flip
    moves a weight gradient that cancels over the batch by more than
    GRAD_RTOL of its largest value. The all-plain step's gradients are then
    printed beside, with the flips counted (the plain conv on the same
    input), and its loss is held at LOSS_RTOL. `loss_rtol` and `grad_rtol`
    replace the two bars (phase 13's bf16 step). The collapsed tail's
    conv_kxk and its wgrad (phase 14c), and the depthwise conv and its
    wgrad (phase 15d), take the same plain versions beside conv3x3's."""
    import numpy as np

    from larvanet_tpu_torch.ops import conv3x3
    from larvanet_tpu_torch.ops import conv3x3_wgrad as wg
    from larvanet_tpu_torch.ops import conv_kxk as ck
    from larvanet_tpu_torch.ops import dwconv3x3 as dw

    kernel_conv, plain_wgrad = conv3x3.conv3x3_bias_act, wg.conv3x3_wgrad_reference
    kernel_kxk, kernel_kxk_wgrad = ck.conv_kxk, ck.conv_kxk_wgrad
    kernel_dw, kernel_dw_wgrad = dw.dwconv3x3, dw.dwconv3x3_wgrad

    def plain_dw(x, kernel, bias, dgrad=False):
        return dw.dwconv3x3_reference(x, kernel, bias)

    def plain_dw_dgrad(x, kernel, bias, dgrad=False):
        return (plain_dw if dgrad else kernel_dw)(x, kernel, bias)

    def plain_conv(x, kernel, bias, act=None, dgrad=False, slope=0.1):
        return conv3x3.conv3x3_bias_act_reference(x, kernel, bias, act, slope)

    def plain_dgrad(x, kernel, bias, act=None, dgrad=False, slope=0.1):
        return (plain_conv if dgrad else kernel_conv)(x, kernel, bias, act, slope=slope)

    def plain_kxk_dgrad(x, kernel, bias=None, pads=None, dgrad=False):
        return (plain_kxk if dgrad else kernel_kxk)(x, kernel, bias, pads)

    def loss_and_grads(conv=kernel_conv, wgrad=wg.conv3x3_wgrad):
        kxk, kxk_wgrad = kernel_kxk, kernel_kxk_wgrad
        dwc, dw_wgrad = kernel_dw, kernel_dw_wgrad
        if conv is not kernel_conv:
            kxk = plain_kxk_dgrad if conv is plain_dgrad else plain_kxk
            dwc = plain_dw_dgrad if conv is plain_dgrad else plain_dw
        if wgrad is not wg.conv3x3_wgrad:
            kxk_wgrad = ck.conv_kxk_wgrad_reference
            dw_wgrad = dw.dwconv3x3_wgrad_reference
        with mock.patch.object(conv3x3, "conv3x3_bias_act", conv), \
                mock.patch.object(wg, "conv3x3_wgrad", wgrad), \
                mock.patch.object(ck, "conv_kxk", kxk), \
                mock.patch.object(ck, "conv_kxk_wgrad", kxk_wgrad), \
                mock.patch.object(dw, "dwconv3x3", dwc), \
                mock.patch.object(dw, "dwconv3x3_wgrad", dw_wgrad):
            loss = float(model._loss_and_grads(x, t))
        # full EBRN's last BRM owns a down_block and bp_flow that no forward runs
        grads = {k: p.grad.clone() for k, p in model.module.named_parameters()
                 if p.grad is not None}
        model.optimizer.zero_grad(set_to_none=True)
        return loss, grads

    def worst(got, want):
        return max((float((got[k] - want[k]).abs().max() / want[k].abs().max()), k)
                   for k in want)

    loss_k, grads_k = loss_and_grads()
    loss_p, grads_p = loss_and_grads(plain_conv, plain_wgrad)
    held, against = grads_p, "the plain versions'"
    if same_forward:
        held, against = loss_and_grads(plain_dgrad, plain_wgrad)[1], \
            "the plain dgrad and wgrad on the kernels' forward"
        flips = [0, 0]

        def counting(x, kernel, bias, act=None, dgrad=False, slope=0.1):
            out = kernel_conv(x, kernel, bias, act, dgrad=dgrad, slope=slope)
            if act == "relu":
                ref = plain_conv(x, kernel, bias, act)
                flips[0] += int(((out > 0) != (ref > 0)).sum())
                flips[1] += out.numel()
            return out

        # with gradients on, as in the step: the Function's forward calls the
        # conv through its module, where the counting wrapper sits
        with mock.patch.object(conv3x3, "conv3x3_bias_act", counting):
            model._compute_loss(x, t)
        print("train: %s, all-plain step against the kernels': worst gradient %s, max |d| / "
              "max |g| %.3g (not held); ReLU outputs on the other side of 0 than the plain "
              "conv's on the same input: %d of %d" % (label, *worst(grads_k, grads_p)[::-1],
                                                      *flips), flush=True)
    err, name = worst(grads_k, held)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    loss_rtol = LOSS_RTOL if loss_rtol is None else loss_rtol
    grad_rtol = GRAD_RTOL if grad_rtol is None else grad_rtol
    print("train: %s, %d x %dx%d LR patches: loss through the kernels %.6f, plain %.6f "
          "(rel %.3g, bar %g); gradients against %s: worst %s, max |d| / max |g| %.3g "
          "(bar %g)" % (label, batch, patch, patch, loss_k, loss_p, loss_rel, loss_rtol,
                        against, name, err, grad_rtol), flush=True)
    if loss_rel > loss_rtol or err > grad_rtol or not np.isfinite(loss_k):
        raise AssertionError("the %s train step's loss or gradients through the kernels "
                             "disagree with %s" % (label, against))


def counted_step(torch, fn):
    """The kernels' launches by path in one call of `fn`, the counters zeroed
    just before it: {"forward": conv3x3, "dgrad": conv3x3 input gradients,
    "wgrad": the weight-gradient kernel}."""
    from larvanet_tpu_torch.ops import conv3x3
    from larvanet_tpu_torch.ops import conv3x3_wgrad as wg

    conv3x3.reset_launches()
    wg.reset_launches()
    fn()
    torch.cuda.synchronize()
    dgrad = dict(conv3x3.DGRAD_LAUNCHES_BY_PATH)
    launches = {"forward": {p: conv3x3.LAUNCHES_BY_PATH[p] - dgrad[p] for p in dgrad},
                "dgrad": dgrad, "wgrad": dict(wg.LAUNCHES_BY_PATH)}
    print("launches: conv3x3 forward %s, dgrad %s; wgrad %s"
          % (launches["forward"], launches["dgrad"], launches["wgrad"]), flush=True)
    return launches


def time_train_step(torch, model, x, t, step, label, batch, patch, dname="f32"):
    """The median ms of `step` (CUDA events) and where the card's time goes
    in it: forward convs (a loss with gradients on, the Function's forwards),
    dgrad convs, wgrad, optimizer and other kernels, idle. Returns the
    time_windows entry."""
    tm = time_windows(torch, {"train_step": step})["train_step"]
    train_step_split(torch, model, x, t, step, label, batch, patch, dname, tm)
    return tm


def train_step_split(torch, model, x, t, step, label, batch, patch, dname, tm):
    """Print a train step's time `tm` (a time_windows entry) and where the
    card's time goes in it (time_train_step's split, over SPLIT_REPS
    profiled calls)."""
    print("train: %s, batch %d x %dx%d, %s: %s per train step, %.3f LR-MP/s trained"
          % (label, batch, patch, patch, dname, spread(tm),
             batch * patch * patch / 1e3 / tm[0]), flush=True)
    _, fwd = device_breakdown(torch, lambda: model._compute_loss(x, t),
                              kinds=("wgrad", "conv3x3"))
    _, parts = device_breakdown(torch, step, kinds=("wgrad", "conv3x3"))
    if parts is None or fwd is None:
        print("train step device breakdown not measured (the profiler recorded no kernel)")
        return
    split = {"forward convs": fwd["conv3x3"], "dgrad convs": parts["conv3x3"] - fwd["conv3x3"],
             "wgrad": parts["wgrad"], "optimizer and other kernels": parts["other"]}
    split["idle"] = max(tm[0] - sum(split.values()), 0.0)
    print("train step device split (%s): %s" % (label, ", ".join(
        "%s %.4f ms (%.1f%%)" % (k, v, 100.0 * v / tm[0]) for k, v in split.items())),
        flush=True)


def train_phase(torch):
    """Phase 8. EDSR-baseline x4 trained at full width through the kernels,
    on the plain tail (--collapsed_tail_train 0, and validate with
    --collapsed_tail 0): the counts and checks of the module graph; the
    default collapsed route is phase 14c's. Returns the counted train
    step's launches: {"forward": conv3x3 by path, "dgrad": conv3x3 by path,
    "wgrad": wgrad by path}."""
    import shutil

    import numpy as np

    from larvanet_tpu_torch.cli import train, validate
    from larvanet_tpu_torch.core.registry import get_loader, get_model
    from larvanet_tpu_torch.data import io

    device, batch, patch, steps = "cuda", TRAIN_BATCH, TRAIN_PATCH, TRAIN_STEPS
    with tempfile.TemporaryDirectory() as tmp:
        write_train_set(tmp, np.random.default_rng(SEED + 8), TRAIN_FRAMES, TRAIN_LR)
        data_flags = ["--data_input_path", os.path.join(tmp, "LR"),
                      "--data_truth_path", os.path.join(tmp, "HR"), "--data_cached",
                      "--data_seed", str(SEED)]
        loader = get_loader("div2k_train_loader")
        loader.parse_args(data_flags)
        loader.prepare([4])
        loader.reseed_for_step(0)
        lr_list, hr_list = loader.get_patch_batch(batch, 4, patch)
        model = get_model("edsr")
        model.parse_args(["--collapsed_tail_train", "0"])
        model.prepare([4], device=device, seed=SEED, is_training=True)
        if model.num_parameters() != 1517571:
            raise AssertionError("EDSR-baseline x4 has %d parameters" % model.num_parameters())
        x = torch.from_numpy(np.stack(lr_list).transpose(0, 2, 3, 1).copy()).to(device)
        t = torch.from_numpy(np.stack(hr_list).transpose(0, 2, 3, 1).copy()).to(device)

        check_train_grads(torch, model, x, t, "EDSR-baseline x4", batch, patch)
        launches = counted_step(torch, lambda: model.train_step(lr_list, 4, hr_list))
        if launches != TRAIN_LAUNCHES:
            raise AssertionError("train step launches %s, not %s" % (launches, TRAIN_LAUNCHES))
        time_train_step(torch, model, x, t, lambda: model.train_step(lr_list, 4, hr_list),
                        "EDSR-baseline x4", batch, patch)
        del model, x, t
        torch.cuda.empty_cache()

        # the CLI: steps 1..`steps`, a checkpoint every steps / 2
        half = steps // 2
        cli = ["--dataloader", "div2k_train_loader", "--model", "edsr", "--scales", "4",
               "--device", device, "--batch_size", str(batch), "--input_patch_size",
               str(patch), "--log_freq", str(half), "--save_freq", str(half),
               "--collapsed_tail_train", "0"] + data_flags
        run = os.path.join(tmp, "run")
        t0 = time.perf_counter()
        trained, losses = train.main(cli + ["--train_path", run, "--max_steps", str(steps)])
        print("train CLI: %d steps in %.3f s; loss at step 1 %.6f, at step %d %.6f" % (
            steps, time.perf_counter() - t0, losses[1], steps, losses[steps]), flush=True)
        if not losses[steps] < losses[1]:
            raise AssertionError("the loss did not fall: %s" % losses)
        # resume from the middle checkpoint: the same losses, bit for bit
        again = os.path.join(tmp, "again")
        os.makedirs(again)
        for suffix in (".pth", ".state.pt"):
            shutil.copy(os.path.join(run, "model_%d%s" % (half, suffix)), again)
        _, resumed = train.main(cli + ["--train_path", again, "--max_steps", str(steps),
                                       "--restore_path", "latest"])
        same = {s: (losses[s], resumed.get(s)) for s in range(half + 1, steps + 1)}
        print("train CLI resumed at step %d: losses %s the first run's" % (
            half, "repeat" if all(a == b for a, b in same.values()) else "DO NOT repeat"),
            flush=True)
        if sorted(resumed) != list(range(half + 1, steps + 1)) or any(
                a != b for a, b in same.values()):
            raise AssertionError("the resumed run's losses differ: %s" % same)

        # validate restores model_<steps>.pth: its frames are the trained forward's
        val = os.path.join(tmp, "val")
        for name in ("0000", "0001"):
            for sub in ("HR", os.path.join("LR", "X4")):
                src = name + ("x4" if sub != "HR" else "") + ".png"
                os.makedirs(os.path.join(val, sub), exist_ok=True)
                shutil.copy(os.path.join(tmp, sub, src), os.path.join(val, sub, src))
        validate.main(["--model", "edsr", "--scales", "4", "--device", device,
                       "--collapsed_tail", "0",
                       "--restore_path", os.path.join(run, "model_%d.pth" % steps),
                       "--data_input_path", os.path.join(val, "LR"),
                       "--data_truth_path", os.path.join(val, "HR"),
                       "--save_path", os.path.join(tmp, "sr")])
        for name in ("0000", "0001"):
            lr = io.load_image_u8(os.path.join(val, "LR", "X4", name + "x4.png"))
            want = trained.upscale_uint8([lr.transpose(2, 0, 1)], 4)[0]
            got = io.load_image_u8(os.path.join(tmp, "sr", "x4", name + ".png"))
            if not np.array_equal(got.transpose(2, 0, 1), want):
                raise AssertionError("validate's frame %s from model_%d.pth differs from the "
                                     "trained forward's" % (name, steps))
        print("train: validate on model_%d.pth gives the trained forward's frames, bit for "
              "bit" % steps, flush=True)
        del trained
    return launches


def larva_train_phase(torch, device="cuda"):
    """Phase 8b. The flagship LarvaNet 2x16 trained at full width through the
    kernels: one step's gradients against the plain versions, a counted and
    a timed step, train_larva for LARVA_TRAIN_STEPS steps and a resume from
    its middle checkpoint, and train_larvaV2 on LarvaNetV2 2x4. Returns
    {"step": the counted flagship step's launches, "v2": the V2 run's}, each
    {"forward": conv3x3 by path, "dgrad": conv3x3 by path, "wgrad": by path}."""
    import shutil

    import numpy as np

    from larvanet_tpu_torch.cli import train_larva, train_larvaV2
    from larvanet_tpu_torch.core.registry import get_loader, get_model
    from larvanet_tpu_torch.models import larvanet

    batch, patch, label = TRAIN_BATCH, TRAIN_PATCH, "LarvaNet 2x16"
    with tempfile.TemporaryDirectory() as tmp:
        write_train_set(tmp, np.random.default_rng(SEED + 8), TRAIN_FRAMES, TRAIN_LR)
        data_flags = ["--data_input_path", os.path.join(tmp, "LR"),
                      "--data_truth_path", os.path.join(tmp, "HR"), "--data_cached",
                      "--data_seed", str(SEED)]
        loader = get_loader("div2k_train_loader")
        loader.parse_args(data_flags)
        loader.prepare([4])
        loader.reseed_for_step(0)
        lr_nhwc, hr_nhwc = loader.get_patch_batch_nhwc(batch, 4, patch)
        model = get_model("LarvaNet")
        model.parse_args(list(LARVANET_FLAGS))
        model.prepare([4], device=device, seed=SEED, is_training=True)
        if model.num_parameters() != LARVANET_PARAMS["LarvaNet"]:
            raise AssertionError("%s has %d parameters" % (label, model.num_parameters()))
        x, t = torch.from_numpy(lr_nhwc).to(device), torch.from_numpy(hr_nhwc).to(device)

        check_train_grads(torch, model, x, t, label, batch, patch, same_forward=True)
        step = lambda: model.train_step(lr_nhwc, 4, hr_nhwc)  # noqa: E731
        launches = {"step": counted_step(torch, step)}
        if launches["step"] != LARVA_TRAIN_LAUNCHES:
            raise AssertionError("%s train step launches %s, not %s"
                                 % (label, launches["step"], LARVA_TRAIN_LAUNCHES))
        time_train_step(torch, model, x, t, step, label, batch, patch)
        del model, x, t
        torch.cuda.empty_cache()

        # validation frames, and train_larva with a checkpoint every
        # LARVA_VAL_STEPS steps; each validation's step, PSNR and lr recorded
        val = os.path.join(tmp, "val")
        for i in range(LARVA_VAL_FRAMES):
            for sub, name in (("HR", "%04d.png" % i), (os.path.join("LR", "X4"),
                                                     "%04dx4.png" % i)):
                os.makedirs(os.path.join(val, sub), exist_ok=True)
                shutil.copy(os.path.join(tmp, sub, name), os.path.join(val, sub, name))
        volume = patch * patch * batch * 3
        cli = ["--dataloader", "div2k_train_loader", "--device", device,
               "--val_data_input_path", os.path.join(val, "LR"),
               "--val_data_truth_path", os.path.join(val, "HR"), "--batch_size", str(batch),
               "--input_patch_size", str(patch), "--log_freq", str(LARVA_VAL_STEPS)] + data_flags
        larva_cli = cli + LARVANET_FLAGS + LARVA_SCHEDULE + [
            "--max_steps", str(LARVA_TRAIN_STEPS), "--val_volume", str(LARVA_VAL_STEPS * volume)]
        seen = []
        validate_for_train = larvanet.LarvaNetBase.validate_for_train

        def recording(model, args, loader):
            psnr = validate_for_train(model, args, loader)
            seen.append((model.global_step, psnr, model.get_learning_rate()))
            return psnr

        run, again = os.path.join(tmp, "run"), os.path.join(tmp, "again")
        with mock.patch.object(larvanet.LarvaNetBase, "validate_for_train", recording):
            t0 = time.perf_counter()
            trained, losses = train_larva.main(larva_cli + ["--train_path", run])
            straight, seen[:] = list(seen), []
            print("train_larva: %s, %d steps in %.3f s; loss at step 1 %.6f, at step %d %.6f; "
                  "validations (step, PSNR, lr after) %s" % (
                      label, LARVA_TRAIN_STEPS, time.perf_counter() - t0, losses[1],
                      LARVA_TRAIN_STEPS, losses[LARVA_TRAIN_STEPS], straight), flush=True)
            want = [1, LARVA_VAL_STEPS, LARVA_TRAIN_STEPS]
            if [s for s, _, _ in straight] != want:
                raise AssertionError("train_larva validated at steps %s, not %s"
                                     % ([s for s, _, _ in straight], want))
            stems = ["model_step%d_vol0G" % s for s in want[1:]]
            files = sorted(os.listdir(run))
            if not all(s + ext in files for s in stems for ext in (".pth", ".state.pt")):
                raise AssertionError("train_larva wrote %s" % files)
            if not all(np.isfinite(v) for v in losses.values()) or not all(
                    np.isfinite(p) for _, p, _ in straight):
                raise AssertionError("train_larva's losses or PSNRs are not finite")
            # the resume from the middle checkpoint repeats the rest bit for bit
            os.makedirs(again)
            for ext in (".pth", ".state.pt"):
                shutil.copy(os.path.join(run, stems[0] + ext), again)
            resumed_model, resumed = train_larva.main(
                larva_cli + ["--train_path", again, "--restore_path", "latest"])
        rest = list(range(LARVA_VAL_STEPS + 1, LARVA_TRAIN_STEPS + 1))
        same = (sorted(resumed) == rest and all(resumed[s] == losses[s] for s in rest)
                and seen == straight[-1:]
                and resumed_model.scheduler.state_dict() == trained.scheduler.state_dict()
                and resumed_model.total_volume == trained.total_volume
                and all(torch.equal(a, b) for a, b in zip(trained.module.parameters(),
                                                          resumed_model.module.parameters())))
        print("train_larva resumed at step %d: losses, lr %s, the schedule, the volume and "
              "the weights %s the first run's" % (
                  LARVA_VAL_STEPS, [lr for _, _, lr in seen],
                  "repeat" if same else "DO NOT repeat"), flush=True)
        if not same:
            raise AssertionError("the resumed run differs: losses %s against %s, validations "
                                 "%s against %s" % (resumed, losses, seen, straight))
        del trained, resumed_model
        torch.cuda.empty_cache()

        # train_larvaV2: LarvaNetV2 2x4, validated at step 1 only
        v2_cli = cli + V2_FLAGS + ["--max_steps", str(V2_STEPS),
                                   "--train_path", os.path.join(tmp, "v2")]
        launches["v2"] = counted_step(torch, lambda: train_larvaV2.main(v2_cli))
        n_val = LARVA_VAL_FRAMES
        want = {k: {p: V2_STEPS * n for p, n in by.items()}
                for k, by in V2_STEP_LAUNCHES.items()}
        for p, n in V2_VAL_FORWARD.items():
            want["forward"][p] += n_val * n
        if launches["v2"] != want:
            raise AssertionError("train_larvaV2 launches %s, not %s" % (launches["v2"], want))
        print("train_larvaV2: LarvaNetV2 %s, %d steps and %d validation forwards: launches "
              "as expected" % (" ".join(V2_FLAGS), V2_STEPS, n_val), flush=True)
    return launches


def plain_kxk(x, kernel, bias=None, pads=None, dgrad=False):
    """conv_kxk's plain version with the wrapper's signature (a fixed
    kernel, a ConvGroup of one, carries its bias)."""
    from larvanet_tpu_torch.ops import conv_kxk as ck

    if isinstance(kernel, ck.ConvGroup):
        (kernel,), (bias,) = kernel.kernels, kernel.biases
    return ck.conv_kxk_reference(x, kernel, bias, pads)


def kxk_launches(ck):
    """conv_kxk's launches by path since its counters were zeroed, single
    (by path) and grouped ("group_" + path)."""
    out = dict(ck.LAUNCHES_BY_PATH)
    out.update({"group_" + p: k for p, k in ck.GROUP_LAUNCHES_BY_PATH.items()})
    return out


def plain_versions():
    """A context in which every conv3x3, conv_kxk (single and grouped),
    fused ResBlock and depthwise conv call runs its plain version (and
    counts no launch)."""
    from larvanet_tpu_torch.models import layers
    from larvanet_tpu_torch.ops import collapsed_tail
    from larvanet_tpu_torch.ops import conv3x3
    from larvanet_tpu_torch.ops import conv_kxk as ck
    from larvanet_tpu_torch.ops import dwconv3x3 as dw
    from larvanet_tpu_torch.ops import wino_resblock as wr

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(layers, "conv3x3_bias_act",
                                          conv3x3.conv3x3_bias_act_reference))
    stack.enter_context(mock.patch.object(ck, "conv_kxk", plain_kxk))
    stack.enter_context(mock.patch.object(collapsed_tail, "conv_kxk_group",
                                          ck.conv_kxk_group_reference))
    stack.enter_context(mock.patch.object(wr, "wino_resblock_transformed",
                                          wr.wino_resblock_transformed_reference))
    stack.enter_context(mock.patch.object(
        dw, "dwconv3x3", lambda x, kernel, bias, dgrad=False: dw.dwconv3x3_reference(
            x, kernel, bias)))
    return stack


# conv_kxk launches by path of the last `counted` run, and the sum of the
# main paths' runs that were held to their counts (the kernels line)
LAST_KXK = {}
KXK_FORWARDS = dict(NO_KXK)


def counted(torch, fn, device="cuda"):
    """fn() with the launch counters zeroed just before it and read just
    after: (its result, conv3x3 launches by path, fused launches by m); the
    conv_kxk launches by path go to LAST_KXK."""
    from larvanet_tpu_torch.ops import conv3x3
    from larvanet_tpu_torch.ops import conv_kxk as ck
    from larvanet_tpu_torch.ops import wino_resblock as wr

    conv3x3.reset_launches()
    ck.reset_launches()
    wr.reset_launches()
    out = fn()
    if device == "cuda":
        torch.cuda.synchronize()
    LAST_KXK.clear()
    LAST_KXK.update(kxk_launches(ck))
    return out, dict(conv3x3.LAUNCHES_BY_PATH), dict(wr.LAUNCHES)


def expect_kxk(label, by_path, per_forward, forwards):
    """Fail unless the conv_kxk launches `by_path` are `forwards` forwards'
    worth of `per_forward`; add them to KXK_FORWARDS."""
    want = {p: k * forwards for p, k in per_forward.items()}
    print("%s: conv_kxk launches by path %s (%d forwards)" % (label, by_path, forwards),
          flush=True)
    if dict(by_path) != want:
        raise AssertionError("%s: conv_kxk launches %s, not %d forwards' %s"
                             % (label, by_path, forwards, want))
    _add(KXK_FORWARDS, by_path)


def expect_forwards(label, by_path, per_forward, forwards, kxk=None, probes=0):
    """Fail unless `by_path` is `forwards` forwards' worth of `per_forward`
    and `probes` tail probes' (PROBE_LAUNCHES: a CLI that makes the collapsed
    route in the counted run); with `kxk`, the last counted run's conv_kxk
    launches too (`expect_kxk`)."""
    want = {p: k * forwards + probes * PROBE_LAUNCHES[p] for p, k in per_forward.items()}
    print("%s: conv3x3 launches by path %s (%d forwards%s)" % (
        label, by_path, forwards, ", %d tail probes" % probes if probes else ""), flush=True)
    if by_path != want:
        raise AssertionError("%s: conv3x3 launches %s, not %d forwards' and %d probes' %s"
                             % (label, by_path, forwards, probes, want))
    if kxk is not None:
        expect_kxk(label, LAST_KXK, kxk, forwards)


def tile_count(h, w, tile, overlap):
    """The tiles TiledUpscaler cuts from an h x w frame (1: a full-frame call)."""
    from larvanet_tpu_torch.eval.tiling import _tile_starts

    if h < tile or w < tile:
        return 1
    stride = tile - overlap
    return len(_tile_starts(h, tile, stride)) * len(_tile_starts(w, tile, stride))


def tile_forwards(h, w, tile, overlap, max_batch=None):
    """The forwards TiledUpscaler runs on an h x w frame in chunks of
    `max_batch` (default TILE_MAX_BATCH) tiles."""
    return math.ceil(tile_count(h, w, tile, overlap) / (max_batch or TILE_MAX_BATCH))


def _psnr(a, b) -> float:
    """PSNR (dB, peak 255) of one frame against another, unclamped."""
    mse = float(((a.double() - b.double()) ** 2).mean())
    return float("inf") if mse == 0 else 10.0 * math.log10(255.0 ** 2 / mse)


def peak_mb(torch, fn, device="cuda"):
    """Peak device memory (MB) allocated by PyTorch during one call of fn."""
    if device != "cuda":
        fn()
        return None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 1e6


def full_frame_model_phase(torch, label, device="cuda"):
    """Phases 10a-10c for one model of FULL_FRAME_MODELS on the
    FULL_FRAME_LR frame: chop, tiles and the self-ensemble through the
    kernels, each counted and held against its plain version (or the direct
    forward), then timed with its peak memory. EDSR serves on its default
    route, the collapsed tail (the self-ensemble runs the f32 module with
    its own tail); the exact tiling and the 8K frame's chunks must equal
    the direct forward and the chunks of 16 bit for bit. Returns the conv3x3
    launches by path of the counted runs."""
    import numpy as np

    from larvanet_tpu_torch.eval.ensemble import self_ensemble_forward
    from larvanet_tpu_torch.eval.tiling import TiledUpscaler, upscale_with_chop_forward
    from larvanet_tpu_torch.ops.collapsed_tail import make_collapsed_edsr_forward

    name, flags, per_forward, (exact_tile, exact_overlap) = FULL_FRAME_MODELS[label]
    kxk = FULL_FRAME_KXK[label]
    larva = name != "edsr"
    h, w = FULL_FRAME_LR
    rng = np.random.default_rng(SEED + 10)
    img = photo(rng, h, w)
    big = photo(rng, *BIG_FRAME_LR)
    with tempfile.TemporaryDirectory() as tmp:
        pth = os.path.join(tmp, "%s.pth" % name)
        if larva:
            save_larvanet(torch, pth, name, flags, device)
        else:
            save_edsr_baseline(torch, pth, img, device)
        model = larvanet_model(name, flags, device, pth)
    if not larva:
        model.set_route(make_collapsed_edsr_forward(model))
    totals = {}

    def hwc(chw):
        return torch.from_numpy(np.ascontiguousarray(chw.transpose(1, 2, 0))).to(device)

    def held(what, got, ref, base):
        """got within FWD_RTOL of ref, relative to ref's largest value
        (LarvaNet: its residual over `base`, the interpolated base)."""
        magnitude = ref - base if larva else ref
        err = float((got - ref).abs().max())
        bar = FWD_RTOL * float(magnitude.abs().max())
        print("full frame %s %s: max |d| %.3g (bar %.3g%s)" % (
            label, what, err, bar, ", relative to the residual" if larva else ""),
            flush=True)
        if got.shape != ref.shape or not bool(torch.isfinite(got).all()) or err > bar:
            raise AssertionError("full frame %s: %s disagrees" % (label, what))

    x = model._input_to_device([img])
    direct = model.fwd_runtime(x)[0]
    base = larvanet_base(torch, model, img) if larva else None

    # 10a: chop, 4 quadrants of 179 or 180 x 265
    def chop():
        return upscale_with_chop_forward(model, img, 4, CHOP_OVERLAP)

    got, by_path, _ = counted(torch, chop, device)
    expect_forwards("full frame %s chop" % label, by_path, per_forward, 4, kxk)
    _add(totals, by_path)
    with plain_versions():
        ref = chop()
    got, ref = hwc(got), hwc(ref)
    held("chop against its plain version", got, ref, base)
    print("full frame %s chop %d: PSNR %.2f dB against the direct forward, max |d| %.3g"
          % (label, CHOP_OVERLAP, _psnr(got, direct), float((got - direct).abs().max())))

    # 10b: tiles at the exact overlap (one chunk) against the direct forward,
    # at the CLIs' default overlap, and on the big frame in chunks of 64
    tilers = {"tile %d/%d" % (exact_tile, exact_overlap): TiledUpscaler(
        model.fwd_runtime, 4, exact_tile, exact_overlap, TILE_MAX_BATCH, device),
        "tile %d/%d" % TILE_DEFAULT: TiledUpscaler(model.fwd_runtime, 4, *TILE_DEFAULT,
                                                   TILE_MAX_BATCH, device)}
    for i, (what, tiler) in enumerate(tilers.items()):
        got, by_path, _ = counted(torch, lambda: tiler.upscale_device(x[0]), device)
        expect_forwards("full frame %s %s" % (label, what), by_path, per_forward,
                        tile_forwards(h, w, tiler.tile, tiler.tile - tiler.stride), kxk)
        _add(totals, by_path)
        if i == 0:
            held("%s against the direct forward" % what, got, direct, base)
            if not torch.equal(got, direct):
                raise AssertionError("full frame %s: the exact tiling %s differs from the "
                                     "direct forward" % (label, what))
            print("full frame %s %s: equal to the direct forward bit for bit" % (label, what))
        else:
            print("full frame %s %s: max |d| %.3g, PSNR %.2f dB against the direct forward"
                  % (label, what, float((got - direct).abs().max()), _psnr(got, direct)))
    xb = model._input_to_device([big])[0]
    big_tiler = TiledUpscaler(model.fwd_runtime, 4, *TILE_DEFAULT, max_batch=TILE_MAX_BATCH,
                              device=device)
    small_tiler = TiledUpscaler(model.fwd_runtime, 4, *TILE_DEFAULT,
                                max_batch=BIG_FRAME_SMALL_BATCH, device=device)
    big_label = "tile %d/%d at %dx%d LR" % (TILE_DEFAULT + BIG_FRAME_LR)
    run = {}
    mb = peak_mb(torch, lambda: run.update(out=counted(
        torch, lambda: big_tiler.upscale_device(xb), device)), device)
    got, by_path, _ = run.pop("out")
    expect_forwards("full frame %s %s" % (label, big_label), by_path, per_forward,
                    tile_forwards(*BIG_FRAME_LR, *TILE_DEFAULT), kxk)
    _add(totals, by_path)
    print("full frame %s %s: %d tiles in chunks of %d, peak memory %s" % (
        label, big_label, tile_count(*BIG_FRAME_LR, *TILE_DEFAULT), TILE_MAX_BATCH,
        "not measured" if mb is None else "%.1f MB" % mb), flush=True)
    small = small_tiler.upscale_device(xb)
    held("%s in chunks of %d against chunks of %d" % (
        big_label, TILE_MAX_BATCH, BIG_FRAME_SMALL_BATCH), got, small,
        larvanet_base(torch, model, big) if larva else None)
    if not torch.equal(got, small):
        raise AssertionError("full frame %s: %s in chunks of %d differs from chunks of %d"
                             % (label, big_label, TILE_MAX_BATCH, BIG_FRAME_SMALL_BATCH))
    print("full frame %s %s: chunks of %d equal chunks of %d bit for bit"
          % (label, big_label, TILE_MAX_BATCH, BIG_FRAME_SMALL_BATCH))
    del got, small

    # 10c: the self-ensemble of the f32 module, its 8 orientations (the
    # transposed 510x339 frame among them) through the kernels
    se = self_ensemble_forward(model.module)
    got, by_path, _ = counted(torch, lambda: se(x)[0], device)
    expect_forwards("full frame %s self-ensemble" % label, by_path, FULL_FRAME_MODULE[label], 8,
                    NO_KXK)
    _add(totals, by_path)
    with plain_versions():
        ref = se(x)[0]
    held("self-ensemble against its plain version", got, ref, base)
    print("full frame %s self-ensemble: PSNR %.2f dB against the direct forward"
          % (label, _psnr(got, direct)))
    del got, ref

    if device != "cuda":
        return totals
    # times and peak memory, the paths of a group timed in turns
    frame = "at %dx%d LR" % (h, w)
    for dname in ("f32", "bf16"):
        model.set_serving_dtype(dname)
        light = {"direct " + frame: lambda: model.upscale([img], 4),
                 "chop %d %s" % (CHOP_OVERLAP, frame): chop}
        for what, tiler in tilers.items():
            light["%s %s" % (what, frame)] = lambda tiler=tiler: tiler.upscale_chw(img)
        heavy = {big_label: lambda: big_tiler.upscale_device(xb)}
        if dname == "f32":  # the self-ensemble runs the f32 module in either dtype
            heavy["self-ensemble " + frame] = lambda: se(x)
        for group, windows, reps in ((light, WINDOWS, TIMED_REPS), (heavy, 3, 2)):
            for what, t in time_windows(torch, group, windows, reps).items():
                print("full frame %s %s, %s: %s per frame, peak memory %.1f MB" % (
                    label, dname, what, spread(t), peak_mb(torch, group[what])), flush=True)
    model.set_serving_dtype("f32")
    return totals


def write_test_set(root, rng):
    """Benchmark trees in the layout of the test CLI and the geometry of the
    JAX package's realistic fixture (its data/fixture_real is generated,
    not committed): `<root>/test_HR/<dataset>/` and `test_LR/<dataset>/`
    for SynSetReal and DIV2K_val (LR `<name>x4.png`), TEST_FRAMES `photo`
    frames each, LR the 4x4 box mean of the HR frame's aligned part.
    Returns {dataset: image names without the extension}."""
    import numpy as np

    from larvanet_tpu_torch.data import io

    names = {}
    for ds in ("SynSetReal", "DIV2K_val"):
        names[ds] = []
        for i, (h, w, eh, ew) in enumerate(TEST_FRAMES):
            hr = photo(rng, 4 * h + eh, 4 * w + ew)
            lr = np.round(hr[:, :4 * h, :4 * w].reshape(3, h, 4, w, 4).mean((2, 4)))
            name = "real%03d" % i
            lr_name = name + ("x4" if ds == "DIV2K_val" else "")
            io.save_image_chw(hr, os.path.join(root, "test_HR", ds, name + ".png"))
            io.save_image_chw(lr.astype(np.uint8),
                              os.path.join(root, "test_LR", ds, lr_name + ".png"))
            names[ds].append(name)
    return names


def full_frame_cli_phase(torch, device="cuda"):
    """Phase 10d: the CLIs in this process with EDSR-baseline x4 (phase 6's
    model): validate on phase 6's set with --chop_forward, --tile_forward
    (also under --wino_trunk 2 and 4) and --self_ensemble, each image's
    PSNR within VALIDATE_PSNR_TOL of the same run with the plain versions;
    serve in chop and tile mode against get_sr's frames of the same mode;
    test on benchmark trees (`write_test_set`) with and without
    --chop_forward. Every run's launches are counted, on the default
    collapsed tail (the self-ensemble: the f32 module's own tail; a run
    that makes the route also probes its tail). Then 10e (`ema_phase`).
    Returns (conv3x3 launches by path, {m: fused launches by path})."""
    import numpy as np

    from larvanet_tpu_torch.cli import get_sr, serve, validate
    from larvanet_tpu_torch.cli import test as test_cli
    from larvanet_tpu_torch.data import io, png

    conv_totals, fused = {}, {2: {}, 4: {}}
    f32 = PATH_LAUNCHES["f32"]
    with tempfile.TemporaryDirectory() as tmp:
        write_validate_set(tmp)
        first_lr = io.load_image_u8(os.path.join(tmp, "even", "LR", "X4", "0000x4.png"))
        pth = os.path.join(tmp, "edsr_x4.pth")
        save_edsr_baseline(torch, pth, first_lr.transpose(2, 0, 1), device)
        model_flags = ["--model", "edsr", "--scales", "4", "--device", device,
                       "--restore_path", pth]

        # validate: (label, flags, subset, --wino_trunk, forwards of an h x w frame)
        runs = [("chop", ["--chop_forward"], "all", 0, lambda h, w: 4),
                ("tile", ["--tile_forward"] + VALIDATE_TILE, "all", 0,
                 lambda h, w: tile_forwards(h, w, 48, 16)),
                ("self-ensemble", ["--self_ensemble"], "all", 0, lambda h, w: 8)]
        runs += [("tile --wino_trunk %d" % m, ["--tile_forward"] + VALIDATE_TILE, "even", m,
                  lambda h, w: tile_forwards(h, w, 48, 16)) for m in (2, 4)]
        no_kxk = NO_KXK
        for label, flags, sub, m, forwards_of in runs:
            frames = VALIDATE_LR + ((VALIDATE_ODD_LR,) if sub == "all" else ())
            forwards = sum(forwards_of(h, w) for h, w in frames)
            argv = model_flags + flags + [
                "--data_input_path", os.path.join(tmp, sub, "LR"),
                "--data_truth_path", os.path.join(tmp, sub, "HR"), "--wino_trunk", str(m)]
            reports = [os.path.join(tmp, "%s_%s.json" % (label, side))
                       for side in ("kernels", "plain")]
            t0 = time.perf_counter()
            _, by_path, wino = counted(
                torch, lambda: validate.main(argv + ["--report_json", reports[0]]), device)
            seconds = time.perf_counter() - t0
            with plain_versions():
                validate.main(argv + ["--report_json", reports[1]])
            psnrs = []
            for report in reports:
                with open(report) as f:
                    psnrs.append(json.load(f)["scales"]["4"]["per_image"])
            deltas = {k: abs(psnrs[0][k] - psnrs[1][k]) for k in psnrs[1]}
            print("full frame validate %s: %d images, %d forwards in %.3f s; PSNRs %s; max "
                  "|dPSNR| %.3g dB against the plain versions (bar %g)" % (
                      label, len(frames), forwards, seconds,
                      ", ".join("%s %.4f" % kv for kv in sorted(psnrs[0].items())),
                      max(deltas.values()), VALIDATE_PSNR_TOL), flush=True)
            if sorted(psnrs[0]) != sorted(psnrs[1]) or len(deltas) != len(frames) \
                    or max(deltas.values()) > VALIDATE_PSNR_TOL:
                raise AssertionError("full frame validate %s: PSNRs %s, plain %s"
                                     % (label, psnrs[0], psnrs[1]))
            ensemble = label == "self-ensemble"
            expect_forwards("full frame validate %s" % label, by_path,
                            WINO_CONV_PATH_LAUNCHES["f32"] if m else
                            PLAIN_PATH_LAUNCHES["f32"] if ensemble else f32, forwards,
                            no_kxk if ensemble else KXK_LAUNCHES, probes=1)
            _add(conv_totals, by_path)
            want = {k: (16 * forwards if k == m else 0) for k in (2, 4)}
            if wino != want:
                raise AssertionError("full frame validate %s: fused launches %s, not %s"
                                     % (label, wino, want))
            if m:
                _add(fused[m], {"cuda_core": 0, "tensor_core": wino[m]})

        # serve in chop and tile mode, against get_sr's frames of the mode
        # the full frame and the size of its first chop quadrant
        rng = np.random.default_rng(SEED + 11)
        h, w = FULL_FRAME_LR
        frames = [photo(rng, h, w),
                  photo(rng, h // 2 + CHOP_OVERLAP // 2, w // 2 + CHOP_OVERLAP // 2)]
        in_dir = os.path.join(tmp, "frames")
        for i, f in enumerate(frames):
            io.save_image_chw(f, os.path.join(in_dir, "f%d.png" % i))
        for mode, forwards in (("chop", 4 * len(frames)),
                               ("tile", sum(tile_forwards(*f.shape[1:], *TILE_DEFAULT)
                                            for f in frames))):
            flags = ["--%s_forward" % mode]
            out_dir = os.path.join(tmp, "get_sr_" + mode)
            get_sr.main(model_flags + ["--input_path", in_dir, "--output_path", out_dir]
                        + flags)
            args, remaining = serve.build_parser().parse_known_args(model_flags + flags)
            service = serve.build_service(args, remaining)
            service.warmup(128, 128)
            httpd = serve.make_server(service, "127.0.0.1", 0)
            thread = threading.Thread(target=httpd.serve_forever, daemon=True)
            thread.start()
            url = "http://127.0.0.1:%d" % httpd.server_address[1]
            try:
                bodies = [png.encode(f.transpose(1, 2, 0)) for f in frames]
                replies, by_path, _ = counted(
                    torch, lambda: [_http(url + "/upscale", b) for b in bodies], device)
                info = json.loads(_http(url + "/info")[1])
            finally:
                httpd.shutdown()
                httpd.server_close()
                thread.join(timeout=60)
            expect_forwards("full frame serve %s" % mode, by_path, f32, forwards, KXK_LAUNCHES)
            _add(conv_totals, by_path)
            for i, (code, body) in enumerate(replies):
                if code != 200:
                    raise AssertionError("serve %s: request %d: HTTP %d" % (mode, i, code))
                got = png.decode(body, grey16="clip").astype(np.int16)
                want = io.load_image_u8(os.path.join(out_dir, "f%d.png" % i)).astype(np.int16)
                levels = int(np.abs(got - want).max()) if got.shape == want.shape else -1
                print("full frame serve %s: request %d %s -> %s, max %d uint8 level(s) from "
                      "get_sr's frame; /info mode %s, device_seconds %s" % (
                          mode, i, frames[i].shape[1:], got.shape, levels, info["mode"],
                          info["device_seconds"]), flush=True)
                if levels < 0 or levels > 1 or info["mode"] != mode:
                    raise AssertionError("serve %s disagrees with get_sr" % mode)

        # test: the paper protocol on benchmark trees of photo frames
        root = os.path.join(tmp, "bench")
        names = write_test_set(root, np.random.default_rng(SEED + 13))
        for extra in ([], ["--chop_forward"]):
            report = os.path.join(tmp, "test%d.json" % len(extra))
            t0 = time.perf_counter()
            _, by_path, _ = counted(torch, lambda: test_cli.main(
                model_flags + ["--input_root_path", os.path.join(root, "test_LR"),
                               "--truth_root_path", os.path.join(root, "test_HR"),
                               "--output_root_path", os.path.join(tmp, "test_sr"),
                               "--datasets", ",".join(names), "--report_json", report]
                + extra), device)
            seconds = time.perf_counter() - t0
            with open(report) as f:
                scores = json.load(f)
            n_images = sum(len(v) for v in names.values())
            print("full frame test %s: %d images in %.3f s; %s" % (
                " ".join(extra) or "(whole frames)", n_images, seconds, "; ".join(
                    "%s PSNR %.4f SSIM %.4f" % (ds, scores[ds]["mean_psnr"],
                                                scores[ds]["mean_ssim"]) for ds in names)),
                flush=True)
            for ds, n in names.items():
                per = scores[ds]["per_image"]
                if sorted(per) != n or not all(
                        math.isfinite(v["psnr"]) and math.isfinite(v["ssim"])
                        for v in per.values()):
                    raise AssertionError("test %s: report %s" % (extra, scores[ds]))
            expect_forwards("full frame test %s" % " ".join(extra), by_path, f32,
                            n_images * (4 if extra else 1), KXK_LAUNCHES, probes=1)
            _add(conv_totals, by_path)

        _add(conv_totals, ema_phase(torch, tmp, pth, device))
    return conv_totals, fused


def ema_phase(torch, tmp, pth, device="cuda"):
    """Phase 10e. A .pth (the weights of `pth`) whose .state.pt holds an
    average that differs from them; validate --ema on phase 6's set under
    `tmp` must write the frames of the average's own forward on the
    default route (the collapsed tail, probed from the average), bit for
    bit. Returns validate's conv3x3 launches by path."""
    import numpy as np

    from larvanet_tpu_torch.cli import validate
    from larvanet_tpu_torch.core.registry import get_model
    from larvanet_tpu_torch.data import io
    from larvanet_tpu_torch.ops.collapsed_tail import make_collapsed_edsr_forward

    trainer = get_model("edsr")
    trainer.parse_args([])
    trainer.ema_decay = 0.9
    trainer.prepare([4], device=device, seed=SEED, is_training=True)
    trainer.restore(pth)
    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    average = [p.detach() * (1 + 0.05 * torch.randn(p.shape, generator=gen, device=device))
               for p in trainer.module.parameters()]
    trainer.ema.load(average)
    ema_pth = trainer.save(os.path.join(tmp, "ema"))
    out_dir = os.path.join(tmp, "ema_sr")
    lr_dir = os.path.join(tmp, "all", "LR")
    _, by_path, _ = counted(torch, lambda: validate.main(
        ["--model", "edsr", "--scales", "4", "--device", device, "--restore_path", ema_pth,
         "--ema", "1", "--data_input_path", lr_dir,
         "--data_truth_path", os.path.join(tmp, "all", "HR"), "--save_path", out_dir]), device)
    n_images = len(VALIDATE_LR) + 1
    expect_forwards("full frame validate --ema", by_path, PATH_LAUNCHES["f32"], n_images,
                    KXK_LAUNCHES, probes=1)

    models = []
    for weights in (average, None):
        model = get_model("edsr")
        model.parse_args([])
        model.prepare([4], device=device, seed=SEED)
        model.restore(pth)
        if weights is not None:
            with torch.no_grad():
                for p, a in zip(model.module.parameters(), weights):
                    p.copy_(a)
        model.set_route(make_collapsed_edsr_forward(model))
        models.append(model)
    differ = 0
    for name in io.list_pngs(os.path.join(tmp, "all", "HR")):
        lr = io.load_image_chw(os.path.join(lr_dir, "X4", name + "x4.png"))
        got = io.load_image_u8(os.path.join(out_dir, "x4", name + ".png")).transpose(2, 0, 1)
        if not np.array_equal(got, models[0].upscale_uint8([lr], 4)[0]):
            raise AssertionError("validate --ema: frame %s is not the average's forward" % name)
        differ += int(not np.array_equal(got, models[1].upscale_uint8([lr], 4)[0]))
    print("full frame validate --ema: %d frames equal the average's forward bit for bit; "
          "%d of them differ from the weights' forward" % (n_images, differ), flush=True)
    if differ == 0:
        raise AssertionError("validate --ema: the average gives the weights' frames")
    return by_path


def full_frame_phase(torch, device="cuda"):
    """Phase 10. Returns {"conv3x3": launches by path, "wino": {m: fused
    launches by path}} of every counted run."""
    conv = {}
    for label in FULL_FRAME_MODELS:
        _add(conv, full_frame_model_phase(torch, label, device))
        if device == "cuda":
            torch.cuda.empty_cache()
    cli_conv, fused = full_frame_cli_phase(torch, device)
    _add(conv, cli_conv)
    return {"conv3x3": conv, "wino": fused}


# ---- phase 11: the W8A8 int8 path ------------------------------------------------


def s8_bound_ms(n, h, w, c, f, item, entry, res=False):
    """The least time of one conv3x3_s8 call: its bytes (conv_a: x in the
    dtype, int8 out; conv_b: int8 in, the dtype out, and the residual when
    `res` is read; both: the int8 weight, the f32 scale and bias) over HBM
    bandwidth vs its operations at the dense INT8 peak (PEAK_FLOPS["s8"])."""
    px = n * h * w
    if entry == "conv_a":
        nbytes = px * (item * c + f)
    else:
        nbytes = px * (c + (2 if res else 1) * item * f)
    nbytes += 9 * c * f + 8 * f
    t_bytes, t_ops = nbytes / PEAK_BYTES, 2 * px * 9 * c * f / PEAK_FLOPS["s8"]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def s8_kernel_phase(torch):
    """Phase 11a. conv3x3_s8's two entries, bf16 and f32, at every pair shape
    (S8_SHAPES) on the 4 x 192x192 batch and the 339x510 frame: 0 values
    differing from the plain version on the same int8 input and scales,
    then the times in turns (the entry as a CUDA graph replay of one call
    and through its wrapper, plain version, torch._int_mm on the same im2col
    GEMM with the unfold not timed, the port's bf16 conv3x3 kernel and
    F.conv2d bf16 at the same shape) and the bound, each entry's replay time
    also as a multiple of its bound (the sums' "ms"; "wrapper_ms" beside).
    Returns {dtype: sums over one EDSR-baseline int8 forward's 16 pairs at
    4 x 192x192, with "larvanet": the same over one LarvaNet 2x16 int8
    forward's 33 pairs at the 48->48 shape}, the rows, and {dtype: the
    largest |kernel - plain| of both entries over every shape}."""
    import numpy as np
    import torch.nn.functional as F

    from larvanet_tpu_torch.ops import conv3x3
    from larvanet_tpu_torch.ops import conv3x3_s8 as s8

    rng = np.random.default_rng(SEED + 11)
    dev = "cuda"
    sums, rows, errs = {}, [], {"f32": 0.0, "bf16": 0.0}
    for label, c, f in S8_SHAPES:
        for (n, h, w) in (LR_BATCH, RAGGED):
            codes_a = rng.integers(-127, 128, (3, 3, c, c)).astype(np.int8)
            codes_b = rng.integers(-127, 128, (3, 3, c, f)).astype(np.int8)
            sa = (rng.uniform(0.5, 2.0, c) * 1e-3).astype(np.float32)
            sb = (rng.uniform(0.5, 2.0, f) * 1e-3).astype(np.float32)
            x32 = torch.from_numpy((rng.standard_normal((n, h, w, c)) * 3).astype(np.float32))
            bias_a = torch.from_numpy(rng.standard_normal(c).astype(np.float32))
            bias_b = torch.from_numpy(rng.standard_normal(f).astype(np.float32))
            for dname, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
                item = 4 if dname == "f32" else 2
                hin = x32.to(dev).to(dtype)
                s_in = float(hin.float().abs().max()) * 1.05 / 127.0
                wa = s8.make_weight(codes_a, sa, s_in, bias_a, dtype, dev)
                t = s8._dequant(s8.conv_codes_reference(s8.quantize(hin, s_in), wa.codes),
                                wa, dtype)
                s_mid = float(torch.relu(t).float().abs().max()) * 1.05 / 127.0
                del t
                wb = s8.make_weight(codes_b, sb, s_mid, bias_b, dtype, dev)
                res = (torch.randn((n, h, w, f), device=dev) * 4).to(dtype)
                res_b = res if c == f else None
                tq = s8.conv_a(hin, wa, s_in, s_mid)
                want_a = s8.conv_a_reference(hin, wa, s_in, s_mid)
                out = s8.conv_b(tq, wb, dtype, res_b, 1.0)
                want_b = s8.conv_b_reference(tq, wb, dtype, res_b, 1.0)
                torch.cuda.synchronize()
                diff_a = int((tq != want_a).sum())
                diff_b = int((out.float().view(torch.int32) != want_b.float().view(torch.int32))
                             .sum())
                errs[dname] = max(errs[dname],
                                  float((tq.float() - want_a.float()).abs().max()),
                                  float((out.float() - want_b.float()).abs().max()))
                clipped = int((want_a.abs() == 127).sum())
                # the yardsticks: cuBLASLt's s8 GEMM on the same im2col
                # product, the port's bf16 conv kernel and F.conv2d in bf16
                xq = s8.quantize(hin, s_in)
                cols = F.pad(xq.float(), (0, 0, 1, 1, 1, 1))
                cols = torch.cat([cols[:, dy:dy + h, dx:dx + w, :] for dy in range(3)
                                  for dx in range(3)], dim=-1).reshape(n * h * w, 9 * c)
                cols = cols.to(torch.int8).contiguous()
                kmat = wa.codes.reshape(9 * c, c).contiguous()
                xb = hin.to(torch.bfloat16).contiguous()
                kb16 = torch.from_numpy(codes_a.astype(np.float32) * 1e-3).to(dev)
                bb16 = bias_a.to(dev)
                x_nchw = xb.permute(0, 3, 1, 2)
                w_oihw = kb16.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
                    memory_format=torch.channels_last)
                fns = {"conv_a": lambda: s8.conv_a(hin, wa, s_in, s_mid),
                       "conv_b": lambda: s8.conv_b(tq, wb, dtype, res_b),
                       "plain_a": lambda: s8.conv_a_reference(hin, wa, s_in, s_mid),
                       "plain_b": lambda: s8.conv_b_reference(tq, wb, dtype, res_b),
                       "int_mm": lambda: torch._int_mm(cols, kmat),
                       "bf16_conv3x3": lambda: conv3x3.conv3x3_bias_act(xb, kb16, bb16, "relu"),
                       "conv2d_bf16": lambda: F.conv2d(x_nchw, w_oihw, padding=1)}
                # the entries' own times: a CUDA graph of one call straight
                # through the C entry, replayed (no host work between two);
                # the wrapper's, timed as a caller issues it, sit beside them
                for key, entry, call in (
                        ("graph_a", "conv_a", lambda fn: s8._run_a(
                            fn, hin, wa, s_in, s_mid, "relu",
                            torch.cuda.current_stream().cuda_stream)),
                        ("graph_b", "conv_b", lambda fn: s8._run_b(
                            fn, tq, wb, dtype, res_b, 1.0,
                            torch.cuda.current_stream().cuda_stream))):
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph):
                        call(s8._entry(entry, dtype))
                    fns[key] = graph.replay
                s8.reset_launches()
                t = time_windows(torch, fns)
                bounds = {"conv_a": s8_bound_ms(n, h, w, c, c, item, "conv_a"),
                          "conv_b": s8_bound_ms(n, h, w, c, f, item, "conv_b",
                                                res_b is not None)}
                print("s8 %s %dx%dx%d %s: conv_a %d of %d codes differ from the plain version "
                      "(%d clip), conv_b %d of %d values; conv_a %s = %.1fx its bound (through "
                      "the wrapper %s; plain %s, bound %.4f ms by %s), conv_b %s = %.1fx its "
                      "bound (through the wrapper %s; plain %s, bound %.4f ms by %s); "
                      "yardsticks: _int_mm %s, bf16 conv3x3 kernel %s, F.conv2d bf16 %s" % (
                          label, n, h, w, dname, diff_a, want_a.numel(), clipped, diff_b,
                          want_b.numel(), spread(t["graph_a"]),
                          t["graph_a"][0] / bounds["conv_a"][0], spread(t["conv_a"]),
                          spread(t["plain_a"]), *bounds["conv_a"], spread(t["graph_b"]),
                          t["graph_b"][0] / bounds["conv_b"][0], spread(t["conv_b"]),
                          spread(t["plain_b"]),
                          *bounds["conv_b"], spread(t["int_mm"]), spread(t["bf16_conv3x3"]),
                          spread(t["conv2d_bf16"])), flush=True)
                if diff_a or diff_b or not bool(torch.isfinite(out.float()).all()):
                    raise AssertionError("conv3x3_s8 %s %s disagrees with its plain version"
                                         % (label, dname))
                rows.append({"shape": label, "geometry": [n, h, w], "dtype": dname,
                             **{k: v[0] for k, v in t.items()},
                             "bound_a": bounds["conv_a"][0], "bound_b": bounds["conv_b"][0]})
                # one EDSR-baseline int8 forward: 16 pairs of the 64->64
                # shape; one LarvaNet 2x16 int8 forward: 33 of the 48->48
                pairs_of = {(64, 64): (16, None), (48, 48): (33, "larvanet")}
                if (n, h, w) == LR_BATCH and (c, f) in pairs_of:
                    k, key = pairs_of[(c, f)]
                    part = {
                        "ms": k * (t["graph_a"][0] + t["graph_b"][0]),
                        "wrapper_ms": k * (t["conv_a"][0] + t["conv_b"][0]),
                        "plain_ms": k * (t["plain_a"][0] + t["plain_b"][0]),
                        "bound_ms": k * (bounds["conv_a"][0] + bounds["conv_b"][0]),
                        "bound_by": bounds["conv_a"][1],
                        "int_mm_ms": 2 * k * t["int_mm"][0],
                        "bf16_conv3x3_ms": 2 * k * t["bf16_conv3x3"][0],
                        "conv2d_bf16_ms": 2 * k * t["conv2d_bf16"][0]}
                    if key is None:
                        sums.setdefault(dname, {}).update(part)
                    else:
                        sums.setdefault(dname, {})[key] = part
                del hin, tq, out, want_a, want_b, cols, res, res_b
            torch.cuda.empty_cache()
    return sums, rows, errs


# phase 11a's wide shape: C past what one code halo of the kernel's shared
# memory holds (C > 480 for conv_b in f32), which takes the chunked plan
S8_WIDE = (("wide 1280->64", 1280, 64, (1, 48, 48)),)


def s8_wide_phase(torch):
    """Phase 11a, wide: both entries at S8_WIDE, f32 and bf16, against the
    plain version (0 values may differ), then the times in turns (the
    entry as a CUDA graph replay of one call, through its wrapper, the
    plain version) beside the bound. Returns {"launches": the wrapper's
    launches in the phase, by entry, "shapes": the rows}."""
    import numpy as np

    from larvanet_tpu_torch.ops import conv3x3_s8 as s8

    rng = np.random.default_rng(SEED + 12)
    dev, rows = "cuda", []
    s8.reset_launches()
    for label, c, f, (n, h, w) in S8_WIDE:
        codes = rng.integers(-127, 128, (3, 3, c, f)).astype(np.int8)
        sa = (rng.uniform(0.5, 2.0, f) * 1e-3).astype(np.float32)
        bias = torch.from_numpy(rng.standard_normal(f).astype(np.float32))
        x32 = torch.from_numpy((rng.standard_normal((n, h, w, c)) * 3).astype(np.float32))
        tq = torch.from_numpy(rng.integers(-127, 128, (n, h, w, c)).astype(np.int8)).to(dev)
        for dname, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            item = 4 if dname == "f32" else 2
            hin = x32.to(dev).to(dtype)
            s_in = float(hin.float().abs().max()) * 1.05 / 127.0
            wa = s8.make_weight(codes, sa, s_in, bias, dtype, dev)
            t = s8._dequant(s8.conv_codes_reference(s8.quantize(hin, s_in), wa.codes), wa,
                            dtype)
            s_mid = float(torch.relu(t).float().abs().max()) * 1.05 / 127.0
            wb = s8.make_weight(codes, sa, 0.03 / c, bias, dtype, dev)
            res = (torch.randn((n, h, w, f), device=dev) * 4).to(dtype)
            got_a = s8.conv_a(hin, wa, s_in, s_mid)
            got_b = s8.conv_b(tq, wb, dtype, res, 0.1)
            want_a = s8.conv_a_reference(hin, wa, s_in, s_mid)
            want_b = s8.conv_b_reference(tq, wb, dtype, res, 0.1)
            torch.cuda.synchronize()
            diff_a = int((got_a != want_a).sum())
            diff_b = int((got_b.float().view(torch.int32) != want_b.float().view(torch.int32))
                         .sum())
            fns = {"conv_a": lambda: s8.conv_a(hin, wa, s_in, s_mid),
                   "conv_b": lambda: s8.conv_b(tq, wb, dtype, res, 0.1),
                   "plain_a": lambda: s8.conv_a_reference(hin, wa, s_in, s_mid),
                   "plain_b": lambda: s8.conv_b_reference(tq, wb, dtype, res, 0.1)}
            for key, entry, call in (
                    ("graph_a", "conv_a", lambda fn: s8._run_a(
                        fn, hin, wa, s_in, s_mid, "relu",
                        torch.cuda.current_stream().cuda_stream)),
                    ("graph_b", "conv_b", lambda fn: s8._run_b(
                        fn, tq, wb, dtype, res, 0.1,
                        torch.cuda.current_stream().cuda_stream))):
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    call(s8._entry(entry, dtype))
                fns[key] = graph.replay
            tm = time_windows(torch, fns, windows=3, reps=3)
            bounds = {"conv_a": s8_bound_ms(n, h, w, c, f, item, "conv_a"),
                      "conv_b": s8_bound_ms(n, h, w, c, f, item, "conv_b", True)}
            print("s8 %s %dx%dx%d %s (chunked halo): conv_a %d of %d codes differ from the "
                  "plain version, conv_b %d of %d values; conv_a %s = %.1fx its bound "
                  "(through the wrapper %s; plain %s; bound %.4f ms by %s), conv_b %s = %.1fx "
                  "its bound (through the wrapper %s; plain %s; bound %.4f ms by %s)" % (
                      label, n, h, w, dname, diff_a, want_a.numel(), diff_b, want_b.numel(),
                      spread(tm["graph_a"]), tm["graph_a"][0] / bounds["conv_a"][0],
                      spread(tm["conv_a"]), spread(tm["plain_a"]), *bounds["conv_a"],
                      spread(tm["graph_b"]), tm["graph_b"][0] / bounds["conv_b"][0],
                      spread(tm["conv_b"]), spread(tm["plain_b"]), *bounds["conv_b"]),
                  flush=True)
            if diff_a or diff_b or not bool(torch.isfinite(got_b.float()).all()):
                raise AssertionError("conv3x3_s8 %s %s disagrees with its plain version"
                                     % (label, dname))
            rows.append({"shape": label, "geometry": [n, h, w], "dtype": dname,
                         **{k: v[0] for k, v in tm.items()},
                         "bound_a": bounds["conv_a"][0], "bound_b": bounds["conv_b"][0],
                         "bound_by": bounds["conv_a"][1], "max_abs_err": 0.0})
            del hin, got_a, got_b, want_a, want_b, t, res
        torch.cuda.empty_cache()
    return {"launches": dict(s8.LAUNCHES_BY_ENTRY), "shapes": rows}


def _int8_model(torch, name, tmp, fit_frame):
    """EDSR-baseline x4 (fitted as in phase 4) or LarvaNet 2x16 (as in 4b),
    restored from a .pth as the CLIs do: (model, model flags, .pth)."""
    from larvanet_tpu_torch.core.registry import get_model

    pth = os.path.join(tmp, "%s_int8.pth" % name)
    if name == "edsr":
        save_edsr_baseline(torch, pth, fit_frame)
        flags = ["--model", "edsr"]
    else:
        save_larvanet(torch, pth, name, LARVANET_FLAGS)
        flags = ["--model", name] + LARVANET_FLAGS
    model = get_model(name)
    model.parse_args(list(flags[2:]))
    model.prepare([4], device="cuda", seed=SEED)
    model.restore(pth)
    return model, flags, pth


def _plain_s8():
    """A context in which conv3x3_s8's entries run their plain versions."""
    from larvanet_tpu_torch.ops import conv3x3_s8 as s8

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(s8, "conv_a", s8.conv_a_reference))
    stack.enter_context(mock.patch.object(s8, "conv_b", s8.conv_b_reference))
    return stack


def int8_forward_phase(torch):
    """Phase 11b. EDSR-baseline x4 and LarvaNet 2x16, routed by the CLIs'
    maybe_int8_trunk and calibrated on INT8_CALIB `photo` frames, on the 4 x
    192x192 batch of photo frames: the launches of one forward (INT8_LAUNCHES),
    each pair's captured input through the kernel's pair and the plain pair
    (0 values differing), the whole forward against the plain int8 forward
    with the same scales (PSNR >= INT8_FWD_PSNR_DB; LarvaNet relative to the
    residual over the base), and against the exact bf16 forward, timed in
    turns with it. Returns {name: s8 launches by entry}."""
    from types import SimpleNamespace

    import numpy as np

    from larvanet_tpu_torch.cli import common
    from larvanet_tpu_torch.models.layers import interpolated_base
    from larvanet_tpu_torch.ops import conv3x3, pairs
    from larvanet_tpu_torch.ops import conv3x3_s8 as s8
    from larvanet_tpu_torch.ops import conv_kxk as ck

    rng = np.random.default_rng(SEED + 12)
    n, h, w = LR_BATCH
    frames = [photo(rng, h, w) for _ in range(n)]
    x = torch.from_numpy(np.ascontiguousarray(
        np.stack(frames).transpose(0, 2, 3, 1), np.float32)).cuda()
    calib = np.stack([photo(rng, *INT8_CALIB[1:]) for _ in range(INT8_CALIB[0])])
    calib = calib.transpose(0, 2, 3, 1).astype(np.float32)
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("edsr", "LarvaNet"):
            model, _, _ = _int8_model(torch, name, tmp, frames[0])
            t0 = time.perf_counter()
            common.maybe_int8_trunk(model, SimpleNamespace(int8_trunk=1, model=name),
                                    lambda: calib)
            print("int8 %s: calibrated on %d x %dx%d photo frames in %.3f s"
                  % (name, *INT8_CALIB, time.perf_counter() - t0), flush=True)
            # the int8 forward the route calls, and its pair runner
            int8_fwd = next(c.cell_contents for c in model.route.__closure__
                            if hasattr(c.cell_contents, "runner"))
            runner = int8_fwd.runner
            seen = []
            real = runner.int8

            def capture(idx, hin, conv1, conv2, kind="res", res_weight=1.0):
                seen.append((idx, hin, kind, res_weight))
                return real(idx, hin, conv1, conv2, kind, res_weight)

            runner.int8 = capture
            s8.reset_launches()
            conv3x3.reset_launches()
            ck.reset_launches()
            got = model.fwd_runtime(x)
            torch.cuda.synchronize()
            by_entry, by_path = dict(s8.LAUNCHES_BY_ENTRY), dict(conv3x3.LAUNCHES_BY_PATH)
            # EDSR's int8 forward bakes the collapsed tail, as JAX's does
            expect_kxk("int8 %s" % name, kxk_launches(ck), KXK_LAUNCHES if name == "edsr"
                       else NO_KXK, 1)
            del runner.int8
            want_s8, want_conv = INT8_LAUNCHES[name]
            print("int8 %s: one forward of %d x %dx%d: conv3x3_s8 launches %s, conv3x3 by "
                  "path %s" % (name, n, h, w, by_entry, by_path), flush=True)
            if by_entry != want_s8 or by_path != want_conv:
                raise AssertionError("int8 %s: launches %s and %s, not %s and %s"
                                     % (name, by_entry, by_path, want_s8, want_conv))
            launches[name] = by_entry
            # each pair: the kernel's pair and the plain pair on its input
            differ = total = 0
            for idx, hin, kind, rw in seen:
                q = runner.quant[idx]
                k_out = pairs.int8_pair(q, hin, kind, rw)
                with _plain_s8():
                    p_out = pairs.int8_pair(q, hin, kind, rw)
                differ += int((k_out.float().view(torch.int32)
                               != p_out.float().view(torch.int32)).sum())
                total += p_out.numel()
            del seen
            print("int8 %s: %d pairs, each on its captured input through the kernel and the "
                  "plain pair: %d of %d values differ" % (name, len(runner.quant), differ,
                                                          total), flush=True)
            if differ:
                raise AssertionError("int8 %s: a pair through the kernel differs from the "
                                     "plain pair" % name)
            with _plain_s8(), plain_versions():
                ref = model.fwd_runtime(x)
            base = (interpolated_base(x.to(torch.bfloat16), 4, model.module.interpolate).float()
                    if name != "edsr" else 0.0)
            peak = float((ref - base).abs().max()) if name != "edsr" else 255.0
            mse = float(((got.double() - ref.double()) ** 2).mean())
            psnr = float("inf") if mse == 0 else 10 * math.log10(peak ** 2 / mse)
            # the exact bf16 forward, timed in turns with the int8 one
            model.set_serving_dtype("bf16")
            exact_mod = model.serving_module
            xb = x.to(torch.bfloat16)
            with torch.no_grad():
                exact = exact_mod(xb).float()
            psnr_exact = _psnr(got, exact)
            t = time_windows(torch, {"int8": lambda: int8_fwd(xb),
                                     "exact_bf16": lambda: exact_mod(xb)})
            print("int8 %s: %d x %dx%d LR: PSNR %.2f dB against the plain int8 forward with "
                  "the same scales (%s; bar %g dB), %.2f dB against the exact bf16 forward; "
                  "int8 forward %s, exact bf16 forward %s; %s" % (
                      name, n, h, w, psnr, "relative to the residual, peak %.3g" % peak
                      if name != "edsr" else "peak 255", INT8_FWD_PSNR_DB, psnr_exact,
                      spread(t["int8"]), spread(t["exact_bf16"]),
                      breakdown_line(torch, lambda: int8_fwd(xb), t["int8"][0],
                                     ("conv3x3_s8", "conv3x3"))), flush=True)
            if psnr < INT8_FWD_PSNR_DB or not bool(torch.isfinite(got).all()):
                raise AssertionError("int8 %s: the forward through the kernels disagrees "
                                     "with the plain int8 forward" % name)
            del model, got, ref, exact
            torch.cuda.empty_cache()
    return launches


def _counted_s8(torch, fn):
    """fn() with the s8, conv3x3 and conv_kxk counters zeroed just before it
    and read just after: (its result, s8 launches by entry, conv3x3 by
    path); conv_kxk's by path go to LAST_KXK."""
    from larvanet_tpu_torch.ops import conv3x3
    from larvanet_tpu_torch.ops import conv3x3_s8 as s8
    from larvanet_tpu_torch.ops import conv_kxk as ck

    s8.reset_launches()
    conv3x3.reset_launches()
    ck.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    LAST_KXK.clear()
    LAST_KXK.update(kxk_launches(ck))
    return out, dict(s8.LAUNCHES_BY_ENTRY), dict(conv3x3.LAUNCHES_BY_PATH)


def _expect_s8(label, got, per_forward, forwards):
    want = {k: v * forwards for k, v in per_forward.items()}
    print("%s: conv3x3_s8 launches %s (%d int8 forwards)" % (label, got, forwards), flush=True)
    if got != want:
        raise AssertionError("%s: conv3x3_s8 launches %s, not %s" % (label, got, want))


def int8_cli_phase(torch):
    """Phase 11c. The CLIs with --int8_trunk 1 on EDSR-baseline x4: serve
    (calibrated on a directory of photo PNGs) with four POSTs, each reply
    within 1 uint8 level of the kernels' own int8 forward, the odd-width
    frame on the exact route; validate --int8_report on phase 6's set (the
    report and its JSON); runtime at 339x510 (EDSR and LarvaNet 2x16); get_sr
    and test on phase 10d's trees. Returns the s8 launches by entry, summed."""
    import numpy as np

    from larvanet_tpu_torch.cli import get_sr, runtime, serve, validate
    from larvanet_tpu_torch.cli import test as port_test
    from larvanet_tpu_torch.data import io, png

    per = INT8_LAUNCHES["edsr"][0]
    total = {"conv_a": 0, "conv_b": 0}
    rng = np.random.default_rng(SEED + 13)
    with tempfile.TemporaryDirectory() as tmp:
        calib_dir = os.path.join(tmp, "calib")
        for i in range(4):
            io.save_image_chw(photo(rng, 96, 128), os.path.join(calib_dir, "c%d.png" % i))
        frames = [photo(rng, 120, 160), photo(rng, 120, 160), photo(rng, 67, 93),
                  photo(rng, 96, 128)]
        _, flags, pth = _int8_model(torch, "edsr", tmp, frames[0])

        # serve
        args, remaining = serve.build_parser().parse_known_args(
            flags + ["--scales", "4", "--restore_path", pth, "--int8_trunk", "1",
                     "--int8_calib_path", calib_dir])
        service = serve.build_service(args, remaining)
        service.warmup(128, 128)
        httpd = serve.make_server(service, "127.0.0.1", 0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        url = "http://127.0.0.1:%d" % httpd.server_address[1]
        try:
            replies, by_entry, by_path = _counted_s8(torch, lambda: [
                _http(url + "/upscale", png.encode(f.transpose(1, 2, 0))) for f in frames])
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=60)
        _expect_s8("serve --int8_trunk 1", by_entry, per, 3)
        expect_forwards("serve --int8_trunk 1: 3 int8 forwards (bf16) and the odd frame's "
                        "exact f32 forward (the collapsed tail)", by_path,
                        {p: 3 * INT8_LAUNCHES["edsr"][1][p] + PATH_LAUNCHES["f32"][p]
                         for p in PATH_LAUNCHES["f32"]}, 1)
        expect_kxk("serve --int8_trunk 1: the baked tail of 4 forwards", LAST_KXK,
                   KXK_LAUNCHES, 4)
        _add(total, by_entry)
        for i, (img, (code, body)) in enumerate(zip(frames, replies)):
            if code != 200:
                raise AssertionError("serve --int8_trunk 1: request %d gave HTTP %d" % (i, code))
            got = torch.from_numpy(png.decode(body, grey16="clip").astype(np.int16))
            own = service.model.upscale_device([img], 4, uint8=False)[0].cpu()
            levels = int((got - torch.clamp(torch.round(own), 0, 255).to(torch.int16))
                         .abs().max())
            print("serve --int8_trunk 1: request %d %dx%d (%s route): max %d uint8 level(s) "
                  "from the kernels' own forward" % (i, *img.shape[1:], "exact" if
                                                     img.shape[2] % 2 else "int8", levels),
                  flush=True)
            if levels > 1:
                raise AssertionError("serve --int8_trunk 1: request %d differs by %d levels"
                                     % (i, levels))
        del service

        # validate --int8_report on phase 6's set (4 even frames, 1 odd)
        write_validate_set(tmp)
        report = os.path.join(tmp, "int8_report.json")
        vflags = flags + ["--scales", "4", "--restore_path", pth,
                          "--data_input_path", os.path.join(tmp, "all", "LR"),
                          "--data_truth_path", os.path.join(tmp, "all", "HR"),
                          "--report_json", report, "--int8_trunk", "1", "--int8_report",
                          "--int8_max_drop", "100"]
        _, by_entry, _ = _counted_s8(torch, lambda: validate.main(vflags))
        _expect_s8("validate --int8_trunk 1 --int8_report", by_entry, per, len(VALIDATE_LR))
        _add(total, by_entry)
        with open(report) as f:
            rep = json.load(f)["scales"]["4"]["int8_vs_exact"]
        print("validate --int8_report: mean delta %+.4f dB, worst %+.4f dB, per image %s"
              % (rep["mean_delta_db"], rep["worst_delta_db"], rep["per_image_delta"]),
              flush=True)

        # runtime at 339x510
        _, hh, ww = RAGGED
        for name, mflags in (("edsr", flags), ("LarvaNet", ["--model", "LarvaNet"]
                                               + LARVANET_FLAGS)):
            (mean_s, mps), by_entry, _ = _counted_s8(torch, lambda: runtime.main(
                mflags + ["--scales", "4", "--input_height", str(hh), "--input_width",
                          str(ww), "--num_warmup", "2", "--num_iters", str(TIMED_REPS),
                          "--int8_trunk", "1"]))
            forwards = 2 + TIMED_REPS
            _expect_s8("runtime %s --int8_trunk 1" % name, by_entry, INT8_LAUNCHES[name][0],
                       forwards)
            _add(total, by_entry)
            print("runtime: %s, %dx%d LR, --int8_trunk 1: %.4f ms per frame, %.3f LR-MP/s"
                  % (name, hh, ww, 1e3 * mean_s, mps), flush=True)

        # get_sr and test on phase 10d's trees
        names = write_test_set(tmp, np.random.default_rng(SEED + 10))
        lr_dir = os.path.join(tmp, "test_LR", "SynSetReal")
        _, by_entry, _ = _counted_s8(torch, lambda: get_sr.main(
            flags + ["--scales", "4", "--restore_path", pth, "--input_path", lr_dir,
                     "--output_path", os.path.join(tmp, "sr"), "--int8_trunk", "1"]))
        even = sum(1 for n_ in names["SynSetReal"]
                   if io.load_image_u8(os.path.join(lr_dir, n_ + ".png")).shape[1] % 2 == 0)
        _expect_s8("get_sr --int8_trunk 1", by_entry, per, even)
        _add(total, by_entry)
        out_root = os.path.join(tmp, "test_out")
        (results, by_entry, _) = _counted_s8(torch, lambda: port_test.main(
            flags + ["--scales", "4", "--restore_path", pth,
                     "--input_root_path", os.path.join(tmp, "test_LR"),
                     "--truth_root_path", os.path.join(tmp, "test_HR"),
                     "--output_root_path", out_root, "--datasets", "SynSetReal,DIV2K_val",
                     "--int8_trunk", "1", "--report_json", os.path.join(tmp, "t.json")]))
        _expect_s8("test --int8_trunk 1", by_entry, per, 2 * even)
        _add(total, by_entry)
        print("test --int8_trunk 1: %s" % (results,), flush=True)
    return total


def qat_phase(torch):
    """Phase 11d. --qat 1 on EDSR-baseline x4 and LarvaNet 2x16 at batch 16 of
    48x48 LR patches on phase 8's set: the loss and its gradients held
    against the plain dgrad and wgrad on the kernels' own forward
    (check_train_grads' same_forward: fake-quant codes flip as ReLUs do), the
    all-plain step printed beside; the train CLI for QAT_STEPS steps, then
    again from the checkpoint at step QAT_STEPS - 1, whose last loss must
    repeat the first run's bit for bit."""
    import shutil

    import numpy as np

    from larvanet_tpu_torch.cli import train
    from larvanet_tpu_torch.core.registry import get_loader, get_model

    batch, patch = TRAIN_BATCH, TRAIN_PATCH
    with tempfile.TemporaryDirectory() as tmp:
        write_train_set(tmp, np.random.default_rng(SEED + 8), TRAIN_FRAMES, TRAIN_LR)
        data_flags = ["--data_input_path", os.path.join(tmp, "LR"),
                      "--data_truth_path", os.path.join(tmp, "HR"), "--data_cached",
                      "--data_seed", str(SEED)]
        loader = get_loader("div2k_train_loader")
        loader.parse_args(data_flags)
        loader.prepare([4])
        loader.reseed_for_step(0)
        lr_list, hr_list = loader.get_patch_batch(batch, 4, patch)
        x = torch.from_numpy(np.stack(lr_list).transpose(0, 2, 3, 1).copy()).cuda()
        t = torch.from_numpy(np.stack(hr_list).transpose(0, 2, 3, 1).copy()).cuda()
        # EDSR on the plain tail (--collapsed_tail_train 0), the graph of
        # these checks; the collapsed route trains in phase 14c
        for name, mflags in (("edsr", ["--collapsed_tail_train", "0"]),
                             ("LarvaNet", LARVANET_FLAGS)):
            model = get_model(name)
            model.parse_args(mflags + ["--qat", "1"])
            model.prepare([4], device="cuda", seed=SEED, is_training=True)
            check_train_grads(torch, model, x, t, "%s --qat 1" % name, batch, patch,
                              same_forward=True)
            del model
            torch.cuda.empty_cache()
            steps = QAT_STEPS
            cli = ["--dataloader", "div2k_train_loader", "--model", name, "--scales", "4",
                   "--batch_size", str(batch), "--input_patch_size", str(patch),
                   "--log_freq", "1", "--save_freq", str(steps - 1), "--qat", "1"] \
                + mflags + data_flags
            run = os.path.join(tmp, "run_" + name)
            _, losses = train.main(cli + ["--train_path", run, "--max_steps", str(steps)])
            again = os.path.join(tmp, "again_" + name)
            os.makedirs(again)
            # the checkpoint of step steps - 1 (EDSR: model_2.pth; the LarvaNet
            # family: model_step2_vol0G.pth) and its state file
            kept = [f for f in os.listdir(run) if f.startswith(
                ("model_%d." % (steps - 1), "model_step%d_" % (steps - 1)))]
            if len(kept) != 2:
                raise AssertionError("qat %s: checkpoint files %s" % (name, os.listdir(run)))
            for f in kept:
                shutil.copy(os.path.join(run, f), again)
            _, resumed = train.main(cli + ["--train_path", again, "--max_steps", str(steps),
                                           "--restore_path", "latest"])
            print("qat %s: train CLI losses %s; resumed at step %d: %s" % (
                name, {k: round(v, 6) for k, v in losses.items()}, steps - 1, resumed),
                flush=True)
            if resumed.get(steps) != losses[steps] or not all(
                    np.isfinite(v) for v in losses.values()):
                raise AssertionError("qat %s: the resumed run's loss %s differs from %s"
                                     % (name, resumed.get(steps), losses[steps]))


# ---- phase 13: the rest of the training flags -----------------------------------

# the bf16 step through the kernels against the plain dgrad and wgrad on the
# kernels' forward (check_train_grads' same_forward), and its loss against the
# all-plain bf16 step's: the conv kernel's bf16 outputs and the plain
# version's are f32 sums in other orders rounded to bf16, and a half-step
# apart they land a bf16 step (2^-8) apart, which the backward carries on
BF16_TRAIN_LOSS_RTOL = 2.0 ** -7
BF16_TRAIN_GRAD_RTOL = 2.0 ** -5
# bf16's wgrad launches by path in one step (ops/conv3x3_wgrad.py: the
# tensor-core shapes on conv3x3_wgrad_bf16_tc, the other two on their f32
# entries of the widened operands)
BF16_WGRAD_LAUNCHES = {"tensor_core": 35, "narrow": 1, "cuda_core": 1}
# --remat 1 recomputes each ResBlock / leg pair in the backward: its two
# convs run again as forwards (EDSR: 16 pairs; LarvaNet 2x16: 32 body pairs
# and 2 legs)
REMAT_EXTRA_FORWARDS = {"edsr": 32, "LarvaNet": 68}
# the LR size of the --remat memory comparison (batch TRAIN_BATCH)
REMAT_LR = 96
# --device_pipeline: DP_CHUNK steps a chunk, DP_STEPS steps a run
DP_CHUNK = 10
DP_STEPS = 20


def wgrad_bf16_bound_ms(n, h, w, c, f):
    """The least time of one bf16 weight and bias gradient: bf16 x and g
    read once, the f32 dW and db written once, over HBM bandwidth vs its 2 N
    H W 9 C F (+ N H W F) operations at the bf16 peak."""
    nbytes = 2 * n * h * w * (c + f) + 4 * (9 * c * f + f)
    flops = 2 * n * h * w * 9 * c * f + n * h * w * f
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS["bf16"]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def wgrad_bf16_phase(torch, wgrad_shapes=TRAIN_WGRAD, label="EDSR-baseline x4"):
    """13a's kernel half: the wgrad wrapper on bf16 x and g at every shape of
    an EDSR-baseline x4 step (TRAIN_WGRAD), which launches
    conv3x3_wgrad_bf16_tc on the tensor-core shapes, held against its plain
    version (GRAD_RTOL of max |dW|) and timed in turns with cuDNN's bf16
    gradient (conv2d_weight), the f32 entry on the same values widened to
    f32 and the plain version, beside its bound at the bf16 peak. Returns
    the sums over one step (the shapes' counts), the bound's kind, the
    largest |d| and |d| / max |dW|, and {name: the shape's numbers}."""
    from larvanet_tpu_torch.ops import conv3x3_wgrad as wg

    n = TRAIN_BATCH
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    keys = ("ms", "f32_entry_ms", "plain_ms", "library_ms", "bound_ms")
    sums, kinds, shapes = dict.fromkeys(keys, 0.0), {}, {}
    worst_abs = worst_rel = 0.0
    for name, mult, c, f, count in wgrad_shapes:
        h = w = TRAIN_PATCH * mult
        x = torch.randn((n, h, w, c), generator=gen, device="cuda").bfloat16()
        g = (torch.randn((n, h, w, f), generator=gen, device="cuda") / (n * h * w)).bfloat16()
        x32, g32 = x.float(), g.float()
        path = wg.path_for(c, f)
        want_w, want_b = wg.conv3x3_wgrad_reference(x, g)
        dw, db = wg.conv3x3_wgrad(x, g)
        torch.cuda.synchronize()
        err = max(float((dw - want_w).abs().max()), float((db - want_b).abs().max()))
        rel = max(float((dw - want_w).abs().max() / want_w.abs().max()),
                  float((db - want_b).abs().max() / want_b.abs().max()))
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
        if rel > GRAD_RTOL or not bool(torch.isfinite(dw).all()):
            raise AssertionError("bf16 wgrad %s disagrees with its plain version, max |d| / "
                                 "max |dW| = %g" % (name, rel))
        x_nchw, g_nchw = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        t = time_windows(torch, {
            "kernel": lambda: wg.conv3x3_wgrad(x, g),
            "f32_entry": lambda: wg.conv3x3_wgrad(x32, g32),
            "conv2d_weight": lambda: torch.nn.grad.conv2d_weight(x_nchw, (f, c, 3, 3), g_nchw,
                                                                 padding=1),
            "plain": lambda: wg.conv3x3_wgrad_reference(x, g)})
        bound, by = wgrad_bf16_bound_ms(n, h, w, c, f)
        entry = wg._ENTRY[wg.entry_for(path, f, torch.bfloat16)]
        print("wgrad bf16 %-18s x=%s C=%d F=%d (%s, %s): kernel %s, f32 entry %s, conv2d_weight "
              "bf16 %s, plain %s, bound %.4f ms (%s), max|d| %.3g (%.3g of max |dW|), %d a step"
              % (name, (n, h, w), c, f, path, entry, spread(t["kernel"]),
                 spread(t["f32_entry"]), spread(t["conv2d_weight"]), spread(t["plain"]),
                 bound, by, err, rel, count), flush=True)
        part = {"ms": t["kernel"][0], "f32_entry_ms": t["f32_entry"][0],
                "plain_ms": t["plain"][0], "library_ms": t["conv2d_weight"][0],
                "bound_ms": bound}
        shapes[name] = dict(part, path=path, entry=entry, bound_by=by, max_abs_err=err,
                            max_rel_err=rel)
        for k in keys:
            sums[k] += count * part[k]
        kinds[by] = kinds.get(by, 0.0) + count * bound
        del x, g, x32, g32, dw, db, want_w, want_b
        torch.cuda.empty_cache()
    print("wgrad bf16 per %s train step (%d launches): kernel %.4f ms, f32 entry "
          "%.4f ms, plain %.4f ms, conv2d_weight bf16 %.4f ms, bound %.4f ms" % (
              label, sum(sh[-1] for sh in wgrad_shapes), sums["ms"], sums["f32_entry_ms"],
              sums["plain_ms"], sums["library_ms"], sums["bound_ms"]), flush=True)
    return sums, max(kinds, key=kinds.get), worst_abs, worst_rel, shapes


def cli_resume_check(main, cli, tmp, steps, save_stems, label):
    """Run `main(cli)` for `steps` steps into tmp/run, then again from the
    middle checkpoint (the files named by `save_stems`, copied to tmp/again)
    with --restore_path latest: the loss must fall and the resumed run's
    losses after the checkpoint repeat the first run's bit for bit.
    Returns the first run's model and losses."""
    import shutil

    run, again = os.path.join(tmp, "run"), os.path.join(tmp, "again")
    t0 = time.perf_counter()
    model, losses = main(cli + ["--train_path", run, "--max_steps", str(steps)])
    first, last = min(losses), max(losses)
    print("%s: %d steps in %.3f s; loss at step %d %.6f, at step %d %.6f" % (
        label, steps, time.perf_counter() - t0, first, losses[first], last, losses[last]),
        flush=True)
    if not losses[last] < losses[first]:
        raise AssertionError("%s: the loss did not fall: %s" % (label, losses))
    os.makedirs(again)
    for stem in save_stems:
        shutil.copy(os.path.join(run, stem), again)
    _, resumed = main(cli + ["--train_path", again, "--max_steps", str(steps),
                             "--restore_path", "latest"])
    same = sorted(resumed) == [s for s in sorted(losses) if s > steps // 2] and all(
        resumed[s] == losses[s] for s in resumed)
    print("%s resumed at step %d: losses %s the first run's" % (
        label, steps // 2, "repeat" if same else "DO NOT repeat"), flush=True)
    if not same:
        raise AssertionError("%s: the resumed run's losses %s differ from %s"
                             % (label, resumed, losses))
    return model, losses


def bf16_train_phase(torch, tmp, data_flags, lr_list, hr_list):
    """13a. --train_dtype bf16 on EDSR-baseline x4 at full width, batch 16 of
    48x48: the wgrad kernel's bf16 entry at the step's shapes
    (wgrad_bf16_phase); one step's loss and gradients through the kernels
    against the plain dgrad and wgrad on the kernels' forward (and the
    all-plain bf16 step's loss); one counted step (37 forward, 36 dgrad and
    37 wgrad launches by path, the wgrad's bf16 launches by path
    BF16_WGRAD_LAUNCHES); the step's median ms and device split beside
    phase 8's f32 step; the train CLI for TRAIN_STEPS steps and a resume
    from the middle repeating the rest bit for bit. Returns (the counted
    step's launches, the wgrad numbers)."""
    import numpy as np

    from larvanet_tpu_torch.cli import train
    from larvanet_tpu_torch.core.registry import get_model
    from larvanet_tpu_torch.ops import conv3x3_wgrad as wg

    wgrad = wgrad_bf16_phase(torch)
    batch, patch = TRAIN_BATCH, TRAIN_PATCH
    x = torch.from_numpy(np.stack(lr_list).transpose(0, 2, 3, 1).copy()).cuda()
    t = torch.from_numpy(np.stack(hr_list).transpose(0, 2, 3, 1).copy()).cuda()
    step_ms = {}
    for dname in ("f32", "bf16"):
        model = get_model("edsr")
        model.parse_args(["--train_dtype", dname, "--collapsed_tail_train", "0"])
        model.prepare([4], device="cuda", seed=SEED, is_training=True)
        if dname == "bf16":
            check_train_grads(torch, model, x, t, "EDSR-baseline x4 bf16", batch, patch,
                              same_forward=True, loss_rtol=BF16_TRAIN_LOSS_RTOL,
                              grad_rtol=BF16_TRAIN_GRAD_RTOL)
            launches = counted_step(torch, lambda: model.train_step(lr_list, 4, hr_list))
            bf16_wgrad = dict(wg.BF16_LAUNCHES_BY_PATH)
            print("bf16 train step: wgrad's bf16 launches by path %s" % bf16_wgrad, flush=True)
            if launches != TRAIN_LAUNCHES or bf16_wgrad != BF16_WGRAD_LAUNCHES:
                raise AssertionError("bf16 train step launches %s (bf16 wgrad %s), not %s (%s)"
                                     % (launches, bf16_wgrad, TRAIN_LAUNCHES,
                                        BF16_WGRAD_LAUNCHES))
        step_ms[dname] = time_train_step(
            torch, model, x, t, lambda: model.train_step(lr_list, 4, hr_list),
            "EDSR-baseline x4", batch, patch, dname)[0]
        del model
        torch.cuda.empty_cache()
    print("train step, EDSR-baseline x4 batch 16 x 48x48: bf16 %.4f ms against f32 %.4f ms "
          "(%.2fx)" % (step_ms["bf16"], step_ms["f32"], step_ms["f32"] / step_ms["bf16"]),
          flush=True)
    del x, t
    half = TRAIN_STEPS // 2
    cli = ["--dataloader", "div2k_train_loader", "--model", "edsr", "--scales", "4",
           "--device", "cuda", "--batch_size", str(batch), "--input_patch_size", str(patch),
           "--log_freq", str(half), "--save_freq", str(half), "--train_dtype", "bf16",
           "--collapsed_tail_train", "0"] + data_flags
    os.makedirs(os.path.join(tmp, "bf16"))
    cli_resume_check(train.main, cli, os.path.join(tmp, "bf16"), TRAIN_STEPS,
                     ["model_%d.pth" % half, "model_%d.state.pt" % half],
                     "train CLI --train_dtype bf16")
    torch.cuda.empty_cache()
    return dict(launches, bf16_wgrad=bf16_wgrad), wgrad


def remat_phase(torch):
    """13b. --remat 1 on an EDSR-baseline x4 step and a LarvaNet 2x16 step,
    batch TRAIN_BATCH of REMAT_LR^2 LR: the loss and every gradient equal
    --remat 0's bit for bit (the recomputed forwards run the same kernels
    on the same inputs), one counted step with the recomputed pairs'
    forwards (REMAT_EXTRA_FORWARDS), and the peak memory of a step
    (max_memory_allocated) under both."""
    from larvanet_tpu_torch.core.registry import get_model

    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    n, h = TRAIN_BATCH, REMAT_LR
    x = torch.rand((n, h, h, 3), generator=gen, device="cuda") * 255
    t = torch.rand((n, 4 * h, 4 * h, 3), generator=gen, device="cuda") * 255
    out = {}
    for name, flags in (("edsr", ["--collapsed_tail_train", "0"]),
                        ("LarvaNet", list(LARVANET_FLAGS))):
        grads, peaks = {}, {}
        for remat in ("0", "1"):
            model = get_model(name)
            model.parse_args(flags + ["--remat", remat])
            model.prepare([4], device="cuda", seed=SEED, is_training=True)

            def step():
                model.optimizer.zero_grad(set_to_none=True)
                return model._loss_and_grads(x, t)

            step()
            peaks[remat] = peak_mb(torch, step)
            loss = step()
            grads[remat] = [float(loss)] + [p.grad.clone() for p in model.module.parameters()]
            if remat == "1":
                launches = counted_step(torch, step)
                extra = launches["forward"]["tensor_core"] - (
                    TRAIN_LAUNCHES if name == "edsr" else LARVA_TRAIN_LAUNCHES
                )["forward"]["tensor_core"]
                if extra != REMAT_EXTRA_FORWARDS[name]:
                    raise AssertionError("--remat 1 %s: %d recomputed forwards, not %d"
                                         % (name, extra, REMAT_EXTRA_FORWARDS[name]))
            del model
            torch.cuda.empty_cache()
        same = grads["0"][0] == grads["1"][0] and all(
            torch.equal(a, b) for a, b in zip(grads["0"][1:], grads["1"][1:]))
        print("--remat 1, %s, batch %d x %dx%d LR: loss and gradients %s --remat 0's; peak "
              "memory of a step %.1f MB (--remat 0: %.1f MB)" % (
                  name, n, h, h, "equal, bit for bit," if same else "DIFFER from",
                  peaks["1"], peaks["0"]), flush=True)
        if not same:
            raise AssertionError("--remat 1 changed %s's gradients" % name)
        out[name] = {"peak_mb": peaks["1"], "peak_mb_remat0": peaks["0"]}
    return out


def chunk_idle(torch, fn, steps):
    """(wall ms a step, device ms a step by kind, idle share) of fn() (a
    chunk or a host step of `steps` steps) under torch.profiler, timed with
    CUDA events once, after a warm call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    fn()
    end.record()
    end.synchronize()
    wall = start.elapsed_time(end) / steps
    host = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / steps
    return wall, host, busy, max(wall - busy, 0.0) / wall


def device_pipeline_phase(torch, tmp, data_flags, loader):
    """13c. --device_pipeline DP_CHUNK: the set resident on the card (MB
    printed); one counted chunk (DP_CHUNK steps' launches); the steps/s of
    ChunkRateMeter over 3 chunks and a chunk's idle share (CUDA events and
    torch.profiler) beside the host loop's step (data and train_step);
    then train (EDSR-baseline x4) and train_larva (LarvaNet 2x16) for
    DP_STEPS steps with a resume from the middle repeating the rest bit for
    bit. Returns the counted chunk's launches."""
    from larvanet_tpu_torch.cli import common, train, train_larva
    from larvanet_tpu_torch.core.registry import get_model
    from larvanet_tpu_torch.data.device_pipeline import chunk_seed, pipeline_for, run_chunk

    batch, patch = TRAIN_BATCH, TRAIN_PATCH
    pipe = pipeline_for(loader.dataset, 4, "cuda")
    print("device pipeline: %d images, %.3f MB resident on the card"
          % (len(pipe), pipe.nbytes() / 1e6), flush=True)
    model = get_model("edsr")
    model.parse_args(["--collapsed_tail_train", "0"])
    model.prepare([4], device="cuda", seed=SEED, is_training=True)
    lr = model.get_learning_rate()
    chunk = lambda: run_chunk(model, pipe, DP_CHUNK, batch, patch, lr,  # noqa: E731
                              chunk_seed(SEED, model.global_step))
    launches = counted_step(torch, chunk)
    want = {k: {p: DP_CHUNK * v for p, v in by.items()} for k, by in TRAIN_LAUNCHES.items()}
    if launches != want:
        raise AssertionError("a device-pipeline chunk's launches %s, not %s" % (launches, want))
    meter = common.ChunkRateMeter()
    for i in range(3):
        t0 = time.time()
        loss = float(chunk())
        model.global_step += DP_CHUNK
        inst, avg, trusted = meter.update(model.global_step, DP_CHUNK, time.time() - t0)
        print("device pipeline chunk %d: mean loss %.6f (%.1f steps/s)%s"
              % (i, loss, inst, meter.suffix(avg, trusted)), flush=True)

    def host_step():
        lr_list, hr_list = loader.get_patch_batch(batch, 4, patch)
        model.train_step(lr_list, 4, hr_list)

    rows = {"chunk": chunk_idle(torch, chunk, DP_CHUNK), "host loop": chunk_idle(torch,
                                                                                 host_step, 1)}
    for label, (wall, host, busy, idle) in rows.items():
        print("device pipeline: %s, EDSR-baseline x4 f32 batch %d x %dx%d: %.4f ms a step on "
              "the card's clock (%.4f on the host's), kernels %.4f ms, idle %.1f%%"
              % (label, batch, patch, patch, wall, host, busy, 100 * idle), flush=True)
    del model
    torch.cuda.empty_cache()
    half = DP_STEPS // 2
    cli = ["--dataloader", "div2k_train_loader", "--model", "edsr", "--scales", "4",
           "--device", "cuda", "--batch_size", str(batch), "--input_patch_size", str(patch),
           "--save_freq", str(half), "--device_pipeline", str(DP_CHUNK),
           "--collapsed_tail_train", "0"] + data_flags
    os.makedirs(os.path.join(tmp, "dp"))
    cli_resume_check(train.main, cli, os.path.join(tmp, "dp"), DP_STEPS,
                     ["model_%d.pth" % half, "model_%d.state.pt" % half],
                     "train CLI --device_pipeline %d" % DP_CHUNK)
    volume = patch * patch * batch * 3
    larva_cli = ["--dataloader", "div2k_train_loader", "--device", "cuda",
                 "--val_data_input_path", os.path.join(tmp, "LR"),
                 "--val_data_truth_path", os.path.join(tmp, "HR"), "--batch_size", str(batch),
                 "--input_patch_size", str(patch), "--device_pipeline", str(DP_CHUNK),
                 "--val_volume", str(half * volume)] + LARVANET_FLAGS + data_flags
    os.makedirs(os.path.join(tmp, "dp_larva"))
    stem = "model_step%d_vol0G" % half
    cli_resume_check(train_larva.main, larva_cli, os.path.join(tmp, "dp_larva"), DP_STEPS,
                     [stem + ".pth", stem + ".state.pt"],
                     "train_larva CLI --device_pipeline %d" % DP_CHUNK)
    torch.cuda.empty_cache()
    return launches


def checkpoint_flags_phase(torch, tmp, data_flags):
    """13d-13f. --async_checkpoint 1: the files of an asynchronous save of a
    trained EDSR-baseline x4 equal a synchronous save's tensors bit for bit,
    with a step taken before the writer is waited for. --profile_dir: the
    train CLI for 2 steps writes trace.json, which names the conv3x3 and
    wgrad kernels. --widen_from: a LarvaNet 2x16 checkpoint widened into
    LarvaNet_w64 2x16 computes the narrow forward within FWD_RTOL of its
    residual."""
    import numpy as np

    from larvanet_tpu_torch.cli import common, train
    from larvanet_tpu_torch.core.registry import get_model
    from larvanet_tpu_torch.models.base import state_path
    from larvanet_tpu_torch.utils import profiling
    from larvanet_tpu_torch.utils.torch_convert import load_pth

    rng = np.random.default_rng(SEED + 15)
    model = get_model("edsr")
    model.parse_args([])
    model.prepare([4], device="cuda", seed=SEED, is_training=True)
    lr = rng.uniform(0, 255, (TRAIN_BATCH, 48, 48, 3)).astype(np.float32)
    hr = np.repeat(np.repeat(lr, 4, 1), 4, 2)
    model.train_step(lr, 4, hr)
    sync = model.save(os.path.join(tmp, "sync"))
    model.async_checkpoints = True
    t0 = time.perf_counter()
    path = model.save(os.path.join(tmp, "async"))
    submit_ms = (time.perf_counter() - t0) * 1e3
    model.train_step(lr, 4, hr)
    model.wait_for_checkpoints()
    a, b = load_pth(sync), load_pth(path)
    sa = torch.load(state_path(sync), weights_only=True)
    sb = torch.load(state_path(path), weights_only=True)
    same = a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a) and all(
        torch.equal(u.cpu(), v.cpu()) for u, v in zip(
            [x for st in sa["optimizer"]["state"].values() for x in st.values()],
            [x for st in sb["optimizer"]["state"].values() for x in st.values()]))
    print("--async_checkpoint 1: the files %s the synchronous save's tensors, bit for bit "
          "(the save returned in %.3f ms)" % ("hold" if same else "DO NOT hold", submit_ms),
          flush=True)
    if not same:
        raise AssertionError("the asynchronous checkpoint differs from the synchronous one")
    del model
    torch.cuda.empty_cache()

    trace_dir = os.path.join(tmp, "trace")
    train.main(["--dataloader", "div2k_train_loader", "--model", "edsr", "--scales", "4",
                "--device", "cuda", "--batch_size", str(TRAIN_BATCH), "--input_patch_size",
                str(TRAIN_PATCH), "--max_steps", "2", "--save_freq", "100", "--train_path",
                os.path.join(tmp, "prof"), "--profile_dir", trace_dir] + data_flags)
    events = json.load(open(os.path.join(trace_dir, profiling.TRACE_FILE)))["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    found = {k: sum(k in n for n in names) for k in ("conv3x3", "wgrad")}
    print("--profile_dir: %s holds %d kernel records, %s; train_step spans %d" % (
        profiling.TRACE_FILE, len(names), found,
        sum(e.get("name") == "train_step" for e in events)), flush=True)
    if not all(found.values()):
        raise AssertionError("the trace names no conv3x3 or wgrad kernel: %s" % found)

    narrow_path = os.path.join(tmp, "narrow.pth")
    save_larvanet(torch, narrow_path)
    narrow = larvanet_model("LarvaNet", LARVANET_FLAGS, pth=narrow_path)
    wide = get_model("LarvaNet_w64")
    wide.parse_args(list(LARVANET_FLAGS))
    wide.prepare([4], device="cuda", seed=SEED + 1, is_training=True)
    common.maybe_widen_from(wide, mock.Mock(widen_from=narrow_path, restore_path=None))
    img = photo(rng, *TRAIN_LR)
    x = torch.from_numpy(img.transpose(1, 2, 0)[None].astype(np.float32)).cuda()
    with torch.no_grad():
        got, want = wide.fwd_runtime(x)[0], narrow.fwd_runtime(x)[0]
        base = larvanet_base(torch, narrow, img)
    residual = float((want - base).abs().max())
    err = float((got - want).abs().max())
    print("--widen_from: LarvaNet 2x16 widened into LarvaNet_w64 2x16 (%d -> %d parameters): "
          "max |wide - narrow| %.3g, %.3g of the residual's max %.3g (bar %g)" % (
              narrow.num_parameters(), wide.num_parameters(), err, err / residual, residual,
              FWD_RTOL), flush=True)
    if err > FWD_RTOL * residual:
        raise AssertionError("the widened model's forward differs from the narrow one's")


def train_flags_phase(torch):
    """Phase 13, on phase 8's set: 13a bf16 training, 13b --remat, 13c
    --device_pipeline, 13d-f --async_checkpoint, --profile_dir and
    --widen_from. Returns {"bf16_step": its counted launches (with
    "bf16_wgrad"), "chunk": the counted chunk's, "wgrad_bf16": the bf16
    wgrad numbers, "remat": peak memory by model}."""
    import numpy as np

    from larvanet_tpu_torch.core.registry import get_loader

    with tempfile.TemporaryDirectory() as tmp:
        write_train_set(tmp, np.random.default_rng(SEED + 8), TRAIN_FRAMES, TRAIN_LR)
        data_flags = ["--data_input_path", os.path.join(tmp, "LR"),
                      "--data_truth_path", os.path.join(tmp, "HR"), "--data_cached",
                      "--data_seed", str(SEED)]
        loader = get_loader("div2k_train_loader")
        loader.parse_args(data_flags)
        loader.prepare([4])
        loader.reseed_for_step(0)
        lr_list, hr_list = loader.get_patch_batch(TRAIN_BATCH, 4, TRAIN_PATCH)
        bf16_step, wgrad = bf16_train_phase(torch, tmp, data_flags, lr_list, hr_list)
        remat = remat_phase(torch)
        chunk = device_pipeline_phase(torch, tmp, data_flags, loader)
        checkpoint_flags_phase(torch, tmp, data_flags)
    return {"bf16_step": bf16_step, "chunk": chunk, "wgrad_bf16": wgrad, "remat": remat}


# ---- phase 14: the collapsed linear tail ------------------------------------------

SAME5 = (2, 2, 2, 2)
# conv_kxk's shapes (ops/conv_kxk.py), as (name, geometry, C, F, kh, kw,
# pads, launches per collapsed x4 forward): the main 5x5 SAME conv of the
# x4, x2 and x3 tails (64 -> 3 s^2), the border operators on 4-pixel strips
# (top / bottom (4, 5), left / right (5, 4), 64 -> b q = 2 x 3 s^2) and the
# corners (4x4 convs of a 4x4 patch, 64 -> b^2 q = 4 x 48); the collapsed
# interpolated base's 3 -> 48 (5x5 bicubic, 3x3 bilinear, 1x1 nearest);
# the live tail's input gradient, 48 -> 64 at the training size. Geometry:
# "lr" the LR batch, "rows" its 4-row strips, "cols" its 4-column strips,
# "corner" its 4x4 patches, "train" batch 16 x 48x48
KXK_SHAPES = (
    ("x4 5x5", "lr", 64, 48, 5, 5, SAME5, 1),
    ("x4 top/bottom 4x5", "rows", 64, 96, 4, 5, (0, 0, 2, 2), 0),
    ("x4 left/right 5x4", "cols", 64, 96, 5, 4, (2, 2, 0, 0), 0),
    ("x4 corner 4x4", "corner", 64, 192, 4, 4, (0, 0, 0, 0), 0),
    ("x2 5x5", "lr", 64, 12, 5, 5, SAME5, 0),
    ("x2 top/bottom 4x5", "rows", 64, 24, 4, 5, (0, 0, 2, 2), 0),
    ("x2 left/right 5x4", "cols", 64, 24, 5, 4, (2, 2, 0, 0), 0),
    ("x3 5x5", "lr", 64, 27, 5, 5, SAME5, 0),
    ("x3 top/bottom 4x5", "rows", 64, 54, 4, 5, (0, 0, 2, 2), 0),
    ("x3 left/right 5x4", "cols", 64, 54, 5, 4, (2, 2, 0, 0), 0),
    ("base bicubic x4 5x5", "lr", 3, 48, 5, 5, SAME5, 0),
    ("base bilinear x4 3x3", "lr", 3, 48, 3, 3, (1, 1, 1, 1), 0),
    ("base nearest x4 1x1", "lr", 3, 48, 1, 1, (0, 0, 0, 0), 0),
    ("dgrad x4 5x5 48->64", "train", 48, 64, 5, 5, SAME5, 0),
)
# the border operators as grouped launches (ops/conv_kxk.py
# conv_kxk_group): those of a collapsed x4 forward as it launches them (the
# tensor cores), and the collapsed bicubic base's (C = 3: the CUDA cores),
# as (name, geometry, problems, C, F, kh, kw, pads, launches per collapsed
# x4 forward)
KXK_GROUPS = (
    ("x4 top+bottom 4x5", "rows", 2, 64, 96, 4, 5, (0, 0, 2, 2), 1),
    ("x4 left+right 5x4", "cols", 2, 64, 96, 5, 4, (2, 2, 0, 0), 1),
    ("x4 corners 4x4", "corner", 4, 64, 192, 4, 4, (0, 0, 0, 0), 1),
    ("base bicubic x4 top+bottom 4x5", "rows", 2, 3, 96, 4, 5, (0, 0, 2, 2), 0),
    ("base bicubic x4 left+right 5x4", "cols", 2, 3, 96, 5, 4, (2, 2, 0, 0), 0),
    ("base bicubic x4 corners 4x4", "corner", 4, 3, 192, 4, 4, (0, 0, 0, 0), 0),
)
# the weight gradients, 5x5 SAME at batch 16 x 48x48, as (name, C, F, path):
# the live tail's 64 -> 48 conv (the tensor cores), and the bicubic base's
# 3 -> 48 (C % 16 != 0: the CUDA cores)
KXK_WGRAD = (("live tail 64->48", 64, 48, "tensor_core"),
             ("base bicubic 3->48", 3, 48, "cuda_core"))
# f32: F32_ATOL per product summed, scaled from the 3x3 64-channel conv's 576
# products to the shape's kh kw C. The tensor cores' f32 sums round toward
# zero, so the error's bias grows with the products summed (the 5x5 64 ->
# 48 conv on an H100, 1,600 products of N(0, 1) x 0.1 N(0, 1) values: 2.56e-4
# against F32_ATOL's 2e-4, the tensor-core accumulation's bias)
KXK_F32_TERMS = 576
# the probed kernel against the one composed from the tail's weights (the
# live tail's delta batch with full padding, nothing subtracted): a probed
# entry is the difference of two responses of the tail's output magnitude
# (~|DIV2K mean| and the fitted bias, up to ~256), each carrying a step or
# two of f32 rounding at that magnitude, so it is held within PROBE_STEPS
# steps of it
PROBE_STEPS = 4
# the collapsed forward against the plain tail's, f32, by PSNR on [0, 255]:
# the forward sums the probed kernel's steps over 1,600 taps of the trunk's
# features (|h| ~ 140 on average at full width), ~0.05 on average and ~0.36
# at most, in JAX's own collapsed forward as in the port's (JAX's 0.1 bar,
# tests/test_collapsed_tail.py:26-28, is at 16 features); a wrong operator
# moves pixels by whole levels, tens of dB below this bar
COLLAPSED_PSNR_DB = 60.0
# one EDSR-baseline x4 train step on the default route (the live collapsed
# tail, the loss before the shuffle), by path. conv3x3 forwards: the
# trunk's 34 (first_conv on the CUDA cores) and, for the kernel's
# composition (a 64-image delta batch), the bias tile (a 5x5 canvas) and
# each of the two strip batches, the original tail's three convs (two 64 ->
# 256 on the tensor cores, one 64 -> 3 narrow). dgrads: the trunk's 33, and
# the tail calls' (none for the first conv of the composition and of the
# bias tile, whose inputs are the delta batch and the zero canvas): 256 ->
# 64 on the tensor cores, 3 -> 64 on the CUDA cores. wgrads: one per
# forward conv, by conv3x3_wgrad's path_for
TRAIN_COLLAPSED_LAUNCHES = {"forward": {"cuda_core": 1, "tensor_core": 41, "narrow": 4},
                            "dgrad": {"cuda_core": 4, "tensor_core": 39, "narrow": 0},
                            "wgrad": {"tensor_core": 41, "narrow": 4, "cuda_core": 1}}
# conv_kxk in that step: the 5x5 64 -> 48 forward and its 48 -> 64 input
# gradient on the tensor cores, and one weight gradient
TRAIN_COLLAPSED_KXK = {"forward": {"cuda_core": 0, "tensor_core": 1},
                       "dgrad": {"cuda_core": 0, "tensor_core": 1}, "wgrad": 1}


def _kxk_input(kind, geometry):
    n, h, w = geometry
    return {"lr": (n, h, w), "rows": (n, 4, w), "cols": (n, h, 4), "corner": (n, 4, 4),
            "train": (TRAIN_BATCH, TRAIN_PATCH, TRAIN_PATCH)}[kind]


def graph_replay(torch, fn):
    """A CUDA graph of one call of fn (captured after one call on a side
    stream), as a callable that replays it: the device's time of the call
    with no host work between two."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def kxk_kernel_phase(torch):
    """Phase 14a, the kernels. conv_kxk at every shape of KXK_SHAPES on the 4
    x 192x192 batch (and the main x4 conv on the 339x510 frame), f32 (TF32
    off) and bf16, and the border groups of KXK_GROUPS as grouped launches:
    one launch on the path `path_for` names, held against its plain version
    (F32_ATOL per KXK_F32_TERMS products summed; bf16 one step), timed in
    turns with it and F.conv2d (the yardstick; a group beside its problems'
    F.conv2d calls), beside its bound. A single conv's kernel is fixed, a
    ConvGroup of one, as the baked tail holds its main conv. "ms" and
    "library_ms" are CUDA graph replays of one call (the device's time),
    "wrapper_ms" the wrapper as a caller issues it. Returns ({dtype: sums
    over one collapsed x4 forward's 4 launches}, {dtype: worst error},
    {shape row: numbers})."""
    import torch.nn.functional as F

    from larvanet_tpu_torch.ops import conv_kxk as ck

    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    keys = ("ms", "wrapper_ms", "plain_ms", "library_ms", "bound_ms")
    sums = {d: dict.fromkeys(keys, 0.0) for d in dtypes}
    kinds = {d: {} for d in dtypes}
    worst = {d: 0.0 for d in dtypes}
    rows = {}

    def library(x, k, b, pads):
        w_oihw = k.to(x.dtype).permute(3, 2, 0, 1).contiguous()
        x_nchw = x.permute(0, 3, 1, 2)  # channels_last view of NHWC
        b_lib = None if b is None else b.to(x.dtype)
        return lambda: F.conv2d(x_nchw, w_oihw, b_lib, padding=(pads[0], pads[2]))

    def measure(name, dname, geometry, calls, bound, by, err, path, count):
        kernel, lib_calls, plain = calls
        t = time_windows(torch, {
            "kernel": graph_replay(torch, kernel), "wrapper": kernel,
            "F.conv2d": graph_replay(torch, lambda: [c() for c in lib_calls]), "plain": plain})
        print("conv_kxk %-22s %-4s x=%s: %s kernel %s (through the wrapper %s), F.conv2d %s, "
              "plain %s, bound %.4f ms (%s, %.1fx), max|d| %.3g" % (
                  name, dname, geometry, path, spread(t["kernel"]), spread(t["wrapper"]),
                  spread(t["F.conv2d"]), spread(t["plain"]), bound, by,
                  t["kernel"][0] / bound, err), flush=True)
        row = {"ms": t["kernel"][0], "wrapper_ms": t["wrapper"][0], "plain_ms": t["plain"][0],
               "library_ms": t["F.conv2d"][0], "bound_ms": bound, "bound_by": by,
               "max_abs_err": err, "path": path}
        rows["%s %dx%dx%d %s" % (name, *geometry, dname)] = row
        if count:
            for k in keys:
                sums[dname][k] += count * row[k]
            kinds[dname][by] = kinds[dname].get(by, 0.0) + count * bound

    def held(name, dname, geometry, got, want, kh, kw, c, path):
        ok, err = _conv_ok(torch, got, want, dname,
                           F32_ATOL * max(1.0, kh * kw * c / KXK_F32_TERMS))
        worst[dname] = max(worst[dname], err)
        if not ok:
            raise AssertionError("conv_kxk %s %s %s: %s kernel disagrees with its plain "
                                 "version, max |d| = %g" % (name, dname, geometry, path, err))
        return err

    for geometry, (name, kind, c, f, kh, kw, pads, count) in (
            [(LR_BATCH, shape) for shape in KXK_SHAPES] + [(RAGGED, KXK_SHAPES[0])]):
        n, h, w = _kxk_input(kind, geometry)
        x32 = torch.randn((n, h, w, c), generator=gen, device="cuda")
        k32 = 0.1 * torch.randn((kh, kw, c, f), generator=gen, device="cuda")
        b32 = torch.randn((f,), generator=gen, device="cuda")
        one = ck.ConvGroup([k32], [b32])  # its entry operands made once
        for dname, dtype in dtypes.items():
            x = x32.to(dtype)
            path = ck.path_for(c)
            ck.reset_launches()
            got = ck.conv_kxk(x, one, None, pads)
            torch.cuda.synchronize()  # a fault during the run shows here
            if kxk_launches(ck) != dict(NO_KXK, **{path: 1}):
                raise AssertionError("conv_kxk %s %s: launches %s, expected one on %s"
                                     % (name, dname, kxk_launches(ck), path))
            err = held(name, dname, (n, h, w, c, f), got,
                       ck.conv_kxk_reference(x, k32, b32, pads), kh, kw, c, path)
            bound, by = bound_ms(n, h, w, c, f, dname, kh, kw, pads)
            measure(name, dname, (n, h, w), (
                lambda: ck.conv_kxk(x, one, None, pads), [library(x, k32, b32, pads)],
                lambda: ck.conv_kxk_reference(x, k32, b32, pads)),
                bound, by, err, path, count if geometry == LR_BATCH else 0)
            del x, got
        del x32, k32, b32, one
        torch.cuda.empty_cache()
    for name, kind, groups, c, f, kh, kw, pads, count in KXK_GROUPS:
        n, h, w = _kxk_input(kind, LR_BATCH)
        xs32 = [torch.randn((n, h, w, c), generator=gen, device="cuda") for _ in range(groups)]
        group = ck.ConvGroup(
            [0.1 * torch.randn((kh, kw, c, f), generator=gen, device="cuda")
             for _ in range(groups)],
            [torch.randn((f,), generator=gen, device="cuda") for _ in range(groups)])
        for dname, dtype in dtypes.items():
            xs = [x.to(dtype) for x in xs32]
            path = ck.path_for(c)
            ck.reset_launches()
            with torch.no_grad():
                got = ck.conv_kxk_group(xs, group, None, pads)
            torch.cuda.synchronize()
            if kxk_launches(ck) != dict(NO_KXK, **{"group_" + path: 1}):
                raise AssertionError("conv_kxk group %s %s: launches %s, expected one grouped "
                                     "on %s" % (name, dname, kxk_launches(ck), path))
            want = ck.conv_kxk_group_reference(xs, group, None, pads)
            err = max(held(name, dname, (groups, n, h, w, c, f), a, b, kh, kw, c, path)
                      for a, b in zip(got, want))
            bound, by = bound_ms(n, h, w, c, f, dname, kh, kw, pads)
            measure(name, dname, (n, h, w), (
                lambda: ck.conv_kxk_group(xs, group, None, pads),
                [library(x, k, b, pads) for x, k, b in zip(xs, group.kernels, group.biases)],
                lambda: ck.conv_kxk_group_reference(xs, group, None, pads)),
                groups * bound, by, err, "group " + path, count)
            del xs, got, want
        torch.cuda.empty_cache()
    launches = sum(row[-1] for row in KXK_SHAPES + KXK_GROUPS)
    for dname in dtypes:
        sums[dname]["bound_by"] = max(kinds[dname], key=kinds[dname].get)
        print("conv_kxk per collapsed EDSR-baseline x4 forward at %s (%d launches), %s: kernel "
              "%.4f ms (through the wrapper %.4f), plain %.4f ms, F.conv2d %.4f ms, bound %.4f "
              "ms (%s)" % (LR_BATCH, launches, dname, sums[dname]["ms"],
                           sums[dname]["wrapper_ms"], sums[dname]["plain_ms"],
                           sums[dname]["library_ms"], sums[dname]["bound_ms"],
                           sums[dname]["bound_by"]), flush=True)
    return sums, worst, rows


def kxk_wgrad_phase(torch):
    """Phase 14a, the weight gradient: conv_kxk_wgrad at each shape of
    KXK_WGRAD, 5x5 SAME at batch 16 x 48x48, f32 and bf16, on the path
    `wgrad_path_for` names (which must be the row's), against its plain
    version (GRAD_RTOL of max |dW|, and of max |db|), two runs bit for bit,
    timed in turns with it and conv2d_weight (the yardstick) as CUDA graph
    replays, and through the wrapper, beside its bound. Returns {path:
    {dtype: the numbers}}."""
    from larvanet_tpu_torch.ops import conv_kxk as ck

    n, h, w = TRAIN_BATCH, TRAIN_PATCH, TRAIN_PATCH
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    out = {}
    for name, c, f, want_path in KXK_WGRAD:
        x32 = torch.randn((n, h, w, c), generator=gen, device="cuda")
        g32 = torch.randn((n, h, w, f), generator=gen, device="cuda") / (n * h * w)
        path = ck.wgrad_path_for(c, 5, 5)
        if path != want_path:
            raise AssertionError("conv_kxk_wgrad %s: wgrad_path_for names %s, not %s"
                                 % (name, path, want_path))
        out[path] = {}
        for dname, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            x, g = x32.to(dtype), g32.to(dtype)
            ck.reset_launches()
            dw, db = ck.conv_kxk_wgrad(x, g, 5, 5, SAME5)
            again = ck.conv_kxk_wgrad(x, g, 5, 5, SAME5)
            torch.cuda.synchronize()
            if ck.WGRAD_LAUNCHES_BY_PATH[path] != 2:
                raise AssertionError("conv_kxk_wgrad %s %s: launches %s, expected 2 on %s" % (
                    name, dname, ck.WGRAD_LAUNCHES_BY_PATH, path))
            same = torch.equal(dw, again[0]) and torch.equal(db, again[1])
            want_w, want_b = ck.conv_kxk_wgrad_reference(x, g, 5, 5, SAME5)
            err = max(float((dw - want_w).abs().max()), float((db - want_b).abs().max()))
            rel = max(float((dw - want_w).abs().max() / want_w.abs().max()),
                      float((db - want_b).abs().max() / want_b.abs().max()))
            if rel > GRAD_RTOL or not same or not bool(torch.isfinite(dw).all()):
                raise AssertionError("conv_kxk_wgrad %s %s disagrees with its plain version "
                                     "(max |d| / max |dW| = %g) or between two runs (%s)"
                                     % (name, dname, rel, "equal" if same else "not equal"))
            x_nchw, g_nchw = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
            t = time_windows(torch, {
                "kernel": graph_replay(torch, lambda: ck.conv_kxk_wgrad(x, g, 5, 5, SAME5)),
                "wrapper": lambda: ck.conv_kxk_wgrad(x, g, 5, 5, SAME5),
                "conv2d_weight": graph_replay(torch, lambda: torch.nn.grad.conv2d_weight(
                    x_nchw, (f, c, 5, 5), g_nchw, padding=2)),
                "plain": lambda: ck.conv_kxk_wgrad_reference(x, g, 5, 5, SAME5)})
            item = 4 if dname == "f32" else 2
            nbytes = item * n * h * w * (c + f) + 4 * (25 * c * f + f)
            flops = 2 * n * h * w * 25 * c * f + n * h * w * f
            t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dname]
            bound = 1e3 * max(t_bytes, t_ops)
            by = "bytes" if t_bytes >= t_ops else "operations"
            print("conv_kxk_wgrad %s %s x=%s C=%d F=%d 5x5 (%s): kernel %s (through the wrapper "
                  "%s), conv2d_weight %s, plain %s, bound %.4f ms (%s, %.1fx), max|d| %.3g (%.3g "
                  "of max |dW|), two runs equal" % (
                      name, dname, (n, h, w), c, f, path, spread(t["kernel"]),
                      spread(t["wrapper"]), spread(t["conv2d_weight"]), spread(t["plain"]),
                      bound, by, t["kernel"][0] / bound, err, rel), flush=True)
            out[path][dname] = {"ms": t["kernel"][0], "wrapper_ms": t["wrapper"][0],
                                "plain_ms": t["plain"][0],
                                "library_ms": t["conv2d_weight"][0], "bound_ms": bound,
                                "bound_by": by, "max_abs_err": err, "max_rel_err": rel,
                                "path": path}
            del x, g, dw, db, again, want_w, want_b
        del x32, g32
        torch.cuda.empty_cache()
    return out


def collapsed_radius_phase(torch):
    """Phase 14a, the probes: EDSR-baseline x2, x3 and x4 at full width
    (random weights from SEED) probed on the card through the kernels
    (ops/collapsed_tail.collapsed_edsr_tail): the trimmed radius must be
    2, as JAX's is, which needs the delta and zero responses to cancel
    exactly. Returns {scale: radius}."""
    from larvanet_tpu_torch.core.registry import get_model
    from larvanet_tpu_torch.ops.collapsed_tail import collapsed_edsr_tail

    radius = {}
    for scale in (2, 3, 4):
        model = get_model("edsr")
        model.parse_args([])
        model.prepare([scale], device="cuda", seed=SEED)
        t0 = time.perf_counter()
        tail = collapsed_edsr_tail(model)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        radius[scale] = tail.radius
        print("collapsed tail x%d: probed on the card in %.3f s, kernel %s, radius %d (1 + %d "
              "stages probed)" % (scale, seconds, tuple(tail.kernel_np.shape), tail.radius,
                                  2 if scale == 4 else 1), flush=True)
        if tail.radius != 2:
            raise AssertionError("collapsed tail x%d: radius %d, not 2: the probes did not "
                                 "cancel exactly" % (scale, tail.radius))
        del model, tail
    return radius


def _no_grad(torch, fn):
    def call():
        with torch.no_grad():
            return fn()
    return call


def collapsed_serve_phase(torch):
    """Phase 14b. EDSR-baseline x4 at full width (fitted as in phase 4) on
    the 4 x 192x192 batch of photo frames, f32 and bf16, on the default
    route, the collapsed tail: one forward counted (PATH_LAUNCHES conv3x3
    and KXK_LAUNCHES conv_kxk launches), held within FWD_RTOL /
    BF16_FWD_RTOL of the same route with the plain versions inside and
    within COLLAPSED_PSNR_DB (bf16: BF16_FWD_RTOL of its max) of the plain
    tail's forward, its probed kernel within PROBE_STEPS f32 steps of the
    kernel composed from the tail's weights; the forwards and the tails alone timed in turns against
    the plain tail's, with their device split. Then the baked tail of the
    --wino_trunk 2 forward (counted; f32 within WINO_FWD_RTOL of the
    collapsed conv3x3 forward) and of the int8 forward (counted; PSNR
    against the plain int8 forward >= INT8_FWD_PSNR_DB). Returns the
    numbers."""
    from types import SimpleNamespace

    import numpy as np

    from larvanet_tpu_torch.cli import common
    from larvanet_tpu_torch.core.registry import get_model
    from larvanet_tpu_torch.ops import conv3x3_s8 as s8
    from larvanet_tpu_torch.ops.collapsed_tail import (collapsed_edsr_tail, edsr_tail_fn,
                                                        live_collapsed_edsr_tail,
                                                        make_collapsed_edsr_forward)
    from larvanet_tpu_torch.ops.wino_resblock import make_wino_edsr_forward

    rng = np.random.default_rng(SEED + 16)
    n, h, w = LR_BATCH
    frames = [photo(rng, h, w) for _ in range(n)]
    x = torch.from_numpy(np.ascontiguousarray(
        np.stack(frames).transpose(0, 2, 3, 1), np.float32)).cuda()
    with tempfile.TemporaryDirectory() as tmp:
        pth = os.path.join(tmp, "edsr_x4.pth")
        save_edsr_baseline(torch, pth, frames[0])
        model = get_model("edsr")
        model.parse_args([])
        model.prepare([4], device="cuda", seed=SEED)
        model.restore(pth)
    direct = make_collapsed_edsr_forward(model)
    # the probed kernel against the composed one
    tail = collapsed_edsr_tail(model)
    with torch.no_grad():
        composed = live_collapsed_edsr_tail(model.module, 4)[0].cpu().numpy()
    magnitude = float(np.abs(tail.bias_tile_np).max() + np.abs(tail.kernel_np).max())
    probe_err = float(np.abs(tail.kernel_np - composed).max())
    probe_bar = PROBE_STEPS * float(np.spacing(np.float32(magnitude)))
    print("collapsed tail x4: the probed kernel lies %.3g from the composed one (bar %.3g: %d "
          "f32 steps at the tail's %.4g)" % (probe_err, probe_bar, PROBE_STEPS, magnitude),
          flush=True)
    if composed.shape != tail.kernel_np.shape or probe_err > probe_bar:
        raise AssertionError("the probed kernel disagrees with the composed one")
    out = {"probe_err": probe_err}
    collapsed = {}

    def run(route):
        model.set_route(route)
        return model.fwd_runtime(x)

    for dname in ("f32", "bf16"):
        model.set_serving_dtype(dname)
        label = "collapsed %s" % dname
        got, conv, _ = counted(torch, lambda: run(direct))
        expect_forwards("forward %s" % label, conv, PATH_LAUNCHES[dname], 1, KXK_LAUNCHES)
        collapsed[dname] = got
        with plain_versions():
            ref = run(direct)
        err = float((got - ref).abs().max())
        bar = (FWD_RTOL if dname == "f32" else BF16_FWD_RTOL) * float(ref.abs().max())
        plain_tail = run(None)
        d_tail = float((got - plain_tail).abs().max())
        psnr_tail = _psnr(got, plain_tail)
        tail_ok = (psnr_tail >= COLLAPSED_PSNR_DB if dname == "f32"
                   else d_tail <= BF16_FWD_RTOL * float(plain_tail.abs().max()))
        print("forward %s: max |d| %.3g against the same route with the plain versions (bar "
              "%.3g); against the plain tail's forward max |d| %.3g, mean %.3g, PSNR %.2f dB "
              "(bar: %s)" % (label, err, bar, d_tail, float((got - plain_tail).abs().mean()),
                             psnr_tail, "%g dB" % COLLAPSED_PSNR_DB if dname == "f32" else
                             "%.3g" % (BF16_FWD_RTOL * float(plain_tail.abs().max()))),
              flush=True)
        if err > bar or not tail_ok or not bool(torch.isfinite(got).all()):
            raise AssertionError("forward %s disagrees" % label)
        del ref, plain_tail
        t = time_windows(torch, {"collapsed": lambda: run(direct), "plain tail": lambda: run(None)})
        splits = {k: breakdown_line(torch, lambda k=k: run(direct if k == "collapsed" else None),
                                    t[k][0]) for k in t}
        for k in t:
            print("forward: EDSR-baseline x4, %d x %dx%d LR, %s, %s tail: %s per forward, %.3f "
                  "LR-MP/s; %s" % (n, h, w, dname, k, spread(t[k]), n * h * w / 1e3 / t[k][0],
                                   splits[k]), flush=True)
        # the tails alone, on the trunk's output
        xd = x.to(model.compute_dtype)
        with torch.no_grad():
            hd = model.serving_module(xd, tail=lambda z: z)
        plain = edsr_tail_fn(model.serving_module)
        tails = {"collapsed": _no_grad(torch, lambda: tail(hd)),
                 "plain": _no_grad(torch, lambda: plain(hd))}
        tt = time_windows(torch, tails)
        for k, fn in tails.items():
            print("tail: EDSR-baseline x4, %d x %dx%d LR, %s, %s: %s; %s" % (
                n, h, w, dname, k, spread(tt[k]), breakdown_line(torch, fn, tt[k][0])),
                flush=True)
        out[dname] = {"forward_ms": t["collapsed"][0], "plain_tail_forward_ms": t["plain tail"][0],
                      "tail_ms": tt["collapsed"][0], "plain_tail_ms": tt["plain"][0],
                      "max_abs_err": err, "vs_plain_tail": d_tail,
                      "vs_plain_tail_psnr": psnr_tail}
        del hd
    model.set_serving_dtype("f32")

    # --wino_trunk 2 on the baked tail, f32
    wino = make_wino_edsr_forward(model, 2)
    got, conv, fused = counted(torch, lambda: run(wino))
    expect_forwards("forward --wino_trunk 2 (baked tail)", conv, WINO_CONV_PATH_LAUNCHES["f32"],
                    1, KXK_LAUNCHES)
    err = float((got - collapsed["f32"]).abs().max())
    bar = WINO_FWD_RTOL * float(collapsed["f32"].abs().max())
    print("forward --wino_trunk 2 (baked tail): fused launches %s; max |d| %.3g against the "
          "collapsed conv3x3 forward (bar %.3g)" % (fused, err, bar), flush=True)
    if fused != {2: 16, 4: 0} or err > bar:
        raise AssertionError("the --wino_trunk 2 forward on the baked tail disagrees")

    # the int8 forward on the baked tail, calibrated on photo frames
    calib = np.stack([photo(rng, *INT8_CALIB[1:]) for _ in range(INT8_CALIB[0])])
    calib = calib.transpose(0, 2, 3, 1).astype(np.float32)
    model.set_route(None)
    common.maybe_int8_trunk(model, SimpleNamespace(int8_trunk=1, model="edsr"), lambda: calib)
    got, by_entry, conv = _counted_s8(torch, lambda: model.fwd_runtime(x))
    expect_forwards("forward --int8_trunk 1 (baked tail)", conv, INT8_LAUNCHES["edsr"][1], 1)
    expect_kxk("forward --int8_trunk 1 (baked tail)", LAST_KXK, KXK_LAUNCHES, 1)
    with _plain_s8(), plain_versions():
        ref = model.fwd_runtime(x)
    psnr = _psnr(got, ref)
    print("forward --int8_trunk 1 (baked tail): conv3x3_s8 launches %s; PSNR %.2f dB against the "
          "plain int8 forward (bar %g), %.2f dB against the f32 collapsed forward" % (
              by_entry, psnr, INT8_FWD_PSNR_DB, _psnr(got, collapsed["f32"])), flush=True)
    if by_entry != INT8_LAUNCHES["edsr"][0] or psnr < INT8_FWD_PSNR_DB:
        raise AssertionError("the int8 forward on the baked tail disagrees")
    model.set_route(None)
    del model, got, ref, collapsed
    torch.cuda.empty_cache()
    return out


def collapsed_train_phase(torch):
    """Phase 14c. EDSR-baseline x4 trained at full width on the default
    route (the live collapsed tail, the loss before the shuffle), batch 16
    of 48x48 on phase 8's set: one batch's loss and gradients against the
    plain versions (LOSS_RTOL, GRAD_RTOL; conv3x3, conv_kxk and both weight
    gradients plain); one counted step (TRAIN_COLLAPSED_LAUNCHES,
    TRAIN_COLLAPSED_KXK); the step's median ms and device split against
    --collapsed_tail_train 0's in the same call; the train CLI for
    TRAIN_STEPS steps and a resume from the middle, bit for bit. Returns
    the counted step's launches ({"forward", "dgrad", "wgrad"}, and
    "kxk")."""
    import numpy as np

    from larvanet_tpu_torch.cli import train
    from larvanet_tpu_torch.core.registry import get_loader, get_model
    from larvanet_tpu_torch.ops import conv_kxk as ck

    batch, patch = TRAIN_BATCH, TRAIN_PATCH
    with tempfile.TemporaryDirectory() as tmp:
        write_train_set(tmp, np.random.default_rng(SEED + 8), TRAIN_FRAMES, TRAIN_LR)
        data_flags = ["--data_input_path", os.path.join(tmp, "LR"),
                      "--data_truth_path", os.path.join(tmp, "HR"), "--data_cached",
                      "--data_seed", str(SEED)]
        loader = get_loader("div2k_train_loader")
        loader.parse_args(data_flags)
        loader.prepare([4])
        loader.reseed_for_step(0)
        lr_list, hr_list = loader.get_patch_batch(batch, 4, patch)
        x = torch.from_numpy(np.stack(lr_list).transpose(0, 2, 3, 1).copy()).cuda()
        t = torch.from_numpy(np.stack(hr_list).transpose(0, 2, 3, 1).copy()).cuda()
        models = {}
        for label, flags in (("collapsed", []), ("plain", ["--collapsed_tail_train", "0"])):
            model = get_model("edsr")
            model.parse_args(flags)
            model.prepare([4], device="cuda", seed=SEED, is_training=True)
            models[label] = model
        model = models["collapsed"]
        if model.train_tail_route() != "lr_domain" or models["plain"].train_tail_route():
            raise AssertionError("train routes %s / %s" % (
                model.train_tail_route(), models["plain"].train_tail_route()))
        check_train_grads(torch, model, x, t, "EDSR-baseline x4 collapsed tail", batch, patch)
        ck.reset_launches()
        launches = counted_step(torch, lambda: model.train_step(lr_list, 4, hr_list))
        dgrad = dict(ck.DGRAD_LAUNCHES_BY_PATH)
        kxk = {"forward": {p: ck.LAUNCHES_BY_PATH[p] - dgrad[p] for p in dgrad},
               "dgrad": dgrad, "wgrad": ck.WGRAD_LAUNCHES}
        print("launches: conv_kxk forward %s, dgrad %s; conv_kxk_wgrad %d"
              % (kxk["forward"], kxk["dgrad"], kxk["wgrad"]), flush=True)
        if launches != TRAIN_COLLAPSED_LAUNCHES or kxk != TRAIN_COLLAPSED_KXK:
            raise AssertionError("collapsed train step launches %s and %s, not %s and %s" % (
                launches, kxk, TRAIN_COLLAPSED_LAUNCHES, TRAIN_COLLAPSED_KXK))
        # the two routes' steps timed in turns, window by window
        steps = {label: (lambda m=m: m.train_step(lr_list, 4, hr_list))
                 for label, m in models.items()}
        tms = time_windows(torch, steps)
        times = {label: tm[0] for label, tm in tms.items()}
        for label, m in models.items():
            train_step_split(torch, m, x, t, steps[label], "EDSR-baseline x4 %s tail" % label,
                             batch, patch, "f32", tms[label])
            _, parts = device_breakdown(torch, steps[label],
                                        kinds=("conv_kxk", "wgrad", "conv3x3"))
            if parts is not None:
                print("train step kernels by name (%s tail): %s" % (label, ", ".join(
                    "%s %.4f ms" % kv for kv in parts.items())), flush=True)
        print("train step, EDSR-baseline x4 batch 16 x 48x48 f32, timed in turns: collapsed "
              "tail %.4f ms against the plain tail's %.4f ms (%.3fx)" % (
                  times["collapsed"], times["plain"], times["plain"] / times["collapsed"]),
              flush=True)
        del models, model, x, t
        torch.cuda.empty_cache()
        half = TRAIN_STEPS // 2
        cli = ["--dataloader", "div2k_train_loader", "--model", "edsr", "--scales", "4",
               "--device", "cuda", "--batch_size", str(batch), "--input_patch_size",
               str(patch), "--log_freq", str(half), "--save_freq", str(half)] + data_flags
        os.makedirs(os.path.join(tmp, "collapsed"))
        cli_resume_check(train.main, cli, os.path.join(tmp, "collapsed"), TRAIN_STEPS,
                         ["model_%d.pth" % half, "model_%d.state.pt" % half],
                         "train CLI (the collapsed tail, the loss before the shuffle)")
    torch.cuda.empty_cache()
    return dict(launches, kxk=kxk, step_ms=times)


# ---- phase 15: the MSRR family ---------------------------------------------------

# 15a: the depthwise conv at dwsr_reduced x4's 48 channels (the 4 x 192x192
# batch and one 339x510 frame) and MAMNet's CSD 64 (its later slice); its
# input and weight gradients at a train step's batch 16 x 48x48
DW_SHAPES = (("dwsr_reduced x4", LR_BATCH, 48), ("dwsr_reduced x4", RAGGED, 48),
             ("MAMNet CSD", LR_BATCH, 64))
DW_GRAD_SHAPES = (("dwsr_reduced x4", (TRAIN_BATCH, TRAIN_PATCH, TRAIN_PATCH), 48),
                  ("MAMNet CSD", (TRAIN_BATCH, TRAIN_PATCH, TRAIN_PATCH), 64))
PEAK_F32_FMA = 67e12  # f32 outside the tensor cores: the depthwise conv's products
# 15b: the new epilogues on each conv3x3 path, (C, F, path), and their acts
EPILOGUE_SHAPES = ((48, 48, "tensor_core"), (3, 48, "cuda_core"), (48, 3, "narrow"))
EPILOGUE_ACTS = (("relu6", 0.1), ("leaky_relu", 0.2))
# 15c: the family at full width, x4: name -> (parameters, conv3x3 launches a
# forward by path, dwconv3x3 launches a forward); msrr_reduced's int8
# forward's s8 launches
MSRR_MODELS = {
    "msrr_reduced": (1331520, {"cuda_core": 1, "tensor_core": 64, "narrow": 0}, 0),
    "dwsr_reduced": (182592, {"cuda_core": 1, "tensor_core": 0, "narrow": 0}, 64),
    "msrr": (1517571, {"cuda_core": 1, "tensor_core": 35, "narrow": 1}, 0),
    "msrr_test": (1517571, {"cuda_core": 1, "tensor_core": 35, "narrow": 1}, 0),
}
MSRR_INT8_S8 = {"conv_a": 32, "conv_b": 32}
# the device split's kernel kinds, by name: the s8 kernel's name holds "conv3x3"
MSRR_KINDS = ("s8", "dw_", "conv3x3")
# 15d: one train step at batch 16 x 48x48: conv3x3 forward / dgrad / wgrad by
# path, dwconv3x3 by entry
_MSRR48_STEP = {"forward": {"cuda_core": 1, "tensor_core": 64, "narrow": 0},
                "dgrad": {"cuda_core": 0, "tensor_core": 64, "narrow": 0},
                "wgrad": {"tensor_core": 64, "narrow": 0, "cuda_core": 1},
                "dw": {"forward": 0, "dgrad": 0, "wgrad": 0}}
MSRR_TRAIN = {
    "msrr_reduced": _MSRR48_STEP,
    "msrr_reduced_relu6": _MSRR48_STEP,
    "dwsr_reduced": {"forward": {"cuda_core": 1, "tensor_core": 0, "narrow": 0},
                     "dgrad": {"cuda_core": 0, "tensor_core": 0, "narrow": 0},
                     "wgrad": {"tensor_core": 0, "narrow": 0, "cuda_core": 1},
                     "dw": {"forward": 64, "dgrad": 64, "wgrad": 64}},
}
MSRR_CLI_STEPS = 4


def dw_bound_ms(n, h, w, c, dname, entry="forward"):
    """The least time of one depthwise call: bytes (forward and dgrad: x in,
    y out, the taps; wgrad: x and g in, 10 C f32 sums out) over HBM
    bandwidth vs its f32 products (9 multiply-adds and an add a value) at
    the f32 peak outside the tensor cores."""
    item = 4 if dname == "f32" else 2
    px = n * h * w * c
    if entry == "wgrad":
        nbytes = item * 2 * px + 4 * 10 * c
    else:
        nbytes = item * (2 * px + 9 * c) + 4 * c
    t_bytes, t_ops = nbytes / PEAK_BYTES, (2 * 9 + 1) * px / PEAK_F32_FMA
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _dw_row(torch, label, fns, bound, err, extra=""):
    """Time `fns` in turns and print one row; returns the row's numbers."""
    tm = time_windows(torch, fns)
    row = {k + "_ms": tm[k][0] for k in tm}
    row["ms"] = row.pop("kernel_ms")
    row.update(bound_ms=bound[0], bound_by=bound[1], max_abs_err=err)
    print("dwconv3x3 %s: kernel %s (%.1fx its bound), %s; bound %.4f ms (%s)%s" % (
        label, spread(tm["kernel"]), tm["kernel"][0] / bound[0],
        ", ".join("%s %s" % (k, spread(v)) for k, v in tm.items() if k != "kernel"),
        bound[0], bound[1], extra), flush=True)
    return row


def dw_kernel_phase(torch):
    """Phase 15a. dwconv3x3 (the forward entry) at DW_SHAPES and its input
    gradient (the same entry, the taps rotated, no bias) and
    dwconv3x3_wgrad at DW_GRAD_SHAPES, f32 (TF32 off) and bf16: the forward
    and the input gradient bit for bit with the plain version, the weight
    gradient within GRAD_RTOL of its largest value and two runs bit for
    bit; each timed in turns as a CUDA graph replay of one call ("ms"; the
    taps cast to x's dtype beforehand, so that the replay holds the kernel
    alone), through the wrapper (f32 taps, cast by it), against its plain
    version and the library call
    (F.conv2d / conv2d_input / conv2d_weight with groups = C, also
    replayed) beside its bound. Returns {dtype: {entry: the dwsr_reduced x4
    shape's row}} and every row."""
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_input, conv2d_weight

    from larvanet_tpu_torch.ops import build
    from larvanet_tpu_torch.ops import dwconv3x3 as dw

    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    main, rows = {"f32": {}, "bf16": {}}, []
    lib = build.load(dw.SOURCE)
    for label, (n, h, w), c in DW_SHAPES + DW_GRAD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            # the tile each entry takes (its operands' pointers 16-byte aligned)
            for entry in ("forward", "wgrad"):
                print("dwconv3x3 plan %s %s %s %s: %s" % (
                    entry, label, (n, h, w, c), str(dtype)[6:],
                    dw.plan(lib, (0, 0, 0), dtype, (n, h, w, c), entry)))
    for label, (n, h, w), c in DW_SHAPES:
        k = 0.3 * torch.randn((3, 3, 1, c), generator=gen, device="cuda")
        b = torch.randn((c,), generator=gen, device="cuda")
        x32 = 3.0 * torch.randn((n, h, w, c), generator=gen, device="cuda")
        for dname, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            x = x32.to(dtype)
            got, want = dw.dwconv3x3(x, k, b), dw.dwconv3x3_reference(x, k, b)
            if got.dtype != dtype or not torch.equal(got, want):
                raise AssertionError("dwconv3x3 %s %s %s: %d values differ from the plain "
                                     "version" % (label, (n, h, w, c), dname,
                                                  int((got != want).sum())))
            xn, wl, bl = x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1).to(dtype), b.to(dtype)
            kx = k.to(dtype)  # the entry's own taps: the replay holds the kernel alone
            row = _dw_row(torch, "%s %s %s" % (label, (n, h, w, c), dname), {
                "kernel": graph_replay(torch, lambda: dw.dwconv3x3(x, kx, b)),
                "wrapper": lambda: dw.dwconv3x3(x, k, b),
                "plain": lambda: dw.dwconv3x3_reference(x, k, b),
                "library": graph_replay(torch, lambda: F.conv2d(xn, wl, bl, padding=1,
                                                                groups=c))},
                dw_bound_ms(n, h, w, c, dname), 0.0, ", bit for bit with the plain version")
            rows.append(dict(row, shape=[n, h, w, c], dtype=dname, entry="forward"))
            if (label, (n, h, w), c) == DW_SHAPES[0]:
                main[dname]["forward"] = row
        del x32
    for label, (n, h, w), c in DW_GRAD_SHAPES:
        k = 0.3 * torch.randn((3, 3, 1, c), generator=gen, device="cuda")
        x32 = 3.0 * torch.randn((n, h, w, c), generator=gen, device="cuda")
        g32 = torch.randn((n, h, w, c), generator=gen, device="cuda")
        zero = torch.zeros((c,), device="cuda")
        for dname, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            x, g = x32.to(dtype), g32.to(dtype)
            kr = dw.dgrad_kernel(k)
            got, want = dw.dwconv3x3(g, kr, zero, dgrad=True), dw.dwconv3x3_reference(g, kr, zero)
            if not torch.equal(got, want):
                raise AssertionError("dwconv3x3 dgrad %s %s: %d values differ" % (
                    label, dname, int((got != want).sum())))
            xn, gn, wl = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1)
            krx = kr.to(dtype)
            row = _dw_row(torch, "dgrad %s %s %s" % (label, (n, h, w, c), dname), {
                "kernel": graph_replay(torch, lambda: dw.dwconv3x3(g, krx, zero, dgrad=True)),
                "wrapper": lambda: dw.dwconv3x3(g, kr, zero, dgrad=True),
                "plain": lambda: dw.dwconv3x3_reference(g, kr, zero),
                "library": graph_replay(torch, lambda: conv2d_input(
                    xn.shape, wl.to(dtype), gn, padding=1, groups=c))},
                dw_bound_ms(n, h, w, c, dname), 0.0, ", bit for bit with the plain version")
            rows.append(dict(row, shape=[n, h, w, c], dtype=dname, entry="dgrad"))
            dk, db = dw.dwconv3x3_wgrad(x, g)
            again = dw.dwconv3x3_wgrad(x, g)
            want_k, want_b = dw.dwconv3x3_wgrad_reference(x, g)
            rel = max(float((dk - want_k).abs().max() / want_k.abs().max()),
                      float((db - want_b).abs().max() / want_b.abs().max()))
            err = max(float((dk - want_k).abs().max()), float((db - want_b).abs().max()))
            same = torch.equal(again[0], dk) and torch.equal(again[1], db)
            if rel > GRAD_RTOL or not same or not bool(torch.isfinite(dk).all()):
                raise AssertionError("dwconv3x3_wgrad %s %s: max |d| / max |g| %.3g (bar %g), "
                                     "two runs %s" % (label, dname, rel, GRAD_RTOL,
                                                      "equal" if same else "DIFFER"))
            row = _dw_row(torch, "wgrad %s %s %s" % (label, (n, h, w, c), dname), {
                "kernel": graph_replay(torch, lambda: dw.dwconv3x3_wgrad(x, g)),
                "wrapper": lambda: dw.dwconv3x3_wgrad(x, g),
                "plain": lambda: dw.dwconv3x3_wgrad_reference(x, g),
                "library": graph_replay(torch, lambda: conv2d_weight(
                    xn, (c, 1, 3, 3), gn, padding=1, groups=c))},
                dw_bound_ms(n, h, w, c, dname, "wgrad"), err,
                "; max |d| / max |g| %.3g against the plain version, two runs bit for bit"
                % rel)
            rows.append(dict(row, shape=[n, h, w, c], dtype=dname, entry="wgrad",
                             max_rel_err=rel))
            if (label, (n, h, w), c) == DW_GRAD_SHAPES[0]:
                main[dname]["dgrad"] = rows[-2]
                main[dname]["wgrad"] = rows[-1]
        del x32, g32
    torch.cuda.empty_cache()
    return main, rows


def epilogue_phase(torch):
    """Phase 15b. The epilogues MSRR's ablations add: conv3x3 with relu6 and
    leaky_relu(0.2) at EPILOGUE_SHAPES on the 4 x 192x192 batch, f32 and
    bf16, each on the path it names (one launch counted there), against its
    plain version; conv3x3_s8's conv_a with the same two at 48 -> 48, f32
    and bf16, bit for bit. Returns {dtype: the conv3x3 calls' largest error}."""
    import numpy as np

    from larvanet_tpu_torch.ops import conv3x3
    from larvanet_tpu_torch.ops import conv3x3_s8 as s8

    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    n, h, w = LR_BATCH
    worst = {"f32": 0.0, "bf16": 0.0}
    for c, f, path in EPILOGUE_SHAPES:
        x32 = 3.0 * torch.randn((n, h, w, c), generator=gen, device="cuda")
        k = torch.randn((3, 3, c, f), generator=gen, device="cuda") / math.sqrt(9 * c)
        b = 3.0 + 3.0 * torch.randn((f,), generator=gen, device="cuda")
        for dname, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            x = x32.to(dtype)
            for act, slope in EPILOGUE_ACTS:
                conv3x3.reset_launches()
                got = conv3x3.conv3x3_bias_act(x, k, b, act, slope=slope)
                torch.cuda.synchronize()
                by_path = dict(conv3x3.LAUNCHES_BY_PATH)
                want = conv3x3.conv3x3_bias_act_reference(x, k, b, act, slope)
                ok, err = _conv_ok(torch, got, want, dname)
                bent = float((want.float() != conv3x3.conv3x3_bias_act_reference(
                    x, k, b, None).float()).float().mean())
                print("epilogue conv3x3 %d->%d %s %s(%g) on the %s path: max |d| %.3g against "
                      "the plain version; the activation moved %.3f of the values" % (
                          c, f, dname, act, slope, path, err, bent), flush=True)
                if not ok or by_path[path] != 1 or sum(by_path.values()) != 1 or bent < 0.05:
                    raise AssertionError("conv3x3 %d->%d %s %s: path %s, max |d| %.3g" % (
                        c, f, dname, act, by_path, err))
                worst[dname] = max(worst[dname], err)
        del x32
    rng = np.random.default_rng(SEED + 17)
    c = 48
    codes = rng.integers(-127, 128, (3, 3, c, c)).astype(np.int8)
    sa = (rng.uniform(0.5, 2.0, c) * 1e-3).astype(np.float32)
    bias = torch.from_numpy((2.0 * rng.standard_normal(c)).astype(np.float32))
    hin32 = torch.from_numpy((rng.standard_normal((n, h, w, c)) * 3).astype(np.float32))
    for dname, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        hin = hin32.to("cuda").to(dtype)
        s_in = float(hin.float().abs().max()) * 1.05 / 127.0
        wt = s8.make_weight(codes, sa, s_in, bias, dtype, "cuda")
        for act, slope in EPILOGUE_ACTS:
            s_mid = 6.0 / 100.0 if act == "relu6" else s_in
            got = s8.conv_a(hin, wt, s_in, s_mid, act, slope)
            want = s8.conv_a_reference(hin, wt, s_in, s_mid, act, slope)
            differ = int((got != want).sum())
            print("epilogue conv3x3_s8 conv_a 48->48 %s %s(%g): %d of %d codes differ from "
                  "the plain version" % (dname, act, slope, differ, want.numel()), flush=True)
            if differ:
                raise AssertionError("conv3x3_s8 conv_a %s %s is not bit for bit" % (dname, act))
    torch.cuda.empty_cache()
    return worst


def save_msrr(torch, path, name, device="cuda"):
    """An MSRR-family model x4 at full width, random weights from SEED (the
    family's 0.1-scaled Kaiming init), saved as the port module's own
    state_dict."""
    from larvanet_tpu_torch.core.registry import get_model

    model = get_model(name)
    model.parse_args([])
    model.prepare([4], device=device, seed=SEED)
    if model.num_parameters() != MSRR_MODELS[name][0]:
        raise AssertionError("%s x4 has %d parameters, not %d"
                             % (name, model.num_parameters(), MSRR_MODELS[name][0]))
    torch.save(model.module.state_dict(), path)


def fit_residual(torch, model, x):
    """Scale the last conv of a random msrr or msrr_test x4 so that its
    residual over the bilinear base on `x` has a std of 40: as drawn, the
    0.1-scaled convs leave it near 1e-2, where no error of the trunk would
    show against the base. The residual is linear in the last conv's weight
    and bias, so both are scaled alike."""
    from larvanet_tpu_torch.models.layers import interpolated_base

    module = model.module
    last = getattr(module, "final_conv", None) or module.conv_last
    with torch.no_grad():
        res = module(x) - interpolated_base(x, 4, "bilinear")
        a = 40.0 / float(res.std())
        last.weight.mul_(a)
        last.bias.mul_(a)


def _counted_msrr(torch, fn):
    """fn() with the conv3x3, dwconv3x3 and conv3x3_s8 counters zeroed just
    before it and read just after: (its result, conv3x3 by path, dwconv3x3
    by entry, s8 by entry)."""
    from larvanet_tpu_torch.ops import conv3x3
    from larvanet_tpu_torch.ops import conv3x3_s8 as s8
    from larvanet_tpu_torch.ops import dwconv3x3 as dw

    for counter in (conv3x3, dw, s8):
        counter.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return (out, dict(conv3x3.LAUNCHES_BY_PATH), dict(dw.LAUNCHES_BY_ENTRY),
            dict(s8.LAUNCHES_BY_ENTRY))


def msrr_forward_phase(torch):
    """Phase 15c. Each MSRR_MODELS model x4 at full width, random weights
    from SEED, on the 4 x 192x192 batch in f32 and bf16: one counted forward
    (its conv3x3 launches by path and dwconv3x3 launches as MSRR_MODELS
    says), held against the same forward with every kernel's plain version
    within FWD_RTOL (bf16: BF16_FWD_RTOL) of the residual over the
    interpolated base (msrr and msrr_test with their last conv scaled,
    fit_residual), then timed with its device split (conv3x3, the
    depthwise kernels "dw_", s8, other, idle). msrr_reduced's W8A8 int8
    forward (bf16, calibrated on the batch): counted (MSRR_INT8_S8 and its
    head conv), held against the same forward on the plain versions
    (INT8_FWD_PSNR_DB), timed. Returns {"conv3x3": launches by path,
    "dw": by entry, "s8": by entry} over the counted forwards, and
    {model: {dtype: ms}}."""
    from larvanet_tpu_torch.core.registry import get_model
    from larvanet_tpu_torch.models.layers import interpolated_base
    from larvanet_tpu_torch.ops.int8_forward import make_int8_msrr_forward

    n, h, w = LR_BATCH
    gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
    x = 255.0 * torch.rand((n, h, w, 3), generator=gen, device="cuda")
    totals, times = {"conv3x3": {}, "dw": {}, "s8": {}}, {}
    for name, (n_params, per_conv, per_dw) in MSRR_MODELS.items():
        model = get_model(name)
        model.parse_args([])
        model.prepare([4], device="cuda", seed=SEED)
        if model.num_parameters() != n_params:
            raise AssertionError("%s has %d parameters" % (name, model.num_parameters()))
        method = getattr(model.module, "base", None) or "bilinear"
        if name in ("msrr", "msrr_test"):
            fit_residual(torch, model, x[:1])
        times[name] = {}
        for dname in ("f32", "bf16"):
            model.set_serving_dtype(dname)
            got, conv, dwl, _ = _counted_msrr(torch, lambda: model.fwd_runtime(x))
            if conv != per_conv or dwl != {"forward": per_dw, "dgrad": 0, "wgrad": 0}:
                raise AssertionError("%s %s forward: conv3x3 %s, dwconv3x3 %s, not %s and %d"
                                     % (name, dname, conv, dwl, per_conv, per_dw))
            _add(totals["conv3x3"], conv)
            _add(totals["dw"], dwl)
            with plain_versions():
                ref = model.fwd_runtime(x)
            base = interpolated_base(x.to(model.compute_dtype), 4, method)
            residual = float((ref - base).abs().max())
            err = float((got - ref).abs().max())
            bar = (FWD_RTOL if dname == "f32" else BF16_FWD_RTOL) * residual
            tm = time_windows(torch, {"forward": lambda: model.fwd_runtime(x)})["forward"]
            times[name][dname] = tm[0]
            print("msrr forward %s x4 %s: conv3x3 %s, dwconv3x3 %d a forward; max |d| %.3g "
                  "against the plain versions (bar %.3g, residual max |y| %.3g); %s per "
                  "forward, %.3f LR-MP/s; %s" % (
                      name, dname, conv, per_dw, err, bar, residual, spread(tm),
                      n * h * w / 1e3 / tm[0], breakdown_line(
                          torch, lambda: model.fwd_runtime(x), tm[0], MSRR_KINDS)), flush=True)
            if err > bar or not bool(torch.isfinite(got).all()) or residual < 1.0:
                raise AssertionError("%s %s forward disagrees with the plain versions"
                                     % (name, dname))
            del got, ref, base
        model.set_serving_dtype("f32")
        if name == "msrr_reduced":
            calib = x[:, :96, :96].cpu().numpy()
            fwd = make_int8_msrr_forward(model, calib)
            got, conv, _, s8l = _counted_msrr(torch, lambda: fwd(x))
            if s8l != MSRR_INT8_S8 or conv != {"cuda_core": 1, "tensor_core": 0, "narrow": 0}:
                raise AssertionError("msrr_reduced int8 forward: s8 %s, conv3x3 %s" % (s8l,
                                                                                     conv))
            _add(totals["s8"], s8l)
            _add(totals["conv3x3"], conv)
            with plain_versions(), _plain_s8():
                ref = fwd(x)
            psnr = _psnr(got.float(), ref.float())
            with torch.no_grad():
                exact = model.module(x)
            tm = time_windows(torch, {"forward": lambda: fwd(x)})["forward"]
            times[name]["int8"] = tm[0]
            print("msrr forward msrr_reduced x4 int8 (bf16): s8 %s, conv3x3 %s; PSNR %.2f dB "
                  "against the plain versions' int8 forward (bar %.1f), %.2f dB against the "
                  "exact f32 forward; %s per forward; %s" % (
                      s8l, conv, psnr, INT8_FWD_PSNR_DB, _psnr(got.float(), exact),
                      spread(tm), breakdown_line(torch, lambda: fwd(x), tm[0], MSRR_KINDS)),
                  flush=True)
            if psnr < INT8_FWD_PSNR_DB:
                raise AssertionError("msrr_reduced int8 forward disagrees with the plain one")
            del fwd, got, ref, exact
        del model
        torch.cuda.empty_cache()
    return totals, times


def msrr_train_phase(torch):
    """Phase 15d. msrr_reduced, msrr_reduced_relu6 and dwsr_reduced x4 at full
    width trained at batch 16 x 48x48, f32, on phase 8's kind of set: one
    batch's loss and gradients against the same Function with the plain
    dgrad and wgrad on the kernels' forward (check_train_grads), a counted
    step (MSRR_TRAIN: conv3x3 forward / dgrad / wgrad by path, the
    depthwise kernels by entry), a step timed (3 windows of 5) with its
    split; then
    msrr_reduced through train_larva for MSRR_CLI_STEPS steps (validation at
    step 1 and every 2 steps, volume checkpoints) and the other two through
    train for MSRR_CLI_STEPS steps. Returns the counted steps' launches
    and {model: ms a step}."""
    import numpy as np

    from larvanet_tpu_torch.cli import train, train_larva
    from larvanet_tpu_torch.core.registry import get_loader, get_model
    from larvanet_tpu_torch.ops import dwconv3x3 as dw

    batch, patch = TRAIN_BATCH, TRAIN_PATCH
    steps, times = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        write_train_set(tmp, np.random.default_rng(SEED + 19), TRAIN_FRAMES, TRAIN_LR)
        data_flags = ["--data_input_path", os.path.join(tmp, "LR"),
                      "--data_truth_path", os.path.join(tmp, "HR"), "--data_cached",
                      "--data_seed", str(SEED)]
        loader = get_loader("div2k_train_loader")
        loader.parse_args(data_flags)
        loader.prepare([4])
        loader.reseed_for_step(0)
        lr_nhwc, hr_nhwc = loader.get_patch_batch_nhwc(batch, 4, patch)
        x, t = torch.from_numpy(lr_nhwc).cuda(), torch.from_numpy(hr_nhwc).cuda()
        for name, want in MSRR_TRAIN.items():
            model = get_model(name)
            model.parse_args([])
            model.prepare([4], device="cuda", seed=SEED, is_training=True)
            label = "%s x4" % name
            check_train_grads(torch, model, x, t, label, batch, patch, same_forward=True)
            step = lambda: model.train_step(lr_nhwc, 4, hr_nhwc)  # noqa: E731
            dw.reset_launches()
            launches = counted_step(torch, step)
            launches["dw"] = dict(dw.LAUNCHES_BY_ENTRY)
            if launches != want:
                raise AssertionError("%s train step launches %s, not %s"
                                     % (label, launches, want))
            print("train %s: dwconv3x3 launches %s" % (label, launches["dw"]), flush=True)
            steps.append(launches)
            # 3 windows of 5 steps: the phase's share of the script's time
            tm = time_windows(torch, {"train_step": step}, windows=3, reps=5)["train_step"]
            train_step_split(torch, model, x, t, step, label, batch, patch, "f32", tm)
            times[name] = tm[0]
            del model
            torch.cuda.empty_cache()
        volume = patch * patch * batch * 3
        cli = ["--dataloader", "div2k_train_loader", "--device", "cuda", "--batch_size",
               str(batch), "--input_patch_size", str(patch), "--max_steps",
               str(MSRR_CLI_STEPS)] + data_flags
        run = os.path.join(tmp, "msrr_reduced")
        trained, losses = train_larva.main(cli + [
            "--model", "msrr_reduced", "--val_data_input_path", os.path.join(tmp, "LR"),
            "--val_data_truth_path", os.path.join(tmp, "HR"), "--val_volume", str(2 * volume),
            "--log_freq", "1", "--train_path", run])
        files = sorted(os.listdir(run))
        stems = ["model_step%d_vol0G" % s for s in range(2, MSRR_CLI_STEPS + 1, 2)]
        print("train_larva msrr_reduced x4: losses %s, lr %.3g, files %s" % (
            {k: round(v, 4) for k, v in losses.items()}, trained.get_learning_rate(), files),
            flush=True)
        if sorted(losses) != list(range(1, MSRR_CLI_STEPS + 1)) or not all(
                s + ext in files for s in stems for ext in (".pth", ".state.pt")) or not all(
                np.isfinite(v) for v in losses.values()):
            raise AssertionError("train_larva msrr_reduced: losses %s, files %s"
                                 % (losses, files))
        del trained
        for name in ("dwsr_reduced", "msrr_reduced_relu6"):
            _, losses = train.main(cli + ["--model", name, "--scales", "4", "--log_freq", "1",
                                          "--train_path", os.path.join(tmp, name)])
            print("train %s x4: losses %s" % (name, {k: round(v, 4) for k, v in losses.items()}),
                  flush=True)
            if sorted(losses) != list(range(1, MSRR_CLI_STEPS + 1)) or not all(
                    np.isfinite(v) for v in losses.values()):
                raise AssertionError("train %s: losses %s" % (name, losses))
    torch.cuda.empty_cache()
    return steps, times


def msrr_test_cli_phase(torch):
    """Phase 15e. The test CLI on msrr_test x4 at full width (random weights
    from SEED), in its [0, 1] range, on a SynSetReal tree of TEST_FRAMES
    `photo` frames (write_test_set): counted (37 conv3x3 launches a frame),
    the per-image Y-PSNR printed by the CLI. Returns the conv3x3 launches
    by path."""
    import numpy as np

    from larvanet_tpu_torch.cli import test as port_test

    with tempfile.TemporaryDirectory() as tmp:
        write_test_set(tmp, np.random.default_rng(SEED + 20))
        pth = os.path.join(tmp, "msrr_test.pth")
        save_msrr(torch, pth, "msrr_test")
        results, conv, _, _ = _counted_msrr(torch, lambda: port_test.main([
            "--model", "msrr_test", "--device", "cuda", "--restore_path", pth,
            "--input_root_path", os.path.join(tmp, "test_LR"), "--truth_root_path",
            os.path.join(tmp, "test_HR"), "--output_root_path", os.path.join(tmp, "out"),
            "--datasets", "SynSetReal"]))
    frames = len(TEST_FRAMES)
    want = {p: k * frames for p, k in MSRR_MODELS["msrr_test"][1].items()}
    print("test msrr_test x4: %s; conv3x3 launches %s for %d frames" % (
        results, conv, frames), flush=True)
    if conv != want or not all(np.isfinite(r[1]) for r in results):
        raise AssertionError("test msrr_test: conv3x3 %s (not %s), results %s"
                             % (conv, want, results))
    return conv


def msrr_phase(torch):
    """Phase 15: 15a-15e, each one's seconds printed. Returns what the
    kernels line takes."""
    t0 = time.perf_counter()
    seconds = {}

    def lap(part):
        seconds[part] = time.perf_counter() - t0 - sum(seconds.values())

    dw_main, dw_rows = dw_kernel_phase(torch)
    lap("15a")
    epilogue = epilogue_phase(torch)
    lap("15b")
    served = {}
    for dtype_name in ("f32", "bf16"):
        _, by_path, model = serve_phase(torch, dtype_name=dtype_name,
                                        model_name="msrr_reduced")
        _add(served, by_path)
        del model
    forwards, forward_ms = msrr_forward_phase(torch)
    lap("15c")
    steps, step_ms = msrr_train_phase(torch)
    lap("15d")
    test_conv = msrr_test_cli_phase(torch)
    lap("15e")
    print("phase 15: %.1f s (%s)" % (time.perf_counter() - t0, ", ".join(
        "%s %.1f s" % kv for kv in seconds.items())), flush=True)
    return dict(dw_main=dw_main, dw_rows=dw_rows, epilogue=epilogue, served=served,
                forwards=forwards, forward_ms=forward_ms, steps=steps, step_ms=step_ms,
                test_conv=test_conv)


# ---- phase 16: TreeNet and the REGOs ---------------------------------------------

# 16a: the conv shapes these families bring (X4_CONVS' format), with their
# launches per REGO-Net x4 forward: the RESBlock's conv1 with LeakyReLU(0.1)
# (its conv2, 64 -> 64, and feature_extraction, 3 -> 64, are phase 3's
# shapes), SRrecon's 384 -> 48 over the fuse's six 64-channel chunks;
# REGO-serial's merge conv_0 384 -> 64 and TreeNet's head 3 -> 48 with
# LeakyReLU(0.1), which no REGO-Net forward runs
BRANCHY_CONVS = (
    ("REGO RESBlock conv1 leaky", 1, 64, 64, "leaky_relu", 15, "tensor_core"),
    ("REGO SRrecon 384->48", 1, 384, 48, None, 1, "tensor_core"),
    ("REGO-serial conv_0 384->64", 1, 384, 64, None, 0, "tensor_core"),
    ("TreeNet first_conv leaky", 1, 3, 48, "leaky_relu", 0, "cuda_core"),
)
# their weight and input gradients at a train step's batch 16 x 48x48, with
# the launches of a REGO-Net step (TRAIN_WGRAD's and TRAIN_DGRAD's formats)
BRANCHY_WGRAD = (("REGO SRrecon 384->48", 1, 384, 48, 1),
                 ("REGO-serial conv_0 384->64", 1, 384, 64, 0))
BRANCHY_DGRAD = (("REGO SRrecon 48->384", 1, 48, 384),
                 ("REGO-serial conv_0 64->384", 1, 64, 384))
# 16b: name -> (flags, parameters, conv3x3 launches a x4 forward by path):
# TreeNet's head on the CUDA cores and its 16 ResBlocks' 32 convs on the
# tensor cores; REGO-Net's feature_extraction on the CUDA cores, its 15
# RESBlocks' 30 convs and SRrecon on the tensor cores; REGO-serial
# --num_regos 2 twice the RESBlocks and the merge conv_0
BRANCHY_MODELS = {
    "TreeNet": ([], 666432, {"cuda_core": 1, "tensor_core": 32, "narrow": 0}),
    "REGO-Net": ([], 1275568, {"cuda_core": 1, "tensor_core": 31, "narrow": 0}),
    "REGO-serial": (["--num_regos", "2"], 2604656,
                    {"cuda_core": 1, "tensor_core": 62, "narrow": 0}),
}
# 16c: the --int8_trunk forward's launches: s8 by entry (a pair each
# ResBlock) and the conv3x3 launches that stay exact (the heads; REGO's
# SRrecon)
BRANCHY_INT8 = {"TreeNet": ({"conv_a": 16, "conv_b": 16},
                            {"cuda_core": 1, "tensor_core": 0, "narrow": 0}),
                "REGO-Net": ({"conv_a": 15, "conv_b": 15},
                             {"cuda_core": 1, "tensor_core": 1, "narrow": 0})}
# the residual std fit_branchy gives a random model over its base
BRANCHY_RESIDUAL_STD = 30.0
# 16d: name -> (flags, launches of one step at batch 16 x 48x48): TreeNet
# --num_branches 2 (49 forward convs; 48 dgrads, none for the head; 49
# wgrads, the head's 3 -> 48 on the CUDA cores), REGO-Net (32, 31, 32)
BRANCHY_TRAIN = {
    "TreeNet": (["--num_branches", "2"],
                {"forward": {"cuda_core": 1, "tensor_core": 48, "narrow": 0},
                 "dgrad": {"cuda_core": 0, "tensor_core": 48, "narrow": 0},
                 "wgrad": {"tensor_core": 48, "narrow": 0, "cuda_core": 1}}),
    "REGO-Net": ([], {"forward": {"cuda_core": 1, "tensor_core": 31, "narrow": 0},
                      "dgrad": {"cuda_core": 0, "tensor_core": 31, "narrow": 0},
                      "wgrad": {"tensor_core": 31, "narrow": 0, "cuda_core": 1}}),
}
# REGO-serial --num_regos 2's step (63, 62, 63), and the convs of its 30
# pairs that a --remat 1 step recomputes
SERIAL_STEP = {"forward": {"cuda_core": 1, "tensor_core": 62, "narrow": 0},
               "dgrad": {"cuda_core": 0, "tensor_core": 62, "narrow": 0},
               "wgrad": {"tensor_core": 62, "narrow": 0, "cuda_core": 1}}
SERIAL_REMAT_EXTRA = 60
BRANCHY_CLI_STEPS = 4


def fit_branchy(torch, model, x):
    """Scale a random TreeNet's or REGO's output so that its residual over
    its base on `x` (NHWC on the card) has a std of BRANCHY_RESIDUAL_STD:
    REGO's residual is linear in SRrecon's weight and bias, both scaled;
    TreeNet's, at its init (zero biases, ReLU and LeakyReLU), positively
    homogeneous in its head's weight, scaled alone."""
    from larvanet_tpu_torch.models.layers import interpolated_base

    module = model.module
    with torch.no_grad():
        res = module(x) - interpolated_base(x, 4, module.interpolate)
        a = BRANCHY_RESIDUAL_STD / float(res.std())
        if hasattr(module, "SRrecon"):
            module.SRrecon.body[0].weight.mul_(a)
            module.SRrecon.body[0].bias.mul_(a)
        else:
            module.common_parts[0].weight.mul_(a)


def branchy_model(name, device="cuda", extra=(), is_training=False):
    """A BRANCHY_MODELS model x4 at full width, random weights from SEED."""
    from larvanet_tpu_torch.core.registry import get_model

    flags, n_params, _ = BRANCHY_MODELS[name]
    model = get_model(name)
    model.parse_args(list(flags) + list(extra))
    model.prepare([4], device=device, seed=SEED, is_training=is_training)
    if not extra and model.num_parameters() != n_params:
        raise AssertionError("%s x4 has %d parameters, not %d"
                             % (name, model.num_parameters(), n_params))
    return model


def save_branchy(torch, path, name, fit_frame, device="cuda"):
    """A BRANCHY_MODELS model, fitted on the CHW frame `fit_frame`
    (fit_branchy), saved as the port module's own state_dict."""
    model = branchy_model(name, device)
    fit_branchy(torch, model, model._input_to_device([fit_frame]))
    torch.save(model.module.state_dict(), path)


def branchy_s8_phase(torch, slope=0.1, pairs=None, res_weights=(1.0, 0.1),
                     label="REGO RESBlock", act="leaky_relu"):
    """Phase 16a's s8 half (17a's with ebrn_rm's BRM pair, 18a's with
    MAMNet's MAMBlock pair, `act` relu): REGO's RESBlock
    pair at 64 -> 64 on the 4 x 192x192 batch, bf16 (the CLIs' int8 dtype)
    and f32: conv_a with `act` (leaky_relu at `slope`) and conv_b without a
    residual (the 'both' and 'none' pairs add hin + t, or not, outside it)
    at each of `res_weights`
    (REGO-Net's 1, REGO-serial's 0.1), each bit for bit with its plain
    version, timed in turns as CUDA graph replays of the entry beside the
    plain version and the bound. Returns {dtype: the sums over one int8
    forward's `pairs` pairs (REGO-Net's 15)}."""
    import numpy as np

    from larvanet_tpu_torch.ops import conv3x3_s8 as s8

    rng = np.random.default_rng(SEED + 24)
    n, h, w = LR_BATCH
    c = 64
    pairs = BRANCHY_INT8["REGO-Net"][0]["conv_a"] if pairs is None else pairs
    codes_a, codes_b = (rng.integers(-127, 128, (3, 3, c, c)).astype(np.int8) for _ in "ab")
    sa, sb = ((rng.uniform(0.5, 2.0, c) * 1e-3).astype(np.float32) for _ in "ab")
    bias_a, bias_b = (torch.from_numpy(rng.standard_normal(c).astype(np.float32))
                      for _ in "ab")
    x32 = torch.from_numpy((rng.standard_normal((n, h, w, c)) * 3).astype(np.float32))
    out = {}
    for dname, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        item = 4 if dname == "f32" else 2
        hin = x32.to("cuda").to(dtype)
        s_in = float(hin.float().abs().max()) * 1.05 / 127.0
        wa = s8.make_weight(codes_a, sa, s_in, bias_a, dtype, "cuda")
        s_mid = s_in  # leaky_relu keeps both signs: the pre-activation's range
        wb = s8.make_weight(codes_b, sb, s_mid, bias_b, dtype, "cuda")
        tq = s8.conv_a(hin, wa, s_in, s_mid, act, slope)
        differ = int((tq != s8.conv_a_reference(hin, wa, s_in, s_mid, act, slope)).sum())
        bits = torch.int16 if dname == "bf16" else torch.int32
        for rw in res_weights:
            got = s8.conv_b(tq, wb, dtype, None, rw)
            differ += int((got.view(bits) != s8.conv_b_reference(tq, wb, dtype, None, rw)
                           .view(bits)).sum())
        stream = torch.cuda.current_stream
        t = time_windows(torch, {
            "conv_a": graph_replay(torch, lambda: s8._run_a(
                s8._entry("conv_a", dtype), hin, wa, s_in, s_mid, act,
                stream().cuda_stream, slope)),
            "conv_b": graph_replay(torch, lambda: s8._run_b(
                s8._entry("conv_b", dtype), tq, wb, dtype, None, 1.0, stream().cuda_stream)),
            "plain_a": lambda: s8.conv_a_reference(hin, wa, s_in, s_mid, act, slope),
            "plain_b": lambda: s8.conv_b_reference(tq, wb, dtype, None, 1.0)})
        bounds = {"conv_a": s8_bound_ms(n, h, w, c, c, item, "conv_a"),
                  "conv_b": s8_bound_ms(n, h, w, c, c, item, "conv_b")}
        print("s8 %s 64->64 %dx%dx%d %s: conv_a %s(%g) %s = %.1fx its "
              "bound %.4f ms (%s; plain %s), conv_b without a residual %s = %.1fx its bound "
              "%.4f ms (%s; plain %s); %d values differ from the plain versions (conv_b at "
              "res_weight %s)" % (
                  label, n, h, w, dname, act, slope, spread(t["conv_a"]),
                  t["conv_a"][0] / bounds["conv_a"][0],
                  *bounds["conv_a"], spread(t["plain_a"]), spread(t["conv_b"]),
                  t["conv_b"][0] / bounds["conv_b"][0], *bounds["conv_b"],
                  spread(t["plain_b"]), differ, " and ".join("%g" % rw for rw in res_weights)),
              flush=True)
        if differ:
            raise AssertionError("conv3x3_s8 %s pair %s: %d values differ"
                                 % (label, dname, differ))
        out[dname] = {"ms": pairs * (t["conv_a"][0] + t["conv_b"][0]),
                      "plain_ms": pairs * (t["plain_a"][0] + t["plain_b"][0]),
                      "bound_ms": pairs * (bounds["conv_a"][0] + bounds["conv_b"][0]),
                      "bound_by": bounds["conv_a"][1], "library_ms": None,
                      "conv_a_ms": t["conv_a"][0], "conv_b_ms": t["conv_b"][0]}
        del hin, tq, got
    torch.cuda.empty_cache()
    return out


def branchy_forward_phase(torch):
    """Phase 16b's forwards and 16c. Each BRANCHY_MODELS model x4 at full
    width, fitted (fit_branchy), on the 4 x 192x192 batch in f32 and bf16:
    one counted forward (BRANCHY_MODELS' launches), held against the same
    forward with every kernel's plain version within FWD_RTOL (bf16:
    BF16_FWD_RTOL) of the residual over the base, then timed with its
    device split (conv3x3, s8, other, idle). 16c: TreeNet's and REGO-Net's
    --int8_trunk route (the CLIs' maybe_int8_trunk, calibrated on the
    batch's 96 x 96 corner): counted (BRANCHY_INT8), held against the same
    route on the plain versions (INT8_FWD_PSNR_DB), timed. Returns the
    counted launches ({"conv3x3": by path, "s8": by entry}) and {model:
    {dtype: ms}}."""
    from types import SimpleNamespace

    from larvanet_tpu_torch.cli import common
    from larvanet_tpu_torch.models.layers import interpolated_base

    n, h, w = LR_BATCH
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    x = 255.0 * torch.rand((n, h, w, 3), generator=gen, device="cuda")
    totals, times = {"conv3x3": {}, "s8": {}}, {}
    kinds = ("s8", "conv3x3")
    for name, (_, _, per_conv) in BRANCHY_MODELS.items():
        model = branchy_model(name)
        fit_branchy(torch, model, x[:1])
        times[name] = {}
        for dname in ("f32", "bf16"):
            model.set_serving_dtype(dname)
            got, conv, _, _ = _counted_msrr(torch, lambda: model.fwd_runtime(x))
            if conv != per_conv:
                raise AssertionError("%s %s forward: conv3x3 %s, not %s"
                                     % (name, dname, conv, per_conv))
            _add(totals["conv3x3"], conv)
            with plain_versions():
                ref = model.fwd_runtime(x)
            base = interpolated_base(x.to(model.compute_dtype), 4, model.module.interpolate)
            residual = float((ref - base).abs().max())
            err = float((got - ref).abs().max())
            bar = (FWD_RTOL if dname == "f32" else BF16_FWD_RTOL) * residual
            tm = time_windows(torch, {"forward": lambda: model.fwd_runtime(x)})["forward"]
            times[name][dname] = tm[0]
            print("branchy forward %s x4 %s: conv3x3 %s; max |d| %.3g against the plain "
                  "versions (bar %.3g, residual max |y| %.3g); %s per forward, %.3f LR-MP/s; "
                  "%s" % (name, dname, conv, err, bar, residual, spread(tm),
                          n * h * w / 1e3 / tm[0], breakdown_line(
                              torch, lambda: model.fwd_runtime(x), tm[0], kinds)), flush=True)
            if err > bar or not bool(torch.isfinite(got).all()) or residual < 1.0:
                raise AssertionError("%s %s forward disagrees with the plain versions"
                                     % (name, dname))
            del got, ref, base
        model.set_serving_dtype("f32")
        if name in BRANCHY_INT8:
            want_s8, want_conv = BRANCHY_INT8[name]
            common.maybe_int8_trunk(model, SimpleNamespace(int8_trunk=1, model=name),
                                    lambda: x[:, :96, :96].cpu().numpy())
            got, conv, _, s8l = _counted_msrr(torch, lambda: model.fwd_runtime(x))
            if s8l != want_s8 or conv != want_conv:
                raise AssertionError("%s int8 forward: s8 %s, conv3x3 %s" % (name, s8l, conv))
            _add(totals["s8"], s8l)
            _add(totals["conv3x3"], conv)
            with plain_versions(), _plain_s8():
                ref = model.fwd_runtime(x)
            psnr = _psnr(got, ref)
            exact = model.int8_exact_forward(x).float()
            tm = time_windows(torch, {"forward": lambda: model.fwd_runtime(x)})["forward"]
            times[name]["int8"] = tm[0]
            print("branchy forward %s x4 --int8_trunk (bf16): s8 %s, conv3x3 %s; PSNR %.2f dB "
                  "against the plain versions' int8 forward (bar %.1f), %.2f dB against the "
                  "exact f32 forward; %s per forward; %s" % (
                      name, s8l, conv, psnr, INT8_FWD_PSNR_DB, _psnr(got, exact), spread(tm),
                      breakdown_line(torch, lambda: model.fwd_runtime(x), tm[0], kinds)),
                  flush=True)
            if psnr < INT8_FWD_PSNR_DB:
                raise AssertionError("%s int8 forward disagrees with the plain one" % name)
            del got, ref, exact
        del model
        torch.cuda.empty_cache()
    return totals, times


def branchy_train_phase(torch):
    """Phase 16d. TreeNet --num_branches 2 and REGO-Net x4 at full width
    trained at batch 16 x 48x48, f32, on phase 8's kind of set: one batch's
    loss and gradients against the same Function with the plain dgrad and
    wgrad on the kernels' forward (check_train_grads), a counted step
    (BRANCHY_TRAIN), a step timed (3 windows of 5) with its split; TreeNet
    through train_larva (StepLR, a --val_volume of 2 steps: checkpoints
    model_2 and model_4) and REGO-Net through train for BRANCHY_CLI_STEPS
    steps; then REGO-serial --num_regos 2: one counted step with --qat 1,
    and with --remat 1 --lr_domain_loss 1 the loss and every gradient
    equal --remat 0's bit for bit, its counted step recomputing
    SERIAL_REMAT_EXTRA pairs. Returns the counted steps' launches and
    {model: ms a step}."""
    import numpy as np

    from larvanet_tpu_torch.cli import train, train_larva
    from larvanet_tpu_torch.core.registry import get_loader

    batch, patch = TRAIN_BATCH, TRAIN_PATCH
    steps, times = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        write_train_set(tmp, np.random.default_rng(SEED + 22), TRAIN_FRAMES, TRAIN_LR)
        data_flags = ["--data_input_path", os.path.join(tmp, "LR"),
                      "--data_truth_path", os.path.join(tmp, "HR"), "--data_cached",
                      "--data_seed", str(SEED)]
        loader = get_loader("div2k_train_loader")
        loader.parse_args(data_flags)
        loader.prepare([4])
        loader.reseed_for_step(0)
        lr_nhwc, hr_nhwc = loader.get_patch_batch_nhwc(batch, 4, patch)
        x, t = torch.from_numpy(lr_nhwc).cuda(), torch.from_numpy(hr_nhwc).cuda()
        for name, (flags, want) in BRANCHY_TRAIN.items():
            model = branchy_model(name, extra=flags, is_training=True)
            label = "%s %s x4" % (name, " ".join(flags))
            check_train_grads(torch, model, x, t, label, batch, patch, same_forward=True)
            step = lambda: model.train_step(lr_nhwc, 4, hr_nhwc)  # noqa: E731
            launches = counted_step(torch, step)
            if launches != want:
                raise AssertionError("%s train step launches %s, not %s"
                                     % (label, launches, want))
            steps.append(launches)
            tm = time_windows(torch, {"train_step": step}, windows=3, reps=5)["train_step"]
            train_step_split(torch, model, x, t, step, label, batch, patch, "f32", tm)
            times[name] = tm[0]
            del model
            torch.cuda.empty_cache()
        volume = patch * patch * batch * 3
        cli = ["--dataloader", "div2k_train_loader", "--device", "cuda", "--batch_size",
               str(batch), "--input_patch_size", str(patch), "--max_steps",
               str(BRANCHY_CLI_STEPS), "--log_freq", "1"] + data_flags
        run = os.path.join(tmp, "treenet")
        trained, losses = train_larva.main(cli + [
            "--model", "TreeNet", "--num_branches", "2", "--lr_step", "2",
            "--val_data_input_path", os.path.join(tmp, "LR"), "--val_data_truth_path",
            os.path.join(tmp, "HR"), "--val_volume", str(2 * volume), "--train_path", run])
        files = sorted(os.listdir(run))
        print("train_larva TreeNet --num_branches 2 x4: losses %s, lr %.3g, files %s" % (
            {k: round(v, 4) for k, v in losses.items()}, trained.get_learning_rate(), files),
            flush=True)
        if sorted(losses) != list(range(1, BRANCHY_CLI_STEPS + 1)) or not all(
                "model_%d%s" % (s, ext) in files for s in (2, 4)
                for ext in (".pth", ".state.pt")) or not all(
                np.isfinite(v) for v in losses.values()) or abs(
                trained.get_learning_rate() - 1e-4) > 1e-12:
            raise AssertionError("train_larva TreeNet: losses %s, files %s" % (losses, files))
        del trained
        _, losses = train.main(cli + ["--model", "REGO-Net", "--scales", "4",
                                      "--train_path", os.path.join(tmp, "rego")])
        print("train REGO-Net x4: losses %s" % {k: round(v, 4) for k, v in losses.items()},
              flush=True)
        if sorted(losses) != list(range(1, BRANCHY_CLI_STEPS + 1)) or not all(
                np.isfinite(v) for v in losses.values()):
            raise AssertionError("train REGO-Net: losses %s" % (losses,))
        model = branchy_model("REGO-serial", extra=["--qat", "1"], is_training=True)
        label = "REGO-serial --num_regos 2 --qat 1 x4"
        launches = counted_step(torch, lambda: model.train_step(lr_nhwc, 4, hr_nhwc))
        loss = model.train_step(lr_nhwc, 4, hr_nhwc)
        print("train %s: a step's loss %.4f" % (label, loss), flush=True)
        if launches != SERIAL_STEP or not np.isfinite(loss):
            raise AssertionError("%s: launches %s, loss %s" % (label, launches, loss))
        steps.append(launches)
        del model
        grads = {}
        for remat in ("0", "1"):
            model = branchy_model("REGO-serial", is_training=True,
                                  extra=["--remat", remat, "--lr_domain_loss", "1"])

            def one():
                model.optimizer.zero_grad(set_to_none=True)
                return model._loss_and_grads(x, t)

            grads[remat] = [float(one())] + [p.grad.clone() for p in model.module.parameters()]
            if remat == "1":
                launches = counted_step(torch, one)
                extra = launches["forward"]["tensor_core"] - SERIAL_STEP["forward"][
                    "tensor_core"]
                if extra != SERIAL_REMAT_EXTRA or launches["wgrad"] != SERIAL_STEP["wgrad"]:
                    raise AssertionError("REGO-serial --remat 1: %d recomputed forwards, "
                                         "launches %s" % (extra, launches))
                steps.append(launches)
            del model
            torch.cuda.empty_cache()
        same = grads["0"][0] == grads["1"][0] and all(
            torch.equal(a, b) for a, b in zip(grads["0"][1:], grads["1"][1:]))
        print("train REGO-serial --num_regos 2 --remat 1 --lr_domain_loss 1 x4: loss %.4f, "
              "loss and gradients %s --remat 0's" % (
                  grads["1"][0], "equal, bit for bit," if same else "DIFFER from"), flush=True)
        if not same:
            raise AssertionError("--remat 1 changed REGO-serial's gradients")
    torch.cuda.empty_cache()
    return steps, times


def tree_cli_phase(torch):
    """Phase 16e. validate_tree on TreeNet --num_branches 2 x4 (fitted,
    saved as a .pth) over phase 6's set with --pipeline_depth 1 and 2: the
    per-branch PSNRs equal, each run counted (33 conv3x3 launches a branch's
    forward, both branches on every frame); then state_dict_tree, counted
    (branch 0's forward on every frame, twice). Returns the conv3x3
    launches by path."""
    import numpy as np

    from larvanet_tpu_torch.cli import state_dict_tree, validate_tree
    from larvanet_tpu_torch.ops import conv3x3

    per = {"cuda_core": 1, "tensor_core": 32, "narrow": 0}
    total = {}
    frames = len(VALIDATE_LR) + 1
    with tempfile.TemporaryDirectory() as tmp:
        write_validate_set(tmp)
        rng = np.random.default_rng(SEED + 23)
        pth = os.path.join(tmp, "treenet.pth")
        model = branchy_model("TreeNet", extra=["--num_branches", "2"])
        fit_branchy(torch, model, model._input_to_device([photo(rng, 96, 128)]))
        torch.save(model.module.state_dict(), pth)
        del model
        argv = ["--device", "cuda", "--restore_path", pth, "--num_branches", "2",
                "--data_input_path", os.path.join(tmp, "all", "LR"),
                "--data_truth_path", os.path.join(tmp, "all", "HR")]
        results = {}
        for depth in (1, 2):
            conv3x3.reset_launches()
            results[depth] = validate_tree.main(argv + ["--pipeline_depth", str(depth)])
            torch.cuda.synchronize()
            by_path = dict(conv3x3.LAUNCHES_BY_PATH)
            expect_forwards("validate_tree --pipeline_depth %d" % depth, by_path, per,
                            2 * frames)
            _add(total, by_path)
        print("validate_tree TreeNet --num_branches 2 x4: mean PSNR by branch %s (depth 1), "
              "%s (depth 2)" % tuple({b: round(r["mean_psnr"], 4) for b, r in res.items()}
                                     for res in (results[1], results[2])), flush=True)
        if results[1] != results[2] or not all(np.isfinite(r["mean_psnr"])
                                               for r in results[1].values()):
            raise AssertionError("validate_tree: --pipeline_depth 2 gave %s, 1 gave %s"
                                 % (results[2], results[1]))
        conv3x3.reset_launches()
        state_dict_tree.main(argv)
        torch.cuda.synchronize()
        by_path = dict(conv3x3.LAUNCHES_BY_PATH)
        expect_forwards("state_dict_tree", by_path, per, 2 * frames)
        _add(total, by_path)
    return total


def branchy_phase(torch):
    """Phase 16: 16a-16e, each one's seconds printed. Returns what the
    kernels line takes."""
    t0 = time.perf_counter()
    seconds = {}

    def lap(part):
        seconds[part] = time.perf_counter() - t0 - sum(seconds.values())

    conv_sums, _, conv_worst, _ = kernel_phase(torch, BRANCHY_CONVS,
                                               "REGO-Net x4 (its new shapes)", scaled_bar=True)
    wgrad = train_kernel_phase(torch, BRANCHY_WGRAD, BRANCHY_DGRAD,
                               "REGO-Net x4 (its new shapes)")
    wgrad_bf16 = wgrad_bf16_phase(torch, BRANCHY_WGRAD, "REGO-Net x4 (its new shapes)")
    s8_pair = branchy_s8_phase(torch)
    lap("16a")
    served = {}
    for name, dtype_name in (("TreeNet", "f32"), ("REGO-Net", "f32"), ("REGO-Net", "bf16")):
        _, by_path, model = serve_phase(torch, dtype_name=dtype_name, model_name=name)
        _add(served, by_path)
        del model
    forwards, forward_ms = branchy_forward_phase(torch)
    lap("16b-c")
    steps, step_ms = branchy_train_phase(torch)
    lap("16d")
    cli_conv = tree_cli_phase(torch)
    lap("16e")
    print("phase 16: %.1f s (%s)" % (time.perf_counter() - t0, ", ".join(
        "%s %.1f s" % kv for kv in seconds.items())), flush=True)
    conv = dict(served)
    for part in (forwards["conv3x3"], cli_conv):
        _add(conv, part)
    return dict(conv_sums=conv_sums, conv_worst=conv_worst, wgrad=wgrad, wgrad_bf16=wgrad_bf16,
                s8_pair=s8_pair, conv=conv, s8=forwards["s8"], forward_ms=forward_ms,
                steps=steps, step_ms=step_ms)


# ---- phase 17: the EBRN and HRSR families ---------------------------------------

# 17a: the conv shapes these families bring (X4_CONVS' format), with their
# launches per forward. Full EBRN x4 at one 192x192 LR tile (EBRN_LR: its
# HR flows at 16x the pixels, 64 channels): fe0 3 -> 4F and recon 10F -> 3
# over the concat on the CUDA cores, fe1 4F -> F, and phase 3's 64 -> 64 at
# the LR (fe2, 27 bp_flow) and HR size (30 sr_flow, 9 fusion); then on the
# 4 x 192x192 batch ebrn_rm's upsample 10F -> 48 (ten channel chunks) and
# hrsr's 3-channel HR convs (middle_conv with LeakyReLU(0.1), the 4 HR
# blocks' conv1 with ReLU and conv2) on the CUDA cores
EBRN_LR = (1, 192, 192)
EBRN_CONVS = (
    ("EBRN fe0 3->256", 1, 3, 256, None, 1, "cuda_core"),
    ("EBRN fe1 256->64", 1, 256, 64, None, 1, "tensor_core"),
    ("EBRN LR 64->64 (fe2, bp_flow)", 1, 64, 64, None, 28, "tensor_core"),
    ("EBRN HR 64->64 (sr_flow, fusion)", 4, 64, 64, None, 39, "tensor_core"),
    ("EBRN recon 640->3", 4, 640, 3, None, 1, "cuda_core"),
)
EBRN_RM_CONVS = (("ebrn_rm upsample 640->48", 1, 640, 48, None, 1, "tensor_core"),)
HRSR_CONVS = (
    ("hrsr middle_conv 3->3 leaky", 4, 3, 3, "leaky_relu", 1, "cuda_core"),
    ("hrsr HR block conv1 3->3 relu", 4, 3, 3, "relu", 4, "cuda_core"),
    ("hrsr HR block conv2 3->3", 4, 3, 3, None, 4, "cuda_core"),
)
# their weight and input gradients at a train step's batch 16 x 48x48 (TRAIN_WGRAD's
# and TRAIN_DGRAD's formats): EBRN's recon 640 -> 3 on the narrow wgrad entry and
# its input gradient 3 -> 640 at the HR size, fe0's 3 -> 256 (no input gradient);
# ebrn_rm's upsample input gradient 48 -> 640
EBRN_WGRAD = (("EBRN recon 640->3", 4, 640, 3, 1), ("EBRN fe0 3->256", 1, 3, 256, 1))
EBRN_DGRAD = (("EBRN recon 3->640", 4, 3, 640), ("ebrn_rm upsample 48->640", 1, 48, 640))
# 17b: name -> (flags, parameters, conv3x3 launches a x4 forward by path): ebrn_rm's
# first_conv on the CUDA cores, its 10 BRM pairs, 9 fusion convs and upsample on the
# tensor cores; full EBRN 70 (above) and 10 up- and 9 down-projections on the library;
# hrsr's first_conv, middle_conv and 8 HR convs on the CUDA cores, its 4 LR blocks on
# the tensor cores; hrsr_c3's first_conv and 32 LR blocks
SR_MODELS = {
    "ebrn_rm": ([], 1349232, {"cuda_core": 1, "tensor_core": 30, "narrow": 0}),
    "ebrn": ([], 8005315, {"cuda_core": 2, "tensor_core": 68, "narrow": 0}),
    "hrsr": ([], 168372, {"cuda_core": 10, "tensor_core": 8, "narrow": 0}),
    "hrsr_c3": ([], 1331520, {"cuda_core": 1, "tensor_core": 64, "narrow": 0}),
}
# the residual std fit_sr_residual gives a random model over its base
SR_RESIDUAL_STD = 30.0
# 17c: the --int8_trunk forward's launches: s8 by entry (a pair each BRM or LR
# block) and the conv3x3 launches that stay exact
SR_INT8 = {"ebrn_rm": ({"conv_a": 10, "conv_b": 10},
                       {"cuda_core": 1, "tensor_core": 10, "narrow": 0}),
           "hrsr": ({"conv_a": 4, "conv_b": 4}, {"cuda_core": 10, "tensor_core": 0, "narrow": 0}),
           "hrsr_c3": ({"conv_a": 32, "conv_b": 32},
                       {"cuda_core": 1, "tensor_core": 0, "narrow": 0})}
# 17d: name -> (flags, launches of one step at batch 16 x 48x48): ebrn_rm on its
# LR-domain route (31 forward; 30 dgrads, none for first_conv; 31 wgrads, first_conv's
# 3 -> 64 on the CUDA cores), full EBRN (70; 69, recon's 3 -> 640 on the CUDA cores;
# 70, recon's 640 -> 3 narrow), hrsr_c3 --qat 1 (65; 64; 65)
SR_TRAIN = {
    "ebrn_rm": ([], {"forward": {"cuda_core": 1, "tensor_core": 30, "narrow": 0},
                     "dgrad": {"cuda_core": 0, "tensor_core": 30, "narrow": 0},
                     "wgrad": {"tensor_core": 30, "narrow": 0, "cuda_core": 1}}),
    "ebrn": ([], {"forward": {"cuda_core": 2, "tensor_core": 68, "narrow": 0},
                  "dgrad": {"cuda_core": 1, "tensor_core": 68, "narrow": 0},
                  "wgrad": {"tensor_core": 68, "narrow": 1, "cuda_core": 1}}),
    "hrsr_c3": (["--qat", "1"], {"forward": {"cuda_core": 1, "tensor_core": 64, "narrow": 0},
                                 "dgrad": {"cuda_core": 0, "tensor_core": 64, "narrow": 0},
                                 "wgrad": {"tensor_core": 64, "narrow": 0, "cuda_core": 1}}),
}
SR_CLI_STEPS = 4
# 17d's train set (DIV2K layout, photo frames): its frames and LR size; the loaders
# decode their PNGs in Python (data/png.py), host work that grows with the pixels
SR_TRAIN_FRAMES = 4
SR_TRAIN_LR = (64, 96)
# hrsr through train_schedule on a val set of SCHEDULE_VAL frames of SCHEDULE_VAL_LR:
# an epoch of one step, validation every 2, --threshold 100 (only the first
# validation improves), so the plateau halves the lr at the third; the resumed run
# starts from the first validation's checkpoint
SCHEDULE_STEPS = 6
SCHEDULE_LRS = [1e-3, 1e-3, 5e-4]
SCHEDULE_RESUME = 2
SCHEDULE_VAL = 2
SCHEDULE_VAL_LR = (48, 64)


def sr_model(name, device="cuda", extra=(), is_training=False):
    """An SR_MODELS model x4 at full width, random weights from SEED."""
    from larvanet_tpu_torch.core.registry import get_model

    flags, n_params, _ = SR_MODELS[name]
    model = get_model(name)
    model.parse_args(list(flags) + list(extra))
    model.prepare([4], device=device, seed=SEED, is_training=is_training)
    if not extra and model.num_parameters() != n_params:
        raise AssertionError("%s x4 has %d parameters, not %d"
                             % (name, model.num_parameters(), n_params))
    return model


def fit_sr_residual(torch, model, x):
    """Scale a random EBRN-, HRSR-family, MAMNet or IMDN model so that its
    residual over its base (`sr_base`) on `x` (NHWC on the card) has a std
    of SR_RESIDUAL_STD.
    HRSR's residual, at its init (zero biases, ReLU and LeakyReLU), is
    positively homogeneous in first_conv's weight, scaled alone; EBRN's,
    ebrn_rm's, MAMNet's and IMDN's is linear in the last conv's weight and
    bias (recon_layer, MAMNet's final_conv, upsample.body.0), both scaled,
    and where the base is the inverse mean shift the last bias moves the
    output's mean to mid-grey, so that the served frames span the pixel
    range."""
    from larvanet_tpu_torch.models.mamnet import MAMNetModule

    module = model.module
    with torch.no_grad():
        res = module(x) - sr_base(torch, module, x)
        a = SR_RESIDUAL_STD / float(res.std())
        if hasattr(module, "lr_res_blocks"):
            module.first_conv.weight.mul_(a)
            return
        last = (module.recon_layer if hasattr(module, "recon_layer") else module.final_conv
                if isinstance(module, MAMNetModule) else module.upsample.body[0])
        last.weight.mul_(a)
        last.bias.mul_(a)
        if not getattr(module, "bilinear_base", False):
            shift = 128.0 - a * res.reshape(-1, 3).mean(0) - module.mean_inverse_shift.bias
            last.bias.add_(shift.repeat_interleave(last.bias.numel() // 3))


def save_sr_model(torch, path, name, fit_frame, device="cuda"):
    """An SR_MODELS model, fitted on the CHW frame `fit_frame`
    (fit_sr_residual), saved as the port module's own state_dict."""
    model = sr_model(name, device)
    fit_sr_residual(torch, model, model._input_to_device([fit_frame]))
    torch.save(model.module.state_dict(), path)


def projection_ms(torch, model, x):
    """The card's time of a full-EBRN forward's up- and down-projections (the
    library convs: F.conv_transpose2d, F.conv2d) on `x`: their calls of one
    forward, with the inputs they took, replayed under the profiler
    (device_breakdown). None where the profiler records no kernel."""
    from larvanet_tpu_torch.models.layers import DownProjection, UpProjection

    calls = []
    hooks = [m.register_forward_hook(lambda mod, inp, out: calls.append((mod, inp[0])))
             for m in model.serving_module.modules()
             if isinstance(m, (UpProjection, DownProjection))]
    try:
        model.fwd_runtime(x)
    finally:
        for hook in hooks:
            hook.remove()

    def replay():
        with torch.no_grad():
            for mod, inp in calls:
                mod(inp)

    _, parts = device_breakdown(torch, replay, kinds=())
    return None if parts is None else parts["other"]


def sr_forward_phase(torch):
    """Phase 17b's forwards and 17c. Each SR_MODELS model x4 at full width,
    fitted (fit_sr_residual), on the 4 x 192x192 batch (full EBRN: EBRN_LR)
    in f32 and bf16 (full EBRN serves its f32 module, as JAX does): one
    counted forward (SR_MODELS' launches), held against the same forward
    with every kernel's plain version within FWD_RTOL (bf16: BF16_FWD_RTOL)
    of the residual over the base, then timed with its device split
    (conv3x3, s8, other, idle; full EBRN's projections replayed apart,
    `projection_ms`). 17c: the --int8_trunk route of ebrn_rm, hrsr and
    hrsr_c3 (the CLIs' maybe_int8_trunk, calibrated on the batch's 96 x 96
    corner): counted (SR_INT8), held against the same route on the plain
    versions (INT8_FWD_PSNR_DB), timed. Returns the counted launches
    ({"conv3x3": by path, "s8": by entry}) and {model: {dtype: ms}}."""
    from types import SimpleNamespace

    from larvanet_tpu_torch.cli import common

    totals, times = {"conv3x3": {}, "s8": {}}, {}
    kinds = ("s8", "conv3x3")
    for name, (_, _, per_conv) in SR_MODELS.items():
        n, h, w = EBRN_LR if name == "ebrn" else LR_BATCH
        gen = torch.Generator(device="cuda").manual_seed(SEED + 25)
        x = 255.0 * torch.rand((n, h, w, 3), generator=gen, device="cuda")
        model = sr_model(name)
        fit_sr_residual(torch, model, x[:1])
        times[name] = {}
        for dname in ("f32",) if name == "ebrn" else ("f32", "bf16"):
            model.set_serving_dtype(dname)
            got, conv, _, _ = _counted_msrr(torch, lambda: model.fwd_runtime(x))
            if conv != per_conv:
                raise AssertionError("%s %s forward: conv3x3 %s, not %s"
                                     % (name, dname, conv, per_conv))
            _add(totals["conv3x3"], conv)
            with plain_versions():
                ref = model.fwd_runtime(x)
            base = sr_base(torch, model.module, x.to(model.compute_dtype)).float()
            residual = float((ref - base).abs().max())
            err = float((got - ref).abs().max())
            bar = (FWD_RTOL if dname == "f32" else BF16_FWD_RTOL) * residual
            windows = 3 if name == "ebrn" else WINDOWS
            tm = time_windows(torch, {"forward": lambda: model.fwd_runtime(x)},
                              windows=windows)["forward"]
            times[name][dname] = tm[0]
            split = breakdown_line(torch, lambda: model.fwd_runtime(x), tm[0], kinds)
            if name == "ebrn":
                proj = projection_ms(torch, model, x)
                split += ("; the up- and down-projections (library convs, among the other "
                          "kernels) %s" % ("not measured" if proj is None else
                                           "%.4f ms (%.1f%%)" % (proj, 100.0 * proj / tm[0])))
            print("sr forward %s x4 %s %s: conv3x3 %s; max |d| %.3g against the plain versions "
                  "(bar %.3g, residual max |y| %.3g); %s per forward, %.3f LR-MP/s; %s" % (
                      name, dname, (n, h, w), conv, err, bar, residual, spread(tm),
                      n * h * w / 1e3 / tm[0], split), flush=True)
            if err > bar or not bool(torch.isfinite(got).all()) or residual < 1.0:
                raise AssertionError("%s %s forward disagrees with the plain versions"
                                     % (name, dname))
            del got, ref, base
        model.set_serving_dtype("f32")
        if name in SR_INT8:
            want_s8, want_conv = SR_INT8[name]
            common.maybe_int8_trunk(model, SimpleNamespace(int8_trunk=1, model=name),
                                    lambda: x[:, :96, :96].cpu().numpy())
            got, conv, _, s8l = _counted_msrr(torch, lambda: model.fwd_runtime(x))
            if s8l != want_s8 or conv != want_conv:
                raise AssertionError("%s int8 forward: s8 %s, conv3x3 %s" % (name, s8l, conv))
            _add(totals["s8"], s8l)
            _add(totals["conv3x3"], conv)
            with plain_versions(), _plain_s8():
                ref = model.fwd_runtime(x)
            psnr = _psnr(got, ref)
            exact = model.int8_exact_forward(x).float()
            tm = time_windows(torch, {"forward": lambda: model.fwd_runtime(x)})["forward"]
            times[name]["int8"] = tm[0]
            print("sr forward %s x4 --int8_trunk (bf16): s8 %s, conv3x3 %s; PSNR %.2f dB "
                  "against the plain versions' int8 forward (bar %.1f), %.2f dB against the "
                  "exact f32 forward; %s per forward; %s" % (
                      name, s8l, conv, psnr, INT8_FWD_PSNR_DB, _psnr(got, exact), spread(tm),
                      breakdown_line(torch, lambda: model.fwd_runtime(x), tm[0], kinds)),
                  flush=True)
            if psnr < INT8_FWD_PSNR_DB:
                raise AssertionError("%s int8 forward disagrees with the plain one" % name)
            del got, ref, exact
        del model, x
        torch.cuda.empty_cache()
    return totals, times


def sr_train_phase(torch):
    """Phase 17d. ebrn_rm (its LR-domain route), full EBRN and hrsr_c3 --qat 1
    x4 at full width trained at batch 16 x 48x48, f32, on a set of phase 8's
    kind (SR_TRAIN_FRAMES frames of SR_TRAIN_LR): one batch's loss and
    gradients against the same Function with the plain dgrad and wgrad on
    the kernels' forward (check_train_grads), a counted step (SR_TRAIN), a
    step timed (3 windows of 5) with its split; ebrn_rm through train for
    SR_CLI_STEPS steps; hrsr through train_schedule with an epoch of one
    step and validation every 2 on SCHEDULE_VAL frames (validations and
    plateau steps at 2, 4 and 6, the lr halved at 6), then resumed from its
    step-2 checkpoint: the same validations and the same weights, bit for
    bit. Returns the counted steps' launches and {model: ms a step}."""
    import numpy as np

    from larvanet_tpu_torch.cli import train, train_schedule
    from larvanet_tpu_torch.core.registry import get_loader

    batch, patch = TRAIN_BATCH, TRAIN_PATCH
    steps, times = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(SEED + 26)
        write_train_set(tmp, rng, SR_TRAIN_FRAMES, SR_TRAIN_LR)
        data_flags = ["--data_input_path", os.path.join(tmp, "LR"),
                      "--data_truth_path", os.path.join(tmp, "HR"), "--data_cached",
                      "--data_seed", str(SEED)]
        loader = get_loader("div2k_train_loader")
        loader.parse_args(data_flags)
        loader.prepare([4])
        loader.reseed_for_step(0)
        lr_nhwc, hr_nhwc = loader.get_patch_batch_nhwc(batch, 4, patch)
        x, t = torch.from_numpy(lr_nhwc).cuda(), torch.from_numpy(hr_nhwc).cuda()
        for name, (flags, want) in SR_TRAIN.items():
            t0 = time.perf_counter()
            model = sr_model(name, extra=flags, is_training=True)
            label = "%s %s x4" % (name, " ".join(flags))
            check_train_grads(torch, model, x, t, label, batch, patch, same_forward=True)
            t1 = time.perf_counter()
            step = lambda: model.train_step(lr_nhwc, 4, hr_nhwc)  # noqa: E731
            launches = counted_step(torch, step)
            if launches != want:
                raise AssertionError("%s train step launches %s, not %s"
                                     % (label, launches, want))
            steps.append(launches)
            tm = time_windows(torch, {"train_step": step}, windows=3, reps=5)["train_step"]
            t2 = time.perf_counter()
            train_step_split(torch, model, x, t, step, label, batch, patch, "f32", tm)
            times[name] = tm[0]
            print("17d %s: %.1f s checking the gradients, %.1f s counting and timing, %.1f s "
                  "profiling" % (label, t1 - t0, t2 - t1, time.perf_counter() - t2),
                  flush=True)
            del model
            torch.cuda.empty_cache()
        cli = ["--dataloader", "div2k_train_loader", "--device", "cuda", "--batch_size",
               str(batch), "--input_patch_size", str(patch), "--log_freq", "1"] + data_flags
        t0 = time.perf_counter()
        _, losses = train.main(cli + ["--model", "ebrn_rm", "--scales", "4", "--max_steps",
                                      str(SR_CLI_STEPS), "--train_path",
                                      os.path.join(tmp, "ebrn_rm")])
        print("train ebrn_rm x4 (LR-domain loss): losses %s (%.1f s)"
              % ({k: round(v, 4) for k, v in losses.items()}, time.perf_counter() - t0),
              flush=True)
        if sorted(losses) != list(range(1, SR_CLI_STEPS + 1)) or not all(
                np.isfinite(v) for v in losses.values()):
            raise AssertionError("train ebrn_rm: losses %s" % (losses,))
        write_train_set(os.path.join(tmp, "val"), rng, SCHEDULE_VAL, SCHEDULE_VAL_LR)
        schedule = cli + [
            "--model", "hrsr", "--val_data_input_path", os.path.join(tmp, "val", "LR"),
            "--val_data_truth_path", os.path.join(tmp, "val", "HR"),
            "--step_per_epoch", "1", "--val_freq_epochs", "2", "--max_steps",
            str(SCHEDULE_STEPS), "--threshold", "100"]
        run = os.path.join(tmp, "hrsr")
        t0 = time.perf_counter()
        model, losses, vals = train_schedule.main(schedule + ["--train_path", run])
        print("train_schedule hrsr x4: validations (step, PSNR, lr after the plateau step) "
              "%s; losses %s (%.1f s)" % (vals, {k: round(v, 4) for k, v in losses.items()},
                                          time.perf_counter() - t0), flush=True)
        if [(s, lr) for s, _, lr in vals] != list(zip(range(2, SCHEDULE_STEPS + 1, 2),
                                                      SCHEDULE_LRS)) or not all(
                np.isfinite(v) for v in losses.values()):
            raise AssertionError("train_schedule hrsr: validations %s" % (vals,))
        resumed, _, rest = train_schedule.main(schedule + [
            "--train_path", os.path.join(tmp, "resumed"), "--restore_path",
            os.path.join(run, "model_%d.pth" % SCHEDULE_RESUME)])
        same = rest == vals[SCHEDULE_RESUME // 2:] and all(
            torch.equal(a, b) for a, b in zip(model.module.state_dict().values(),
                                              resumed.module.state_dict().values()))
        print("train_schedule hrsr x4 resumed at step %d: validations %s, weights and "
              "validations %s the uninterrupted run's" % (
                  SCHEDULE_RESUME, rest, "equal, bit for bit, to" if same else "DIFFER from"),
              flush=True)
        if not same or resumed.lr_scheduler != model.lr_scheduler:
            raise AssertionError("train_schedule hrsr: the resume differs")
        del model, resumed
    torch.cuda.empty_cache()
    return steps, times


def sr_cli_phase(torch):
    """Phase 17e. The inference CLIs on the fitted models, saved as .pth,
    each run counted: validate on hrsr over phase 6's set (18 conv3x3
    launches a frame), get_sr on ebrn_rm over its LR frames (31), test on
    hrsr_c3 over a SynSetReal tree (65), runtime on full EBRN at the DIV2K
    x4 LR size, 339x510 (70 a forward). Returns the conv3x3 launches by
    path."""
    import numpy as np

    from larvanet_tpu_torch.cli import get_sr, runtime, test, validate

    total = {}
    frames = len(VALIDATE_LR) + 1
    rng = np.random.default_rng(SEED + 27)
    with tempfile.TemporaryDirectory() as tmp:
        write_validate_set(tmp)
        write_test_set(tmp, rng)
        pths = {}
        for name in ("hrsr", "ebrn_rm", "hrsr_c3", "ebrn"):
            pths[name] = os.path.join(tmp, name + ".pth")
            save_sr_model(torch, pths[name], name, photo(rng, 96, 128))
        lr_dir = os.path.join(tmp, "all", "LR")
        runs = [
            ("validate hrsr", frames, "hrsr", lambda: validate.main([
                "--model", "hrsr", "--device", "cuda", "--restore_path", pths["hrsr"],
                "--data_input_path", lr_dir,
                "--data_truth_path", os.path.join(tmp, "all", "HR")])),
            ("get_sr ebrn_rm", frames, "ebrn_rm", lambda: get_sr.main([
                "--model", "ebrn_rm", "--device", "cuda", "--restore_path", pths["ebrn_rm"],
                "--input_path", os.path.join(lr_dir, "X4"),
                "--output_path", os.path.join(tmp, "sr")])),
            ("test hrsr_c3", len(TEST_FRAMES), "hrsr_c3", lambda: test.main([
                "--model", "hrsr_c3", "--device", "cuda", "--restore_path", pths["hrsr_c3"],
                "--input_root_path", os.path.join(tmp, "test_LR"), "--truth_root_path",
                os.path.join(tmp, "test_HR"), "--output_root_path", os.path.join(tmp, "out"),
                "--datasets", "SynSetReal"])),
            ("runtime ebrn", None, "ebrn", lambda: runtime.main([
                "--model", "ebrn", "--device", "cuda", "--restore_path", pths["ebrn"],
                "--input_height", str(RAGGED[1]), "--input_width", str(RAGGED[2]),
                "--num_warmup", "1", "--num_iters", "3"])),
        ]
        for label, forwards, name, run in runs:
            result, conv, _, _ = _counted_msrr(torch, run)
            per = SR_MODELS[name][2]
            if forwards is None:  # runtime: its warmup and timed forwards
                forwards = sum(conv.values()) // sum(per.values())
            print("%s x4: %s" % (label, result), flush=True)
            expect_forwards(label, conv, per, forwards)
            _add(total, conv)
        if len(os.listdir(os.path.join(tmp, "sr"))) != frames:
            raise AssertionError("get_sr ebrn_rm wrote %s" % os.listdir(os.path.join(tmp, "sr")))
    return total


def sr_phase(torch):
    """Phase 17: 17a-17e, each one's seconds printed. Returns what the
    kernels line takes."""
    t0 = time.perf_counter()
    seconds = {}

    def lap(part):
        seconds[part] = time.perf_counter() - t0 - sum(seconds.values())

    conv_sums, conv_worst = {}, {"f32": 0.0, "bf16": 0.0}
    for key, convs, label, geometries in (
            ("ebrn", EBRN_CONVS, "EBRN x4 (its new shapes)", (EBRN_LR,)),
            ("ebrn_rm", EBRN_RM_CONVS, "ebrn_rm x4 (its new shape)", (LR_BATCH,)),
            ("hrsr", HRSR_CONVS, "hrsr x4 (its new shapes)", (LR_BATCH,))):
        sums, _, worst, _ = kernel_phase(torch, convs, label, scaled_bar=True,
                                         geometries=geometries)
        conv_sums[key] = sums
        for dname in conv_worst:
            conv_worst[dname] = max(conv_worst[dname], worst[dname])
    wgrad = train_kernel_phase(torch, EBRN_WGRAD, EBRN_DGRAD, "EBRN x4 (its new shapes)")
    s8_pair = branchy_s8_phase(torch, slope=0.05, pairs=SR_INT8["ebrn_rm"][0]["conv_a"],
                               res_weights=(1.0,), label="ebrn_rm BRM")
    lap("17a")
    served = {}
    for name, dtype_name in (("ebrn_rm", "f32"), ("ebrn_rm", "bf16"), ("ebrn", "f32"),
                             ("hrsr", "f32"), ("hrsr_c3", "f32")):
        _, by_path, model = serve_phase(torch, dtype_name=dtype_name, model_name=name)
        _add(served, by_path)
        del model
    forwards, forward_ms = sr_forward_phase(torch)
    lap("17b-c")
    steps, step_ms = sr_train_phase(torch)
    lap("17d")
    cli_conv = sr_cli_phase(torch)
    lap("17e")
    print("phase 17: %.1f s (%s)" % (time.perf_counter() - t0, ", ".join(
        "%s %.1f s" % kv for kv in seconds.items())), flush=True)
    conv = dict(served)
    for part in (forwards["conv3x3"], cli_conv):
        _add(conv, part)
    return dict(conv_sums=conv_sums, conv_worst=conv_worst, wgrad=wgrad, s8_pair=s8_pair,
                conv=conv, s8=forwards["s8"], forward_ms=forward_ms, steps=steps,
                step_ms=step_ms)


# ---- phase 18: MAMNet and IMDN ----------------------------------------------------

# 18a: IMDN's new conv shapes (X4_CONVS' format) at its leaky_relu slope, with
# their launches per x4 forward: conv2 and conv3 48 -> 64 (two a block, 8
# blocks), conv4 48 -> 16, the upsample conv 64 -> 3 s^2 (48 at x4; 27 at x3, on
# the CUDA cores, no x4 launch)
IMDN_CONVS = (
    ("IMDN conv2/conv3 48->64 leaky", 1, 48, 64, "leaky_relu", 16, "tensor_core"),
    ("IMDN conv4 48->16 leaky", 1, 48, 16, "leaky_relu", 8, "tensor_core"),
    ("IMDN upsample 64->48", 1, 64, 48, None, 1, "tensor_core"),
    ("IMDN upsample x3 64->27", 1, 64, 27, None, 0, "cuda_core"),
)
IMDN_SLOPE = 0.05
# IMDN's new weight-gradient shapes at batch 16 x 48x48 (TRAIN_WGRAD's format)
# and the input gradient no forward has (conv4's, 16 -> 48; TRAIN_DGRAD's)
IMDN_WGRAD = (("IMDN conv4 48->16", 1, 48, 16, 8), ("IMDN conv2/3 48->64", 1, 48, 64, 16))
IMDN_DGRAD = (("IMDN conv4 16->48", 1, 16, 48),)
# 18b: name -> (parameters, conv3x3 launches a x4 forward by path on the CLIs'
# default route, conv_kxk launches, dwconv3x3 launches): MAMNet on the collapsed
# tail (first_conv on the CUDA cores, its 32 block convs and after_res_conv on the
# tensor cores, the tail's 4 conv_kxk launches, 16 CSD launches); IMDN's module
# (first_conv; 32 block convs, after_res_conv, the upsample conv)
MI_MODELS = {
    "mamnet": (1537091, {"cuda_core": 1, "tensor_core": 33, "narrow": 0}, KXK_LAUNCHES, 16),
    "imdn_aim2019": (893936, {"cuda_core": 1, "tensor_core": 34, "narrow": 0}, NO_KXK, 0),
}
# MAMNet under --packed_trunk 0: the module's own tail, EDSR's 37 convs
MAMNET_MODULE = {"cuda_core": 1, "tensor_core": 35, "narrow": 1}
# MAMNet's --int8_trunk forward: a pair each MAMBlock, first_conv and
# after_res_conv exact, the baked tail, the 16 CSDs
MAMNET_INT8 = ({"conv_a": 16, "conv_b": 16}, {"cuda_core": 1, "tensor_core": 1, "narrow": 0})
# IMDN's rem1 / rem2 / rem3 copies a forward: three a block
IMDN_COPIES = 24
# 18c: one train step at batch 16 x 48x48: MAMNet on its default route (the live
# collapsed tail, the loss before the shuffle: EDSR's collapsed step, phase 14c,
# and the CSDs' depthwise forward, input and weight gradients); IMDN's module
# (35 forward; 34 dgrads, none for first_conv; 35 wgrads, first_conv's on the
# CUDA cores)
MI_TRAIN = {
    "mamnet": dict(TRAIN_COLLAPSED_LAUNCHES, dw={"forward": 16, "dgrad": 16, "wgrad": 16},
                   kxk=TRAIN_COLLAPSED_KXK),
    "imdn_aim2019": {"forward": {"cuda_core": 1, "tensor_core": 34, "narrow": 0},
                     "dgrad": {"cuda_core": 0, "tensor_core": 34, "narrow": 0},
                     "wgrad": {"tensor_core": 34, "narrow": 0, "cuda_core": 1},
                     "dw": {"forward": 0, "dgrad": 0, "wgrad": 0},
                     "kxk": {"forward": {"cuda_core": 0, "tensor_core": 0},
                             "dgrad": {"cuda_core": 0, "tensor_core": 0}, "wgrad": 0}},
}
# the device split's kernel kinds: the s8 kernel's name holds "conv3x3"
MI_KINDS = ("s8", "dw_", "conv_kxk", "conv3x3")


def mi_model(name, device="cuda", is_training=False):
    """An MI_MODELS model x4 at full width, random weights from SEED."""
    from larvanet_tpu_torch.core.registry import get_model

    model = get_model(name)
    model.parse_args([])
    model.prepare([4], device=device, seed=SEED, is_training=is_training)
    if model.num_parameters() != MI_MODELS[name][0]:
        raise AssertionError("%s x4 has %d parameters, not %d"
                             % (name, model.num_parameters(), MI_MODELS[name][0]))
    return model


def save_mi_model(torch, path, name, fit_frame, device="cuda", seed=SEED):
    """An MI_MODELS model, fitted on the CHW frame `fit_frame`
    (fit_sr_residual), saved as the port module's own state_dict."""
    model = mi_model(name, device)
    if seed != SEED:
        model.prepare([4], device=device, seed=seed)
    fit_sr_residual(torch, model, model._input_to_device([fit_frame]))
    torch.save(model.module.state_dict(), path)


def _counted_mi(torch, fn):
    """fn() counted as _counted_msrr counts it, with conv_kxk's launches by
    path and IMDN's slice copies: (result, conv3x3 by path, dwconv3x3 by
    entry, s8 by entry, conv_kxk by path, copies)."""
    from larvanet_tpu_torch.models import imdn
    from larvanet_tpu_torch.ops import conv_kxk as ck

    ck.reset_launches()
    imdn.reset_slice_copies()
    out, conv, dw, s8l = _counted_msrr(torch, fn)
    return out, conv, dw, s8l, kxk_launches(ck), imdn.SLICE_COPIES


def mi_forward_phase(torch):
    """Phase 18b's forwards and 18c's int8. Each MI_MODELS model x4 at full
    width, fitted (fit_sr_residual), on the 4 x 192x192 batch in f32 and
    bf16 on the CLIs' default route (maybe_collapse_tail: MAMNet's collapsed
    tail): one counted forward (MI_MODELS' launches; IMDN's slice copies),
    held against the same forward with every kernel's plain version within
    FWD_RTOL (bf16: BF16_FWD_RTOL) of the residual over the base, timed with
    its device split. MAMNet also: its module graph (--packed_trunk 0),
    counted and held; its --int8_trunk route (calibrated on the batch's 96 x
    96 corner), counted (MAMNET_INT8), held against the plain versions'
    int8 forward (INT8_FWD_PSNR_DB), timed. IMDN: one block's three slice
    copies timed at the batch's size. Returns the counted launches
    ({"conv3x3", "s8", "dw"}) and {model: {route: ms}}."""
    from types import SimpleNamespace

    from larvanet_tpu_torch.cli import common

    totals, times = {"conv3x3": {}, "s8": {}, "dw": {}}, {}
    n, h, w = LR_BATCH
    gen = torch.Generator(device="cuda").manual_seed(SEED + 28)
    x = 255.0 * torch.rand((n, h, w, 3), generator=gen, device="cuda")

    def run(label, model, per_conv, per_kxk, per_dw, copies, dname):
        got, conv, dwl, _, kxk, made = _counted_mi(torch, lambda: model.fwd_runtime(x))
        if conv != per_conv or dwl["forward"] != per_dw or made != copies:
            raise AssertionError("%s: conv3x3 %s, dwconv3x3 %s, copies %d" % (
                label, conv, dwl, made))
        expect_kxk(label, kxk, per_kxk, 1)
        _add(totals["conv3x3"], conv)
        _add(totals["dw"], dwl)
        with plain_versions():
            ref = model.fwd_runtime(x)
        base = sr_base(torch, model.module, x.to(model.compute_dtype)).float()
        residual = float((ref - base).abs().max())
        err = float((got - ref).abs().max())
        bar = (FWD_RTOL if dname == "f32" else BF16_FWD_RTOL) * residual
        if err > bar or not bool(torch.isfinite(got).all()) or residual < 1.0:
            raise AssertionError("%s forward disagrees with the plain versions" % label)
        return conv, dwl, kxk, err, bar, residual

    for name, (_, per_conv, per_kxk, per_dw) in MI_MODELS.items():
        model = mi_model(name)
        fit_sr_residual(torch, model, x[:1])
        common.maybe_collapse_tail(model, SimpleNamespace(model=name, collapsed_tail=1))
        copies = IMDN_COPIES if name == "imdn_aim2019" else 0
        times[name] = {}
        for dname in ("f32", "bf16"):
            model.set_serving_dtype(dname)
            label = "%s x4 %s" % (name, dname)
            conv, dwl, kxk, err, bar, residual = run(label, model, per_conv, per_kxk, per_dw,
                                                     copies, dname)
            tm = time_windows(torch, {"forward": lambda: model.fwd_runtime(x)})["forward"]
            times[name][dname] = tm[0]
            print("mi forward %s %s: conv3x3 %s, conv_kxk %s, dwconv3x3 %s, slice copies %d; "
                  "max |d| %.3g against the plain versions (bar %.3g, residual max |y| %.3g); "
                  "%s per forward, %.3f LR-MP/s; %s" % (
                      label, (n, h, w), conv, kxk, dwl, copies, err, bar, residual,
                      spread(tm), n * h * w / 1e3 / tm[0],
                      breakdown_line(torch, lambda: model.fwd_runtime(x), tm[0], MI_KINDS)),
                  flush=True)
        model.set_serving_dtype("f32")
        if name == "mamnet":
            route = model.route
            model.set_route(None)  # --packed_trunk 0: the module graph
            conv, _, kxk, err, bar, _ = run("mamnet x4 --packed_trunk 0", model,
                                            MAMNET_MODULE, NO_KXK, per_dw, 0, "f32")
            print("mi forward mamnet x4 --packed_trunk 0 (the module graph): conv3x3 %s, "
                  "conv_kxk %s; max |d| %.3g against the plain versions (bar %.3g)"
                  % (conv, kxk, err, bar), flush=True)
            model.set_route(route)
            want_s8, want_conv = MAMNET_INT8
            common.maybe_int8_trunk(model, SimpleNamespace(int8_trunk=1, model=name),
                                    lambda: x[:, :96, :96].cpu().numpy())
            got, conv, dwl, s8l, kxk, _ = _counted_mi(torch, lambda: model.fwd_runtime(x))
            if s8l != want_s8 or conv != want_conv or dwl["forward"] != per_dw:
                raise AssertionError("mamnet int8 forward: s8 %s, conv3x3 %s, dwconv3x3 %s"
                                     % (s8l, conv, dwl))
            expect_kxk("mamnet x4 --int8_trunk", kxk, KXK_LAUNCHES, 1)
            for key, part in (("s8", s8l), ("conv3x3", conv), ("dw", dwl)):
                _add(totals[key], part)
            with plain_versions(), _plain_s8():
                ref = model.fwd_runtime(x)
            psnr = _psnr(got, ref)
            exact = model.int8_exact_forward(x).float()
            tm = time_windows(torch, {"forward": lambda: model.fwd_runtime(x)})["forward"]
            times[name]["int8"] = tm[0]
            print("mi forward mamnet x4 --int8_trunk (bf16): s8 %s, conv3x3 %s, conv_kxk %s, "
                  "dwconv3x3 %s; PSNR %.2f dB against the plain versions' int8 forward (bar "
                  "%.1f), %.2f dB against the exact f32 forward; %s per forward; %s" % (
                      s8l, conv, kxk, dwl, psnr, INT8_FWD_PSNR_DB, _psnr(got, exact),
                      spread(tm), breakdown_line(torch, lambda: model.fwd_runtime(x), tm[0],
                                                 MI_KINDS)), flush=True)
            if psnr < INT8_FWD_PSNR_DB:
                raise AssertionError("mamnet int8 forward disagrees with the plain one")
            del got, ref, exact
        else:
            t = torch.randn((n, h, w, 64), device="cuda")
            tm = time_windows(torch, {"copy": lambda: t[..., 16:].contiguous()})["copy"]
            bound = 1e3 * 2 * 4 * n * h * w * 48 / PEAK_BYTES
            times[name]["slice_copy"] = tm[0]
            print("mi imdn slice copy (rem, 48 of 64 channels) at %s f32: %s, bound %.4f ms "
                  "(bytes); %d a forward: %.4f ms, %.1f%% of the f32 forward"
                  % ((n, h, w), spread(tm), bound, IMDN_COPIES, IMDN_COPIES * tm[0],
                     100.0 * IMDN_COPIES * tm[0] / times[name]["f32"]), flush=True)
            del t
        del model
        torch.cuda.empty_cache()
    return totals, times


def mi_train_phase(torch):
    """Phase 18c's steps. MAMNet (its default route: the live collapsed tail,
    the loss before the shuffle) and IMDN x4 at full width trained at batch
    16 x 48x48, f32, on a set of phase 8's kind: one batch's loss and
    gradients against the same Functions with the plain dgrad and wgrad on
    the kernels' forward (check_train_grads), a counted step (MI_TRAIN:
    conv3x3, wgrad, dwconv3x3 and conv_kxk by entry), a step timed (3
    windows of 5) with its split. Returns the counted steps' launches and
    {model: ms a step}."""
    import numpy as np

    from larvanet_tpu_torch.core.registry import get_loader
    from larvanet_tpu_torch.ops import conv_kxk as ck
    from larvanet_tpu_torch.ops import dwconv3x3 as dw

    batch, patch = TRAIN_BATCH, TRAIN_PATCH
    steps, times = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        write_train_set(tmp, np.random.default_rng(SEED + 29), SR_TRAIN_FRAMES, SR_TRAIN_LR)
        loader = get_loader("div2k_train_loader")
        loader.parse_args(["--data_input_path", os.path.join(tmp, "LR"), "--data_truth_path",
                           os.path.join(tmp, "HR"), "--data_cached", "--data_seed", str(SEED)])
        loader.prepare([4])
        loader.reseed_for_step(0)
        lr_nhwc, hr_nhwc = loader.get_patch_batch_nhwc(batch, 4, patch)
    x, t = torch.from_numpy(lr_nhwc).cuda(), torch.from_numpy(hr_nhwc).cuda()
    for name, want in MI_TRAIN.items():
        t0 = time.perf_counter()
        model = mi_model(name, is_training=True)
        label = "%s x4" % name
        if name == "mamnet" and model.train_tail_route(patch) != "lr_domain":
            raise AssertionError("mamnet trains on %s" % model.train_tail_route(patch))
        check_train_grads(torch, model, x, t, label, batch, patch, same_forward=True)
        t1 = time.perf_counter()
        step = lambda: model.train_step(lr_nhwc, 4, hr_nhwc)  # noqa: E731
        dw.reset_launches()
        ck.reset_launches()
        launches = counted_step(torch, step)
        dgrad = dict(ck.DGRAD_LAUNCHES_BY_PATH)
        launches["dw"] = dict(dw.LAUNCHES_BY_ENTRY)
        launches["kxk"] = {"forward": {p: ck.LAUNCHES_BY_PATH[p] - dgrad[p] for p in dgrad},
                           "dgrad": dgrad, "wgrad": ck.WGRAD_LAUNCHES}
        print("launches: dwconv3x3 %s, conv_kxk %s" % (launches["dw"], launches["kxk"]),
              flush=True)
        if launches != want:
            raise AssertionError("%s train step launches %s, not %s" % (label, launches, want))
        steps.append(launches)
        tm = time_windows(torch, {"train_step": step}, windows=3, reps=5)["train_step"]
        t2 = time.perf_counter()
        train_step_split(torch, model, x, t, step, label, batch, patch, "f32", tm)
        times[name] = tm[0]
        print("18c %s: %.1f s checking the gradients, %.1f s counting and timing, %.1f s "
              "profiling" % (label, t1 - t0, t2 - t1, time.perf_counter() - t2), flush=True)
        del model
        torch.cuda.empty_cache()
    return steps, times


def mi_cli_phase(torch):
    """Phase 18d. The CLIs on the fitted models, saved as .pth, each run
    counted: validate on MAMNet over phase 6's set (its collapsed route made
    inside the run: one tail probe), get_sr on IMDN over its LR frames, test
    on MAMNet over a SynSetReal tree, runtime on MAMNet at the DIV2K x4 LR
    size 339x510, train on IMDN for 2 steps (a checkpoint each) and
    psnr_trend over those two checkpoints (IMDN's module). Returns the
    conv3x3 launches by path."""
    import numpy as np

    from larvanet_tpu_torch.cli import get_sr, psnr_trend, runtime, test, train, validate

    total = {}
    frames = len(VALIDATE_LR) + 1
    rng = np.random.default_rng(SEED + 30)
    with tempfile.TemporaryDirectory() as tmp:
        write_validate_set(tmp)
        write_test_set(tmp, rng)
        pths = {}
        for name in MI_MODELS:
            pths[name] = os.path.join(tmp, name + ".pth")
            save_mi_model(torch, pths[name], name, photo(rng, 96, 128))
        lr_dir = os.path.join(tmp, "all", "LR")
        data = ["--data_input_path", lr_dir, "--data_truth_path", os.path.join(tmp, "all", "HR")]
        run_dir = os.path.join(tmp, "imdn_run")
        runs = [
            ("validate mamnet", frames, "mamnet", 1, lambda: validate.main([
                "--model", "mamnet", "--device", "cuda", "--restore_path", pths["mamnet"]]
                + data)),
            ("get_sr imdn_aim2019", frames, "imdn_aim2019", 0, lambda: get_sr.main([
                "--model", "imdn_aim2019", "--device", "cuda", "--restore_path",
                pths["imdn_aim2019"], "--input_path", os.path.join(lr_dir, "X4"),
                "--output_path", os.path.join(tmp, "sr")])),
            ("test mamnet", len(TEST_FRAMES), "mamnet", 1, lambda: test.main([
                "--model", "mamnet", "--device", "cuda", "--restore_path", pths["mamnet"],
                "--input_root_path", os.path.join(tmp, "test_LR"), "--truth_root_path",
                os.path.join(tmp, "test_HR"), "--output_root_path", os.path.join(tmp, "out"),
                "--datasets", "SynSetReal"])),
            ("runtime mamnet", None, "mamnet", 1, lambda: runtime.main([
                "--model", "mamnet", "--device", "cuda", "--restore_path", pths["mamnet"],
                "--input_height", str(RAGGED[1]), "--input_width", str(RAGGED[2]),
                "--num_warmup", "1", "--num_iters", "3"])),
        ]
        for label, forwards, name, probes, run in runs:
            result, conv, _ = counted(torch, run)
            per, per_kxk = MI_MODELS[name][1], MI_MODELS[name][2]
            if forwards is None:  # runtime: its warmup and timed forwards
                forwards = sum(LAST_KXK.values()) // sum(per_kxk.values())
            print("%s x4: %s" % (label, result), flush=True)
            expect_forwards(label, conv, per, forwards, kxk=per_kxk, probes=probes)
            _add(total, conv)
        if len(os.listdir(os.path.join(tmp, "sr"))) != frames:
            raise AssertionError("get_sr imdn wrote %s" % os.listdir(os.path.join(tmp, "sr")))
        _, losses = train.main([
            "--dataloader", "div2k_train_loader", "--model", "imdn_aim2019", "--scales", "4",
            "--device", "cuda", "--batch_size", "4", "--input_patch_size", "32",
            "--max_steps", "2", "--save_freq", "1", "--log_freq", "1", "--train_path",
            run_dir, "--data_cached"] + data)
        if sorted(losses) != [1, 2] or not all(np.isfinite(v) for v in losses.values()):
            raise AssertionError("train imdn_aim2019: losses %s" % (losses,))
        trend, conv, _ = counted(torch, lambda: psnr_trend.main([
            "--model", "imdn_aim2019", "--device", "cuda", "--restore_dir", run_dir] + data))
        print("psnr_trend imdn_aim2019 x4 over %s: %s" % (sorted(os.listdir(run_dir)), trend),
              flush=True)
        if [n for n, _ in trend] != ["model_1.pth", "model_2.pth"]:
            raise AssertionError("psnr_trend swept %s" % (trend,))
        expect_forwards("psnr_trend imdn_aim2019", conv, MI_MODELS["imdn_aim2019"][1],
                        2 * frames, kxk=NO_KXK)
        _add(total, conv)
    return total


def mi_phase(torch):
    """Phase 18: 18a-18d, each one's seconds printed. Returns what the
    kernels line takes."""
    t0 = time.perf_counter()
    seconds = {}

    def lap(part):
        seconds[part] = time.perf_counter() - t0 - sum(seconds.values())

    conv_sums, _, conv_worst, _ = kernel_phase(torch, IMDN_CONVS, "IMDN x4 (its new shapes)",
                                               scaled_bar=True, geometries=(LR_BATCH,),
                                               slope=IMDN_SLOPE)
    wgrad = train_kernel_phase(torch, IMDN_WGRAD, IMDN_DGRAD, "IMDN x4 (its new shapes)")
    s8_pair = branchy_s8_phase(torch, pairs=MAMNET_INT8[0]["conv_a"], res_weights=(1.0,),
                               label="MAMNet MAMBlock", act="relu")
    lap("18a")
    served = {}
    for name, dtype_name in (("mamnet", "f32"), ("mamnet", "bf16"), ("imdn_aim2019", "f32"),
                             ("imdn_aim2019", "bf16")):
        _, by_path, model = serve_phase(torch, dtype_name=dtype_name, model_name=name)
        _add(served, by_path)
        del model
    forwards, forward_ms = mi_forward_phase(torch)
    lap("18b")
    steps, step_ms = mi_train_phase(torch)
    lap("18c")
    cli_conv = mi_cli_phase(torch)
    lap("18d")
    print("phase 18: %.1f s (%s)" % (time.perf_counter() - t0, ", ".join(
        "%s %.1f s" % kv for kv in seconds.items())), flush=True)
    conv = dict(served)
    for part in (forwards["conv3x3"], cli_conv):
        _add(conv, part)
    return dict(conv_sums=conv_sums, conv_worst=conv_worst, wgrad=wgrad, s8_pair=s8_pair,
                conv=conv, s8=forwards["s8"], dw=forwards["dw"], forward_ms=forward_ms,
                steps=steps, step_ms=step_ms)


# ---- phase 19: serving artifacts, the full-frame forwards, Winograd --------------

# 19a: the artifacts exported on the card at LR_BATCH, on the serving CLIs'
# route (utils/aot.serving_forward): label -> (model name, model flags, export
# dtype, --int8_trunk). The int8 one in bf16, the CLIs' int8 dtype.
ARTIFACTS = (
    ("EDSR-baseline x4 f32", "edsr", [], "float32", False),
    ("EDSR-baseline x4 bf16", "edsr", [], "bfloat16", False),
    ("EDSR-baseline x4 int8", "edsr", [], "bfloat16", True),
    ("LarvaNet 2x16 bf16", "LarvaNet", LARVANET_FLAGS, "bfloat16", False),
    ("MAMNet x4 f32", "mamnet", [], "float32", False),
)
# the kernels' counters a forward is counted by, and the device split's kinds
ARTIFACT_KINDS = MI_KINDS
# 19b: requests to the artifact server: direct ones at the exported geometry,
# and --tile_forward ones on the ragged frame (tiles of the exported 192, the
# CLIs' default overlap)
ARTIFACT_REQUESTS = 8
ARTIFACT_TILE_REQUESTS = 2
ARTIFACT_TILE_OVERLAP = 24
SERVER_START_S = 300
# 19c: validate --artifact --tile_forward against validate --restore_path
# --tile_forward on phase 6's set, at phase 6's tiles (48, overlap 16), from
# an artifact of 8 tiles; the bar on the mean PSNR
ARTIFACT_VALIDATE_BATCH = 8
ARTIFACT_PSNR_TOL = 1e-4
# 19d: EDSR-baseline x4 bf16 on one BIG_FRAME_LR frame: 8 strips and a grid
# of 135 x 240 tiles, each with a halo of 40 LR pixels, past the collapsed
# route's receptive radius of 36 (34 3x3 convs, the 5x5 tail's 2)
FRAME_STRIPS = 8
FRAME_TILE = (135, 240)
FRAME_HALO = 40
RECEPTIVE_RADIUS = 36
FRAME_WINDOWS = 3
FRAME_REPS = 1
# 19e: the Winograd EDSR forward against the module, JAX's bar
# (tests/test_winograd.py:69)
WINOGRAD_RTOL, WINOGRAD_ATOL = 2e-3, 0.15


def _counted_all(torch, fn):
    """fn() with every forward kernel's counter zeroed just before it and
    read just after: (its result, {"conv3x3": by path, "conv_kxk": by path
    (single and "group_"), "s8": by entry, "dw": by entry})."""
    from larvanet_tpu_torch.ops import conv_kxk as ck

    ck.reset_launches()
    out, conv, dw, s8l = _counted_msrr(torch, fn)
    return out, {"conv3x3": conv, "conv_kxk": kxk_launches(ck), "s8": s8l, "dw": dw}


def artifact_model(torch, name, flags, x):
    """A 19a model x4 at full width, random weights from SEED, its output
    spread over the pixel range on x[:1] (EDSR: fit_output_range; MAMNet:
    fit_sr_residual; LarvaNet as drawn, its residual over the bicubic base)."""
    from larvanet_tpu_torch.core.registry import get_model

    if name == "mamnet":
        model = mi_model(name)
        fit_sr_residual(torch, model, x[:1])
        return model
    model = get_model(name)
    model.parse_args(list(flags))
    model.prepare([4], device="cuda", seed=SEED)
    if name == "edsr":
        fit_output_range(torch, model, x[0].permute(2, 0, 1).cpu().numpy())
    return model


def artifact_export_phase(torch, tmp):
    """Phase 19a. Each ARTIFACTS model exported on the card at the 4 x
    192x192 batch (the route built once: the live forward and the traced one
    are the same closure), saved, loaded back onto the card. The live route
    and the loaded program each run one counted forward: the launches of
    every kernel, by path or entry, must be equal, and the outputs equal bit
    for bit (max |d| 0). Prints export s, artifact MB, load s, and both
    forwards' times in turns with the artifact's device split (idle).
    Returns ({label: numbers}, the counted launches summed, the EDSR f32
    model and its .pth and artifact paths)."""
    from larvanet_tpu_torch.utils import aot

    n, h, w = LR_BATCH
    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    x = 255.0 * torch.rand((n, h, w, 3), generator=gen, device="cuda")
    totals = {"conv3x3": {}, "conv_kxk": {}, "s8": {}, "dw": {}}
    rows, models = {}, {}
    for label, name, flags, dtype, int8 in ARTIFACTS:
        model = models.get(name) or artifact_model(torch, name, flags, x)
        models[name] = model
        calib = x[:, :96, :96].cpu().numpy() if int8 else None
        fwd, desc = aot.serving_forward(model, dtype, int8_trunk=int8, calib=calib)
        fwd(x)
        live, live_counts = _counted_all(torch, lambda: fwd(x))
        t0 = time.perf_counter()
        program, header = aot.trace_serving(model, fwd, desc, (n, h, w, 3), dtype,
                                            ("cuda", "cpu"))
        export_s = time.perf_counter() - t0
        path = os.path.join(tmp, "%s.lvt" % label.replace(" ", "_"))
        aot.save_artifact(path, program, header)
        del program
        t0 = time.perf_counter()
        serve, _ = aot.load_artifact(path, "cuda")
        load_s = time.perf_counter() - t0
        serve(x)
        got, counts = _counted_all(torch, lambda: serve(x))
        err = float((got - live).abs().max())
        print("artifact %s (%s): export %.2f s, %.2f MB, load %.2f s; launches %s, live "
              "route %s; max |d| against the live route %.3g" % (
                  label, desc, export_s, os.path.getsize(path) / 1e6, load_s, counts,
                  live_counts, err), flush=True)
        if counts != live_counts or err != 0.0 or not bool(torch.isfinite(got).all()):
            raise AssertionError("artifact %s differs from its live route" % label)
        for run in (live_counts, counts):
            for key, part in run.items():
                _add(totals[key], part)
        tm = time_windows(torch, {"live": lambda: fwd(x), "artifact": lambda: serve(x)})
        print("artifact %s: forward %s, live route %s (in turns); artifact %s; live %s" % (
            label, spread(tm["artifact"]), spread(tm["live"]),
            breakdown_line(torch, lambda: serve(x), tm["artifact"][0], ARTIFACT_KINDS),
            breakdown_line(torch, lambda: fwd(x), tm["live"][0], ARTIFACT_KINDS)), flush=True)
        rows[label] = {"path_desc": desc, "export_s": export_s,
                       "artifact_mb": os.path.getsize(path) / 1e6, "load_s": load_s,
                       "ms": tm["artifact"][0], "live_ms": tm["live"][0], "launches": counts,
                       "max_abs_err": err}
        if label == "EDSR-baseline x4 f32":
            pth = os.path.join(tmp, "edsr_x4.pth")
            torch.save(model.module.state_dict(), pth)
            edsr = (model, pth, path)
        del serve, got, live
    del models
    torch.cuda.empty_cache()
    return rows, totals, edsr


def _start_artifact_server(path, extra):
    """`serve --artifact path` in a fresh process on an ephemeral port:
    (process, base url), once it prints its address."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.Popen([sys.executable, "-m", "larvanet_tpu_torch.cli.serve",
                             "--artifact", path, "--port", "0", *extra], cwd=root, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc


def _server_url(proc):
    t0 = time.perf_counter()
    for line in proc.stdout:
        if " on http://" in line:
            threading.Thread(target=proc.stdout.read, daemon=True).start()  # drain
            return line.strip().rsplit(" on ", 1)[1]
        if time.perf_counter() - t0 > SERVER_START_S:
            break
    raise AssertionError("serve --artifact did not start (exit %s)" % (proc.poll(),))


def artifact_serve_phase(torch, model, pth, path):
    """Phase 19b. `serve --artifact` of 19a's EDSR f32 artifact (4 x
    192x192) in two fresh processes, direct and --tile_forward, started
    together: ARTIFACT_REQUESTS requests at the exported geometry, sent at
    once (a batch-4 artifact coalesces them), and ARTIFACT_TILE_REQUESTS on
    the ragged frame through tiles of 192. Each response's pixels must equal
    the live server's (build_service on the .pth, direct and with
    --tile_forward --tile_size 192), and each process's /info must report
    its artifact mode and no model zoo in sys.modules."""
    import numpy as np

    from larvanet_tpu_torch.cli import serve
    from larvanet_tpu_torch.data import png

    _, h, w = LR_BATCH
    rng = np.random.default_rng(SEED + 32)
    frames = [photo(rng, h, w) for _ in range(ARTIFACT_REQUESTS)]
    ragged = [photo(rng, *RAGGED[1:]) for _ in range(ARTIFACT_TILE_REQUESTS)]
    procs = {"direct": _start_artifact_server(path, []),
             "tile": _start_artifact_server(path, ["--tile_forward", "--tile_overlap",
                                                   str(ARTIFACT_TILE_OVERLAP)])}
    t0 = time.perf_counter()
    try:
        urls = {mode: _server_url(proc) for mode, proc in procs.items()}
        print("artifact servers up in %.2f s: %s" % (time.perf_counter() - t0, urls),
              flush=True)
        results = {}
        for mode, imgs in (("direct", frames), ("tile", ragged)):
            outs = [None] * len(imgs)

            def post(i, url=urls[mode], imgs=imgs, outs=outs):
                outs[i] = _http(url + "/upscale",
                                png.encode(np.ascontiguousarray(imgs[i].transpose(1, 2, 0))))

            threads = [threading.Thread(target=post, args=(i,)) for i in range(len(imgs))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            status, body = _http(urls[mode] + "/info")
            info = json.loads(body)
            results[mode] = (outs, info)
            print("artifact server %s: %d requests, statuses %s; /info mode %s, path_desc "
                  "%r, input_shape %s, num_forwards %d, mean_batch_size %s, "
                  "model_zoo_loaded %s" % (
                      mode, len(imgs), sorted(set(s for s, _ in outs)), info["mode"],
                      info["path_desc"], info["input_shape"], info["num_forwards"],
                      info["mean_batch_size"], info["model_zoo_loaded"]), flush=True)
            if (any(s != 200 for s, _ in outs) or info["mode"] != "artifact-" + mode
                    or info["model_zoo_loaded"] is not False
                    or info["num_requests"] != len(imgs)):
                raise AssertionError("serve --artifact (%s) failed its checks" % mode)
    finally:
        for proc in procs.values():
            proc.terminate()
        for proc in procs.values():
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    worst = {}
    for mode, imgs in (("direct", frames), ("tile", ragged)):
        extra = (["--tile_forward", "--tile_size", str(h), "--tile_overlap",
                  str(ARTIFACT_TILE_OVERLAP)] if mode == "tile" else [])
        args, remaining = serve.build_parser().parse_known_args(
            ["--model", "edsr", "--restore_path", pth, *extra])
        service = serve.build_service(args, remaining)
        outs, _ = results[mode]
        worst[mode] = 0
        for img, (_, body) in zip(imgs, outs):
            # the live server's response: its frame as make_server encodes it
            want = png.decode(serve.chw_to_png(service.upscale_chw(img)), grey16="clip")
            got = png.decode(body, grey16="clip")
            worst[mode] = max(worst[mode], int(np.abs(got.astype(np.int16)
                                                      - want.astype(np.int16)).max()))
        del service
    print("artifact servers: largest pixel difference from the live server %s" % worst,
          flush=True)
    if any(worst.values()):
        raise AssertionError("serve --artifact's pixels differ from the live server's")
    return worst


def artifact_validate_phase(torch, model, pth, tmp):
    """Phase 19c. validate --artifact --tile_forward of an EDSR f32 artifact
    of ARTIFACT_VALIDATE_BATCH tiles of 48 (exported from 19a's model)
    against validate --restore_path --tile_forward at the same tiles, on
    phase 6's set: the mean PSNRs within ARTIFACT_PSNR_TOL dB."""
    from larvanet_tpu_torch.cli import validate
    from larvanet_tpu_torch.utils import aot

    write_validate_set(tmp)
    tile, overlap = int(VALIDATE_TILE[1]), int(VALIDATE_TILE[3])
    path = os.path.join(tmp, "edsr_x4_tile%d.lvt" % tile)
    program, header = aot.export_serving(model, (ARTIFACT_VALIDATE_BATCH, tile, tile, 3))
    aot.save_artifact(path, program, header)
    data = ["--data_input_path", os.path.join(tmp, "all", "LR"),
            "--data_truth_path", os.path.join(tmp, "all", "HR")]
    t0 = time.perf_counter()
    art = validate.main(["--artifact", path, "--tile_forward", "--tile_overlap", str(overlap),
                         *data])[4]
    art_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    live = validate.main(["--model", "edsr", "--restore_path", pth, "--tile_forward",
                          *VALIDATE_TILE, *data])[4]
    live_s = time.perf_counter() - t0
    print("validate --artifact --tile_forward (tiles %d, overlap %d, batch %d): mean PSNR "
          "%.6f dB in %.2f s; validate --restore_path: %.6f dB in %.2f s; |d| %.3g dB "
          "(bar %g)" % (tile, overlap, ARTIFACT_VALIDATE_BATCH, art, art_s, live, live_s,
                        abs(art - live), ARTIFACT_PSNR_TOL), flush=True)
    if abs(art - live) > ARTIFACT_PSNR_TOL:
        raise AssertionError("validate --artifact disagrees with validate --restore_path")
    return {"psnr": art, "restore_psnr": live}


def frame_forwards_phase(torch, model):
    """Phase 19d. EDSR-baseline x4 bf16 on its collapsed route on one
    BIG_FRAME_LR frame: the direct frame, the strip-batched forward
    (FRAME_STRIPS strips), the tile-scan forward (FRAME_TILE tiles), each
    with a halo of FRAME_HALO >= RECEPTIVE_RADIUS, held against the direct
    frame (max |d|), and beside them TiledUpscaler's default tiles and the
    reference's chop: each timed (CUDA events) with its peak memory."""
    from larvanet_tpu_torch.eval import tiling
    from larvanet_tpu_torch.utils import aot

    fh, fw = BIG_FRAME_LR
    fwd, _ = aot.serving_forward(model, "bfloat16")
    model.set_route(fwd)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 33)
    x = 255.0 * torch.rand((1, fh, fw, 3), generator=gen, device="cuda")
    frame = x[0].permute(2, 0, 1).cpu().numpy()
    strip = tiling.make_strip_batched_forward(fwd, 4, FRAME_STRIPS, FRAME_HALO, fh, fw)
    scan = tiling.make_tile_scan_forward(fwd, 4, *FRAME_TILE, FRAME_HALO, fh, fw)
    tiler = tiling.TiledUpscaler(fwd, 4, *TILE_DEFAULT, device="cuda")
    routes = {"direct": lambda: fwd(x), "strips": lambda: strip(x), "tile_scan": lambda: scan(x),
              "tiles": lambda: tiler.upscale_device(x[0]),
              "chop": lambda: tiling.upscale_with_chop_forward(model, frame, 4, CHOP_OVERLAP)}
    direct = fwd(x)[0]
    out = {}
    for name, fn in routes.items():
        got = fn()
        got = torch.from_numpy(got).permute(1, 2, 0).cuda() if name == "chop" else got
        err = float((got.reshape(direct.shape) - direct).abs().max())
        del got
        mb = peak_mb(torch, fn)
        tm = time_windows(torch, {name: fn}, FRAME_WINDOWS, FRAME_REPS)[name]
        out[name] = {"ms": tm[0], "peak_mb": mb, "max_abs_err": err}
        print("frame %dx%d bf16 %s: max |d| against the direct frame %.3g; %s; peak %.1f MB"
              % (fh, fw, name, err, spread(tm), mb), flush=True)
    for name in ("strips", "tile_scan"):
        if out[name]["max_abs_err"] != 0.0:
            raise AssertionError("the %s forward (halo %d >= radius %d) differs from the "
                                 "direct frame" % (name, FRAME_HALO, RECEPTIVE_RADIUS))
    model.set_route(None)
    model.set_serving_dtype("f32")
    torch.cuda.empty_cache()
    return out


def winograd_phase(torch, model):
    """Phase 19e. The 2-D Winograd EDSR forward (ops/winograd.py: plain
    torch, no CLI routes to it; its tail the baked collapsed tail) in f32 on
    the 4 x 192x192 batch, held at JAX's bar (tests/test_winograd.py:69)
    against the module's walk with the same collapsed tail, so that the
    Winograd trunk is what the bar measures; its distance from the module's
    own tail and from the module on the plain versions printed beside it.
    Both forwards timed."""
    from larvanet_tpu_torch.ops.collapsed_tail import collapsed_edsr_tail
    from larvanet_tpu_torch.ops.winograd import make_winograd_edsr_forward

    n, h, w = LR_BATCH
    gen = torch.Generator(device="cuda").manual_seed(SEED + 34)
    x = 255.0 * torch.rand((n, h, w, 3), generator=gen, device="cuda")
    wino = make_winograd_edsr_forward(model, torch.float32)
    tail = collapsed_edsr_tail(model)
    route = torch.no_grad()(lambda: model.module(x, tail=tail))
    with torch.no_grad():
        got = wino(x)
        want = route()
        module = model.module(x)
        with plain_versions():
            plain = model.module(x)
    excess = float(((got - want).abs() - WINOGRAD_RTOL * want.abs()).max())
    err = float((got - want).abs().max())
    tm = time_windows(torch, {"winograd": lambda: wino(x), "module": route})
    print("winograd EDSR f32 %s: max |d| against the module's collapsed route %.3g (bar %g "
          "+ %g |y|, worst excess over rtol %.3g); against the module's own tail %.3g, the "
          "module on the plain versions %.3g (the collapsed route from the module's tail "
          "%.3g); %s, the module's collapsed route %s" % (
              (n, h, w), err, WINOGRAD_ATOL, WINOGRAD_RTOL, excess,
              float((got - module).abs().max()), float((got - plain).abs().max()),
              float((want - module).abs().max()), spread(tm["winograd"]),
              spread(tm["module"])), flush=True)
    if excess > WINOGRAD_ATOL or not bool(torch.isfinite(got).all()):
        raise AssertionError("the Winograd EDSR forward misses JAX's bar")
    return {"max_abs_err": err, "ms": tm["winograd"][0], "module_ms": tm["module"][0]}


def artifact_phase(torch):
    """Phase 19: 19a to 19e. Returns {"rows", "launches" (19a's counted
    forwards, live and artifact), "serve", "validate", "frames",
    "winograd"}."""
    t0 = time.perf_counter()
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        rows, launches, (model, pth, path) = artifact_export_phase(torch, tmp)
        times["19a"] = time.perf_counter() - t
        t = time.perf_counter()
        served = artifact_serve_phase(torch, model, pth, path)
        times["19b"] = time.perf_counter() - t
        t = time.perf_counter()
        validated = artifact_validate_phase(torch, model, pth, tmp)
        times["19c"] = time.perf_counter() - t
    t = time.perf_counter()
    frames = frame_forwards_phase(torch, model)
    times["19d"] = time.perf_counter() - t
    t = time.perf_counter()
    wino = winograd_phase(torch, model)
    times["19e"] = time.perf_counter() - t
    print("phase 19: %.1f s (%s)" % (time.perf_counter() - t0, ", ".join(
        "%s %.1f s" % kv for kv in times.items())), flush=True)
    del model
    torch.cuda.empty_cache()
    return {"rows": rows, "launches": launches, "serve": served, "validate": validated,
            "frames": frames, "winograd": wino}


# ---- phase 20: the parallel package ------------------------------------------
# 20a: EDSR-baseline x4 at full width on one 540x960 LR frame (3840x2160
# out), its rows split 4 ways: exact (halo = the receptive radius, 36 LR
# rows: RECEPTIVE_RADIUS) and at the CLIs' default --spatial_halo, 32
SPATIAL_LR = (540, 960)
SPATIAL_SHARDS = 4
SPATIAL_DEFAULT_HALO = 32
# 20b: data-parallel serving on a 2-way mesh: LR_BATCH through the collapsed
# route and the int8 route, validate --tile_forward on phase 6's set, serve
# direct requests of DP_REQUEST_LR
DP_EVAL = 2
DP_REQUESTS = 4
DP_REQUEST_LR = (64, 96)
# 20c/20d: data-parallel training on a 2-way mesh at phase 8's batch; the
# parameters after one step lie within 2 learning rates of the single step's
# (Adam's first step moves each weight by +-lr, whose sign flips where a
# gradient lies within its f32 rounding of 0) and the gradients within
# GRAD_RTOL of each tensor's largest
DP_TRAIN = 2
DP_TRAIN_MODELS = (("EDSR-baseline x4", "edsr", ["--collapsed_tail_train", "0"],
                    TRAIN_LAUNCHES),
                   ("LarvaNet 2x16", "LarvaNet", LARVANET_FLAGS, LARVA_TRAIN_LAUNCHES))
# 20e: a 4-conv + shuffle stack at C = 64, x4, on a (2 spatial x 2 model)
# mesh, halo 4 (its receptive radius)
TP_MESH = (2, 2)
TP_CHANS = (3, 64, 64, 64, 48)
TP_LR = (1, 192, 192)
PARALLEL_WINDOWS = 3


def parallel_meshes(torch, n):
    """[(label, devices)] of phase 20's n-device meshes: n repeats of
    cuda:0 (a virtual mesh), and, where the machine has 2 cards or more, n
    positions over the distinct cards."""
    count = torch.cuda.device_count()
    out = [("virtual", [torch.device("cuda", 0)] * n)]
    if count >= 2:
        out.append(("distinct", [torch.device("cuda", i % count) for i in range(n)]))
    return out


def cli_mesh_devices(torch):
    """A context in which the CLIs' meshes (parallel/mesh.devices_for) repeat
    the model's card where the machine has fewer cards than asked: the same
    CLI code a multi-card machine runs, on one card."""
    from larvanet_tpu_torch.parallel import mesh as pm

    real = pm.devices_for

    def devices(device, n, flag="dp_devices"):
        if torch.cuda.device_count() >= n:
            return real(device, n, flag)
        return [torch.device(device)] * n

    return mock.patch.object(pm, "devices_for", devices)


def _rel_err(torch, got, want):
    """(max |got - want|, its share of max |want|)."""
    err = float((got.float() - want.float()).abs().max())
    return err, err / max(float(want.float().abs().max()), 1e-30)


def spatial_phase(torch, devices):
    """20a. EDSR-baseline x4's module graph split over SPATIAL_SHARDS rows of
    `devices`: the receptive radius measured; at halo = radius the f32
    sharded forward against the full-frame forward (FWD_RTOL of the largest
    value; bit for bit where no sum order depends on the strip) and the bf16
    one against the same sharded function on plain convs (BF16_FWD_RTOL); at
    the default halo, both against the sharded plain-conv function (not
    exact against the full frame, printed); 4 x 37 conv3x3 launches a
    sharded forward; the sharded and the full-frame forward timed in
    turns. Returns {"conv": launches by path, "radius", "rows"}."""
    import numpy as np

    from larvanet_tpu_torch.core.registry import get_model
    from larvanet_tpu_torch.parallel.halo import receptive_radius, spatial_sharded_forward
    from larvanet_tpu_torch.parallel.mesh import make_mesh, replicate

    mesh = make_mesh((SPATIAL_SHARDS,), ("spatial",), devices)
    model = get_model("edsr")
    model.parse_args([])
    model.prepare([4], device="cuda", seed=SEED)
    with torch.no_grad():
        radius = receptive_radius(model.module, 4, device="cuda")
    print("20a: %r, EDSR-baseline x4 receptive radius %d LR rows (measured)"
          % (mesh, radius), flush=True)
    if radius != RECEPTIVE_RADIUS:
        raise AssertionError("receptive radius %d, not %d" % (radius, RECEPTIVE_RADIUS))
    rng = np.random.default_rng(SEED + 20)
    x = torch.from_numpy(np.ascontiguousarray(
        photo(rng, *SPATIAL_LR).transpose(1, 2, 0), np.float32))[None].cuda()
    launches, rows = {}, {}
    for dname in ("f32", "bf16"):
        model.set_serving_dtype(dname)
        serving = model.serving_module
        params = replicate(serving, mesh)
        xd = x.to(model.compute_dtype)
        exact = spatial_sharded_forward(lambda m, v: m(v), mesh, halo=radius, scale=4)
        default = spatial_sharded_forward(lambda m, v: m(v), mesh, halo=SPATIAL_DEFAULT_HALO,
                                          scale=4)
        bar = FWD_RTOL if dname == "f32" else BF16_FWD_RTOL
        with torch.no_grad():
            got, by_path, _ = counted(torch, lambda: exact(params, xd))
            expect_forwards("20a sharded %s" % dname, by_path, PLAIN_PATH_LAUNCHES[dname],
                            SPATIAL_SHARDS)
            _add(launches, by_path)
            full = serving(xd)
            with plain_versions():
                plain = exact(params, xd)
                plain_default = default(params, xd)
            got_default = default(params, xd)
        if got.shape != (1, 4 * SPATIAL_LR[0], 4 * SPATIAL_LR[1], 3) or not bool(
                torch.isfinite(got).all()):
            raise AssertionError("20a: sharded output %s" % (tuple(got.shape),))
        ref = full if dname == "f32" else plain
        err = _rel_err(torch, got, ref)
        err_default = _rel_err(torch, got_default, plain_default)
        off_default = _rel_err(torch, got_default, full)
        print("20a %s halo %d: |sharded - %s| %.3g (%.3g of the max; bit for bit: %s); "
              "halo %d: |sharded - plain sharded| %.3g (%.3g), |sharded - full frame| %.3g "
              "(not exact below the radius)"
              % (dname, radius, "full frame" if dname == "f32" else "plain sharded", *err,
                 bool(torch.equal(got, ref)), SPATIAL_DEFAULT_HALO, *err_default,
                 off_default[0]), flush=True)
        if err[1] > bar or err_default[1] > bar:
            raise AssertionError("20a %s: sharded forward off by %s / %s (bar %g)"
                                 % (dname, err, err_default, bar))
        with torch.no_grad():
            tm = time_windows(torch, {"sharded": lambda: exact(params, xd),
                                      "full frame": lambda: serving(xd)},
                              windows=PARALLEL_WINDOWS, reps=1)
        print("20a %s: %d-way sharded forward %s, full frame %s"
              % (dname, SPATIAL_SHARDS, spread(tm["sharded"]), spread(tm["full frame"])),
              flush=True)
        rows[dname] = {"max_abs_err": err[0], "bit_for_bit": bool(torch.equal(got, ref)),
                       "default_halo_err": err_default[0], "default_halo_vs_full": off_default[0],
                       "sharded_ms": tm["sharded"][0], "full_frame_ms": tm["full frame"][0]}
        del got, full, plain, plain_default, got_default
    del model, params
    torch.cuda.empty_cache()
    return {"conv": launches, "radius": radius, "rows": rows}


def dp_eval_phase(torch, devices):
    """20b. use_data_parallel_eval over DP_EVAL positions of `devices`: LR_BATCH
    through EDSR-baseline x4's collapsed route and its int8 route, each
    equal to the single-device forward bit for bit (the same kernels on the
    same samples), 34 conv3x3 + 4 conv_kxk launches a shard (int8: 32 s8);
    validate --tile_forward --dp_devices 2 (TiledUpscaler(min_batch=2)) and
    serve --dp_devices 2 (build_service, DP_REQUESTS direct requests) against
    the same CLIs without it, frame for frame. Returns {"conv", "s8",
    "ms"}."""
    from types import SimpleNamespace

    import numpy as np

    from larvanet_tpu_torch.cli import common, serve, validate
    from larvanet_tpu_torch.core.registry import get_model
    from larvanet_tpu_torch.data import io
    from larvanet_tpu_torch.parallel.mesh import make_mesh, use_data_parallel_eval

    mesh = make_mesh((DP_EVAL,), ("data",), devices[:DP_EVAL])
    print("20b: %r" % (mesh,), flush=True)
    rng = np.random.default_rng(SEED + 21)
    n, h, w = LR_BATCH
    frames = [photo(rng, h, w) for _ in range(n)]
    x = torch.from_numpy(np.ascontiguousarray(
        np.stack(frames).transpose(0, 2, 3, 1), np.float32)).cuda()
    calib = np.stack([photo(rng, *INT8_CALIB[1:]) for _ in range(INT8_CALIB[0])])
    calib = calib.transpose(0, 2, 3, 1).astype(np.float32)
    conv, s8_by_entry, ms = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        pth = os.path.join(tmp, "edsr.pth")
        save_edsr_baseline(torch, pth, frames[0])
        for route in ("collapsed", "int8"):
            model = get_model("edsr")
            model.parse_args([])
            model.prepare([4], device="cuda", seed=SEED)
            model.restore(pth)
            if route == "collapsed":
                common.maybe_collapse_tail(model, SimpleNamespace(collapsed_tail=1))
            else:
                common.maybe_int8_trunk(model, SimpleNamespace(int8_trunk=1, model="edsr"),
                                        lambda: calib)
            single = model.fwd_runtime(x)
            model_single = model.route
            use_data_parallel_eval(model, mesh)
            got, s8_got, by_path = _counted_s8(torch, lambda: model.fwd_runtime(x))
            if route == "collapsed":
                expect_forwards("20b dp eval collapsed", by_path, PATH_LAUNCHES["f32"], DP_EVAL,
                                kxk=KXK_LAUNCHES)
            else:
                _expect_s8("20b dp eval int8", s8_got, INT8_LAUNCHES["edsr"][0], DP_EVAL)
                expect_forwards("20b dp eval int8", by_path, INT8_LAUNCHES["edsr"][1], DP_EVAL,
                                kxk=KXK_LAUNCHES)
                _add(s8_by_entry, s8_got)
            _add(conv, by_path)
            if not torch.equal(got, single):
                raise AssertionError("20b %s: the dp forward differs from the single-device "
                                     "one by %g" % (route, float((got - single).abs().max())))
            dp_route = model.route
            with torch.no_grad():
                tm = time_windows(torch, {"dp": lambda: dp_route(x),
                                          "single": lambda: model_single(x)},
                                  windows=PARALLEL_WINDOWS, reps=2)
            ms[route] = {k: v[0] for k, v in tm.items()}
            print("20b %s: %d x %dx%d, %d-way dp forward %s, single %s; equal bit for bit"
                  % (route, n, h, w, DP_EVAL, spread(tm["dp"]), spread(tm["single"])),
                  flush=True)
            del model, single, got
        # validate --tile_forward, with and without --dp_devices
        write_validate_set(tmp)
        flags = ["--model", "edsr", "--scales", "4", "--device", "cuda", "--restore_path", pth,
                 "--data_input_path", os.path.join(tmp, "even", "LR"),
                 "--data_truth_path", os.path.join(tmp, "even", "HR"), "--tile_forward",
                 *VALIDATE_TILE]
        with cli_mesh_devices(torch):
            dp_psnr = validate.main(flags + ["--dp_devices", str(DP_EVAL), "--save_path",
                                             os.path.join(tmp, "dp")])
        one_psnr = validate.main(flags + ["--save_path", os.path.join(tmp, "one")])
        names = io.list_pngs(os.path.join(tmp, "one", "x4"))
        same = [np.array_equal(io.load_image_u8(os.path.join(tmp, "dp", "x4", k + ".png")),
                               io.load_image_u8(os.path.join(tmp, "one", "x4", k + ".png")))
                for k in names]
        print("20b validate --tile_forward --dp_devices %d: PSNR %s, without %s; %d/%d frames "
              "equal" % (DP_EVAL, dp_psnr, one_psnr, sum(same), len(same)), flush=True)
        if dp_psnr != one_psnr or not all(same) or len(same) != len(VALIDATE_LR):
            raise AssertionError("20b: validate --dp_devices differs")
        # serve: direct requests through build_service
        argv = ["--restore_path", pth, "--device", "cuda"]
        with cli_mesh_devices(torch):
            dp_service = serve.build_service(*serve.build_parser().parse_known_args(
                argv + ["--dp_devices", str(DP_EVAL)]))
        one_service = serve.build_service(*serve.build_parser().parse_known_args(argv))
        if dp_service.dynamic_batch != DP_EVAL:
            raise AssertionError("20b: serve's --dynamic_batch %d, not %d"
                                 % (dp_service.dynamic_batch, DP_EVAL))
        requests = [photo(rng, *DP_REQUEST_LR) for _ in range(DP_REQUESTS)]
        outs, by_path, _ = counted(torch, lambda: [dp_service.upscale_chw(r) for r in requests])
        # a lone request is padded to the mesh: DP_EVAL shard forwards each
        expect_forwards("20b serve --dp_devices", by_path, PATH_LAUNCHES["f32"],
                        DP_REQUESTS * DP_EVAL, kxk=KXK_LAUNCHES)
        _add(conv, by_path)
        for r, out in zip(requests, outs):
            if not np.array_equal(out, one_service.upscale_chw(r)):
                raise AssertionError("20b: a served frame differs under --dp_devices")
        print("20b serve --dp_devices %d: %d requests equal the single-device server's"
              % (DP_EVAL, DP_REQUESTS), flush=True)
        del dp_service, one_service
    torch.cuda.empty_cache()
    return {"conv": conv, "s8": s8_by_entry, "ms": ms}


def _dp_step_pair(torch, name, flags):
    """Two models of `name` from SEED for training, on the card."""
    from larvanet_tpu_torch.core.registry import get_model

    out = []
    for _ in range(2):
        m = get_model(name)
        m.parse_args(list(flags))
        m.prepare([4], device="cuda", seed=SEED, is_training=True)
        out.append(m)
    return out


def _dp_step_check(torch, label, single, dp, x, t, per_step, lr):
    """One step of `single` and one of `dp` (data-parallel already) on the
    same batch: the loss (LOSS_RTOL), the averaged gradients (GRAD_RTOL of
    each tensor's largest), the parameters (2 lr); the dp step's launches,
    per_step by path twice over. Returns the counted launches."""
    loss1 = float(single._optimizer_step(x, t, lr))
    out = []
    launches = counted_step(torch, lambda: out.append(dp._optimizer_step(x, t, lr)))
    want = {k: {p: DP_TRAIN * v for p, v in d.items()} for k, d in per_step.items()}
    if launches != want:
        raise AssertionError("%s: dp step launches %s, not %s" % (label, launches, want))
    loss2 = float(out[0])
    grad_err = max(float((a.grad - b.grad).abs().max()) / max(float(a.grad.abs().max()), 1e-30)
                   for a, b in zip(single.module.parameters(), dp.module.parameters())
                   if a.grad is not None)
    diffs = [(a - b).detach().abs() for a, b in zip(single.module.parameters(),
                                                   dp.module.parameters())]
    param_err = max(float(d.max()) for d in diffs)
    moved = sum(int((d > 1e-6).sum()) for d in diffs)
    print("%s: dp loss %.9g, single %.9g (rel %.3g); gradients %.3g of each max; "
          "parameters max |d| %.3g (%d of %d beyond 1e-6)"
          % (label, loss2, loss1, abs(loss2 - loss1) / abs(loss1), grad_err, param_err, moved,
             sum(d.numel() for d in diffs)), flush=True)
    if abs(loss2 - loss1) > LOSS_RTOL * abs(loss1) or grad_err > GRAD_RTOL or \
            param_err > 2 * lr:
        raise AssertionError("%s: the dp step differs from the single-device step" % label)
    return launches


def dp_train_phase(torch, devices):
    """20c. One data-parallel step of EDSR-baseline x4 (phase 8's batch, the
    module's tail) and of the flagship LarvaNet 2x16 on DP_TRAIN positions of
    `devices`, against the single-device step from the same weights; the
    two timed in turns. Returns {"steps": [launches], "ms"}."""
    import numpy as np

    from larvanet_tpu_torch.parallel.mesh import make_mesh, use_data_parallel

    mesh = make_mesh((DP_TRAIN,), ("data",), devices[:DP_TRAIN])
    print("20c: %r" % (mesh,), flush=True)
    rng = np.random.default_rng(SEED + 22)
    x = torch.from_numpy(rng.uniform(0, 255, (TRAIN_BATCH, TRAIN_PATCH, TRAIN_PATCH, 3))
                         .astype(np.float32)).cuda()
    t = torch.from_numpy(rng.uniform(0, 255, (TRAIN_BATCH, 4 * TRAIN_PATCH, 4 * TRAIN_PATCH, 3))
                         .astype(np.float32)).cuda()
    steps, ms = [], {}
    for label, name, flags, per_step in DP_TRAIN_MODELS:
        single, dp = _dp_step_pair(torch, name, flags)
        use_data_parallel(dp, mesh)
        lr = single.get_learning_rate()
        steps.append(_dp_step_check(torch, "20c " + label, single, dp, x, t, per_step, lr))
        tm = time_windows(torch, {"dp": lambda: dp._optimizer_step(x, t, lr),
                                  "single": lambda: single._optimizer_step(x, t, lr)},
                          windows=PARALLEL_WINDOWS, reps=2)
        ms[label] = {k: v[0] for k, v in tm.items()}
        print("20c %s: %d-way dp step %s, single %s" % (label, DP_TRAIN, spread(tm["dp"]),
                                                        spread(tm["single"])), flush=True)
        del single, dp
        torch.cuda.empty_cache()
    return {"steps": steps, "ms": ms}


def nccl_worker(coordinator, rank):
    """20d's process on card `rank` of a two-card machine: NCCL at world size
    2, one data-parallel EDSR step on its half of the global batch, against
    the single-device step on the whole batch. Returns an exit code."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from larvanet_tpu_torch.parallel.distributed import init_distributed
    from larvanet_tpu_torch.parallel.mesh import make_mesh, use_data_parallel

    torch.cuda.set_device(rank)
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(coordinator, 2, rank, backend="nccl")
    try:
        rng = np.random.default_rng(SEED + 23)
        x = torch.from_numpy(rng.uniform(0, 255, (TRAIN_BATCH, TRAIN_PATCH, TRAIN_PATCH, 3))
                             .astype(np.float32)).cuda()
        t = torch.from_numpy(rng.uniform(0, 255, (TRAIN_BATCH, 4 * TRAIN_PATCH,
                                                  4 * TRAIN_PATCH, 3)).astype(np.float32)).cuda()
        label, name, flags, per_step = DP_TRAIN_MODELS[0]
        single, dp = _dp_step_pair(torch, name, flags)
        use_data_parallel(dp, make_mesh((1,), ("data",), [torch.device("cuda", rank)]))
        half = TRAIN_BATCH // 2
        loss1 = float(single._optimizer_step(x, t, single.get_learning_rate()))
        loss2 = float(dp._optimizer_step(x[rank * half:(rank + 1) * half],
                                         t[rank * half:(rank + 1) * half],
                                         dp.get_learning_rate()))
        err = max(float((a - b).detach().abs().max())
                  for a, b in zip(single.module.parameters(), dp.module.parameters()))
        print("20d rank %d on %s: NCCL dp loss %.9g, single %.9g; parameters max |d| %.3g"
              % (rank, torch.cuda.get_device_name(rank), loss2, loss1, err), flush=True)
        ok = abs(loss2 - loss1) <= LOSS_RTOL * abs(loss1) and err <= 2 * single.get_learning_rate()
    finally:
        dist.destroy_process_group()
    return 0 if ok else 1


def nccl_phase(torch, devices):
    """20d. NCCL on the card: init_distributed at world size 1 and 20c's
    EDSR step through the process group's all-reduce against the
    single-device step; where the machine has 2 cards or more, two processes,
    one card each (nccl_worker). Returns the counted step's launches."""
    import socket

    import numpy as np
    import torch.distributed as dist

    from larvanet_tpu_torch.parallel.distributed import init_distributed, is_primary
    from larvanet_tpu_torch.parallel.mesh import make_mesh, use_data_parallel

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    init_distributed("127.0.0.1:%d" % free_port(), 1, 0, backend="nccl")
    try:
        if not (dist.get_backend() == "nccl" and is_primary()):
            raise AssertionError("20d: not an NCCL group of rank 0")
        rng = np.random.default_rng(SEED + 23)
        x = torch.from_numpy(rng.uniform(0, 255, (TRAIN_BATCH, TRAIN_PATCH, TRAIN_PATCH, 3))
                             .astype(np.float32)).cuda()
        t = torch.from_numpy(rng.uniform(0, 255, (TRAIN_BATCH, 4 * TRAIN_PATCH,
                                                  4 * TRAIN_PATCH, 3)).astype(np.float32)).cuda()
        label, name, flags, per_step = DP_TRAIN_MODELS[0]
        single, dp = _dp_step_pair(torch, name, flags)
        use_data_parallel(dp, make_mesh((DP_TRAIN,), ("data",), devices[:DP_TRAIN]))
        if not dp.data_parallel.distributed:
            raise AssertionError("20d: the step does not see the process group")
        launches = _dp_step_check(torch, "20d NCCL world 1, " + label, single, dp, x, t,
                                  per_step, single.get_learning_rate())
        del single, dp
    finally:
        dist.destroy_process_group()
    count = torch.cuda.device_count()
    if count < 2:
        print("20d: one card: the two-process NCCL step needs 2 cards (not run)", flush=True)
        return launches
    coord = "127.0.0.1:%d" % free_port()
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, chip_smoke; "
            "sys.exit(chip_smoke.nccl_worker(sys.argv[1], int(sys.argv[2])))")
    procs = [subprocess.Popen([sys.executable, "-c", code, coord, str(r)], env=env,
                              cwd=os.path.dirname(os.path.abspath(__file__)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        print(out.strip(), flush=True)
        if p.returncode != 0:
            raise AssertionError("20d: NCCL worker %d failed (exit %s)" % (r, p.returncode))
    return launches


def tp_phase(torch, devices):
    """20e. make_tp_spatial_forward on a TP_MESH (spatial x model) mesh of
    `devices`: a TP_CHANS conv + shuffle stack x4 on TP_LR against the same
    function on plain convs (FWD_RTOL of the largest value); each shard's
    conv path as path_for names it, counted. Returns {"conv", "ms"}."""
    import numpy as np

    from larvanet_tpu_torch.ops.conv3x3 import path_for
    from larvanet_tpu_torch.parallel.mesh import make_mesh
    from larvanet_tpu_torch.parallel.tp import make_tp_spatial_forward

    mesh = make_mesh(TP_MESH, ("spatial", "model"), devices[:TP_MESH[0] * TP_MESH[1]])
    n_spatial, n_model = TP_MESH
    gen = torch.Generator().manual_seed(SEED + 24)
    params = {}
    for i in range(len(TP_CHANS) - 1):
        c, f = TP_CHANS[i], TP_CHANS[i + 1]
        params["conv%d" % i] = {
            "kernel": (torch.randn((3, 3, c, f), generator=gen) / math.sqrt(9 * c)).cuda(),
            "bias": (0.1 * torch.randn((f,), generator=gen)).cuda()}
    rng = np.random.default_rng(SEED + 24)
    x = torch.from_numpy(np.ascontiguousarray(
        photo(rng, *TP_LR[1:]).transpose(1, 2, 0), np.float32))[None].cuda()
    halo = len(TP_CHANS) - 1
    f = make_tp_spatial_forward(mesh, halo=halo, scale=4)
    want_paths = {"cuda_core": 0, "tensor_core": 0, "narrow": 0}
    shard_paths = []
    for i in range(len(TP_CHANS) - 1):
        path = path_for(TP_CHANS[i], TP_CHANS[i + 1] // n_model, torch.float32)
        shard_paths.append("conv%d %d->%d/%d: %s" % (i, TP_CHANS[i], TP_CHANS[i + 1], n_model,
                                                    path))
        want_paths[path] += n_spatial * n_model
    got, by_path, _ = counted(torch, lambda: f(params, x))
    print("20e: %r, shard conv paths %s" % (mesh, "; ".join(shard_paths)), flush=True)
    expect_forwards("20e tp forward", by_path, want_paths, 1)
    with plain_versions():
        want = f(params, x)
    err = _rel_err(torch, got, want)
    tm = time_windows(torch, {"tp": lambda: f(params, x)}, windows=PARALLEL_WINDOWS, reps=2)
    with plain_versions():
        tp_plain = time_windows(torch, {"tp plain": lambda: f(params, x)},
                                windows=PARALLEL_WINDOWS, reps=2)
    print("20e: output %s, |kernels - plain convs| %.3g (%.3g of the max); %s, plain %s"
          % (tuple(got.shape), *err, spread(tm["tp"]), spread(tp_plain["tp plain"])), flush=True)
    if got.shape != (1, 4 * TP_LR[1], 4 * TP_LR[2], 3) or err[1] > FWD_RTOL:
        raise AssertionError("20e: the TP forward is off by %s" % (err,))
    return {"conv": by_path, "ms": {"tp": tm["tp"][0], "plain": tp_plain["tp plain"][0]}}


def dir_checkpoint_phase(torch):
    """20f. --orbax_checkpoint 1: the train CLI at phase 8's batch for 2 steps
    with --dp_devices 2 and directory checkpoints, synchronous and
    --async_checkpoint 1; a resume from the step-1 directory repeats step 2's
    loss, and the restored step-2 directory's forward equals the CLI's
    trained model's, bit for bit."""
    import numpy as np

    from larvanet_tpu_torch.cli import train
    from larvanet_tpu_torch.core.registry import get_model
    from larvanet_tpu_torch.utils.checkpoints import is_dir_checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        write_train_set(tmp, np.random.default_rng(SEED + 25), 2, TRAIN_LR)
        cli = ["--dataloader", "div2k_train_loader", "--model", "edsr", "--scales", "4",
               "--device", "cuda", "--batch_size", str(TRAIN_BATCH), "--input_patch_size",
               str(TRAIN_PATCH), "--save_freq", "1", "--collapsed_tail_train", "0",
               "--orbax_checkpoint", "1", "--dp_devices", str(DP_TRAIN),
               "--data_input_path", os.path.join(tmp, "LR"),
               "--data_truth_path", os.path.join(tmp, "HR"), "--data_cached",
               "--data_seed", str(SEED)]
        for mode in ("sync", "async"):
            run = os.path.join(tmp, mode)
            extra = ["--async_checkpoint", "1"] if mode == "async" else []
            with cli_mesh_devices(torch):
                trained, losses = train.main(cli + extra + ["--train_path", run,
                                                            "--max_steps", "2"])
                again = os.path.join(tmp, mode + "_again")
                os.makedirs(again)
                os.rename(os.path.join(run, "model_1.pth"), os.path.join(again, "model_1.pth"))
                _, resumed = train.main(cli + extra + ["--train_path", again, "--max_steps", "2",
                                                       "--restore_path", "latest"])
            path = os.path.join(run, "model_2.pth")
            if not is_dir_checkpoint(path) or resumed != {2: losses[2]}:
                raise AssertionError("20f %s: directory %s, resumed losses %s, the run's %s"
                                     % (mode, is_dir_checkpoint(path), resumed, losses))
            model = get_model("edsr")
            model.parse_args([])
            model.prepare([4], device="cuda", seed=SEED)
            model.restore(path)
            x = torch.rand((2, 48, 48, 3), device="cuda") * 255
            if not torch.equal(model.fwd_runtime(x), trained.fwd_runtime(x)):
                raise AssertionError("20f %s: the restored directory's forward differs" % mode)
            print("20f %s: 2 dp steps with directory checkpoints; the resume from model_1.pth/ "
                  "repeats step 2's loss %.9g; model_2.pth/ restores the trained forward bit "
                  "for bit" % (mode, losses[2]), flush=True)
            del trained, model
    torch.cuda.empty_cache()


def parallel_phase(torch):
    """Phase 20: 20a-20f on a virtual mesh of the one card, and on the
    distinct cards where there are 2 or more. Returns {"conv": 20a/20b/20e
    forward launches by path, "s8", "steps": 20c/20d's counted steps, and
    the numbers of each part}."""
    t0 = time.perf_counter()
    out = {"conv": {}, "s8": {}, "steps": [], "spatial": {}, "dp_eval": {}, "dp_train": {},
           "tp": {}}
    times = {}
    for label, devices in parallel_meshes(torch, SPATIAL_SHARDS):
        print("phase 20 on the %s mesh: %s" % (label, ", ".join(map(str, devices))),
              flush=True)
        t = time.perf_counter()
        spatial = spatial_phase(torch, devices)
        times["20a " + label] = time.perf_counter() - t
        t = time.perf_counter()
        dp_eval = dp_eval_phase(torch, devices)
        times["20b " + label] = time.perf_counter() - t
        t = time.perf_counter()
        dp_train = dp_train_phase(torch, devices)
        times["20c " + label] = time.perf_counter() - t
        t = time.perf_counter()
        tp = tp_phase(torch, devices)
        times["20e " + label] = time.perf_counter() - t
        for part in (spatial["conv"], dp_eval["conv"], tp["conv"]):
            _add(out["conv"], part)
        _add(out["s8"], dp_eval["s8"])
        out["steps"].extend(dp_train["steps"])
        out["spatial"][label] = {k: spatial[k] for k in ("radius", "rows")}
        out["dp_eval"][label] = dp_eval["ms"]
        out["dp_train"][label] = dp_train["ms"]
        out["tp"][label] = tp["ms"]
    t = time.perf_counter()
    out["steps"].append(nccl_phase(torch, parallel_meshes(torch, DP_TRAIN)[0][1]))
    times["20d"] = time.perf_counter() - t
    t = time.perf_counter()
    dir_checkpoint_phase(torch)
    times["20f"] = time.perf_counter() - t
    print("phase 20: %.1f s (%s)" % (time.perf_counter() - t0, ", ".join(
        "%s %.1f s" % kv for kv in times.items())), flush=True)
    return out


def print_sass_mix(build):
    """The instruction mix of each tensor-core and narrow kernel in the
    built libraries (cuobjdump -sass): ldmatrix, tensor-core products,
    generic loads, cp.async copies, local-memory spills."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        print("sass: cuobjdump not found")
        return
    kinds = {"LDSM": r"\bLDSM\b", "HMMA": r"\bHMMA\b", "IMMA": r"\bIMMA\b",
             "LD.E": r"\bLD\.E\b",
             "LDGSTS": r"\bLDGSTS\b", "LDL/STL": r"\b(?:LDL|STL)\b"}
    # the depthwise kernels' own mix: copies, shared loads, stores, the f32
    # products and sums, shuffles, barriers, spills
    dw_kinds = {"LDGSTS": r"\bLDGSTS\b", "LDS": r"\bLDS\b", "STG": r"\bSTG\b",
                "FMUL": r"\bFMUL\b", "FADD": r"\bFADD\b", "FFMA": r"\bFFMA\b",
                "SHFL": r"\bSHFL\b", "BAR": r"\bBAR\b", "LDL/STL": r"\b(?:LDL|STL)\b"}
    for source in build.SOURCES:
        sass = subprocess.run([tool, "-sass", str(build.library_path(source))],
                              capture_output=True, text=True, timeout=120).stdout
        for fn in re.split(r"\n\s*Function : ", sass)[1:]:
            name = fn.split("\n", 1)[0].strip()
            dw = "dw_" in name
            if not dw and "tc_kernel" not in name and "narrow" not in name and "s8" not in name:
                continue
            mix = {k: len(re.findall(v, fn)) for k, v in (dw_kinds if dw else kinds).items()}
            print("sass %s %s: %s" % (source, name, mix))


def timed(label, fn, *args, **kwargs):
    """fn(*args, **kwargs), its seconds printed with the script's total so
    far (where the time limit goes)."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    print("[time] %s: %.1f s (%.1f s since the start)"
          % (label, time.perf_counter() - t0, time.perf_counter() - T_START), flush=True)
    return out


T_START = time.perf_counter()


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description="On-card smoke run of the port.")
    parser.add_argument("--phase", choices=("all", "parallel"), default="all",
                        help="'parallel': build the kernels and run phase 20 alone "
                             "(on every card of the machine; no kernels line and no "
                             "result line)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    print("device: %s (torch %s, CUDA %s)" % (smi, torch.__version__, torch.version.cuda))

    from larvanet_tpu_torch.ops import build

    t0 = time.perf_counter()
    built = build.build()
    print("build: %.2f s (%s)" % (time.perf_counter() - t0,
                                   ", ".join("%s %.2f s" % kv for kv in built.items())
                                   or "cached"))
    for source in build.SOURCES:
        print("build log %s:\n%s" % (source, build.build_log(source).strip()))
    print_sass_mix(build)
    if args.phase == "parallel":
        par = timed("parallel_phase", parallel_phase, torch)
        print("phase 20 launches: conv3x3 %s, conv3x3_s8 %s" % (par["conv"], par["s8"]))
        print(nvidia_smi_line())
        return 0

    sums, tc_sums, worst, narrow = timed("kernel_phase", kernel_phase, torch)
    larva_sums, _, larva_worst, _ = timed("kernel_phase LarvaNet", kernel_phase, torch,
                                          LARVANET_CONVS, "LarvaNet 2x16")
    for dname in ("f32", "bf16"):
        worst[dname] = max(worst[dname], larva_worst[dname])
    wino = timed("wino_phase", wino_phase, torch)
    launches, by_path, served = 0, {}, {}
    for model_name in ("edsr", "LarvaNet"):
        for dtype_name in ("bf16", "f32"):
            n_launch, n_by_path, model = serve_phase(torch, dtype_name=dtype_name,
                                                     model_name=model_name)
            launches += n_launch
            served[(model_name, dtype_name)] = n_by_path
            _add(by_path, n_by_path)
            if model_name == "edsr" and dtype_name == "f32":
                fwd_launches = timed("forward_phase", forward_phase, torch, model)
            del model
    larva_fwd_launches = timed("larvanet_forward_phase", larvanet_forward_phase, torch)
    validate_launches = timed("validate_phase", validate_phase, torch)
    larva_validate_launches = timed("validate_phase LarvaNet_w64", validate_phase, torch,
                                    model_name="LarvaNet_w64")
    runtime_launches = timed("runtime_phase", runtime_phase, torch)
    timed("runtime_phase LarvaNet", runtime_phase, torch, model_name="LarvaNet")
    torch.cuda.empty_cache()
    train_launches = timed("train_phase", train_phase, torch)
    wgrad_sums, wgrad_by, wgrad_err, wgrad_rel, dgrad_times, _ = timed(
        "train_kernel_phase", train_kernel_phase, torch)
    torch.cuda.empty_cache()
    larva_train = timed("larva_train_phase", larva_train_phase, torch)
    (larva_wgrad_sums, larva_wgrad_by, larva_wgrad_err, larva_wgrad_rel, larva_dgrad,
     larva_wgrad_shapes) = train_kernel_phase(torch, LARVA_TRAIN_WGRAD, LARVA_TRAIN_DGRAD,
                                              "LarvaNet 2x16")
    wgrad_err, wgrad_rel = max(wgrad_err, larva_wgrad_err), max(wgrad_rel, larva_wgrad_rel)
    # the counted train steps' launches, and the V2 run's
    trained = [train_launches, larva_train["step"], larva_train["v2"]]
    torch.cuda.empty_cache()
    full_frame = timed("full_frame_phase", full_frame_phase, torch)
    torch.cuda.empty_cache()
    s8_sums, s8_rows, s8_errs = timed("s8_kernel_phase", s8_kernel_phase, torch)
    s8_wide = timed("s8_wide_phase", s8_wide_phase, torch)
    s8_forward = timed("int8_forward_phase", int8_forward_phase, torch)
    s8_cli = timed("int8_cli_phase", int8_cli_phase, torch)
    timed("qat_phase", qat_phase, torch)
    torch.cuda.empty_cache()
    flags = timed("train_flags_phase", train_flags_phase, torch)
    trained.append(flags["bf16_step"])
    trained.append(flags["chunk"])
    torch.cuda.empty_cache()
    kxk_sums, kxk_worst, kxk_rows = timed("kxk_kernel_phase", kxk_kernel_phase, torch)
    kxk_wgrads = timed("kxk_wgrad_phase", kxk_wgrad_phase, torch)
    kxk_wgrad = kxk_wgrads["tensor_core"]
    radius = timed("collapsed_radius_phase", collapsed_radius_phase, torch)
    collapsed_serve = timed("collapsed_serve_phase", collapsed_serve_phase, torch)
    collapsed_train = timed("collapsed_train_phase", collapsed_train_phase, torch)
    trained.append(collapsed_train)
    torch.cuda.empty_cache()
    msrr = timed("msrr_phase", msrr_phase, torch)
    trained.extend(msrr["steps"])
    msrr_conv = {}
    for part in (msrr["served"], msrr["forwards"]["conv3x3"], msrr["test_conv"]):
        _add(msrr_conv, part)
    s8_by_entry = {}
    for part in (*s8_forward.values(), s8_cli, msrr["forwards"]["s8"]):
        _add(s8_by_entry, part)
    dw_by_entry = dict(msrr["forwards"]["dw"])
    for run in msrr["steps"]:
        _add(dw_by_entry, run["dw"])
    dw_main = msrr["dw_main"]
    torch.cuda.empty_cache()
    branchy = timed("branchy_phase", branchy_phase, torch)
    trained.extend(branchy["steps"])
    torch.cuda.empty_cache()
    sr = timed("sr_phase", sr_phase, torch)
    trained.extend(sr["steps"])
    torch.cuda.empty_cache()
    mi = timed("mi_phase", mi_phase, torch)
    trained.extend(mi["steps"])
    torch.cuda.empty_cache()
    art = timed("artifact_phase", artifact_phase, torch)
    torch.cuda.empty_cache()
    par = timed("parallel_phase", parallel_phase, torch)
    trained.extend(par["steps"])
    family_conv = dict(msrr_conv)  # phases 15's to 20's counted runs
    for part in (branchy["conv"], sr["conv"], mi["conv"], art["launches"]["conv3x3"],
                 par["conv"]):
        _add(family_conv, part)
    for part in (branchy["s8"], sr["s8"], mi["s8"], art["launches"]["s8"], par["s8"]):
        _add(s8_by_entry, part)
    # phase 18's MAMNet forwards and steps: its 16 CSDs a forward
    mi_dw = dict(mi["dw"])
    for run in mi["steps"]:
        _add(mi_dw, run["dw"])
    _add(dw_by_entry, mi_dw)
    _add(dw_by_entry, art["launches"]["dw"])

    kernels = [{
        "name": "conv3x3_bias_act",
        "route": "cuda",
        "source": "larvanet_tpu_torch/csrc/conv3x3_bias_act.cu",
        "replaces": "larvanet_tpu/ops/pallas_conv.py:61",
        "launches": launches + sum(sum(run[k].values()) for run in trained
                                   for k in ("forward", "dgrad"))
        + sum(full_frame["conv3x3"].values()) + sum(family_conv.values()),
        "launches_by_path": {p: by_path[p] + full_frame["conv3x3"].get(p, 0)
                             + family_conv.get(p, 0)
                             + sum(run["forward"][p] + run["dgrad"][p] for run in trained)
                             for p in by_path},
        "max_abs_err": worst["f32"],
        "ms": sums["f32"]["ms"],
        "plain_ms": sums["f32"]["plain_ms"],
        "bound_ms": sums["f32"]["bound_ms"],
        "bound_by": sums["f32"]["bound_by"],
        "library_ms": sums["f32"]["library_ms"],
        "cuda_core_ms": sums["f32"]["cuda_core_ms"],
        "bf16": dict(sums["bf16"], max_abs_err=worst["bf16"]),
        # the 35 convs of a forward on the tensor-core path (f32: split TF32),
        # with their served launches
        "tensor_core": {d: dict(tc_sums[d], launches=served[("edsr", d)]["tensor_core"])
                        for d in ("f32", "bf16")},
        "narrow": narrow,
        # the 67 convs of one LarvaNet 2x16 forward, with their served launches
        "larvanet": {d: dict(larva_sums[d], max_abs_err=larva_worst[d],
                             launches_by_path=served[("LarvaNet", d)])
                     for d in ("f32", "bf16")},
        # one EDSR-baseline x4 train step's forward and dgrad launches, and
        # the dgrad shapes no forward has
        "train_step": {"forward_by_path": train_launches["forward"],
                       "dgrad_by_path": train_launches["dgrad"], "dgrad": dgrad_times},
        # one LarvaNet 2x16 train step's forward and dgrad launches, the
        # train_larvaV2 run's, and V2's 48 -> 96 dgrad
        "larvanet_train": {"forward_by_path": larva_train["step"]["forward"],
                           "dgrad_by_path": larva_train["step"]["dgrad"],
                           "v2_run": {k: larva_train["v2"][k] for k in ("forward", "dgrad")},
                           "dgrad": larva_dgrad},
        # phase 10's counted chop, tile, self-ensemble and CLI runs, by path
        "full_frame": full_frame["conv3x3"],
        # phase 15: the MSRR family's counted serving, forwards and test run
        # (15c, 15e) by path; 15b's new epilogues (relu6, leaky_relu(0.2)),
        # their largest error against the plain version by dtype; the
        # forwards' ms by model and dtype
        "msrr": {"launches_by_path": msrr_conv, "epilogue_max_abs_err": msrr["epilogue"],
                 "forward_ms": msrr["forward_ms"], "train_step_ms": msrr["step_ms"]},
        # phase 16 (TreeNet, the REGOs): 16a's new shapes summed over one
        # REGO-Net x4 forward's launches of them (the RESBlocks' leaky conv1,
        # SRrecon's 384 -> 48) per dtype with their largest error; the
        # forwards' and steps' ms by model (16b-16d); the input gradients at
        # 384 channels (16a); the phase's counted serving, forward and CLI
        # launches by path (its counted steps are in the totals' train runs)
        "branchy": {d: dict(branchy["conv_sums"][d], max_abs_err=branchy["conv_worst"][d])
                    for d in ("f32", "bf16")},
        "branchy_launches_by_path": branchy["conv"],
        "branchy_forward_ms": branchy["forward_ms"],
        "branchy_train_step_ms": branchy["step_ms"],
        "branchy_dgrad": branchy["wgrad"][4],
        # phase 17 (the EBRN and HRSR families): 17a's new shapes summed over
        # one forward's launches of them per dtype (full EBRN at 1 x 192x192:
        # fe0, fe1, the LR and HR 64 -> 64, recon 640 -> 3; ebrn_rm's upsample
        # 640 -> 48; hrsr's 3-channel HR convs) with the largest error; the
        # forwards' and steps' ms by model (17b-17d); the input gradients
        # 3 -> 640 and 48 -> 640 (17a); the phase's counted serving, forward
        # and CLI launches by path (its counted steps are in the train runs)
        "ebrn_hrsr": {k: {d: dict(v[d], max_abs_err=sr["conv_worst"][d])
                          for d in ("f32", "bf16")} for k, v in sr["conv_sums"].items()},
        "ebrn_hrsr_launches_by_path": sr["conv"],
        "ebrn_hrsr_forward_ms": sr["forward_ms"],
        "ebrn_hrsr_train_step_ms": sr["step_ms"],
        "ebrn_hrsr_dgrad": sr["wgrad"][4],
        # phase 18 (MAMNet and IMDN): 18a's IMDN shapes at leaky_relu(0.05)
        # summed over one IMDN x4 forward's launches of them per dtype with
        # the largest error; the forwards' (and IMDN's slice copy's) and
        # steps' ms by model (18b-18c); conv4's 16 -> 48 input gradient; the
        # phase's counted serving, forward and CLI launches by path
        "mamnet_imdn": {d: dict(mi["conv_sums"][d], max_abs_err=mi["conv_worst"][d])
                        for d in ("f32", "bf16")},
        "mamnet_imdn_launches_by_path": mi["conv"],
        "mamnet_imdn_forward_ms": mi["forward_ms"],
        "mamnet_imdn_train_step_ms": mi["step_ms"],
        "mamnet_imdn_dgrad": mi["wgrad"][4],
        # phase 19: 19a's counted forwards (each artifact's and its live
        # route's) by path, each artifact's export, load and forward numbers,
        # 19b's pixel differences, 19c's PSNRs, 19d's frames, 19e's Winograd
        "artifact_launches": art["launches"]["conv3x3"],
        "artifact": {k: art[k] for k in ("rows", "serve", "validate", "frames", "winograd")},
        # phase 20: 20a's sharded forwards, 20b's dp forwards and served
        # requests, 20e's TP forward (20c's and 20d's dp steps are among the
        # train runs above), by path; each part's numbers by mesh
        "parallel_launches": par["conv"],
        "parallel": {k: par[k] for k in ("spatial", "dp_eval", "dp_train", "tp")},
    }, {
        "name": "conv3x3_wgrad",
        "route": "cuda",
        "source": "larvanet_tpu_torch/csrc/conv3x3_wgrad.cu",
        "replaces": "larvanet_tpu/models/layers.py:81 (XLA's weight gradient of conv3x3)",
        "launches": sum(sum(run["wgrad"].values()) for run in trained),
        "launches_by_path": {p: sum(run["wgrad"][p] for run in trained)
                             for p in train_launches["wgrad"]},
        "max_abs_err": wgrad_err,
        "max_rel_err": wgrad_rel,
        "ms": wgrad_sums["ms"],
        "plain_ms": wgrad_sums["plain_ms"],
        "bound_ms": wgrad_sums["bound_ms"],
        "bound_by": wgrad_by,
        "library_ms": wgrad_sums["library_ms"],
        "cuda_core_ms": wgrad_sums["cuda_core_ms"],
        # the sums over one LarvaNet 2x16 train step's 69 wgrads, its
        # launches by path, the train_larvaV2 run's, and each 48-channel shape
        "larvanet_train": dict(larva_wgrad_sums, bound_by=larva_wgrad_by,
                               launches_by_path=larva_train["step"]["wgrad"],
                               v2_run=larva_train["v2"]["wgrad"], shapes=larva_wgrad_shapes),
        # phase 13a: the bf16 step's wgrads (conv3x3_wgrad_bf16_tc on the
        # tensor-core shapes, the f32 entries of the widened operands on the
        # other two), summed over one step's 37, with the counted step's
        # bf16 launches by path; the bound at the bf16 peak, library_ms
        # conv2d_weight in bf16, f32_entry_ms the f32 entry on the same values
        "bf16": dict(flags["wgrad_bf16"][0], bound_by=flags["wgrad_bf16"][1],
                     entry="conv3x3_wgrad_bf16_tc",
                     launches=sum(flags["bf16_step"]["bf16_wgrad"].values()),
                     launches_by_path=flags["bf16_step"]["bf16_wgrad"],
                     max_abs_err=flags["wgrad_bf16"][2], max_rel_err=flags["wgrad_bf16"][3],
                     shapes=flags["wgrad_bf16"][4]),
        # phase 16a: the fuse's C = 384 weight gradients at batch 16 x 48x48,
        # f32 (and the bf16 entry's), each shape's numbers
        "branchy": {"f32": dict(branchy["wgrad"][0], bound_by=branchy["wgrad"][1],
                                max_abs_err=branchy["wgrad"][2],
                                max_rel_err=branchy["wgrad"][3], shapes=branchy["wgrad"][5]),
                    "bf16": dict(branchy["wgrad_bf16"][0], bound_by=branchy["wgrad_bf16"][1],
                                 max_abs_err=branchy["wgrad_bf16"][2],
                                 max_rel_err=branchy["wgrad_bf16"][3],
                                 shapes=branchy["wgrad_bf16"][4])},
        # phase 17a: EBRN's recon 640 -> 3 (narrow) at 16 x 192x192 and fe0
        # 3 -> 256 (CUDA cores) at 16 x 48x48, f32, each shape's numbers
        "ebrn_hrsr": dict(sr["wgrad"][0], bound_by=sr["wgrad"][1],
                          max_abs_err=sr["wgrad"][2], max_rel_err=sr["wgrad"][3],
                          shapes=sr["wgrad"][5]),
        # phase 18a: IMDN's 48 -> 16 and 48 -> 64 at 16 x 48x48, f32, summed
        # over one IMDN step's 24 launches of them, and each shape's numbers
        "mamnet_imdn": dict(mi["wgrad"][0], bound_by=mi["wgrad"][1],
                            max_abs_err=mi["wgrad"][2], max_rel_err=mi["wgrad"][3],
                            shapes=mi["wgrad"][5]),
    }]
    for m, line in ((2, 205), (4, 336)):
        wsums, werr = wino[m]
        by_path = {}
        for part in (fwd_launches[m], validate_launches[m], runtime_launches[m],
                     larva_fwd_launches[m], larva_validate_launches[m],
                     full_frame["wino"][m]):
            _add(by_path, part)
        kernels.append({
            "name": "wino_resblock_f%d" % m,
            "route": "cuda",
            "source": "larvanet_tpu_torch/csrc/wino_resblock.cu",
            "replaces": "larvanet_tpu/ops/wino_pallas.py:%d" % line,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": werr["f32"],
            "ms": wsums["f32"]["ms"],
            "plain_ms": wsums["f32"]["plain_ms"],
            "bound_ms": wsums["f32"]["bound_ms"],
            "bound_by": wsums["f32"]["bound_by"],
            "library_ms": wsums["f32"]["library_ms"],
            "cuda_core_ms": wsums["f32"]["cuda_core_ms"],
            "bf16": dict(wsums["bf16"], max_abs_err=werr["bf16"]),
            # phase 10's validate --tile_forward --wino_trunk m
            "full_frame": full_frame["wino"][m],
        })
    kernels.append({
        "name": "conv3x3_s8",
        "route": "cuda",
        "source": "larvanet_tpu_torch/csrc/conv3x3_s8.cu",
        "replaces": "larvanet_tpu/ops/packed/pairs.py:236 (XLA's int8 "
                    "lax.conv_general_dilated; no Pallas kernel)",
        "launches": sum(s8_by_entry.values()),
        "launches_by_entry": s8_by_entry,
        # phase 11b's counted forwards, by model
        "forwards": s8_forward,
        # the largest |kernel - plain version| of both entries in 11a, bf16
        # and f32 (0.0: every value equal, bit for bit)
        "max_abs_err": max(s8_errs.values()),
        # one EDSR-baseline x4 int8 forward's 16 pairs at 4 x 192x192, bf16
        # (the CLIs' int8 dtype), and the same in f32: each entry's CUDA
        # graph replay, and through the wrapper as a caller issues it
        "ms": s8_sums["bf16"]["ms"],
        "wrapper_ms": s8_sums["bf16"]["wrapper_ms"],
        "plain_ms": s8_sums["bf16"]["plain_ms"],
        "bound_ms": s8_sums["bf16"]["bound_ms"],
        "bound_by": s8_sums["bf16"]["bound_by"],
        # no PyTorch call computes an int8 conv on CUDA; the yardsticks:
        # torch._int_mm on the same im2col GEMMs, the bf16 convs it replaces
        "library_ms": None,
        "yardsticks": {k: s8_sums["bf16"][k]
                       for k in ("int_mm_ms", "bf16_conv3x3_ms", "conv2d_bf16_ms")},
        # one LarvaNet 2x16 int8 forward's 33 pairs (48->48), bf16
        "larvanet": s8_sums["bf16"]["larvanet"],
        # phase 16c's --int8_trunk forwards of TreeNet and REGO-Net (ms, bf16),
        # and 16a's REGO pair (conv_a leaky, conv_b without a residual) summed
        # over one REGO-Net int8 forward's 15 pairs, graph replays, by dtype
        "branchy_int8_ms": {k: v["int8"] for k, v in branchy["forward_ms"].items()
                            if "int8" in v},
        "branchy": branchy["s8_pair"],
        # phase 17c's --int8_trunk forwards of ebrn_rm, hrsr and hrsr_c3 (ms,
        # bf16), and 17a's ebrn_rm BRM pair (conv_a leaky_relu(0.05), conv_b
        # without a residual) summed over one ebrn_rm int8 forward's 10 pairs
        "ebrn_hrsr_int8_ms": {k: v["int8"] for k, v in sr["forward_ms"].items()
                              if "int8" in v},
        "ebrn_hrsr": sr["s8_pair"],
        # phase 18b's --int8_trunk forward of MAMNet (ms, bf16), and 18a's
        # MAMBlock pair (conv_a relu, conv_b without a residual) summed over
        # one MAMNet int8 forward's 16 pairs
        "mamnet_int8_ms": mi["forward_ms"]["mamnet"]["int8"],
        "mamnet": mi["s8_pair"],
        # phase 19a's int8 artifact and its live route, by entry
        "artifact_launches": art["launches"]["s8"],
        # phase 20b's dp forwards of the int8 route (32 a shard)
        "parallel_launches": par["s8"],
        "f32": dict(s8_sums["f32"], max_abs_err=s8_errs["f32"]),
        "shapes": s8_rows,
        # phase 11a's widths past one code halo (the chunked plan): the
        # calls that checked and timed them, outside every model's path
        "wide": s8_wide,
    })
    kxk_by_path = dict(KXK_FORWARDS)
    kxk_steps = [collapsed_train["kxk"]] + [run["kxk"] for run in mi["steps"]]
    for run in kxk_steps:
        for part in (run["forward"], run["dgrad"]):
            _add(kxk_by_path, part)
    _add(kxk_by_path, art["launches"]["conv_kxk"])
    kernels.append({
        "name": "conv_kxk",
        "route": "cuda",
        "source": "larvanet_tpu_torch/csrc/conv_kxk.cu",
        "replaces": "larvanet_tpu/ops/collapsed_tail.py:330 (XLA's lax.conv_general_dilated "
                    "of the collapsed tail; no Pallas kernel)",
        # the counted collapsed forwards of phases 4, 5, 6, 7, 10, 11, 14 and
        # 18 (MAMNet's), and phase 14c's and 18c's train steps (their
        # forwards and input gradients)
        "launches": sum(kxk_by_path.values()),
        "launches_by_path": kxk_by_path,
        "max_abs_err": kxk_worst["f32"],
        # one collapsed EDSR-baseline x4 forward's 4 launches (the main conv
        # and 3 border groups) at 4 x 192x192, f32 (TF32 off) and bf16, each
        # a CUDA graph replay of one call; wrapper_ms through the wrapper;
        # library_ms F.conv2d at the same shapes (a group: its problems' calls)
        "ms": kxk_sums["f32"]["ms"],
        "wrapper_ms": kxk_sums["f32"]["wrapper_ms"],
        "plain_ms": kxk_sums["f32"]["plain_ms"],
        "bound_ms": kxk_sums["f32"]["bound_ms"],
        "bound_by": kxk_sums["f32"]["bound_by"],
        "library_ms": kxk_sums["f32"]["library_ms"],
        "bf16": dict(kxk_sums["bf16"], max_abs_err=kxk_worst["bf16"]),
        "shapes": kxk_rows,
        # phase 14a's probed radius, 14b's forwards and tails, 14c's step
        "radius": radius,
        "serving": collapsed_serve,
        "train_step": {"launches": collapsed_train["kxk"], "ms": collapsed_train["step_ms"]},
        # phase 19a's collapsed artifacts and their live routes
        "artifact_launches": art["launches"]["conv_kxk"],
    })
    kernels.append({
        "name": "conv_kxk_wgrad",
        "route": "cuda",
        "source": "larvanet_tpu_torch/csrc/conv_kxk.cu",
        "replaces": "larvanet_tpu/ops/collapsed_tail.py:330 (XLA's weight gradient of the "
                    "live collapsed tail's conv; no Pallas kernel)",
        # phase 14c's and 18c's (MAMNet's) counted train steps
        "launches": sum(run["wgrad"] for run in kxk_steps),
        "max_abs_err": kxk_wgrad["f32"]["max_abs_err"],
        "max_rel_err": kxk_wgrad["f32"]["max_rel_err"],
        # the 5x5 64 -> 48 weight gradient at batch 16 x 48x48 (tensor cores),
        # a CUDA graph replay of one call; wrapper_ms through the wrapper;
        # library_ms conv2d_weight
        "path": kxk_wgrad["f32"]["path"],
        "ms": kxk_wgrad["f32"]["ms"],
        "wrapper_ms": kxk_wgrad["f32"]["wrapper_ms"],
        "plain_ms": kxk_wgrad["f32"]["plain_ms"],
        "bound_ms": kxk_wgrad["f32"]["bound_ms"],
        "bound_by": kxk_wgrad["f32"]["bound_by"],
        "library_ms": kxk_wgrad["f32"]["library_ms"],
        "bf16": kxk_wgrad["bf16"],
        # the CUDA-core entry (C % 16 != 0) at the bicubic base's 5x5 3 -> 48,
        # f32 and bf16, the same way; on no counted path
        "cuda_core": kxk_wgrads["cuda_core"],
    })
    dw_forward = dw_main["f32"]["forward"]
    kernels.append({
        "name": "dwconv3x3",
        "route": "cuda",
        "source": "larvanet_tpu_torch/csrc/dwconv3x3.cu",
        "replaces": "larvanet_tpu/models/layers.py:199 (XLA's feature_group_count conv of "
                    "DepthwiseSeparableResBlock and of MAMNet's CSD, larvanet_tpu/models/"
                    "mamnet.py:44; no Pallas kernel)",
        # phase 15c's counted dwsr_reduced forwards and 15d's counted steps,
        # and phase 18's MAMNet forwards and step: the forward entry, and
        # the same entry as the input gradient
        "launches": dw_by_entry["forward"] + dw_by_entry["dgrad"],
        "launches_by_entry": {k: dw_by_entry[k] for k in ("forward", "dgrad")},
        # bit for bit with the plain version at every shape of 15a
        "max_abs_err": 0.0,
        # one call at dwsr_reduced x4's 4 x 192x192 x 48, f32 (TF32 off): a
        # CUDA graph replay ("ms"), through the wrapper, the plain version,
        # F.conv2d(groups=C) replayed; its dgrad at 16 x 48x48 under "dgrad"
        "ms": dw_forward["ms"],
        "wrapper_ms": dw_forward["wrapper_ms"],
        "plain_ms": dw_forward["plain_ms"],
        "bound_ms": dw_forward["bound_ms"],
        "bound_by": dw_forward["bound_by"],
        "library_ms": dw_forward["library_ms"],
        "bf16": dw_main["bf16"]["forward"],
        "dgrad": {d: dw_main[d]["dgrad"] for d in ("f32", "bf16")},
        "shapes": [r for r in msrr["dw_rows"] if r["entry"] != "wgrad"],
        # phase 18's MAMNet forwards and step (its 16 CSDs a forward), by
        # entry, among the launches above
        "mamnet_launches_by_entry": mi_dw,
        # phase 19a's MAMNet artifact and its live route
        "artifact_launches": art["launches"]["dw"],
    })
    dw_wgrad = dw_main["f32"]["wgrad"]
    kernels.append({
        "name": "dwconv3x3_wgrad",
        "route": "cuda",
        "source": "larvanet_tpu_torch/csrc/dwconv3x3.cu",
        "replaces": "larvanet_tpu/models/layers.py:199 (XLA's weight gradient of the "
                    "depthwise conv; no Pallas kernel)",
        # phase 15d's counted dwsr_reduced step and 18c's MAMNet step
        "launches": dw_by_entry["wgrad"],
        "max_abs_err": max(r["max_abs_err"] for r in msrr["dw_rows"] if r["entry"] == "wgrad"),
        "max_rel_err": max(r["max_rel_err"] for r in msrr["dw_rows"] if r["entry"] == "wgrad"),
        # at batch 16 x 48x48 x 48, f32: a CUDA graph replay, through the
        # wrapper, the plain version, conv2d_weight(groups=C) replayed
        "ms": dw_wgrad["ms"],
        "wrapper_ms": dw_wgrad["wrapper_ms"],
        "plain_ms": dw_wgrad["plain_ms"],
        "bound_ms": dw_wgrad["bound_ms"],
        "bound_by": dw_wgrad["bound_by"],
        "library_ms": dw_wgrad["library_ms"],
        "bf16": dw_main["bf16"]["wgrad"],
        "shapes": [r for r in msrr["dw_rows"] if r["entry"] == "wgrad"],
    })
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
