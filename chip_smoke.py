"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--profile]

Drives the port's paths (``elektronn3_tpu_torch``; no JAX) at full model
width and checks them: the headline 3D UNet's serving and training
paths, the same two paths of the 2D UNet of
``examples/train_simple2d.py``, then those of the start_filts=64 3D UNet
of ``BASELINE.md``'s coverage matrix, whose C=128 level runs the
kernels, those of the headline 3D UNet with ``normalization=
'batchp'``, whose library levels' batch norms run the kernels K8-K11,
those of the headline 3D UNet with ``activation='silu'`` and
``pallas_flat=True``, whose L0 and decoder level run JAX's semi-fused
flat executor (rows 26/27: ``flat_conv3`` on K1, K4 and K5 without a
prologue), and those of the headline 3D UNet with ``vup=True``, whose L0
decoder never stores the upconv of the L1 carry (rows 1's vup mode, 9,
22 and 23: ``ops/vup.py``), the headline 3D UNet's paths with
``normalization='group'`` (and 'instance'), whose kernel levels run the
per-sample mode of K1-K7 and row 3's and row 13's kernels, and those of
the group model with ``vup=True`` (the vup entries per sample) and of
the 2D UNet with ``normalization='group'`` (rows 16, 17, 19 and 20 per
sample).

1. prints the card (``nvidia-smi`` name and power limit);
2. builds the hand-written kernels of ``elektronn3_tpu_torch/csrc`` with
   nvcc (one process per source, in parallel) and prints the build time
   and each kernel's registers;
3. holds the forward kernels K1-K3 against their plain PyTorch versions
   at the shapes of one 3D Predictor tile (128, 256, 256), in bfloat16
   and float32, and times both;
4. holds the outputs of K1 and K3 with and without statistics, K2 and
   the backward kernels K4-K7 (K6 without and with the level's skip
   cotangent, "+dskip", the paths' form) and row 13's (the one-channel
   conv1's backward, as the paths run it and with the input's gradient,
   "+dx")
   against their plain versions at the shapes of ``bench.py``'s training
   step (batch 8 of (44, 88, 88): levels (44, 88, 88) x 32, (44, 44, 44)
   x 64, (22, 22, 22) x 128), in bfloat16 and float32, and times both;
5. the same at the 2D model's training shapes, on the kernels' D=1
   view (batch 8 of (640, 640): L0 (1, 640, 640) x 32, L1 (1, 320, 320)
   x 64 with its (1, 2, 2) pool, which is row 16/17 of the kernel table
   in PERF.md, the up_1 upconv from the dense (1, 160, 160) x 128, row
   19/20, and the C=128 pool and 256->128 upconv), where the serving
   builds of K1 and K3 are also held at the tiled 2D Predictor's batch
   of 4 and timed at batch 8 (the whole-image request's shapes);
5a. K1-K3 as served at the 3D Predictor tile's C=128 level (64, 64, 64)
   (its convs, its (2, 2, 2) pool, up_0 256->128 from the dense level 3
   and up_1 128->64 from the carried C=128 activation, row 24's
   (2, 2, 2) form), the same at the start_filts=64 model's levels of that
   tile (L0 (128, 256, 256) x 64 planar, L1 (128, 128, 128) x 128, up_1
   256->128 from the dense (64, 64, 64), up_2 128->64 from the carried
   C=128 activation, row 24), row 3's kernel (K1 over the network
   input) at the tile with three input channels and at kd=3, and step 4
   at the training shapes of rows
   11/12 (the (1, 2, 2) upconv 64->32 from a dense (44, 44, 44) x 64) and
   of the
   start_filts=64 model (L0 (44, 88, 88) x 64 planar, L1 (44, 44, 44) x
   128, up_1 256->128 from the dense (22, 22, 22), up_2 128->64 from the
   carried C=128 activation, rows 24/25); these variants are listed but
   not summed in the totals;
5c. the per-sample mode (group and instance norm: (N, C) prologue vectors
   and (N, C) statistics) of K1, row 3's kernel, K2 and K3 at the shapes
   of the group model's serving path, at the Predictor request's batch
   of two tiles and at ``bench.py``'s batch 8 (K3 from L2's (22, 22, 22),
   whose 10,648 voxels a sample are no multiple of its 64-voxel blocks,
   and the row-11 upconv from a dense L1), held against their plain
   versions in bf16 and float32 and timed, each in turns with the same
   kernel's batch form with statistics ("+stats batch") at the same
   shape; the same for the 2D model's kernel levels at batch 8 of
   (640, 640) (rows 3, 1, 4, 16, 19 and 7 forward; 13, 8, 14, 17 and 20
   backward); and the vup entries' per-sample mode at bench.py's up_2
   (all five) and the Predictor request's batch of two tiles
   (``conv_vup`` and row 22): the tensor-core body timed in turns with
   its batch twin, the CUDA-core body in bf16 and float32, each
   per-sample call's (N, C) outputs (and dcarry, dskip) the same bits on
   a rerun and for a sample alone; listed, not summed in the totals;
5b. holds the 'batchp' batch norm's kernels against their plain versions
   at (R, C) = the activation seen as rows, bf16 and f32: K8-K11 at the
   'batchp' headline step's library levels ((85184, 128): L2 and up_0,
   8 x 22^3 at C=128; (10648, 256): the bottom L3), at a ragged R, at
   the ``pallas_flat=False`` step's L0 and L1 (batch 8) and its four
   levels at batch 2, and K9 at the Predictor tile's L3 (one tile, and
   the request's batch of 2); K8 (with the running update) and K10, one
   launch each with their glue, print their per-call and device times;
   then one ``PallasBatchNorm3d`` training forward and backward against
   ``nn.BatchNorm3d``'s at the batch-2 levels and the bench's L2/L3;
6. builds the headline UNet (n_blocks=4, start_filts=32, planar L0,
   batch norm, bfloat16) with seeded weights and random running
   statistics and holds ``forward`` against ``forward(reference=True)``
   on one input tile (128, 256, 256), whose L2 (64^3 voxels at C=128)
   the default ``pallas_flat='auto'`` puts on the kernels;
7. runs Predictor requests on a seeded (1, 1, 64, 256, 256) volume
   (tile (64, 128, 128), overlap (32, 64, 64), batch 2): a warm-up
   request with the upconv launches recorded by shape (row 24's
   (2, 2, 2) form), bfloat16 probabilities timed with the kernels'
   launch counts reset just before it, and a uint8 argmax; checks the
   outputs and that K1-K3 launched (the serving path);
8. trains the headline UNet (bf16, ``CEDiceLoss(1, 1)``, Adam 1e-3) at
   ``bench.py``'s shapes: 3 warm-up and 20 timed steps over 5
   device-resident batches on the kernel path (launch counts reset just
   before the timed steps: every kernel must launch), the plain path
   (1 warm-up and 5 timed steps), and the kernel path again; a falling
   loss on a fixed, learnable
   batch; then one step's loss, parameter gradients and new running
   statistics against the same step through ``reference=True``, in
   float32 and bfloat16;
9. runs ``Trainer.run(max_steps=4)`` on a small in-memory dataset into a
   temporary directory and resumes a second Trainer from what it wrote;
   then ``trainer_full_phase``: ``Trainer.run(max_steps=8)`` of the
   headline UNet (bf16) on 8 patches of bench.py's (44, 88, 88) at
   batch 2, validating 5 patches (batches of 2, 2, 1) with
   ``default_metrics()`` and ``AUROC`` after each epoch, under a
   ``CyclicLR`` with a minimum of the rate after step 6, with
   ``extra_save_steps=(3,)``, ``profile_steps=(2, 4)`` and an 8-tile
   preview; it checks the files written (``_initial``, ``_final``,
   ``_best``, ``_step3``, ``_minlr_step6``, the ``model*.pt``, the
   log), K1, row 3, K2 and K3 launched in each validation batch, the
   validation logits against ``reference=True`` (5e-2 of max|ref|), the
   Trainer's validation stats against its own recount from those
   logits, a ``conv_tc`` kernel in the profiler's trace, ``apply_swa``
   with a ``bn_loader`` (new running statistics, finite validation
   logits) and a second swap restoring the parameters bit for bit, and
   a resumed Trainer's next rate and ``best_val_loss``; it prints each
   epoch's split (train, validate, log, preview, checkpoint seconds),
   the validation MVox/s and which of tensorboard, tqdm, matplotlib and
   sklearn the machine lacks;
   then ``pipeline_phase``, the data pipeline (``elektronn3_tpu_torch.
   data``) on two synthetic (160, 448, 448) cubes (float32 raw, int16
   labels; ``benchmark/make_synthetic_neurodata.py``'s ``make_cube``):
   the card's warp of 16 ``DeviceWarpPatchLoader`` samples (8 affine, 8
   perspective) against the host's C++ ``warp_interp`` and the numpy
   ``map_coordinates_*`` (1e-4 of max|ref|, labels equal off .5 ties, no
   voxel outside a perspective sample's window); ``Trainer.run`` of the
   headline UNet (bf16, batch 8 of (44, 88, 88), the neurodata example's
   CE + Dice loss) fed by ``PatchCreator`` (host warp, the example's
   transforms, ``warp_prob=0.2`` perspective, 4 worker processes) and
   by ``DeviceWarpPatchLoader`` (``normalize`` on the card): 20 timed
   steps after 3, each run's launches equal to step 8's over as many
   steps, finite losses, the first batch the same bits from a second
   loader of the same seed; each run's ms a step, MVox/s, the card's
   idle share over 6 more steps (torch.profiler, the workers still
   busy) beside those steps' own ms a step, the host's cores and
   torch's threads, and the per-batch split
   (host sampling, H2D, warp, train and its launches' host time; H2D
   MB); and, where h5py is installed,
   ``examples/train_unet_neurodata_torch.py`` for 3 steps on the cubes
   written as HDF5;
   then the headline UNet with ``input_grad=True`` on inputs that
   require a gradient: timed steps (row 13's kernel with dx once a
   step), the input's gradient of one step against ``reference=True``,
   and zeros from the default ``input_grad=False`` (JAX's fused conv1);
9a. the rest of the Predictor and the UNet options serving needs:
   ``predictor_tta_phase``, the headline UNet served with flip
   test-time augmentation (``augmentations=8``) on step 7's volume:
   eight times the model calls and the launches of the same request
   without it, its probabilities within 1e-2 of the host's softmax of
   the average of eight requests' logits on flipped volumes (flipped
   back), both requests' MVox/s and each one's six phases
   (``collect_phase_times``: ``h2d``, ``compute``, ``d2h``,
   ``host_assemble``, ``device_call``, ``host_scatter``), and the same
   request with the model loaded from ``save_model``'s file and with the
   weights loaded from a reference-style ``state_dict.pth`` (``module.``
   prefixes) into a model of other weights, both the in-memory request's
   bits; ``valid_phase``, the headline UNet with ``conv_mode='valid'``
   (every level on the library, as JAX plans it): a tiled
   ``offset='auto'`` request, tiles (4, 52, 52) of a (44, 244, 244)
   volume, the probed offset (20, 44, 44) checked and the first tile
   against the model on its input (1e-2), timed steps at batch 8 of
   (44, 140, 140) and one step against ``reference=True`` as in step 8;
   ``merge_add_phase``, the headline UNet with ``merge_mode='add'``: the
   forward check on the tile with every decoder merge on K1 over a
   weight doubled along C_in, a Predictor request, one step's K1, K4
   and K5 launches on the merges, then step 8 (without the plain arm);
   and ``options_phase``: one timed step at the bench of the headline
   UNet with ``up_mode='resizeconv_linear'``, ``attention=True``,
   ``checkpointing=True`` and ``'policy'`` beside the plain one (level
   kinds, ms, peak memory, each checkpointed peak under the plain one),
   and a checkpointed float32 step against the plain one as step 8
   holds the kernels against the reference, then the checkpointed
   steps (True and 'policy') on the kernels against the same steps
   through ``reference=True`` under step 8's float32 and bf16 bounds
   (the recompute reads back the forward's statistics);
9b. ``resunet_phase``: the headline ResUNet without residual blocks
   (res0, which is the UNet) through steps 7 and 8, each path's
   launches and one tile forward's and bench step's launches by shape
   the headline UNet's; with one residual block a level (every level on
   the library ops) a Predictor request and timed steps that launch no
   kernel, and step 8's check; and ``loss_zoo_phase``: timed headline
   steps under each loss the port adds (focal, softmax BCE, mixed,
   masked and distance-weighted MSE, the GAP triplet, Lovász, active
   contour, norpf Dice) beside CEDiceLoss's, K1-K7 launched, then
   ``Trainer.run`` with an unlabeled set and ``FixMatchSegLoss``, which
   gets the Trainer's generator as ``rng`` each step;
10. the 2D UNet (n_blocks=4, start_filts=32, dim=2, batch norm,
    bfloat16): ``forward`` against ``forward(reference=True)`` on a
    batch of 8 (640, 640) images; a whole-image Predictor request on
    (8, 1, 640, 640) and a tiled one on a seeded (1, 1, 2560, 2560)
    image (tile (512, 512), overlap (64, 64), batch 4), timed after a
    warm-up, in MPix/s, with K2 and K3 launched at the row-16 and row-19
    shapes; then steps 8 and 9 at batch 8 of (640, 640), with K2, K3, K6
    and K7 launched at the row-16, 19, 17 and 20 shapes;
11. rows 11/12: one headline training step on a batch of 2 of
    (45, 88, 88), whose L1 depth is odd, so L1 declines and L0's decoder
    upconv takes its dense output (K3/K7 at the row-11/12 shapes), and
    the step against ``reference=True`` as in step 8;
12. the start_filts=64 UNet (n_blocks=4, planar L0, batch norm, bf16):
    steps 6 and 7 with the upconv from the carried C=128 activation
    launched (row 24), then steps 8 and 9 at ``bench.py``'s shapes with
    K3 and K7 launched at the row-24 and row-25 shapes;
13. the card's numbers for JAX's C=128 voxel gate: the sf=64 step on
    the kernel plan, with ``FUSED128_MIN_VOX`` raised to 300,000, above
    L1's 85,184 voxels (L1 and its decoder on the library, L0 on the
    kernels), with ``pallas_flat=False``, and on the kernel plan again;
    then the headline 3D Predictor request with L2 on the kernels and on
    the library (the raised constant) in turn, five requests of each
    after a warm-up pair;
14. the headline UNet with ``normalization='batchp'`` (bf16): steps 6
    and 7 with K9 launched at the tile's L3 (rows 30/tile and
    30/request), then steps 8 and 9, with K8-K11 launched at the shapes
    of rows 29, 30 and 31 and the step times printed beside the 'batch'
    model's of step 8;
14a. the headline UNet with ``normalization='group'`` (8 groups, random
    affine parameters, bf16): steps 6 and 7 with K1 (the tensor-core body
    and row 3's kernel, no CUDA-core body), K2 and K3 launched in their
    per-sample mode at the shapes of the tile's kernel levels (L2 under
    the C=128 gate), the same request at ``batch_size=1`` (its
    probabilities within 5e-2 of the batch-2 request's: each tile has its
    own statistics), the forward check on a batch of two tiles of
    different scales, one ``'instance'`` forward check, and the group
    request's MVox/s beside the headline's;
15. the same model with ``pallas_flat=False`` (its 17 norms on K8-K11,
    K1-K7 not launched): the forward check, timed steps (kernels and
    plain) at batch 2 of (44, 88, 88) and one step against
    ``reference=True``;
16. rows 26-28 against their plain versions: ``flat_conv3`` (K1 with
    the identity prologue) at the Predictor tile's L0 conv2 and up_2
    merge, with statistics, K4 (row 26's dgrad) and K5 (row 27) at
    ``bench.py``'s; ``conv_direct`` (K1 with a zero bias) at the five
    shapes of ``benchmark/conv_microbench.py``; and K1/K4 at N * D =
    65,536 (2, 32768, 4, 8) x 32;
17. the headline UNet with ``activation='silu'`` and ``pallas_flat=True``
    (bf16): steps 6 and 7 with K1 launched three times a model call and
    no other of K1-K7, row 26 recorded at the tile's shapes; steps 8 and
    9 with K1, K4 and K5 launched three times a step (L0 conv2, the up_2
    merge and conv2) and K2, K3, K6, K7 none, rows 26/27 recorded; then
    the same step with ``pallas_flat=False`` (every level on the library;
    JAX calls its flat executor "never profitable"), timed beside it;
18. the vup path: its five kernels (``conv_vup`` with and without
    statistics, ``upconv_stats``, ``conv_vup_dgrad``, ``conv_vup_wgrad``,
    ``upconv_stats_bwd``) against their plain versions at bench.py's up_2
    (carry (8, 44, 44, 44, 64), skip (8, 44, 88, 88, 32)) and
    ``conv_vup`` as served at the Predictor tile's up_2, bf16 and f32;
    then the headline UNet with ``vup=True`` (bf16): steps 6 and 7 with
    ``conv_vup`` once a model call in place of up_2's K1 merge and K3,
    then steps 8 and 9 with the five entries once a step and K1, K3, K4,
    K5, K7 one launch fewer a step than step 8's, rows 9, 22, 23 and 1's
    vup mode recorded at the bench shapes; then the same timed step with
    ``vup`` off and on in turn (off, on, on, off), each arm's peak
    allocated memory beside the other's (the vup arm must hold at least
    150 MB less: it never stores the 174.4 MB upconv output);
19. the headline UNet with ``normalization='group'`` and ``vup=True``
    (bf16): steps 6 and 7 with ``conv_vup`` and row 22's pass once a
    model call, every launch in the per-sample mode, rows 1-vup and 22
    recorded per sample at the request's two tiles; steps 8 (without
    the plain arm) with the five entries once a step, every launch per
    sample, rows 1-vup, 9, 22 and 23 recorded per sample, the step
    against ``reference=True`` in float32 and bfloat16, one step's
    per-sample prologue gradients the same bits on a rerun; then the
    step with ``vup`` off and on in turn and each arm's peak allocated
    memory (the vup arm at least 150 MB under);
20. the 2D UNet with ``normalization='group'`` (bf16): step 10's
    requests with every launch per sample, rows 16 and 19 per sample,
    and the last image served alone against in the batch (5e-2 of
    max|p|); step 8 (without the plain arm) at batch 8 of (640, 640)
    with every launch per sample, rows 16, 17, 19 and 20 per sample, the
    per-sample prologue gradients the same bits on a rerun, its device
    time by kernel, and the same model with ``pallas_flat=False`` timed
    beside it and the 2D 'batch' step;
21. ``multigpu_phase``, the port's multi-GPU path (``parallel/``) with
    the headline UNet (bf16, random norms) at bench.py's global batch of
    8 of (44, 88, 88): (a) one NCCL rank on the card (world 1, so each
    collective is an identity): ``Trainer(mesh=make_mesh())`` takes 3
    SGD steps from a saved state between two no-mesh Trainers from the
    same state (each loss, parameter and running statistic of the mesh run as
    near the first no-mesh run as the second is, times 3, plus 1e-3 of
    its max, at least 1e-5: the kernels' atomic sums vary from run to
    run, and a conv bias that feeds a batch norm starts at 0 and moves
    by their rounding alone), and
    ``Predictor(mesh=..., shard_mode='tiles')`` and ``'spatial'`` (H over
    a 'space' axis, halo 32) each serve the seeded volume within 1e-2 of
    the unsharded request; (b) two gloo ranks sharing the card
    (``parallel.launch``, processes of their own), batch 4 each, rank
    1's rows 3 x + 1 of rank 0's draw (each rank's own batch statistics
    far from the global ones): one ``train_step(mesh=...)`` held against
    the one-process batch-8 step within ``check_train_step``'s bf16
    bounds (the moved-input noise of the one-process step), the
    parameters after it the same bits on both ranks, K1, K4 and K5
    launched on both, and a control step with the norm sites blind to
    the statistics group (per-rank statistics) that must fail the same
    check; a 'tiles' request against
    the unsharded one (1e-2) and a 'spatial' one (H over the two ranks,
    halo 32) against it on the voxels whose receptive field (probed on
    a narrow copy of the architecture) lies inside shard + halo, the
    error elsewhere printed; then on both ranks the dry run's fsdp leg
    (``parallel.dryrun.fsdp_step``: each large kernel split over the two
    ranks on its output channels, JAX's ``_fsdp_spec``, gathered whole
    for the forward) from the same state on the same rows, one SGD step
    of rate 1, so that the whole parameters before less after are the
    step's gradient: held against the one-process step by the same
    bounds, each sharded leaf half its size, K1, K4 and K5 launched.
    Each sub-phase's wall seconds, the backend and the world size are
    printed.

Each time is a mean from CUDA events after a warm-up, over at least 3
calls and as many as fill 20 ms (at most 100). K1 over the network
input (one input of 1 to 4 channels) runs row 3's kernel
(``csrc/conv1_fwd.cu``), whose variants the JSON line lists as
``conv1_fwd`` and whose launches each path counts beside K1's (every
bf16 K1 launch of a path on the tensor-core body or row 3's kernel, row
3's once a step or model call where L0 runs the kernels). Each K1, K3,
K4, K5, K7, row 13, ``upconv_stats_bwd`` and ``conv_vup_wgrad`` line
also names the body that ran (``body``: the tensor-core bodies
``csrc/conv_tc.cu``, ``csrc/upconv_tc.cu``, ``csrc/dgrad_tc.cu``,
``csrc/wgrad_tc.cu`` (K5, and ``conv_vup_wgrad`` with the upconv
recomputed per tile), ``csrc/upconv_bwd_tc.cu`` and
``csrc/upconv_stats_bwd_tc.cu`` for bfloat16, the CUDA-core bodies for
float32, ``csrc/conv1_fwd.cu`` for the network input's forward and
``csrc/conv1_bwd.cu`` for its backward), as
do the JSON line's ``variants``; each serving and training path prints
its launches by body (every bf16 K4 launch on ``tc``, row 13's kernel
once a step on every training path whose L0 runs the kernels).

Every timed variant also prints its bound, the least time the card
could take for its work: the larger of its operations over the card's
peak rate for their type (bf16 products at 989 TFLOP/s; the pool's
float32 compare and prologue at 67 TFLOP/s) and its bytes (each input
read once, each output written once, as the call takes and returns
them) over 3.35 TB/s, the published H100 SXM figures at 700 W. And, for
bfloat16, the time of the library call (cuDNN through torch, on
channels-last tensors; a 2D op on a D=1 view) that computes the same
function, or, where the kernel fuses a prologue or a statistics
epilogue that no single call has, the library op on the
already-prologued input ("lib*" in the line; K6 with the skip's
cotangent: the pool's backward plus the add of the two gradients).

22. ``zoo_phase``, the model zoo (ROADMAP Queue 1 item 8; no hand-written
    kernel: cuDNN, cuBLAS and ATen, so its paths' launch counts are 0):
    VNet(fac=1), UNet3dLite, fcn8s, FCN8s (vgg16), FCDenseNet103, MSDNet
    (40 layers, 3D) and StackedConv2Scalar, each at full width: a
    Predictor request (UNet3dLite's tiled over (1, 1, 64, 512, 512) with
    its valid-conv offset; the classifier's an eval forward), 3 + 10 bf16
    Adam steps (CEDiceLoss, cross entropy for the classifier; step ms,
    MVox/s or MPix/s, peak MB), and one float32 step on the card held
    against the same step on the CPU from the same weights (loss and
    logits within 1e-4, gradients per ``_zoo_hold``: 1e-3 of a leaf
    plus the card's own noise and 1e-4 of the whole gradient); then WSConv,
    EvoNorm B0/S0, the L1 norms and GatherExcite forward and backward at
    (8, 44, 88, 88, 32) against the CPU, and the reversible
    AxialImageTransformer(64, depth 6, 8 heads) on batch 8 of (64, 64)
    against plain autograd through its blocks: gradients within 1e-3,
    peak memory lower.

23. ROADMAP Queue 1 item 9, through the new trainers at full width
    (each phase: the UNet's level plan; the launches of each timed step,
    the same in every step and exactly the kernels the plan implies;
    step ms, MVox/s or MPix/s, peak MB; one step's gradients against the
    plain path by ``check_train_step``): ``n2v_phase``, the
    Noise2Void UNet of examples/train_noise2void.py (n_blocks=3,
    start_filts=32, bf16) at batch 4 of (32, 64, 64) and ratio 0.002,
    fed by ``KnossosRawData`` ('in_memory') over a seeded uint8 stand-in
    of a (128, 512, 512) KNOSSOS dataset (``CubeKD``), checked with the
    masked MSE of a fixed mask; ``trainer_multi_phase``, the headline
    UNet at bench.py's batch 8 as ``optimizer_iterations=2``
    micro-batches of 4 with ``loss_crop`` (2, 8, 8) and a ``cube_meta``
    weight, checked on both micro-batches' accumulated gradients;
    ``triplet_phase``, the 2D UNet on 8 triplets of (640, 640), three
    forwards a step through rows 16/17 and 19/20, its running
    statistics against three training forwards of a copy, checked on
    the three-forward loss; ``gnn_phase``, GCN, SAGE and GAT on a
    Cora-sized graph, the multi-graph trainer on 64 graphs of about
    1000 nodes and the minibatch trainer on an ogbn-arxiv-sized graph
    (1024 seeds, fanout (10, 5); its host sampling share printed), each
    with one float32 step on the card against the CPU's (GNN_TOL) and
    no hand-written kernel launched; and ``config_phase``, a
    ``TrainingConfig`` of the headline UNet through JSON and
    ``build_trainer(worker_type='thread')``, two ``Trainer.run`` steps
    on K1-K7, ``sync_overhead_s`` and ``device_memory_stats``.

24. ``export_phase``, the deployment artifact (ROADMAP Queue 1 item 10,
    JAX's ``export_stablehlo``): the headline UNet (bf16, random norms)
    and its ``'batchp'`` twin, each exported by
    ``training.export_program`` at one float32 Predictor input tile
    (1, 128, 256, 256, 1) (the library plan; K9 as the node
    ``e3tpu.bn_normalize`` under 'batchp'), the seconds of the export
    with its save and of the load, and the file's MB printed; the 'batchp' program loaded in a
    new interpreter that imports ``torch`` and ``ops.pallas_bn`` alone
    (no ``models``, ``training`` or ``inference`` module loaded), its
    output on a seeded tile the same bits as this process's; a
    ``Predictor("<file>.pt2")`` request (tile (64, 128, 128), overlap
    (32, 64, 64), batch 1) on step 7's volume against the model's own
    request on the kernel plan (5e-2, bf16) and against the
    ``pallas_flat=False`` model's (``EXPORT_TOL``), with K9 launched
    exactly once per 'batchp' norm and program call and no other kernel,
    both requests' MVox/s printed; then ``Trainer.run`` of the headline
    UNet with ``example_input`` writes ``model_final.pt2``, which a
    Predictor loads and serves against the trained model's library plan
    (``EXPORT_TOL``).

``--profile`` also profiles three kernel-path training steps of each
model (the 'batchp' one too, and its ``pallas_flat=False`` step at batch
2) with ``torch.profiler`` and prints the
device time by kernel.

Any failed check raises, and the script exits non-zero. The last lines
are a JSON object with each kernel's numbers (``ms``, ``plain_ms``,
``bound_ms`` and ``library_ms`` sum the bfloat16 variants that
``totals_over`` names; ``variants`` lists every
variant's own numbers; ``launches`` sums the paths whose
counts ``launches_by_path`` gives, ``launches_by_body`` the serving and
training paths' by body; the vup entries launch on the vup paths
alone), the card's name and power limit, then
``{"ok": true, "device": {...}}``.
"""

import collections
import contextlib
import copy
import functools
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

TILE = (128, 256, 256)             # one Predictor input tile (D, H, W)
L1 = (128, 128, 128)               # its level 1
L2 = (64, 64, 64)                  # its level 2 (the up_1 upconv input)
BATCH = 8                          # bench.py's training step
PATCH = (44, 88, 88)               # its L0
TL1 = (44, 44, 44)
TL2 = (22, 22, 22)
ODD_L1 = (45, 88, 88)              # an odd L1 depth: L1 declines
L3 = (32, 32, 32)                  # the Predictor tile's level 3
IMAGE = (640, 640)                 # the 2D model's training image
P0, P1, P2, P3 = ((1, 640, 640), (1, 320, 320), (1, 160, 160),
                  (1, 80, 80))     # its levels on the D=1 view
WARMUP, STEPS, N_BATCHES = 3, 20, 5
# The plain versions' steps (10 to 20 times the kernels') are a yardstick,
# not a metric: timed over fewer steps.
PLAIN_WARMUP, PLAIN_STEPS = 1, 3
CROSSOVER_PAIRS = 5                # timed request pairs, kernels / library
# check_train_step: a gradient leaf may differ from the reference step's
# by this many times the reference step's own difference under a one-ulp
# input change (the noise), plus a relative term. On an H100 the leaves
# whose bound the noise sets differ by up to about 2.4 times the noise in
# float32 and 0.8 times in bfloat16 (PERF.md gives the readings).
NOISE_FACTOR = 3
# K8's and K10's float32 sums against their plain versions: within this
# share of max|ref|. On an H100 they differ by up to about 2e-6 of it
# (summing order; x with mean 3, R up to 2.7M), and dropping a ragged
# last block of 69 rows out of 85,221 moves K8's sums by about 8e-4.
BN_SUM_TOL = 1e-5
# Published H100 SXM peaks (NVIDIA data sheet, dense, 700 W).
PEAK_BF16 = 989e12                 # FLOP/s, tensor cores
PEAK_F32 = 67e12                   # FLOP/s, outside the tensor cores
HBM = 3.35e12                      # bytes/s
_F = "elektronn3_tpu/ops/flat_fused.py"
_F64 = "elektronn3_tpu/ops/flat_fused64.py"
_BN = "elektronn3_tpu/ops/pallas_bn.py"
_FC = "elektronn3_tpu/ops/flat_conv.py"
_PC = "elektronn3_tpu/ops/pallas_conv.py"
SOURCES = {
    "conv_bnact": ("elektronn3_tpu_torch/csrc/conv_tc.cu",
                   f"{_F}:689 conv_bnact_flat; {_F64}:1087 "
                   f"conv3_bnact_flat64; {_FC}:479 flat_conv3 (:319); {_PC}"
                   ":109 conv_direct (:150)"),
    # K1's 'conv1' body, counted as K1's launches on that body.
    "conv1_fwd": ("elektronn3_tpu_torch/csrc/conv1_fwd.cu",
                  f"{_F}:2020 conv1_bnstats_flat (row 3, its pallas_call "
                  f":2051; and the one-channel conv1 of {_F64}:1087 "
                  "conv3_bnact_flat64, cin_real=1)"),
    "pool_bnact": ("elektronn3_tpu_torch/csrc/pool_bnact.cu",
                   f"{_F}:1454 pool_bnact_flat_skip; {_F64}:1597 "
                   f"pool222_bnact_flat64_skip; {_F64}:1805 "
                   f"pool122_bnact_flat64_skip ({_F64}:1682 "
                   "pool122_bnact_flat64)"),
    "upconv_bnact": ("elektronn3_tpu_torch/csrc/upconv_tc.cu",
                     f"{_F64}:1977 upconv222_bn_flat64; {_F64}:2657 "
                     f"upconv122_from_flat64; {_F64}:2281 "
                     f"upconv122_bn_flat64; {_F64}:3374 upconv222_f64in; "
                     f"{_F64}:3385 upconv122_f64in; {_F}:1604 "
                     "upconv_bn_flat"),
    "conv_bnact_dgrad": ("elektronn3_tpu_torch/csrc/dgrad_tc.cu",
                         f"{_F}:742 _conv_bnact_bwd (dgrad); {_F64}:1139 "
                         f"_conv64_bwd (dgrad); {_FC}:502 _flat_conv3_bwd "
                         "(dgrad, :319)"),
    "conv_bnact_wgrad": ("elektronn3_tpu_torch/csrc/wgrad_tc.cu",
                         f"{_F}:742 _conv_bnact_bwd (wgrad); {_F64}:1139 "
                         f"_conv64_bwd (wgrad); {_FC}:386 _wgrad (:412)"),
    "conv1_bwd": ("elektronn3_tpu_torch/csrc/conv1_bwd.cu",
                  f"{_F}:2091 _conv1_bwd (row 13, its pallas_call :2126, "
                  "with input_grad its dx; and the one-channel conv1 of "
                  f"{_F64}:1139 _conv64_bwd)"),
    "pool_bnact_bwd": ("elektronn3_tpu_torch/csrc/pool_bnact.cu",
                       f"{_F}:1367 _pool_bwd_impl; {_F64}:1519 "
                       f"_pool64_bwd_impl; {_F64}:1731 _pool122_bwd_impl"),
    "upconv_bnact_bwd": ("elektronn3_tpu_torch/csrc/upconv_bwd_tc.cu",
                         f"{_F64}:2044 _upconv64_bwd; {_F64}:2732 "
                         f"_upconv122_f64_bwd; {_F64}:2347 "
                         f"_upconv122_64_bwd; {_F64}:3393 "
                         f"_upconv_f64in_bwd_call; {_F}:1669 _upconv_bwd"),
    "bn_stats": ("elektronn3_tpu_torch/csrc/batch_norm.cu",
                 f"{_BN}:75 _bn_stats"),
    "bn_normalize": ("elektronn3_tpu_torch/csrc/batch_norm.cu",
                     f"{_BN}:94 _bn_normalize ({_BN}:255 "
                     "batch_norm_inference)"),
    "bn_bwd_reduce": ("elektronn3_tpu_torch/csrc/batch_norm.cu",
                      f"{_BN}:188 _bn_bwd (its pallas_call :199)"),
    "bn_bwd_dx": ("elektronn3_tpu_torch/csrc/batch_norm.cu",
                  f"{_BN}:188 _bn_bwd (its pallas_call :228)"),
    "conv_vup": ("elektronn3_tpu_torch/csrc/conv_tc.cu",
                 f"{_F}:899 conv_bnact_flat_vup (row 1's pallas_call {_F}:415"
                 f" in its vup mode, {_F}:238 _vup_scratch; float32: "
                 "csrc/conv_vup.cu)"),
    "conv_vup_dgrad": ("elektronn3_tpu_torch/csrc/conv_vup_tc.cu",
                       f"{_F}:950 _conv_vup_bwd (row 9, its pallas_call "
                       ":1054): dgrad and the chain into the carry (float32:"
                       " csrc/conv_vup.cu, then csrc/upconv_bnact.cu "
                       "e3_conv_vup_chain)"),
    "conv_vup_wgrad": ("elektronn3_tpu_torch/csrc/wgrad_tc.cu",
                       f"{_F}:950 _conv_vup_bwd (row 9, :1054): the merge "
                       "conv's dW and db (float32: csrc/conv_bnact_bwd.cu)"),
    "upconv_stats": ("elektronn3_tpu_torch/csrc/upconv_stats_bwd_tc.cu",
                     f"{_F64}:2930 upconv122_stats_from_flat64 (row 22, its "
                     "pallas_call :2976; float32: csrc/upconv_bnact.cu)"),
    "upconv_stats_bwd": ("elektronn3_tpu_torch/csrc/upconv_stats_bwd_tc.cu",
                         f"{_F64}:2996 _upconv122_stats_bwd (row 23, its "
                         "pallas_call :3059; float32: csrc/upconv_bnact.cu)"),
}
# K1's, K3's, K4's, K5's and K7's bodies: bf16 runs the tensor-core body
# (``fused.conv_body``, ``fused.upconv_body``, ``fused.dgrad_body``,
# ``fused.wgrad_body``, ``fused.upconv_bwd_body``), float32 the
# CUDA-core body, K1 row 3's kernel (``conv1``, in both dtypes) for the
# network input's one to four channels; its backward is row 13's kernel
# (``conv1``) in both dtypes, with (``conv1+dx``) or without its dx; the
# five vup entries run theirs in bf16 at the vup shapes, all five on one
# recompute of u (``vup.vup_body``).
BODIES = {"conv_bnact": {"tc": "tc (csrc/conv_tc.cu)",
                         "cuda-core": "cuda-core (csrc/conv_bnact.cu)",
                         "conv1": "conv1 (csrc/conv1_fwd.cu)"},
          "conv1_fwd": {"conv1": "conv1 (csrc/conv1_fwd.cu)"},
          "conv_bnact_dgrad": {
              "tc": "tc (csrc/dgrad_tc.cu)",
              "cuda-core": "cuda-core (csrc/conv_bnact_bwd.cu)"},
          "conv1_bwd": {"conv1": "conv1 (csrc/conv1_bwd.cu)",
                        "conv1+dx": "conv1+dx (csrc/conv1_bwd.cu)"},
          "upconv_bnact": {"tc": "tc (csrc/upconv_tc.cu)",
                           "cuda-core": "cuda-core (csrc/upconv_bnact.cu)"},
          "conv_bnact_wgrad": {
              "tc": "tc (csrc/wgrad_tc.cu)",
              "cuda-core": "cuda-core (csrc/conv_bnact_bwd.cu)"},
          "upconv_bnact_bwd": {
              "tc": "tc (csrc/upconv_bwd_tc.cu)",
              "cuda-core": "cuda-core (csrc/upconv_bnact.cu)"},
          "upconv_stats_bwd": {
              "tc": "tc (csrc/upconv_stats_bwd_tc.cu)",
              "cuda-core": "cuda-core (csrc/upconv_bnact.cu)"},
          "conv_vup_wgrad": {
              "tc": "tc (csrc/wgrad_tc.cu)",
              "cuda-core": "cuda-core (csrc/conv_bnact_bwd.cu)"},
          "conv_vup": {"tc": "tc (csrc/conv_tc.cu)",
                       "cuda-core": "cuda-core (csrc/conv_vup.cu)"},
          "conv_vup_dgrad": {
              "tc": "tc (csrc/conv_vup_tc.cu)",
              "cuda-core": "cuda-core (csrc/conv_vup.cu, then the chain of "
                           "csrc/upconv_bnact.cu)"},
          "upconv_stats": {
              "tc": "tc (csrc/upconv_stats_bwd_tc.cu)",
              "cuda-core": "cuda-core (csrc/upconv_bnact.cu)"}}
# Row 3's kernel is K1's 'conv1' body: its launches are K1's on that
# body, which every path's counts list under "conv1_fwd" beside K1's
# (:func:`launch_counts`).
ROW3 = ("conv_bnact", "conv1")
# K8-K11 run only the 'batchp' norm's library levels; K1-K7 every model's
# kernel levels.
BN_KERNELS = ("bn_stats", "bn_normalize", "bn_bwd_reduce", "bn_bwd_dx")
FUSED_KERNELS = tuple(k for k in SOURCES if k not in BN_KERNELS)
# The vup path's entries launch only on a vup=True model's paths; K1-K7
# on every model's kernel levels.
VUP_KERNELS = ("conv_vup", "conv_vup_dgrad", "conv_vup_wgrad",
               "upconv_stats", "upconv_stats_bwd")
K1_K7 = tuple(k for k in FUSED_KERNELS if k not in VUP_KERNELS)
# The kernel launches that stand for rows of the kernel table in PERF.md
# (as recorded by ``record_shapes``): on the 2D path rows 16, 17, 19 and
# 20, the (1, 2, 2) pool at C=64 and its backward, the (1, 2, 2) upconv
# 128->64 from a dense input (no prologue) and its backward; rows 24 and
# 25, the upconv 128->64 from a carried C=128 activation (with its
# prologue) and its backward, (1, 2, 2) on the sf=64 paths and (2, 2, 2)
# ("24/222") on the headline Predictor; rows 11 and 12, the (1, 2, 2)
# upconv 64->32 from a dense input and its backward, where L1 declines.
ROW_SHAPES = {16: ("pool_bnact", 64, (1, 2, 2)),
              17: ("pool_bnact_bwd", 64, (1, 2, 2)),
              19: ("upconv_bnact", 128, 64, 1, False),
              20: ("upconv_bnact_bwd", 128, 64, 1, False),
              24: ("upconv_bnact", 128, 64, 1, True),
              "24/222": ("upconv_bnact", 128, 64, 2, True),
              25: ("upconv_bnact_bwd", 128, 64, 1, True),
              11: ("upconv_bnact", 64, 32, 1, False),
              12: ("upconv_bnact_bwd", 64, 32, 1, False),
              29: ("bn_stats", 85_184, 128),
              "29/L3": ("bn_stats", 10_648, 256),
              30: ("bn_normalize", 85_184, 128),
              "30/L3": ("bn_normalize", 10_648, 256),
              31: ("bn_bwd_reduce", 85_184, 128),
              "31/L3": ("bn_bwd_reduce", 10_648, 256),
              "31/dx": ("bn_bwd_dx", 85_184, 128),
              "31/dx L3": ("bn_bwd_dx", 10_648, 256),
              "30/tile": ("bn_normalize", 32_768, 256),
              "30/request": ("bn_normalize", 65_536, 256),
              # Rows 26/27: K1, K4 and K5 without a prologue, kd=1, at
              # the silu model's flat L0 conv2 and up_2 merge (and conv2).
              26: ("conv_bnact", (32,), 32, 1, False),
              "26/merge": ("conv_bnact", (32, 32), 32, 1, False),
              "26/dgrad": ("conv_bnact_dgrad", (32,), 32, 1, False),
              "26/dgrad merge": ("conv_bnact_dgrad", (32, 32), 32, 1,
                                 False),
              27: ("conv_bnact_wgrad", (32,), 32, 1, False),
              "27/merge": ("conv_bnact_wgrad", (32, 32), 32, 1, False),
              # Rows 1 (vup mode), 9, 22, 23: the vup entries by the
              # carry's shape, at bench.py's up_2 and the Predictor's.
              "1/vup": ("conv_vup", (BATCH, *TL1, 64)),
              9: ("conv_vup_dgrad", (BATCH, *TL1, 64)),
              "9/wgrad": ("conv_vup_wgrad", (BATCH, *TL1, 64)),
              22: ("upconv_stats", (BATCH, *TL1, 64)),
              23: ("upconv_stats_bwd", (BATCH, *TL1, 64)),
              "1/vup tile": ("conv_vup", (1, *L1, 64)),
              "1/vup request": ("conv_vup", (2, *L1, 64))}
# The group model's Predictor (the headline request; under the C=128 gate
# the tile's L2 runs the kernels): the per-sample launches by row.
GROUP_SERVE_SHAPES = {
    "3/ps": ("conv_bnact", (1,), 32, 1, False),
    "1/ps": ("conv_bnact", (32,), 32, 1, True),
    "1/ps merge": ("conv_bnact", (32, 32), 32, 1, True),
    "2/ps": ("pool_bnact", 32, (1, 2, 2)),
    "4/ps L1 conv1": ("conv_bnact", (32,), 64, 3, False),
    "4/ps": ("conv_bnact", (64,), 64, 3, True),
    "4/ps merge": ("conv_bnact", (64, 64), 64, 3, True),
    "4/ps C=128": ("conv_bnact", (128,), 128, 3, True),
    "5/ps": ("pool_bnact", 64, (2, 2, 2)),
    "5/ps C=128": ("pool_bnact", 128, (2, 2, 2)),
    "6/ps": ("upconv_bnact", 256, 128, 2, False),
    "24/222 ps": ("upconv_bnact", 128, 64, 2, True),
    "7/ps": ("upconv_bnact", 64, 32, 1, True)}
# The group model's training step at bench.py's shapes (L2 under the
# C=128 gate): the per-sample launches of the backward kernels by row.
GROUP_TRAIN_SHAPES = {
    "13/ps": ("conv1_bwd", (1,), 32, 1, False),
    "8/ps dgrad": ("conv_bnact_dgrad", (32,), 32, 1, True),
    "8/ps wgrad": ("conv_bnact_wgrad", (32,), 32, 1, True),
    "8/ps merge dgrad": ("conv_bnact_dgrad", (32, 32), 32, 1, True),
    "8/ps merge wgrad": ("conv_bnact_wgrad", (32, 32), 32, 1, True),
    "14/ps L1 conv1 dgrad": ("conv_bnact_dgrad", (32,), 64, 3, False),
    "14/ps L1 conv1 wgrad": ("conv_bnact_wgrad", (32,), 64, 3, False),
    "14/ps dgrad": ("conv_bnact_dgrad", (64,), 64, 3, True),
    "14/ps wgrad": ("conv_bnact_wgrad", (64,), 64, 3, True),
    "14/ps merge dgrad": ("conv_bnact_dgrad", (64, 64), 64, 3, True),
    "14/ps merge wgrad": ("conv_bnact_wgrad", (64, 64), 64, 3, True),
    "10/ps": ("pool_bnact_bwd", 32, (1, 2, 2)),
    "15/ps": ("pool_bnact_bwd", 64, (2, 2, 2)),
    "18/ps": ("upconv_bnact_bwd", 128, 64, 2, False),
    "21/ps": ("upconv_bnact_bwd", 64, 32, 1, True)}
# The 2D group model (rows 16, 17, 19, 20 per sample) and the group vup
# model (rows 1-vup, 9, 22, 23 per sample, by the carry's shape).
GROUP_2D_SHAPES = {"16/ps": ROW_SHAPES[16], "17/ps": ROW_SHAPES[17],
                   "19/ps": ROW_SHAPES[19], "20/ps": ROW_SHAPES[20]}
GROUP_VUP_TRAIN_SHAPES = {f"{r}/ps": ROW_SHAPES[r]
                          for r in ("1/vup", 9, "9/wgrad", 22, 23)}
GROUP_VUP_SERVE_SHAPES = {"1/vup request ps": ("conv_vup", (2, *L1, 64)),
                          "22/request ps": ("upconv_stats", (2, *L1, 64))}
ROW_SHAPES.update({r: ("per_sample",) + k for r, k in
                   {**GROUP_SERVE_SHAPES, **GROUP_TRAIN_SHAPES,
                    **GROUP_2D_SHAPES, **GROUP_VUP_TRAIN_SHAPES,
                    **GROUP_VUP_SERVE_SHAPES}.items()})
GROUP_SERVE_ROWS = tuple(GROUP_SERVE_SHAPES)
GROUP_TRAIN_ROWS = tuple(GROUP_TRAIN_SHAPES)
GROUP_2D_SERVE_ROWS = ("16/ps", "19/ps")
GROUP_2D_TRAIN_ROWS = tuple(GROUP_2D_SHAPES)
GROUP_VUP_SERVE_ROWS = tuple(GROUP_VUP_SERVE_SHAPES)
GROUP_VUP_TRAIN_ROWS = tuple(GROUP_VUP_TRAIN_SHAPES)
VUP_TRAIN_ROWS = ("1/vup", 9, "9/wgrad", 22, 23)
VUP_SERVE_ROWS = ("1/vup tile", "1/vup request")
FLAT_SERVE_ROWS = (26, "26/merge")
FLAT_TRAIN_ROWS = (26, "26/merge", "26/dgrad", "26/dgrad merge", 27,
                   "27/merge")
# The silu model's flat levels: K1, K4 and K5 three times a training step
# (L0 conv2, the up_2 merge, up_2 conv2), K1 three times a model call in
# serving, and no other of K1-K7.
FLAT_KERNELS = ("conv_bnact", "conv_bnact_dgrad", "conv_bnact_wgrad")
# The 'batchp' headline model's rows (K8-K11 at (R, C)): its training
# step's library levels L2 (8 x 22^3 = 85,184 voxels, C=128, under the
# C=128 gate; two norms), up_0 (the same; three) and the bottom L3 (8 x
# 11^3 = 10,648, C=256; two); in serving the Predictor tile's L3 (32^3
# a tile: 32,768 for the forward check's one tile, 65,536 for the
# request's batch of 2).
BATCHP_TRAIN_ROWS = (29, "29/L3", 30, "30/L3", 31, "31/L3", "31/dx",
                     "31/dx L3")
BATCHP_SERVE_ROWS = ("30/tile", "30/request")
# The 'batchp' pallas_flat=False step (batchp_library_phase, batch 2 of
# (44, 88, 88)): every level's norms on K8-K11, at L0 (681,472 voxels,
# C=32) and up_2, L1 (170,368, 64) and up_1, L2 (21,296, 128) and up_0,
# and the bottom L3 (2,662, 256).
BATCHP_LIBRARY_SHAPES = {"L0": (681_472, 32), "L1": (170_368, 64),
                         "L2": (21_296, 128), "L3": (2_662, 256)}
_BN_ROW = {"bn_stats": "29", "bn_normalize": "30", "bn_bwd_reduce": "31",
           "bn_bwd_dx": "31/dx"}
BATCHP_LIBRARY_ROWS = tuple(f"{_BN_ROW[k]} lib {lvl}" for k in BN_KERNELS
                            for lvl in BATCHP_LIBRARY_SHAPES)
ROW_SHAPES.update({f"{_BN_ROW[k]} lib {lvl}": (k, *rc) for k in BN_KERNELS
                   for lvl, rc in BATCHP_LIBRARY_SHAPES.items()})
# The variants each kernel's totals in the JSON line sum (bfloat16): the
# forward kernels' serving variants at the 3D Predictor tile, the
# backward kernels' at bench.py's 3D training shapes, so that the totals
# stay comparable when variants are added. Every other variant
# (statistics outputs, the training K2 forward, the 2D shapes) is
# printed and listed under ``variants`` only.
_TILE_SERVING = ("bf16 serving variants at the 3D Predictor tile "
                 "(1,128,256,256)")
_BENCH = ("bf16 variants at bench.py's 3D training shapes (batch 8 of "
          "(44,88,88))")
_BN_BENCH = ("bf16 variants at the 'batchp' headline step's library "
             "levels, bench.py's batch 8 of (44,88,88): (R, C) = "
             "(85184, 128) and (10648, 256)")
TOTALS_OVER = {"conv_bnact": _TILE_SERVING, "conv1_fwd": _TILE_SERVING,
               "pool_bnact": _TILE_SERVING,
               "upconv_bnact": _TILE_SERVING, "conv_bnact_dgrad": _BENCH,
               "conv_bnact_wgrad": _BENCH, "conv1_bwd": _BENCH,
               "pool_bnact_bwd": _BENCH,
               "upconv_bnact_bwd": _BENCH, **dict.fromkeys(BN_KERNELS,
                                                           _BN_BENCH),
               "conv_vup": _TILE_SERVING,
               **dict.fromkeys(VUP_KERNELS[1:], _BENCH)}
# Forward variants at the 3D Predictor tile's shapes (batch 1):
# (kind, label, level shape, input channels, C_out, kd / window, prologue)
FWD = {"conv": "conv_bnact", "pool": "pool_bnact", "upconv": "upconv_bnact"}
VARIANTS = [
    ("conv", "L0 conv1 1->32 kd1", TILE, (1,), 32, 1, False),
    ("conv", "L0 conv2 32->32 kd1", TILE, (32,), 32, 1, True),
    ("conv", "up_2 merge 32+32->32 kd1", TILE, (32, 32), 32, 1, True),
    ("conv", "L1 conv1 32->64 kd3", L1, (32,), 64, 3, False),
    ("conv", "L1 conv2 64->64 kd3", L1, (64,), 64, 3, True),
    ("conv", "up_1 merge 64+64->64 kd3", L1, (64, 64), 64, 3, True),
    ("pool", "L0 pool (1,2,2) C=32", TILE, (32,), 32, (1, 2, 2), True),
    ("pool", "L1 pool (2,2,2) C=64", L1, (64,), 64, (2, 2, 2), True),
    ("upconv", "up_1 (2,2,2) 128->64", L2, (128,), 64, 2, False),
    ("upconv", "up_2 (1,2,2) 64->32", L1, (64,), 32, 1, True),
]
# Training variants (batch 8), same fields. A conv variant checks the
# statistics outputs of K1, then K4 (unless its input is the network
# input) and K5; an upconv one the statistics of K3, then K7; a pool one
# K2, then K6. First bench.py's 3D shapes, then the 2D model's.
TRAIN_VARIANTS = [
    ("conv", "L0 conv1 1->32 kd1", PATCH, (1,), 32, 1, False),
    ("conv", "L0 conv2 32->32 kd1", PATCH, (32,), 32, 1, True),
    ("conv", "up_2 merge 32+32->32 kd1", PATCH, (32, 32), 32, 1, True),
    ("conv", "L1 conv1 32->64 kd3", TL1, (32,), 64, 3, True),
    ("conv", "L1 conv2 64->64 kd3", TL1, (64,), 64, 3, True),
    ("conv", "up_1 merge 64+64->64 kd3", TL1, (64, 64), 64, 3, True),
    ("pool", "L0 pool (1,2,2) C=32", PATCH, (32,), 32, (1, 2, 2), True),
    ("pool", "L1 pool (2,2,2) C=64", TL1, (64,), 64, (2, 2, 2), True),
    ("upconv", "up_1 (2,2,2) 128->64", TL2, (128,), 64, 2, False),
    ("upconv", "up_2 (1,2,2) 64->32", TL1, (64,), 32, 1, True),
]
TRAIN_VARIANTS_2D = [
    ("conv", "2D L0 conv1 1->32", P0, (1,), 32, 1, False),
    ("conv", "2D L0 conv2 32->32", P0, (32,), 32, 1, True),
    ("conv", "2D up_2 merge 32+32->32", P0, (32, 32), 32, 1, True),
    ("conv", "2D L1 conv1 32->64", P1, (32,), 64, 1, False),
    ("conv", "2D L1 conv2 64->64", P1, (64,), 64, 1, True),
    ("conv", "2D up_1 merge 64+64->64", P1, (64, 64), 64, 1, True),
    ("pool", "2D L0 pool (1,2,2) C=32", P0, (32,), 32, (1, 2, 2), True),
    ("pool", "2D L1 pool (1,2,2) C=64 [row 16/17]", P1, (64,), 64,
     (1, 2, 2), True),
    ("pool", "2D L2 pool (1,2,2) C=128", P2, (128,), 128, (1, 2, 2), True),
    ("upconv", "2D up_1 (1,2,2) 128->64 dense [row 19/20]", P2, (128,), 64,
     1, False),
    ("upconv", "2D up_0 (1,2,2) 256->128 dense", P3, (256,), 128, 1, False),
    ("upconv", "2D up_2 (1,2,2) 64->32", P1, (64,), 32, 1, True),
]
# The 3D Predictor tile's C=128 level (1, 64, 64, 64), which its input
# tile's 262,144 voxels put on the kernels: serving builds, batch 1.
VARIANTS_TILE_C128 = [
    ("conv", "tile L2 conv1 64->128 kd3", L2, (64,), 128, 3, True),
    ("conv", "tile L2 conv2 128->128 kd3", L2, (128,), 128, 3, True),
    ("conv", "tile up_0 merge 128+128->128 kd3", L2, (128, 128), 128, 3,
     True),
    ("pool", "tile L2 pool (2,2,2) C=128", L2, (128,), 128, (2, 2, 2), True),
    ("upconv", "tile up_0 (2,2,2) 256->128 dense", L3, (256,), 128, 2,
     False),
    ("upconv", "tile up_1 (2,2,2) 128->64 carry [row 24]", L2, (128,), 64,
     2, True),
]
# The start_filts=64 model's levels at the same Predictor input tile,
# serving builds, batch 1: L0 planar (128, 256, 256) x 64, L1 (128, 128,
# 128) x 128, up_1 from L2's dense (64, 64, 64) x 256, up_2 from up_1's
# carried C=128 activation (row 24).
VARIANTS_SF64_TILE = [
    ("conv", "sf64 tile L0 conv1 1->64 kd1", TILE, (1,), 64, 1, False),
    ("conv", "sf64 tile L0 conv2 64->64 kd1", TILE, (64,), 64, 1, True),
    ("conv", "sf64 tile up_2 merge 64+64->64 kd1", TILE, (64, 64), 64, 1,
     True),
    ("conv", "sf64 tile L1 conv1 64->128 kd3", L1, (64,), 128, 3, True),
    ("conv", "sf64 tile L1 conv2 128->128 kd3", L1, (128,), 128, 3, True),
    ("conv", "sf64 tile up_1 merge 128+128->128 kd3", L1, (128, 128), 128,
     3, True),
    ("pool", "sf64 tile L0 pool (1,2,2) C=64", TILE, (64,), 64, (1, 2, 2),
     True),
    ("pool", "sf64 tile L1 pool (2,2,2) C=128", L1, (128,), 128, (2, 2, 2),
     True),
    ("upconv", "sf64 tile up_1 (2,2,2) 256->128 dense", L2, (256,), 128, 2,
     False),
    ("upconv", "sf64 tile up_2 (1,2,2) 128->64 carry [row 24]", L1, (128,),
     64, 1, True),
]
# Row 3's kernel (K1's 'conv1' body) at the 3D Predictor tile beyond the
# model variants' 1->32 and 1->64 at kd=1: a three-channel input
# (``UNet(in_channels=3)``) and kd=3 (a UNet whose L0 is not planar).
VARIANTS_CONV1 = [
    ("conv", "tile L0 conv1 3->32 kd1 [in_channels=3]", TILE, (3,), 32, 1,
     False),
    ("conv", "tile L0 conv1 1->32 kd3 [non-planar L0]", TILE, (1,), 32, 3,
     False),
]
# The per-sample mode (group and instance norm) of the forward kernels on
# the headline group model's serving path, at the 3D Predictor request's
# batch of two tiles and at bench.py's batch 8 (whose up_1 takes L2's
# dense (22, 22, 22): 10,648 voxels a sample, no multiple of K3's 64-voxel
# blocks; and its up_2 from a dense L1, row 11, where L1 declines):
# (kind, label, level shape, input channels, C_out, kd / window,
# prologue, batch). Each variant takes (N, C) prologue vectors (where it
# has a prologue) and returns (N, C_out) statistics (K1, K3); beside it,
# the same kernel's batch form at the same shape with (C,) vectors and
# (C_out,) statistics ("+stats", K2 without statistics) is timed in
# turns with it.
PS_VARIANTS = [
    ("conv", "tile L0 conv1 1->32 kd1 [row 3]", TILE, (1,), 32, 1, False,
     2),
    ("conv", "tile L0 conv2 32->32 kd1 [row 1]", TILE, (32,), 32, 1, True,
     2),
    ("conv", "tile up_2 merge 32+32->32 kd1 [row 1]", TILE, (32, 32), 32, 1,
     True, 2),
    ("conv", "tile L1 conv1 32->64 kd3 [row 4]", L1, (32,), 64, 3, False, 2),
    ("conv", "tile L1 conv2 64->64 kd3 [row 4]", L1, (64,), 64, 3, True, 2),
    ("conv", "tile up_1 merge 64+64->64 kd3 [row 4]", L1, (64, 64), 64, 3,
     True, 2),
    ("conv", "tile L2 conv2 128->128 kd3 [row 4]", L2, (128,), 128, 3, True,
     2),
    ("pool", "tile L0 pool (1,2,2) C=32 [row 2]", TILE, (32,), 32, (1, 2, 2),
     True, 2),
    ("pool", "tile L1 pool (2,2,2) C=64 [row 5]", L1, (64,), 64, (2, 2, 2),
     True, 2),
    ("upconv", "tile up_0 (2,2,2) 256->128 dense [row 6]", L3, (256,), 128,
     2, False, 2),
    ("upconv", "tile up_1 (2,2,2) 128->64 carry [row 24]", L2, (128,), 64, 2,
     True, 2),
    ("upconv", "tile up_2 (1,2,2) 64->32 [row 7]", L1, (64,), 32, 1, True, 2),
    ("conv", "bench L0 conv1 1->32 kd1 [row 3]", PATCH, (1,), 32, 1, False,
     BATCH),
    ("conv", "bench L0 conv2 32->32 kd1 [row 1]", PATCH, (32,), 32, 1, True,
     BATCH),
    ("conv", "bench up_2 merge 32+32->32 kd1 [row 1]", PATCH, (32, 32), 32,
     1, True, BATCH),
    ("conv", "bench L1 conv2 64->64 kd3 [row 4]", TL1, (64,), 64, 3, True,
     BATCH),
    ("conv", "bench up_1 merge 64+64->64 kd3 [row 4]", TL1, (64, 64), 64, 3,
     True, BATCH),
    ("pool", "bench L0 pool (1,2,2) C=32 [row 2]", PATCH, (32,), 32,
     (1, 2, 2), True, BATCH),
    ("pool", "bench L1 pool (2,2,2) C=64 [row 5]", TL1, (64,), 64, (2, 2, 2),
     True, BATCH),
    ("upconv", "bench up_1 (2,2,2) 128->64 from L2 [row 6]", TL2, (128,), 64,
     2, False, BATCH),
    ("upconv", "bench up_2 (1,2,2) 64->32 dense [row 11]", TL1, (64,), 32, 1,
     False, BATCH),
    ("upconv", "bench up_2 (1,2,2) 64->32 [row 7]", TL1, (64,), 32, 1, True,
     BATCH),
    # The 2D model's kernel levels at batch 8 of (640, 640) on the D=1
    # view (its C=128 L2 under the gate: up_1 from L2's dense output).
    ("conv", "2D L0 conv1 1->32 kd1 [row 3]", P0, (1,), 32, 1, False,
     BATCH),
    ("conv", "2D L0 conv2 32->32 kd1 [row 1]", P0, (32,), 32, 1, True,
     BATCH),
    ("conv", "2D up_2 merge 32+32->32 kd1 [row 1]", P0, (32, 32), 32, 1,
     True, BATCH),
    ("conv", "2D L1 conv2 64->64 kd1 [row 4]", P1, (64,), 64, 1, True,
     BATCH),
    ("conv", "2D up_1 merge 64+64->64 kd1 [row 4]", P1, (64, 64), 64, 1,
     True, BATCH),
    ("pool", "2D L1 pool (1,2,2) C=64 [row 16]", P1, (64,), 64, (1, 2, 2),
     True, BATCH),
    ("upconv", "2D up_1 (1,2,2) 128->64 dense [row 19]", P2, (128,), 64, 1,
     False, BATCH),
    ("upconv", "2D up_2 (1,2,2) 64->32 [row 7]", P1, (64,), 32, 1, True,
     BATCH),
]
# The per-sample backward (training group and instance norm) of row 13,
# K4, K5, K6 and K7 at bench.py's training shapes (batch 8), as the
# headline group model's kernel levels run them: (kind, label, level
# shape, input channels, C_out, kd / window, prologue). Each takes (N, C)
# statistics cotangents (the conv and upconv outputs feed a group norm)
# and, with a prologue, (N, C) vectors, and gives (N, C) dinv and dshift;
# in bf16 its batch form at the same shape ((C,) vectors and
# cotangents) is timed in turns with it.
PS_BWD_VARIANTS = [
    ("conv", "bench L0 conv1 1->32 kd1 [row 13]", PATCH, (1,), 32, 1,
     False),
    ("conv", "bench L0 conv2 32->32 kd1 [row 8]", PATCH, (32,), 32, 1, True),
    ("conv", "bench up_2 merge 32+32->32 kd1 [row 8]", PATCH, (32, 32), 32,
     1, True),
    ("conv", "bench L1 conv1 32->64 kd3 [row 14]", TL1, (32,), 64, 3, False),
    ("conv", "bench L1 conv2 64->64 kd3 [row 14]", TL1, (64,), 64, 3, True),
    ("conv", "bench up_1 merge 64+64->64 kd3 [row 14]", TL1, (64, 64), 64,
     3, True),
    ("pool", "bench L0 pool (1,2,2) C=32 +dskip [row 10]", PATCH, (32,), 32,
     (1, 2, 2), True),
    ("pool", "bench L1 pool (2,2,2) C=64 +dskip [row 15]", TL1, (64,), 64,
     (2, 2, 2), True),
    ("upconv", "bench up_1 (2,2,2) 128->64 from L2 [row 18]", TL2, (128,),
     64, 2, False),
    ("upconv", "bench up_2 (1,2,2) 64->32 [row 21]", TL1, (64,), 32, 1,
     True),
    # The 2D model's (batch 8 of (640, 640), the D=1 view).
    ("conv", "2D L0 conv1 1->32 kd1 [row 13]", P0, (1,), 32, 1, False),
    ("conv", "2D L0 conv2 32->32 kd1 [row 8]", P0, (32,), 32, 1, True),
    ("conv", "2D L1 conv2 64->64 kd1 [row 14]", P1, (64,), 64, 1, True),
    ("conv", "2D up_1 merge 64+64->64 kd1 [row 14]", P1, (64, 64), 64, 1,
     True),
    ("pool", "2D L1 pool (1,2,2) C=64 +dskip [row 17]", P1, (64,), 64,
     (1, 2, 2), True),
    ("upconv", "2D up_1 (1,2,2) 128->64 dense [row 20]", P2, (128,), 64, 1,
     False),
]
# Training shapes (batch 8) of rows 11/12 on the headline model (L0's
# decoder upconv from L1's dense output, where L1 declines) and of the
# start_filts=64 model at bench.py's (44, 88, 88): L0 planar C=64, L1
# C=128 kd=3, up_1 from L2's dense C=256 output, up_2 from up_1's
# carried C=128 activation (rows 24/25).
TRAIN_VARIANTS_SF64 = [
    ("upconv", "up_2 (1,2,2) 64->32 dense [row 11/12]", TL1, (64,), 32, 1,
     False),
    ("conv", "sf64 L0 conv1 1->64 kd1", PATCH, (1,), 64, 1, False),
    ("conv", "sf64 L0 conv2 64->64 kd1", PATCH, (64,), 64, 1, True),
    ("conv", "sf64 up_2 merge 64+64->64 kd1", PATCH, (64, 64), 64, 1, True),
    ("pool", "sf64 L0 pool (1,2,2) C=64", PATCH, (64,), 64, (1, 2, 2), True),
    ("conv", "sf64 L1 conv1 64->128 kd3", TL1, (64,), 128, 3, True),
    ("conv", "sf64 L1 conv2 128->128 kd3", TL1, (128,), 128, 3, True),
    ("conv", "sf64 up_1 merge 128+128->128 kd3", TL1, (128, 128), 128, 3,
     True),
    ("pool", "sf64 L1 pool (2,2,2) C=128", TL1, (128,), 128, (2, 2, 2),
     True),
    ("upconv", "sf64 up_1 (2,2,2) 256->128 dense", TL2, (256,), 128, 2,
     False),
    ("upconv", "sf64 up_2 (1,2,2) 128->64 carry [row 24/25]", TL1, (128,),
     64, 1, True),
]
# K8-K11 ('batchp'): (label, R, C, training, in the totals). Training
# variants hold K8, K9, K10 and K11; serving ones K9 alone. The bench
# step's library levels, a ragged R, the pallas_flat=False step's L0 and
# L1 at bench.py's batch 8 and its four levels at the batch of 2 that
# batchp_library_phase runs, the Predictor tile's L3.
BN_VARIANTS = [
    ("bench L2/up_0 (8,22,22,22) C=128", 85_184, 128, True, True),
    ("bench L3 (8,11,11,11) C=256", 10_648, 256, True, True),
    ("ragged R=85,184+37 C=128", 85_221, 128, True, False),
    ("pallas_flat=False L0 (8,44,88,88) C=32", 2_725_888, 32, True, False),
    ("pallas_flat=False L1 (8,44,44,44) C=64", 681_472, 64, True, False),
    *((f"pallas_flat=False {lvl} batch 2 R={r} C={c}", r, c, True, False)
      for lvl, (r, c) in BATCHP_LIBRARY_SHAPES.items()),
    ("tile L3 (1,32,32,32) C=256 serving", 32_768, 256, False, False),
    ("request L3 (2,32,32,32) C=256 serving", 65_536, 256, False, False),
]
# bn_layer_phase: one PallasBatchNorm3d against nn.BatchNorm3d at the
# pallas_flat=False step's four levels at batch 2 (b2) and the 'batchp'
# headline step's library levels (bench.py's batch 8).
BN_LAYER_SHAPES = [("b2 L0", (2, 44, 88, 88, 32)),
                   ("b2 L1", (2, 44, 44, 44, 64)),
                   ("b2 L2", (2, 22, 22, 22, 128)),
                   ("b2 L3", (2, 11, 11, 11, 256)),
                   ("bench L2", (8, 22, 22, 22, 128)),
                   ("bench L3", (8, 11, 11, 11, 256))]
# Rows 26/27 (the silu model's flat executor: K1 with the identity
# prologue) at the 3D Predictor tile, serving builds, batch 1, and at
# bench.py's training shapes: K1 with statistics and as served, K4 (row
# 26's dgrad) and K5 (row 27).
VARIANTS_FLAT_TILE = [
    ("conv", "flat tile L0 conv2 32->32 kd1 [row 26]", TILE, (32,), 32, 1,
     False),
    ("conv", "flat tile up_2 merge 32+32->32 kd1 [row 26]", TILE, (32, 32),
     32, 1, False),
]
TRAIN_VARIANTS_FLAT = [
    ("conv", "flat L0 conv2 32->32 kd1 [rows 26/27]", PATCH, (32,), 32, 1,
     False),
    ("conv", "flat up_2 merge 32+32->32 kd1 [rows 26/27]", PATCH, (32, 32),
     32, 1, False),
]
# Row 28: conv_direct at benchmark/conv_microbench.py's CASES (name,
# (B, D, H, W), C_in, C_out, planar).
CONV_DIRECT_CASES = [
    ("L0 conv2 planar 32->32", (8, 44, 88, 88), 32, 32, True),
    ("L0up planar 64->32", (8, 44, 88, 88), 64, 32, True),
    ("L1 conv 64->64", (8, 22, 44, 44), 64, 64, False),
    ("L1up conv 128->64", (8, 22, 44, 44), 128, 64, False),
    ("L2 conv 128->128", (8, 11, 22, 22), 128, 128, False),
]
STEP_MS = {}   # train_phase's step times by model: (kernels, plain, again)
PREDICTED = {}  # predictor_phase's bf16 probabilities and MVox/s by model
# The serving and training paths' launches by (kernel, body), by path.
BODY_LAUNCHES = {}


PHASE_S = {}   # main's phases' wall seconds, for the run's time budget
_MARK = [0.0]


def mark(name):
    """Record the wall seconds since the last mark as phase ``name``."""
    torch.cuda.synchronize()
    now = time.perf_counter()
    PHASE_S[name] = round(now - _MARK[0], 1)
    _MARK[0] = now


def cuda_ms(fn, reps=3, min_ms=15.0):
    """Mean device time of ``fn`` from CUDA events, after one warm-up,
    over ``reps`` calls or as many more (at most 100) as fill ``min_ms``
    at the time one call takes: a few calls of a 0.2 ms op read a
    launch's start-up, not the op."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    fn()
    t1.record()
    torch.cuda.synchronize()
    n = max(reps, min(100, int(min_ms / max(t0.elapsed_time(t1), 1e-3))))
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def nbytes(*ts):
    """Bytes of the tensors in ``ts`` (nested lists and tuples; anything
    else skipped)."""
    total = 0
    for t in ts:
        if isinstance(t, (list, tuple)):
            total += nbytes(*t)
        elif isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def bound(flops, peak, *tensors):
    """(ms, 'operations' or 'bytes'): the least time of ``flops`` at
    ``peak`` and of moving ``tensors`` (the call's inputs and outputs)
    once at the memory rate, and which of the two binds."""
    t_ops = flops / peak * 1e3
    t_mem = nbytes(*tensors) / HBM * 1e3
    return (t_ops, "operations") if t_ops > t_mem else (t_mem, "bytes")


def lib_input(xs, inv, shift, act):
    """The library ops' input (bf16): the concat of ``xs``, prologued
    when ``inv`` is given, as a channels-first view of its
    channels-last memory; 2D (N, C, H, W) when D = 1."""
    from elektronn3_tpu_torch.ops.fused import prologue
    x = torch.cat(xs, -1) if len(xs) > 1 else xs[0]
    if inv is not None:
        x = prologue(x, inv, shift, act).to(x.dtype)
    return lib_view(x)


def lib_view(x):
    """A channels-last (N, D, H, W, C) tensor as a channels-first view
    (a channels_last memory format): (N, C, H, W) when D = 1."""
    if x.shape[1] == 1:
        return x[:, 0].permute(0, 3, 1, 2)
    return x.permute(0, 4, 1, 2, 3)


def library_calls(kind, a, w, b, kdw, dyv=None):
    """The library calls (cuDNN through torch, bf16) beside a variant of
    ``kind`` on the input view ``a`` (see :func:`lib_input`), by the
    kernel each stands beside: the forward op and, given the output
    cotangent's view ``dyv``, the backward ops. A transposed conv's
    backward is two calls: its input gradient is the strided conv of dy
    with the same weight, its weight gradient that conv's weight
    gradient."""
    two_d = a.dim() == 4
    grad = torch.nn.grad
    if kind == "pool":
        win = tuple(kdw[1:]) if two_d else tuple(kdw)
        pool = F.max_pool2d if two_d else F.max_pool3d
        calls = {"pool_bnact": lambda: pool(a, win, win)}
        if dyv is not None:
            back = (torch.ops.aten.max_pool2d_with_indices_backward if two_d
                    else torch.ops.aten.max_pool3d_with_indices_backward)
            idx = pool(a, win, win, return_indices=True)[1]
            n = len(win)
            calls["pool_bnact_bwd"] = lambda: back(
                dyv, a, list(win), list(win), [0] * n, [1] * n, False, idx)
        return calls
    wq = w.to(torch.bfloat16)
    wq = wq[:, :, 0] if two_d else wq
    bq = b.to(torch.bfloat16)
    conv = F.conv2d if two_d else F.conv3d
    conv_weight = grad.conv2d_weight if two_d else grad.conv3d_weight
    if kind == "conv":
        pad = 1 if two_d else (kdw // 2, 1, 1)
        conv_input = grad.conv2d_input if two_d else grad.conv3d_input
        return {"conv_bnact": lambda: conv(a, wq, bq, padding=pad),
                "conv_bnact_dgrad": lambda: conv_input(a.shape, wq, dyv,
                                                       padding=pad),
                "conv_bnact_wgrad": lambda: conv_weight(a, wq.shape, dyv,
                                                        padding=pad)}
    stride = 2 if two_d else (kdw, 2, 2)
    convt = F.conv_transpose2d if two_d else F.conv_transpose3d
    return {"upconv_bnact": lambda: convt(a, wq, bq, stride=stride),
            "upconv_bnact_bwd": lambda: (
                conv(dyv, wq, stride=stride),
                conv_weight(dyv, wq.shape, a, stride=stride))}


def bf16_ulp(r):
    _, e = torch.frexp(r)
    return torch.ldexp(torch.ones_like(r), e - 8)


def check_close(got, ref, dtype, what):
    """Elementwise: bf16 |got - ref| <= 1e-2 max|ref| + one bf16 ulp of
    ref (the one rounding after sums taken in another order); float32
    <= 1e-4 max|ref|. Returns the max abs error."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    scale = float(ref.abs().max())
    if dtype == torch.bfloat16:
        bound_ = 1e-2 * scale + bf16_ulp(ref)
    else:
        bound_ = torch.full_like(ref, 1e-4 * scale)
    if not bool(torch.isfinite(got).all()) or not bool((err <= bound_).all()):
        raise AssertionError(f"{what}: max abs err {float(err.max())} "
                             f"over bound (max|ref| {scale})")
    return float(err.max())


def check_sum(got, ref, what, tol=1e-3):
    """A float32 sum over voxels (statistics, dinv, dshift, dW, db), the
    same terms summed in another order: |got - ref| <= tol max|ref|.
    Returns the max abs error."""
    got, ref = got.float(), ref.float()
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    if not bool(torch.isfinite(got).all()) or err > tol * scale:
        raise AssertionError(f"{what}: max abs err {err} over {tol} x "
                             f"max|ref| {scale}")
    return err


def rand_on_card(seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*s, scale=1.0):
        return scale * torch.randn(*s, generator=g, device="cuda")
    return rnd


class Stats:
    """Every timed variant's numbers, by kernel."""

    def __init__(self):
        self.rows = {name: [] for name in SOURCES}

    def add(self, kernel, label, dtype, err, ms, plain_ms, bnd, lib,
            lib_exact, total=False, lib_op=None, body=None, device=None):
        """One variant: ``bnd`` is :func:`bound`'s (ms, term); ``lib``
        the library time (bf16 only, else None), ``lib_exact`` whether
        that call computes the kernel's whole function (True) or not
        (False), ``lib_op`` what the call is (by default "same function"
        or "op without prologue/statistics"); ``total`` whether a bf16
        variant counts in the kernel's totals (see :meth:`totals`);
        ``body`` which of K1's, K3's, K5's, K7's, row 23's or
        ``conv_vup_wgrad``'s bodies ran (:data:`BODIES`); ``device`` the
        device time from torch.profiler (K8 and K10; ``ms`` is then the
        per-call time of back-to-back calls), printed and kept beside
        ``ms``."""
        b_ms, b_by = bnd
        bf16 = dtype == torch.bfloat16
        if lib_op is None:
            lib_op = ("same function" if lib_exact
                      else "op without prologue/statistics")
        self.rows[kernel].append(dict(
            label=label, dtype=str(dtype)[6:], max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib, library_op=lib_op if bf16 else None,
            in_total=total and bf16,
            **({"body": BODIES[kernel][body]} if body else {}),
            **({"device_ms": device} if device is not None else {})))
        libs = f"  lib{'' if lib_exact else '*'} {lib:8.3f} ms" if bf16 \
            else ""
        print(f"kernel {kernel:16s} {label:42s} {str(dtype)[6:]:8s} "
              f"err {err:.3e} {ms:9.3f} ms  plain {plain_ms:9.3f} ms  "
              f"bound {b_ms:8.3f} ms ({b_by[:3]}, {b_ms / ms:6.1%})" + libs
              + (f"  body {body}" if body else "")
              + (f"  device {device:8.4f} ms ({b_ms / device:6.1%})"
                 if device is not None else ""), flush=True)

    def totals(self, kernel):
        """The JSON line's numbers for ``kernel``: ``ms``, ``plain_ms``,
        ``library_ms`` and ``bound_ms`` sum the bfloat16 variants of
        TOTALS_OVER[kernel] (the variants added with ``total``), and
        ``bound_by`` names the term that binds the larger part of that
        bound; ``max_abs_err`` is the largest over every variant, and
        ``variants`` holds every variant's own numbers."""
        rows = [r for r in self.rows[kernel] if r["in_total"]]
        by = {"bytes": 0.0, "operations": 0.0}
        for r in rows:
            by[r["bound_by"]] += r["bound_ms"]
        return dict(
            max_abs_err=max(r["max_abs_err"] for r in self.rows[kernel]),
            ms=sum(r["ms"] for r in rows),
            plain_ms=sum(r["plain_ms"] for r in rows),
            bound_ms=sum(by.values()), bound_by=max(by, key=by.get),
            library_ms=sum(r["library_ms"] for r in rows),
            totals_over=TOTALS_OVER[kernel], variants=self.rows[kernel])


def stat_name(kernel, body):
    """The JSON line's kernel of a launch of ``kernel`` on ``body``: K1's
    'conv1' body is row 3's kernel, ``conv1_fwd``."""
    return "conv1_fwd" if (kernel, body) == ROW3 else kernel


def launch_counts(fused):
    """The launches counted since the last reset, by kernel, with row 3's
    (K1's on its 'conv1' body) under ``conv1_fwd``."""
    return {**fused.LAUNCHES,
            "conv1_fwd": fused.BODY_LAUNCHES.get(ROW3, 0)}


def check_k1_bodies(launches, bodies, what, per=None):
    """Every (bf16) K1 launch of a path on its tensor-core body or row 3's
    kernel, none on the CUDA-core body; with ``per``, row 3's kernel
    exactly ``per`` times (once a model call or a step where L0 runs the
    kernels)."""
    conv1 = bodies.get(ROW3, 0)
    if bodies.get(("conv_bnact", "cuda-core"), 0) or \
            bodies.get(("conv_bnact", "tc"), 0) + conv1 != \
            launches["conv_bnact"]:
        raise AssertionError(f"{what}: K1 bodies {bodies}")
    if per is not None and conv1 != per:
        raise AssertionError(f"{what}: row 3's kernel {conv1} times, "
                             f"expected {per}")


def fwd_body(fused, kind, dtype, cins):
    """The body K1 or K3 runs for these inputs (``fused.conv_body`` or
    ``fused.upconv_body``), or None for the pool."""
    if kind == "conv":
        return fused.conv_body(dtype, cins)
    return fused.upconv_body(dtype) if kind == "upconv" else None


def bwd_body(fused, name, dtype, cins, label=""):
    """The body K4, K5, K7 or row 13's kernel runs for these inputs
    (``fused.dgrad_body``, ``fused.wgrad_body``, ``fused.upconv_bwd_body``;
    ``label`` says whether row 13's computes dx), or None for K6."""
    if name == "conv_bnact_dgrad":
        return fused.dgrad_body(dtype)
    if name == "conv_bnact_wgrad":
        return fused.wgrad_body(dtype, cins)
    if name == "conv1_bwd":
        return fused.conv1_body(cins, label.endswith("+dx"))
    return fused.upconv_bwd_body(dtype) if name == "upconv_bnact_bwd" \
        else None


def conv_flops(m, cin, cout, kd):
    return 2.0 * m * cin * cout * kd * 9


def upconv_flops(m_in, cin, cout, kd):
    return 2.0 * m_in * cin * cout * kd * 4


def kernel_phase(fused, stats, variants, total):
    """K1-K3 as served (no statistics) at the 3D Predictor tile's
    shapes; ``total``: the variants count in the kernels' totals."""
    for seed, (kind, label, shape, cins, cout, kdw, pro) in \
            enumerate(variants):
        name = FWD[kind]
        for dtype in (torch.bfloat16, torch.float32):
            bf16 = dtype == torch.bfloat16
            rnd = rand_on_card(seed)
            xs = [rnd(1, *shape, c).to(dtype) for c in cins]
            cin = sum(cins)
            inv = rnd(cin) if pro else None      # negative scales included
            shift = rnd(cin, scale=0.5) if pro else None
            act = "relu" if pro else "linear"
            m = xs[0].numel() // cins[0]
            w = b = None
            if kind == "pool":
                args = (xs[0], inv, shift, act, kdw)
                run = lambda: fused.pool_bnact_fwd_kernel(*args)    # noqa
                plain = lambda: fused.pool_bnact_fwd_plain(*args)   # noqa
                flops, peak = 4.0 * xs[0].numel(), PEAK_F32
            elif kind == "conv":
                std = (2.0 / ((cin + cout) * kdw * 9)) ** 0.5
                w, b = rnd(cout, cin, kdw, 3, 3, scale=std), rnd(cout,
                                                                scale=0.1)
                args = (xs, inv, shift, w, b, act, False)
                run = lambda: fused.conv_bnact_fwd_kernel(*args)[0]  # noqa
                plain = lambda: fused.conv_bnact_fwd_plain(*args)[0]  # noqa
                flops, peak = conv_flops(m, cin, cout, kdw), PEAK_BF16
            else:
                std = (2.0 / ((cin + cout) * kdw * 4)) ** 0.5
                w, b = rnd(cin, cout, kdw, 2, 2, scale=std), rnd(cout,
                                                                scale=0.1)
                args = (xs[0], inv, shift, w, b, act, False)
                run = lambda: fused.upconv_bnact_fwd_kernel(*args)[0]  # noqa
                plain = lambda: fused.upconv_bnact_fwd_plain(*args)[0]  # noqa
                flops, peak = upconv_flops(m, cin, cout, kdw), PEAK_BF16
            got = run()
            torch.cuda.synchronize()
            ref = plain()
            if kind == "pool":
                if not torch.equal(got, ref):
                    raise AssertionError(f"K2 {label} {dtype}: not exact")
                err = 0.0
            else:
                err = check_close(got, ref, dtype, f"{label} {dtype}")
            bnd = bound(flops, peak if bf16 else PEAK_F32, args, got)
            lib = None
            if bf16:
                a = lib_input(xs, inv, shift, act)
                lib = cuda_ms(library_calls(kind, a, w, b, kdw)[name])
                del a
            del got, ref
            body = fwd_body(fused, kind, dtype, cins)
            stats.add(stat_name(name, body), label, dtype, err, cuda_ms(run),
                      cuda_ms(plain), bnd, lib, not pro and len(xs) == 1,
                      total=total, body=body)
            del xs, args
            torch.cuda.empty_cache()


def per_sample_phase(fused, stats):
    """The per-sample mode of K1 (its bodies and row 3's), K2 and K3
    (:data:`PS_VARIANTS`): each held against its plain version (the
    output; each sample's statistics row against the plain sums of the
    kernel's own stored output, and in float32 the plain statistics),
    bf16 and float32, with its bound (its inputs and outputs once) and,
    in bf16, the library op on the prologued input (lib*, no
    statistics); in bf16 the same kernel's batch form (+stats) at the
    same shape is checked too, and the two are timed in turns
    (per-sample, batch, batch, per-sample: each line the mean of its
    two); the plain version once."""
    for seed, (kind, label, shape, cins, cout, kdw, pro, n) in \
            enumerate(PS_VARIANTS):
        name = FWD[kind]
        for dtype in (torch.bfloat16, torch.float32):
            bf16 = dtype == torch.bfloat16
            rnd = rand_on_card(300 + seed)
            # samples of different scales, so that their statistics differ
            scale = torch.arange(1, n + 1, device="cuda").view(
                n, *(1,) * (len(shape) + 1))
            xs = [(scale * rnd(n, *shape, c)).to(dtype) for c in cins]
            cin = sum(cins)
            inv = rnd(n, cin) if pro else None
            shift = rnd(n, cin, scale=0.5) if pro else None
            act = "relu" if pro else "linear"
            m = xs[0].numel() // cins[0]
            forms = [("per-sample", inv, shift, "per_sample")]
            if bf16:
                forms.append(("batch" if kind == "pool" else "+stats batch",
                              None if inv is None else inv[0].contiguous(),
                              None if shift is None else shift[0]
                              .contiguous(), True))
            if kind == "conv":
                std = (2.0 / ((cin + cout) * kdw * 9)) ** 0.5
                w, b = rnd(cout, cin, kdw, 3, 3, scale=std), rnd(cout,
                                                                scale=0.1)
                flops, peak = conv_flops(m, cin, cout, kdw), PEAK_BF16
            elif kind == "upconv":
                std = (2.0 / ((cin + cout) * kdw * 4)) ** 0.5
                w, b = rnd(cin, cout, kdw, 2, 2, scale=std), rnd(cout,
                                                                scale=0.1)
                flops, peak = upconv_flops(m, cin, cout, kdw), PEAK_BF16
            else:
                w = b = None
                flops, peak = 4.0 * xs[0].numel(), PEAK_F32
            body = fwd_body(fused, kind, dtype, cins)
            rows = []
            for form, fi, fs, want in forms:
                if kind == "pool":
                    args = (xs[0], fi, fs, act, kdw)
                    run = functools.partial(
                        lambda a: (fused.pool_bnact_fwd_kernel(*a),), args)
                    plain = functools.partial(
                        lambda a: (fused.pool_bnact_fwd_plain(*a),), args)
                elif kind == "conv":
                    args = (xs, fi, fs, w, b, act, want)
                    run = functools.partial(fused.conv_bnact_fwd_kernel,
                                            *args)
                    plain = functools.partial(fused.conv_bnact_fwd_plain,
                                              *args)
                else:
                    args = (xs[0], fi, fs, w, b, act, want)
                    run = functools.partial(fused.upconv_bnact_fwd_kernel,
                                            *args)
                    plain = functools.partial(fused.upconv_bnact_fwd_plain,
                                              *args)
                what = f"{label} {form} {dtype}"
                got, ref = run(), plain()
                torch.cuda.synchronize()
                if kind == "pool":
                    if not torch.equal(got[0], ref[0]):
                        raise AssertionError(f"K2 {what}: not exact")
                    err = 0.0
                else:
                    err = check_close(got[0], ref[0], dtype, what)
                    ps = want == "per_sample"
                    ks, kq = fused.channel_stats(got[0], ps)
                    if got[1].shape != ks.shape:
                        raise AssertionError(f"{what}: statistics "
                                             f"{tuple(got[1].shape)}")
                    for i in range(n if ps else 1):
                        pair = [(got[1], ks), (got[2], kq)]
                        if not bf16:
                            pair += [(got[1], ref[1]), (got[2], ref[2])]
                        for g_, r_ in pair:
                            check_sum(g_[i] if ps else g_,
                                      r_[i] if ps else r_,
                                      f"{what} statistics row {i}")
                bnd = bound(flops, peak if bf16 else PEAK_F32, args, got)
                del got, ref
                lib = None
                if bf16:
                    a = lib_input(xs, fi, fs, act)
                    lib = cuda_ms(library_calls(kind, a, w, b, kdw)[name])
                    del a
                rows.append([form, err, run, plain, bnd, lib, []])
            for r in rows + rows[::-1]:     # in turns: A, B, B, A
                r[6].append(cuda_ms(r[2]))
            for form, err, _, plain, bnd, lib, ms in rows:
                stats.add(stat_name(name, body), f"{label} {form}", dtype,
                          err, sum(ms) / len(ms), cuda_ms(plain), bnd, lib,
                          False, body=body)
            del xs, rows
            torch.cuda.empty_cache()


def check_rows_sum(got, ref, what):
    """A (C,) sum, or (N, C) sums row by row against each row's scale
    (:func:`check_sum`)."""
    if got.dim() == 1:
        return check_sum(got, ref, what)
    if got.shape != ref.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != "
                             f"{tuple(ref.shape)}")
    return max(check_sum(g, r, f"{what} row {i}")
               for i, (g, r) in enumerate(zip(got, ref)))


def per_sample_bwd_phase(fused, stats):
    """The per-sample backward of row 13, K4, K5, K6 and K7
    (:data:`PS_BWD_VARIANTS`, bench.py's batch 8, samples of different
    scales), bf16 and float32, each against its plain version (dx; dinv
    and dshift row by row; dW, db), and the per-sample dinv and dshift
    the same bits on a second call; in bf16 the batch form at the same
    shape too, and the two timed in turns (per-sample, batch, batch,
    per-sample: each line the mean of its two); the plain version once.
    Its bound: its inputs and outputs once, or its FLOPs at the dtype's
    peak; lib*: the library's backward of the op (no prologue, no
    statistics)."""
    n = BATCH
    for seed, (kind, label, shape, cins, cout, kdw, pro) in \
            enumerate(PS_BWD_VARIANTS):
        for dtype in (torch.bfloat16, torch.float32):
            bf16 = dtype == torch.bfloat16
            peak = PEAK_BF16 if bf16 else PEAK_F32
            rnd = rand_on_card(500 + seed)
            scale = torch.arange(1, n + 1, device="cuda").view(
                n, *(1,) * (len(shape) + 1))
            xs = [(scale * rnd(n, *shape, c)).to(dtype) for c in cins]
            cin = sum(cins)
            inv = rnd(n, cin) if pro else None
            shift = rnd(n, cin, scale=0.5) if pro else None
            act = "relu" if pro else "linear"
            m = xs[0].numel() // cins[0]
            w = b = None
            if kind == "pool":
                out_shape = (n, shape[0] // kdw[0], shape[1] // 2,
                             shape[2] // 2, cin)
                dsk = rnd(*xs[0].shape, scale=0.1).to(dtype)
                calls = [("pool_bnact_bwd", fused.pool_bnact_bwd_kernel,
                          fused.pool_bnact_bwd_plain)]
                flops, fpeak = 10.0 * xs[0].numel(), PEAK_F32
            elif kind == "conv":
                std = (2.0 / ((cin + cout) * kdw * 9)) ** 0.5
                w, b = rnd(cout, cin, kdw, 3, 3, scale=std), rnd(cout,
                                                                scale=0.1)
                out_shape = (n, *shape, cout)
                if cins[0] <= fused.CONV1_MAX_CIN:
                    # Row 13 as the path runs it: dW and db, no dx.
                    calls = [("conv1_bwd",
                              lambda *a: fused.conv1_bwd_kernel(*a, False),
                              lambda *a: fused.conv1_bwd_plain(*a, False))]
                else:
                    calls = [("conv_bnact_dgrad",
                              fused.conv_bnact_dgrad_kernel,
                              fused.conv_bnact_dgrad_plain),
                             ("conv_bnact_wgrad",
                              fused.conv_bnact_wgrad_kernel,
                              fused.conv_bnact_wgrad_plain)]
                flops, fpeak = conv_flops(m, cin, cout, kdw), peak
            else:
                std = (2.0 / ((cin + cout) * kdw * 4)) ** 0.5
                w, b = rnd(cin, cout, kdw, 2, 2, scale=std), rnd(cout,
                                                                scale=0.1)
                out_shape = (n, kdw * shape[0], 2 * shape[1], 2 * shape[2],
                             cout)
                calls = [("upconv_bnact_bwd", fused.upconv_bnact_bwd_kernel,
                          fused.upconv_bnact_bwd_plain)]
                flops, fpeak = 2 * upconv_flops(m, cin, cout, kdw), peak
            dy = rnd(*out_shape, scale=0.1).to(dtype)
            y = None if kind == "pool" else \
                (scale * rnd(*out_shape)).to(dtype)
            ds, dq = rnd(n, cout, scale=1e-3), rnd(n, cout, scale=1e-4)
            forms = [("per-sample", inv, shift, ds, dq)]
            if bf16:
                forms.append(("batch", None if inv is None else
                              inv[0].contiguous(), None if shift is None
                              else shift[0].contiguous(), ds[0].contiguous(),
                              dq[0].contiguous()))
            libs = {}
            if bf16:
                a = lib_input(xs, inv, shift, act)
                libs = library_calls(kind, a, w, b, kdw, lib_view(dy))
            for name, kfn, pfn in calls:
                rows = []
                for form, fi, fs, fds, fdq in forms:
                    if kind == "pool":
                        args = (xs[0], fi, fs, act, kdw, dy, dsk)
                    else:
                        x_ = xs if kind == "conv" else xs[0]
                        args = (x_, fi, fs, w, y, dy, fds, fdq, act)
                    run = functools.partial(kfn, *args)
                    plain = functools.partial(pfn, *args)
                    what = f"{name} {label} {form} {dtype}"
                    fused.reset_launches()
                    got = run()
                    if form == "per-sample" and \
                            fused.PS_LAUNCHES != {name: 1}:
                        raise AssertionError(f"{what}: per-sample launches "
                                             f"{fused.PS_LAUNCHES}")
                    again = run()
                    ref = plain()
                    torch.cuda.synchronize()
                    err = 0.0
                    for item, g_, a_, r_ in zip(
                            ("dx", "dinv", "dshift", "dW", "db"),
                            _bwd_named(name, got), _bwd_named(name, again),
                            _bwd_named(name, ref)):
                        if r_ is None:
                            continue
                        if item == "dx":
                            for gi, ri in zip(g_, r_):
                                err = max(err, check_close(
                                    gi, ri, dtype, f"{what} dx"))
                            continue
                        err = max(err, check_rows_sum(g_, r_,
                                                      f"{what} {item}"))
                        if form == "per-sample" and item in (
                                "dinv", "dshift") and not torch.equal(g_,
                                                                      a_):
                            raise AssertionError(f"{what}: {item} not the "
                                                 "same bits on a rerun")
                    bnd = bound(flops, fpeak, args, got)
                    del got, again, ref
                    lib = None
                    if bf16:
                        back = libs[name if name != "conv1_bwd"
                                    else "conv_bnact_wgrad"]
                        if kind == "pool":
                            dskv = lib_view(dsk)
                            lib = cuda_ms(lambda: back() + dskv)
                        else:
                            lib = cuda_ms(back)
                    rows.append([form, err, run, plain, bnd, lib, []])
                for r in rows + rows[::-1]:     # in turns: A, B, B, A
                    r[6].append(cuda_ms(r[2]))
                for form, err, _, plain, bnd, lib, ms in rows:
                    stats.add(name, f"{label} {form}", dtype, err,
                              sum(ms) / len(ms), cuda_ms(plain), bnd, lib,
                              False,
                              body=bwd_body(fused, name, dtype, cins))
            del xs, dy, y, libs
            torch.cuda.empty_cache()


def _batch_head(kind, fargs, n):
    """A conv's or upconv's forward arguments on the first ``n``
    samples."""
    x, inv, shift = fargs
    x = [xi[:n] for xi in x] if kind == "conv" else x[:n]
    return x, inv, shift


def train_kernel_phase(fused, stats, variants, total, serve):
    """K1 and K3 with and without statistics, K2 and K4-K7 at training
    shapes (batch 8), each against its plain version. A forward output
    is held against the plain output; the statistics against the plain
    sums of the kernel's own stored output (the same values: only the
    order of the sum differs) and, in float32, against the plain
    statistics. The serving builds (no statistics) are held at batch 8
    and, with ``serve``, at the tiled 2D Predictor's batch of 4 too,
    and timed at batch 8. ``total``: the backward variants count in the
    kernels' totals."""
    for seed, (kind, label, shape, cins, cout, kdw, pro) in \
            enumerate(variants):
        for dtype in (torch.bfloat16, torch.float32):
            bf16 = dtype == torch.bfloat16
            peak = PEAK_BF16 if bf16 else PEAK_F32
            rnd = rand_on_card(100 + seed)
            xs = [rnd(BATCH, *shape, c).to(dtype) for c in cins]
            cin = sum(cins)
            inv = rnd(cin) if pro else None
            shift = rnd(cin, scale=0.5) if pro else None
            act = "relu" if pro else "linear"
            m = xs[0].numel() // cins[0]
            a = lib_input(xs, inv, shift, act) if bf16 else None
            if kind == "pool":
                fwd_args = (xs[0], inv, shift, act, kdw)
                run = lambda: fused.pool_bnact_fwd_kernel(*fwd_args)  # noqa
                plain = lambda: fused.pool_bnact_fwd_plain(*fwd_args)  # noqa
                got, ref = run(), plain()
                torch.cuda.synchronize()
                if not torch.equal(got, ref):
                    raise AssertionError(f"K2 {label} {dtype}: not exact")
                dp = rnd(*got.shape).to(dtype)
                libs = library_calls(kind, a, None, None, kdw,
                                     lib_view(dp)) if bf16 else {}
                stats.add("pool_bnact", label, dtype, 0.0, cuda_ms(run),
                          cuda_ms(plain),
                          bound(4.0 * xs[0].numel(), PEAK_F32, fwd_args,
                                got),
                          cuda_ms(libs["pool_bnact"]) if bf16 else None,
                          False)
                del got, ref
                # K6 without and with the skip's cotangent (every model
                # path's form: the level's skip is the pool's input); the
                # library call beside the latter is the pool's backward
                # plus the add of the two gradients.
                dsk = rnd(*xs[0].shape).to(dtype)
                for sfx, skip in (("", None), (" +dskip", dsk)):
                    args = (xs[0], inv, shift, act, kdw, dp, skip)
                    run = lambda: fused.pool_bnact_bwd_kernel(*args)  # noqa
                    plain = lambda: fused.pool_bnact_bwd_plain(*args)  # noqa
                    got, ref = run(), plain()
                    torch.cuda.synchronize()
                    if not torch.equal(got[0], ref[0]):
                        raise AssertionError(f"K6 {label}{sfx}: dx not "
                                             "exact")
                    err = max(check_sum(got[1], ref[1],
                                        f"K6 {label}{sfx} dinv"),
                              check_sum(got[2], ref[2],
                                        f"K6 {label}{sfx} dshift"))
                    bnd = bound(10.0 * xs[0].numel(), PEAK_F32, args, got)
                    del got, ref
                    lib = None
                    if bf16:
                        back = libs["pool_bnact_bwd"]
                        dskv = lib_view(dsk)
                        lib = cuda_ms(back if skip is None
                                      else lambda: back() + dskv)
                    stats.add("pool_bnact_bwd", label + sfx, dtype, err,
                              cuda_ms(run), cuda_ms(plain), bnd, lib, False,
                              total and skip is not None,
                              lib_op=None if skip is None else
                              "max_pool backward + the add")
                del xs, a, dp, dsk, args, libs
                torch.cuda.empty_cache()
                continue
            if kind == "conv":
                std = (2.0 / ((cin + cout) * kdw * 9)) ** 0.5
                w = rnd(cout, cin, kdw, 3, 3, scale=std)
                fwd, fwd_plain = (fused.conv_bnact_fwd_kernel,
                                  fused.conv_bnact_fwd_plain)
                if cins[0] <= fused.CONV1_MAX_CIN:
                    # Row 13: the network input's backward, as the paths
                    # run it (no dx) and with input_grad (+dx).
                    bwds = [("conv1_bwd", lambda *a, ig=ig:
                             fused.conv1_bwd_kernel(*a, ig), lambda *a,
                             ig=ig: fused.conv1_bwd_plain(*a, ig),
                             " +dx" if ig else "") for ig in (False, True)]
                else:
                    bwds = [("conv_bnact_dgrad",
                             fused.conv_bnact_dgrad_kernel,
                             fused.conv_bnact_dgrad_plain, ""),
                            ("conv_bnact_wgrad",
                             fused.conv_bnact_wgrad_kernel,
                             fused.conv_bnact_wgrad_plain, "")]
                fargs = (xs, inv, shift)
                flops = conv_flops(m, cin, cout, kdw)
                bwd_flops = flops
            else:
                std = (2.0 / ((cin + cout) * kdw * 4)) ** 0.5
                w = rnd(cin, cout, kdw, 2, 2, scale=std)
                fwd, fwd_plain = (fused.upconv_bnact_fwd_kernel,
                                  fused.upconv_bnact_fwd_plain)
                bwds = [("upconv_bnact_bwd", fused.upconv_bnact_bwd_kernel,
                         fused.upconv_bnact_bwd_plain, "")]
                fargs = (xs[0], inv, shift)
                flops = upconv_flops(m, cin, cout, kdw)
                bwd_flops = 2 * flops                   # dgrad and wgrad
            b = rnd(cout, scale=0.1)
            y, s, q = fwd(*fargs, w, b, act, True)
            y_serve = fwd(*fargs, w, b, act, False)[0]
            y_plain, rs, rq = fwd_plain(*fargs, w, b, act, True)
            torch.cuda.synchronize()
            err = check_close(y, y_plain, dtype, f"{label} {dtype} output")
            serve_err = check_close(y_serve, y_plain, dtype,
                                    f"{label} {dtype} serving output")
            del y_serve, y_plain
            if serve:
                head = _batch_head(kind, fargs, 4)
                got = fwd(*head, w, b, act, False)[0]
                ref = fwd_plain(*head, w, b, act, False)[0]
                torch.cuda.synchronize()
                serve_err = max(serve_err, check_close(
                    got, ref, dtype, f"{label} {dtype} serving batch 4"))
                del head, got, ref
            ks, kq = fused.channel_stats(y)
            err = max(err, check_sum(s, ks, f"{label} sum"),
                      check_sum(q, kq, f"{label} sumsq"))
            if dtype == torch.float32:
                err = max(err, check_sum(s, rs, f"{label} sum vs plain"),
                          check_sum(q, rq, f"{label} sumsq vs plain"))
            bnd = bound(flops, peak, fargs, w, b, y, s, q)
            del s, q, ks, kq, rs, rq
            dy = rnd(*y.shape, scale=0.1).to(dtype)
            libs = library_calls(kind, a, w, b, kdw, lib_view(dy)) \
                if bf16 else {}
            lib = cuda_ms(libs[FWD[kind]]) if bf16 else None
            body = fwd_body(fused, kind, dtype, cins)
            stats.add(stat_name(FWD[kind], body), label + " +stats", dtype,
                      err, cuda_ms(lambda: fwd(*fargs, w, b, act, True)),
                      cuda_ms(lambda: fwd_plain(*fargs, w, b, act, True)),
                      bnd, lib, False, body=body)
            if serve:
                stats.add(stat_name(FWD[kind], body), label + " serving",
                          dtype, serve_err,
                          cuda_ms(lambda: fwd(*fargs, w, b, act, False)),
                          cuda_ms(lambda: fwd_plain(*fargs, w, b, act,
                                                    False)),
                          bound(flops, peak, fargs, w, b, y), lib,
                          not pro and len(xs) == 1, body=body)
            ds, dq = rnd(cout, scale=1e-3), rnd(cout, scale=1e-4)
            bargs = (*fargs, w, y, dy, ds, dq, act)
            for name, kfn, pfn, suffix in bwds:
                run = lambda: kfn(*bargs)                          # noqa
                plain = lambda: pfn(*bargs)                        # noqa
                got, ref = run(), plain()
                torch.cuda.synchronize()
                err = 0.0
                for what, g, r in zip(("dx", "dinv", "dshift", "dW", "db"),
                                      _bwd_named(name, got),
                                      _bwd_named(name, ref)):
                    if g is None:
                        continue
                    if what == "dx":
                        for gi, ri in zip(g, r):
                            err = max(err, check_close(
                                gi, ri, dtype, f"{name} {label} dx"))
                    else:
                        err = max(err, check_sum(g, r, f"{name} {label} "
                                                 f"{what}"))
                if name == "conv1_bwd":
                    # dW, and dx with it, at the dtype's peak (as the
                    # library's conv3d_weight and conv3d_input run it).
                    bnd = bound(bwd_flops * (2 if suffix else 1), peak,
                                bargs, got)
                    lib_fn = (lambda: (libs["conv_bnact_wgrad"](),
                                       libs["conv_bnact_dgrad"]())) \
                        if suffix else libs.get("conv_bnact_wgrad")
                else:
                    bnd = bound(bwd_flops, peak, bargs, got)
                    lib_fn = libs.get(name)
                del got, ref
                # Row 13's "+dx" variant (no model path runs it) is
                # listed, not summed.
                stats.add(name, label + suffix, dtype, err, cuda_ms(run),
                          cuda_ms(plain), bnd,
                          cuda_ms(lib_fn) if bf16 else None, False,
                          total and not suffix,
                          body=bwd_body(fused, name, dtype, cins, suffix))
            del y, dy, xs, a, bargs, fargs, libs
            torch.cuda.empty_cache()


def _bwd_named(name, out):
    """A backward result as (dx list, dinv, dshift, dW, db)."""
    if name == "pool_bnact_bwd":
        return [out[0]], out[1], out[2], None, None
    if name == "conv_bnact_dgrad":
        return out[0], out[1], out[2], None, None
    if name == "conv_bnact_wgrad":
        return None, None, None, out[0], out[1]
    if name == "conv1_bwd":
        return out
    return [out[0]], out[1], out[2], out[3], out[4]


def conv_direct_phase(pallas_conv, stats):
    """Row 28: ``conv_direct`` (K1 with a zero bias, no prologue, no
    statistics) at CONV_DIRECT_CASES, bf16 and f32, against its plain
    version; the library call is cuDNN's conv without bias (the same
    function)."""
    for seed, (label, bdhw, cin, cout, planar) in \
            enumerate(CONV_DIRECT_CASES):
        kd = 1 if planar else 3
        for dtype in (torch.bfloat16, torch.float32):
            bf16 = dtype == torch.bfloat16
            rnd = rand_on_card(300 + seed)
            x = rnd(*bdhw, cin).to(dtype)
            w = rnd(cout, cin, kd, 3, 3,
                    scale=(2.0 / ((cin + cout) * kd * 9)) ** 0.5)
            run = lambda: pallas_conv.conv_direct_kernel(x, w)    # noqa
            plain = lambda: pallas_conv.conv_direct_plain(x, w)   # noqa
            got = run()
            torch.cuda.synchronize()
            err = check_close(got, plain(), dtype, f"conv_direct {label} "
                              f"{dtype}")
            flops = conv_flops(x.numel() // cin, cin, cout, kd)
            bnd = bound(flops, PEAK_BF16 if bf16 else PEAK_F32, x, w, got)
            lib = None
            if bf16:
                a, wq = lib_view(x), w.to(dtype)
                lib = cuda_ms(lambda: F.conv3d(a, wq, padding=(kd // 2, 1,
                                                               1)))
                del a
            stats.add("conv_bnact", f"conv_direct {label} {bdhw} [row 28]",
                      dtype, err, cuda_ms(run), cuda_ms(plain), bnd, lib,
                      True, body=pallas_conv.fused.conv_body(dtype, [cin]))
            del x, got
            torch.cuda.empty_cache()


def nd_check(fused):
    """K1 and K4 at N * D = 65,536 (2, 32768, 4, 8) x 32 (their grid.x
    walks the slabs; grid.y stopped at 65,535 before) against their
    plain versions, with a relu prologue, bf16 and f32."""
    for dtype in (torch.bfloat16, torch.float32):
        rnd = rand_on_card(400)
        xs = [rnd(2, 32768, 4, 8, 32).to(dtype)]
        w, b = rnd(32, 32, 1, 3, 3, scale=0.1), rnd(32)
        inv, shift = rnd(32), rnd(32, scale=0.5)
        y = fused.conv_bnact_fwd_kernel(xs, inv, shift, w, b, "relu",
                                        False)[0]
        torch.cuda.synchronize()
        ref = fused.conv_bnact_fwd_plain(xs, inv, shift, w, b, "relu")[0]
        err = check_close(y, ref, dtype, f"K1 N*D=65536 {dtype}")
        dy = rnd(*ref.shape, scale=0.1).to(dtype)
        args = (xs, inv, shift, w, ref, dy, None, None, "relu")
        got = fused.conv_bnact_dgrad_kernel(*args)
        torch.cuda.synchronize()
        want = fused.conv_bnact_dgrad_plain(*args)
        err4 = max(check_close(got[0][0], want[0][0], dtype,
                               f"K4 N*D=65536 {dtype} dx"),
                   check_sum(got[1], want[1], "K4 N*D=65536 dinv"),
                   check_sum(got[2], want[2], "K4 N*D=65536 dshift"))
        print(f"N*D=65536 {tuple(xs[0].shape)} {str(dtype)[6:]}: K1 max abs"
              f" err {err:.3e}, K4 {err4:.3e} (vs plain)", flush=True)
        del xs, y, ref, dy, args, got, want
        torch.cuda.empty_cache()


def profile_calls(fn, n=20):
    """The device records (kernels, memsets, copies) of ``n`` calls of
    ``fn`` after a warm-up, from torch.profiler: [(name, us)]."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type.name == "CUDA"]


def device_ms(fn, key, n=20):
    """Device time of ``fn`` from torch.profiler: the kernels whose name
    holds ``key``, summed over ``n`` calls after a warm-up, per call, and
    their number per call."""
    ev = [us for name, us in profile_calls(fn, n) if key in name]
    return sum(ev) / 1e3 / n, len(ev) / n


def one_kernel_ms(fn, key, what, n=20, tries=3):
    """Device time of one call of ``fn``, which must run exactly one
    device kernel, named with ``key``, and nothing else: no second
    kernel, memset or copy. Fails at once on any other record or on
    more than ``n`` kernels in ``n`` calls. CUPTI now and then loses a
    kernel's record from a window (one K8 window at L0 showed 19 of its
    20 launches, and nothing else): a window that shows fewer than ``n``
    and nothing else is profiled again, and the check fails if ``tries``
    windows in a row all come up short."""
    counts = []
    for _ in range(tries):
        ev = profile_calls(fn, n)
        other = sorted({name.split("(")[0] for name, _ in ev
                        if key not in name})
        mine = [us for name, us in ev if key in name]
        if other or len(mine) > n:
            raise AssertionError(f"{what}: {len(mine) / n:g} {key} a call, "
                                 f"and other device records {other}")
        if len(mine) == n:
            if counts:
                print(f"{what}: {key} records {counts} of {n}, then {n}: "
                      "profiled again", flush=True)
            return sum(mine) / 1e3 / n
        counts.append(len(mine))
    raise AssertionError(f"{what}: {counts} {key} records in {tries} "
                         f"windows of {n} calls")


def check_bn_glue(got, mean, var, what, bn, gamma, beta, eps):
    """K8's folded vectors (inv, scale, shift) against the plain glue on
    the kernel's own mean and var: within BN_SUM_TOL of each vector's
    scale. Returns the max abs error."""
    inv = torch.rsqrt(var + eps)
    return max(check_sum(g, r, f"{what} {n}", BN_SUM_TOL)
               for n, g, r in zip(("inv", "scale", "shift"), got,
                                  (inv, *bn._scale_shift(gamma, beta, mean,
                                                         inv))))


def bn_kernel_phase(bn, stats):
    """K8-K11 at BN_VARIANTS' (R, C), bf16 and f32, against their plain
    versions on the same operands (x with mean 3, a random cotangent,
    running buffers; K9 and K11 read rows of K8's and K10's outputs).
    K8's mean and running mean, K10's a, b, c, dgamma and dbeta within
    BN_SUM_TOL of their scale; K8's variance and running variance within
    1e-4; K8's inv, scale and shift within BN_SUM_TOL of the plain glue
    on its own mean and variance. K8 and K10 print their per-call time
    (back-to-back calls: the host's issue rate where a call is
    host-bound) and their device time (torch.profiler), and must be one
    device kernel a call. Library calls (bf16, on the (R, C) view, which
    is the channels-last activation): K8 ``torch.batch_norm_stats``
    (per-channel mean and invstd: the same statistics); K9
    ``F.batch_norm(training=False)`` from the batch's statistics (the
    same function); K10 ``native_batch_norm_backward`` for dgamma and
    dbeta (the same function); K11 the same call for dx, which also
    reduces (all of row 31)."""
    eps = 1e-5
    bwd = torch.ops.aten.native_batch_norm_backward
    for seed, (label, r, c, train, total) in enumerate(BN_VARIANTS):
        for dtype in (torch.bfloat16, torch.float32):
            bf16 = dtype == torch.bfloat16
            rnd = rand_on_card(200 + seed)
            x = (3.0 + 2.0 * rnd(r, c)).to(dtype)
            gamma, beta = rnd(c), rnd(c, scale=0.5)
            ra = (rnd(c), rnd(c).abs() + 0.5, 0.1)
            ra_ref = (ra[0].clone(), ra[1].clone(), 0.1)
            st = bn.bn_stats_kernel(x, gamma, beta, eps, ra)
            torch.cuda.synchronize()
            ref = bn.bn_stats_plain(x, gamma, beta, eps, ra_ref)
            if train:
                err = max(check_sum(st[0], ref[0], f"K8 {label} mean",
                                    BN_SUM_TOL),
                          check_sum(st[1], ref[1], f"K8 {label} var", 1e-4),
                          check_bn_glue(st[2:], st[0], st[1],
                                        f"K8 {label}", bn, gamma, beta, eps),
                          check_sum(ra[0], ra_ref[0],
                                    f"K8 {label} running mean", BN_SUM_TOL),
                          check_sum(ra[1], ra_ref[1],
                                    f"K8 {label} running var", 1e-4))

                def k8():
                    return bn.bn_stats_kernel(x, gamma, beta, eps)
                dev = one_kernel_ms(k8, "bn_reduce_kernel", f"K8 {label}")
                lib = cuda_ms(lambda: torch.batch_norm_stats(x, eps)) \
                    if bf16 else None
                stats.add("bn_stats", label, dtype, err, cuda_ms(k8),
                          cuda_ms(lambda: bn.bn_stats_plain(x, gamma, beta,
                                                            eps)),
                          bound(3.0 * r * c, PEAK_F32, x, gamma, beta, st),
                          lib, True, total,
                          "torch.batch_norm_stats: mean and invstd",
                          device=dev)
            args = (x, st[3], st[4])
            y = bn.bn_normalize_kernel(*args)
            torch.cuda.synchronize()
            err = check_close(y, bn.bn_normalize_plain(*args), dtype,
                              f"K9 {label}")
            lib = cuda_ms(lambda: F.batch_norm(
                x, st[0], st[1], gamma, beta, False, 0.0, eps)) \
                if bf16 else None
            stats.add("bn_normalize", label, dtype, err,
                      cuda_ms(lambda: bn.bn_normalize_kernel(*args)),
                      cuda_ms(lambda: bn.bn_normalize_plain(*args)),
                      bound(2.0 * r * c, PEAK_F32, args, y), lib, True,
                      total)
            del y, args
            if not train:
                del x
                torch.cuda.empty_cache()
                continue
            gy = rnd(r, c).to(dtype)
            rargs = (gy, x, st[0], st[1], gamma, eps)
            red = bn.bn_bwd_reduce_kernel(*rargs)
            torch.cuda.synchronize()
            rref = bn.bn_bwd_reduce_plain(*rargs)
            err = max(check_sum(got, want, f"K10 {label} {n}", BN_SUM_TOL)
                      for n, got, want in zip(
                          ("a", "b", "c", "dgamma", "dbeta"),
                          red, rref))

            def k10():
                return bn.bn_bwd_reduce_kernel(*rargs)
            dev = one_kernel_ms(k10, "bn_reduce_kernel", f"K10 {label}")
            libs = {}
            if bf16:
                for k, mask in (("bn_bwd_reduce", [False, True, True]),
                                ("bn_bwd_dx", [True, False, False])):
                    libs[k] = cuda_ms(lambda m=mask: bwd(
                        gy, x, gamma, None, None, st[0], st[2], True, eps,
                        m))
            stats.add("bn_bwd_reduce", label, dtype, err, cuda_ms(k10),
                      cuda_ms(lambda: bn.bn_bwd_reduce_plain(*rargs)),
                      bound(4.0 * r * c, PEAK_F32, rargs, red),
                      libs.get("bn_bwd_reduce"), True, total, device=dev)
            dargs = (gy, x, red[0], red[1], red[2])
            dx = bn.bn_bwd_dx_kernel(*dargs)
            torch.cuda.synchronize()
            err = check_close(dx, bn.bn_bwd_dx_plain(*dargs), dtype,
                              f"K11 {label}")
            stats.add("bn_bwd_dx", label, dtype, err,
                      cuda_ms(lambda: bn.bn_bwd_dx_kernel(*dargs)),
                      cuda_ms(lambda: bn.bn_bwd_dx_plain(*dargs)),
                      bound(5.0 * r * c, PEAK_F32, dargs, dx),
                      libs.get("bn_bwd_dx"), False, total,
                      "native_batch_norm_backward for dx: reduces too "
                      "(all of row 31)")
            del x, gy, dx, rargs, dargs, red, st
            torch.cuda.empty_cache()


def bn_layer_phase():
    """One PallasBatchNorm3d training forward and backward against
    nn.BatchNorm3d's (cuDNN or ATen, on the channels-last view) at
    BN_LAYER_SHAPES, bf16: per call (back-to-back) and device time, and
    the device kernels a call (PallasBatchNorm3d: K8, K9, K10, K11)."""
    from torch import nn
    from elektronn3_tpu_torch.modules.pallas_norm import PallasBatchNorm3d
    for label, shape in BN_LAYER_SHAPES:
        c = shape[-1]
        x = torch.randn(shape, device="cuda", dtype=torch.bfloat16)
        gy = torch.randn_like(x)
        line = []
        for name, layer, view in (
                ("PallasBatchNorm3d", PallasBatchNorm3d(c, device="cuda"),
                 lambda t: t),
                ("nn.BatchNorm3d", nn.BatchNorm3d(c, device="cuda"),
                 lambda t: t.permute(0, 4, 1, 2, 3))):
            layer.train()
            xi = x.clone().requires_grad_(True)

            def step(layer=layer, xi=xi, view=view):
                xi.grad = None
                layer.zero_grad(set_to_none=True)
                layer(view(xi)).backward(view(gy))
            dev, kernels = device_ms(step, "")
            line.append(f"{name} {cuda_ms(step):.4f} ms (device {dev:.4f}, "
                        f"{kernels:g} kernels)")
        print(f"layer batchp {label} {shape} bf16 fwd+bwd: "
              + "; ".join(line), flush=True)
        del x, gy
        torch.cuda.empty_cache()


@contextlib.contextmanager
def record_shapes(fused, bn=None):
    """Count the K1-K7 launches made inside the block by (kernel,
    channels, window or (C_out, kd, prologue)), a conv's channels by
    input ((C_0,) or (C_0, C_1)), those of the per-sample mode (group
    and instance norm) once more under ``("per_sample",) + key``, the
    vup entries' by (entry, the carry's shape), and, given the ``bn``
    module (``ops/pallas_bn``), K8-K11's by (kernel, R, C)."""
    from elektronn3_tpu_torch.ops import vup
    seen = collections.Counter()
    vup_names = {f"{k}_kernel": k for k in VUP_KERNELS[1:]}
    vup_names["conv_vup_fwd_kernel"] = "conv_vup"
    vup_real = {n: getattr(vup, n) for n in vup_names}

    def wrap_vup(n):
        def f(carry, *rest):
            key = (vup_names[n], tuple(carry.shape))
            seen[key] += 1
            # the per-sample mode: an (N, C) prologue or statistics
            # cotangent, or per-sample statistics
            if "per_sample" in [r for r in rest if isinstance(r, str)] or any(
                    isinstance(r, torch.Tensor) and r.dim() == 2
                    for r in rest):
                seen[("per_sample",) + key] += 1
            return vup_real[n](carry, *rest)
        return f
    names = ("pool_bnact_fwd_kernel", "pool_bnact_bwd_kernel",
             "upconv_bnact_fwd_kernel", "upconv_bnact_bwd_kernel",
             "conv_bnact_fwd_kernel", "conv_bnact_dgrad_kernel",
             "conv_bnact_wgrad_kernel", "conv1_bwd_kernel")
    real = {n: getattr(fused, n) for n in names}
    bn_names = tuple(f"{k}_kernel" for k in BN_KERNELS) if bn else ()
    bn_real = {n: getattr(bn, n) for n in bn_names}

    def wrap_bn(n):
        def f(x2d, *rest):
            seen[(n[:-len("_kernel")],) + tuple(x2d.shape)] += 1
            return bn_real[n](x2d, *rest)
        return f

    def wrap(n):
        def f(x, inv, shift, *rest):
            if n.startswith("conv"):   # K1, K4, K5 and row 13's
                w = rest[0]
                key = (n.replace("_fwd_kernel", "").replace("_kernel", ""),
                       tuple(xi.shape[-1] for xi in x), w.shape[0],
                       w.shape[2], inv is not None)
            elif n.startswith("pool"):
                key = (n.replace("_fwd_kernel", "").replace("_kernel", ""),
                       x.shape[-1], tuple(rest[1]))
            else:
                w = rest[0]
                key = (n.replace("_fwd_kernel", "").replace("_kernel", ""),
                       x.shape[-1], w.shape[1], w.shape[2], inv is not None)
            seen[key] += 1
            # the per-sample mode: (N, C) vectors, per-sample statistics
            # or (N, C) statistics cotangents (the backward's ds, dq)
            if (inv is not None and inv.dim() == 2) or "per_sample" in [
                    r for r in rest if isinstance(r, str)] or any(
                        isinstance(r, torch.Tensor) and r.dim() == 2
                        for r in rest):
                seen[("per_sample",) + key] += 1
            return real[n](x, inv, shift, *rest)
        return f
    for n in names:
        setattr(fused, n, wrap(n))
    for n in bn_names:
        setattr(bn, n, wrap_bn(n))
    for n in vup_names:
        setattr(vup, n, wrap_vup(n))
    try:
        yield seen
    finally:
        for n in names:
            setattr(fused, n, real[n])
        for n in bn_names:
            setattr(bn, n, bn_real[n])
        for n in vup_names:
            setattr(vup, n, vup_real[n])


def check_rows(seen, rows, what):
    missing = [r for r in rows if ROW_SHAPES[r] not in seen]
    if missing:
        raise AssertionError(f"{what}: no launch at the shapes of rows "
                             f"{missing} (launched: {sorted(seen)})")
    print(f"{what}: launches at the shapes of rows "
          + ", ".join(f"{r} {ROW_SHAPES[r]}: {seen[ROW_SHAPES[r]]}"
                      for r in rows), flush=True)


# The vup entries' variants: (label, carry shape, skip shape, training).
# bench.py's up_2 (training: every entry) and the 3D Predictor tile's
# (serving: conv_vup without statistics).
VUP_VARIANTS = [
    ("vup bench up_2 64->32 [rows 1-vup/9/22/23]", (BATCH, *TL1, 64),
     (BATCH, *PATCH, 32), True),
    ("vup tile up_2 64->32 [row 1-vup]", (1, *L1, 64), (1, *TILE, 32),
     False),
]


def vup_kernel_phase(vup, stats):
    """The vup entries against their plain versions on the same inputs
    (relu prologues with negative scales, random statistics
    cotangents), bf16 and f32: ``conv_vup`` as served (and, in training,
    with statistics), ``upconv_stats``, ``conv_vup_dgrad`` (dcarry and
    dskip elementwise, the sums as sums), ``conv_vup_wgrad`` and
    ``upconv_stats_bwd``. Library calls (bf16, cuDNN through torch,
    channels-last): ``conv_transpose3d`` plus ``conv3d`` on the
    prologued inputs for ``conv_vup``; ``conv_transpose3d`` plus
    ``torch.batch_norm_stats`` for ``upconv_stats``; the two convs'
    backward calls for the backward entries (the merge conv's input or
    weight gradient, the transposed conv's input and weight gradients):
    each computes less than the kernel (no prologue, no chain), "lib*".
    The bound counts the upconv recompute as work: 2 * 64 * 32 FLOP per
    output voxel for each use of the upconv output."""
    from elektronn3_tpu_torch.ops.fused import channel_stats
    for seed, (label, cshape, sshape, train) in enumerate(VUP_VARIANTS):
        for dtype in (torch.bfloat16, torch.float32):
            bf16 = dtype == torch.bfloat16
            peak = PEAK_BF16 if bf16 else PEAK_F32
            rnd = rand_on_card(500 + seed)
            carry = rnd(*cshape).to(dtype)
            skip = rnd(*sshape).to(dtype)
            up = (carry, rnd(64), rnd(64, scale=0.5),
                  rnd(64, 32, 1, 2, 2, scale=(2.0 / (96 * 4)) ** 0.5),
                  rnd(32, scale=0.1))
            args = (*up, skip, rnd(64), rnd(64, scale=0.5),
                    rnd(32, 64, 1, 3, 3, scale=(2.0 / (96 * 9)) ** 0.5),
                    rnd(32, scale=0.1))
            m = skip.numel() // 32
            f_up, f_merge = 2.0 * m * 64 * 32, 2.0 * m * 64 * 32 * 9
            libs = {}
            if bf16:
                libs = {k: cuda_ms(f) for k, f in vup_library_calls(
                    vup, up, args, rnd, dtype).items()}
            for want in (False, True) if train else (False,):
                run = lambda: vup.conv_vup_fwd_kernel(   # noqa
                    *args, "relu", "relu", want)
                plain = lambda: vup.conv_vup_fwd_plain(  # noqa
                    *args, "relu", "relu", want)
                got, ref = run(), plain()
                torch.cuda.synchronize()
                err = check_close(got[0], ref[0], dtype, f"{label} {dtype}")
                if want:
                    ks, kq = channel_stats(got[0])
                    err = max(err, check_sum(got[1], ks, f"{label} sum"),
                              check_sum(got[2], kq, f"{label} sumsq"))
                    if not bf16:
                        err = max(err, check_sum(got[1], ref[1], label),
                                  check_sum(got[2], ref[2], label))
                bnd = bound(f_up + f_merge, peak, args, got)
                del got, ref
                stats.add("conv_vup", label + (" +stats" if want
                                               else " serving"), dtype,
                          err, cuda_ms(run), cuda_ms(plain), bnd,
                          libs.get("conv_vup"), False,
                          total=not train and not want,
                          lib_op="conv_transpose3d + conv3d on the "
                          "prologued inputs",
                          body=vup.vup_body(dtype, 64, 32))
            if not train:
                del carry, skip, up, args, libs
                torch.cuda.empty_cache()
                continue
            run = lambda: vup.upconv_stats_kernel(*up, "relu")   # noqa
            plain = lambda: vup.upconv_stats_plain(*up, "relu")  # noqa
            got, ref = run(), plain()
            torch.cuda.synchronize()
            err = max(check_sum(got[0], ref[0], f"{label} upconv sum"),
                      check_sum(got[1], ref[1], f"{label} upconv sumsq"))
            stats.add("upconv_stats", label, dtype, err, cuda_ms(run),
                      cuda_ms(plain), bound(f_up, peak, up, got),
                      libs.get("upconv_stats"), False, total=True,
                      lib_op="conv_transpose3d + torch.batch_norm_stats",
                      body=vup.vup_body(dtype, 64, 32))
            y = vup.conv_vup_fwd_plain(*args, "relu", "relu")[0]
            ds, dq = rnd(32, scale=1e-3), rnd(32, scale=1e-4)
            bargs = (*args[:9], y, rnd(*y.shape, scale=0.1).to(dtype), ds,
                     dq, "relu", "relu")
            for name, flops, elementwise in (
                    ("conv_vup_dgrad", 3 * f_up + f_merge, (0, 5)),
                    ("conv_vup_wgrad", f_up + f_merge, ()),
                    ("upconv_stats_bwd", 3 * f_up, (0,))):
                fargs = (*up, ds, dq, "relu") if name == "upconv_stats_bwd" \
                    else bargs
                kfn = getattr(vup, f"{name}_kernel")
                pfn = getattr(vup, f"{name}_plain")
                run = lambda: kfn(*fargs)      # noqa
                plain = lambda: pfn(*fargs)    # noqa
                got, ref = run(), plain()
                torch.cuda.synchronize()
                err = 0.0
                for i, (g, r) in enumerate(zip(got, ref)):
                    what = f"{name} {label} {dtype} output {i}"
                    err = max(err, check_close(g, r, dtype, what)
                              if i in elementwise else check_sum(g, r, what))
                bnd = bound(flops, peak, fargs, got)
                del got, ref
                stats.add(name, label, dtype, err, cuda_ms(run),
                          cuda_ms(plain), bnd, libs.get(name), False,
                          total=True, lib_op="the two convs' backward calls",
                          body=vup.vup_body(dtype, 64, 32))
            del carry, skip, up, args, bargs, y, libs
            torch.cuda.empty_cache()


def vup_library_calls(vup, up, args, rnd, dtype):
    """The vup entries' library yardsticks (bf16, cuDNN through torch,
    channels-last), each computing less than the entry (no prologue, no
    chain; "lib*"): ``conv_transpose3d`` plus ``conv3d`` on the prologued
    inputs for ``conv_vup``; ``conv_transpose3d`` plus
    ``torch.batch_norm_stats`` for ``upconv_stats``; the two convs'
    backward calls for the backward entries. ``up`` and ``args`` as
    ``vup.conv_vup`` takes them ((C,) or (N, C) vectors)."""
    from elektronn3_tpu_torch.ops.fused import prologue
    grad = torch.nn.grad
    carry, skip = up[0], args[5]
    a_c = lib_view(prologue(carry, up[1], up[2], "relu").to(dtype))
    u = lib_view(vup._upconv_plain(*up, "relu"))
    a_m = lib_input([u.permute(0, 2, 3, 4, 1), skip], args[6], args[7],
                    "relu")
    wuq, buq = up[3].to(dtype), up[4].to(dtype)
    wq, bq = args[8].to(dtype), args[9].to(dtype)
    st = (1, 2, 2)
    convt = F.conv_transpose3d
    dyv = lib_view(rnd(*skip.shape, scale=0.1).to(dtype))

    def convt_bwd():    # u's values serve as its cotangent
        return (F.conv3d(u, wuq, stride=st),
                grad.conv3d_weight(u, wuq.shape, a_c, stride=st))
    return {
        "conv_vup": lambda: (convt(a_c, wuq, buq, stride=st),
                             F.conv3d(a_m, wq, bq, padding=(0, 1, 1))),
        "upconv_stats": lambda: torch.batch_norm_stats(
            convt(a_c, wuq, buq, stride=st), 1e-5),
        "upconv_stats_bwd": convt_bwd,
        "conv_vup_dgrad": lambda: (
            grad.conv3d_input(a_m.shape, wq, dyv, padding=(0, 1, 1)),
            convt_bwd()),
        "conv_vup_wgrad": lambda: grad.conv3d_weight(
            a_m, wq.shape, dyv, padding=(0, 1, 1))}


# The vup entries' per-sample mode (the group vup model): (label, carry
# shape, skip shape, training) at bench.py's up_2 (training: every
# entry) and the Predictor's request of two tiles (serving: conv_vup with
# per-sample statistics and row 22's pass). Each on the 'tc' body in
# bf16, timed in turns with its batch twin, and on the 'cuda-core' body
# in bf16 and float32.
PS_VUP_VARIANTS = [
    ("vup bench up_2 64->32 [rows 1-vup/9/22/23]", (BATCH, *TL1, 64),
     (BATCH, *PATCH, 32), True),
    ("vup request up_2 64->32 [rows 1-vup/22]", (2, *L1, 64),
     (2, *TILE, 32), False),
]
PS_VUP_BODIES = ((torch.bfloat16, "tc"), (torch.bfloat16, "cuda-core"),
                 (torch.float32, "cuda-core"))


def _ps_vup_inputs(seed, cshape, sshape, dtype):
    """(rnd, up, args) of :func:`vup_kernel_phase` with (N, C) prologue
    rows for the carry and the merge, each sample of its own scale."""
    rnd = rand_on_card(seed)
    n = cshape[0]
    scale = torch.arange(1, n + 1, device="cuda").view(n, 1, 1, 1, 1)
    up = ((scale * rnd(*cshape)).to(dtype), rnd(n, 64),
          rnd(n, 64, scale=0.5),
          rnd(64, 32, 1, 2, 2, scale=(2.0 / (96 * 4)) ** 0.5),
          rnd(32, scale=0.1))
    args = (*up, (scale * rnd(*sshape)).to(dtype), rnd(n, 64),
            rnd(n, 64, scale=0.5),
            rnd(32, 64, 1, 3, 3, scale=(2.0 / (96 * 9)) ** 0.5),
            rnd(32, scale=0.1))
    return rnd, up, args


def _batch_twin(args):
    """The batch form of a per-sample call: row 0 of every (N, C)
    vector."""
    return tuple(a[0].contiguous() if isinstance(a, torch.Tensor)
                 and a.dim() == 2 else a for a in args)


def _sample_alone(args, i):
    """Sample i's slice of every batched argument (activations and (N, C)
    rows; each weight's first dimension is a channel count above N)."""
    n = args[0].shape[0]
    return tuple(a[i:i + 1].clone() if isinstance(a, torch.Tensor)
                 and a.dim() > 1 and a.shape[0] == n else a for a in args)


def check_ps_repeat(run, args, out, keep, what):
    """The outputs ``keep`` of a per-sample call the same bits on a rerun
    and, for the last sample, when it runs alone."""
    i = args[0].shape[0] - 1
    again, alone = run(args), run(_sample_alone(args, i))
    torch.cuda.synchronize()
    for k in keep:
        if not torch.equal(out[k], again[k]):
            raise AssertionError(f"{what}: output {k} not the same bits on "
                                 "a rerun")
        if not torch.equal(out[k][i], alone[k][0]):
            raise AssertionError(f"{what}: output {k} of sample {i} not the "
                                 "same bits when it runs alone")


@contextlib.contextmanager
def recompute_as_k3(vup, fused, on):
    """With ``on``, the plain versions' upconv output u is K3's (the
    kernel's) stored output, whose bits the vup entries' recompute of the
    body ``vup.vup_body`` picks reproduces (bf16: ``vup_mma``; float32:
    ``upconv_value8``). The plain u (one library transposed conv) may sit
    one unit in the last place from it, which moves a relu's decision
    where u * inv0 + shift0 is within that unit of 0 and so changes that
    voxel's gradient by its whole value: the dgrad's reference then takes
    the kernel's relu decisions and differs from the kernel only in its
    sums' order."""
    real = vup._upconv_plain

    def k3(carry, invc, shiftc, wu, bu, act_c):
        return fused.upconv_bnact_fwd_kernel(carry, invc, shiftc, wu, bu,
                                             act_c, False)[0]
    if on:
        vup._upconv_plain = k3
    try:
        yield
    finally:
        vup._upconv_plain = real


def per_sample_vup_phase(vup, fused, stats, backward):
    """The vup entries' per-sample mode (:data:`PS_VUP_VARIANTS`): the
    forward (``conv_vup`` with per-sample statistics, ``upconv_stats``
    per sample) or, with ``backward``, the training variant's backward
    entries with (N, C) statistics cotangents (dcarry and dskip
    elementwise; dinv, dshift, dinvc, dshiftc row by row; dW, db, dwu,
    dbu as sums), on each of :data:`PS_VUP_BODIES`, against the plain
    versions; each per-sample call one per-sample launch, and its
    per-sample outputs (and dcarry, dskip) the same bits on a rerun and
    for a sample alone. On the 'tc' body the batch twin ((C,) vectors
    and cotangents) is checked too and the two timed in turns
    (per-sample, batch, batch, per-sample); lib* as
    :func:`vup_kernel_phase`'s."""
    from elektronn3_tpu_torch.ops.fused import channel_stats
    for seed, (label, cshape, sshape, train) in enumerate(PS_VUP_VARIANTS):
        if backward and not train:
            continue
        for dtype, body in PS_VUP_BODIES:
            bf16 = dtype == torch.bfloat16
            peak = PEAK_BF16 if bf16 else PEAK_F32
            rnd, up, args = _ps_vup_inputs(700 + seed, cshape, sshape, dtype)
            n = cshape[0]
            m = args[5].numel() // 32
            f_up, f_merge = 2.0 * m * 64 * 32, 2.0 * m * 64 * 32 * 9
            twin = body == "tc"
            libs = vup_library_calls(vup, up, args, rnd, dtype) \
                if bf16 else {}
            if backward:
                y = vup.conv_vup_fwd_plain(*args, "relu", "relu")[0]
                bargs = (*args[:9], y, rnd(*y.shape, scale=0.1).to(dtype),
                         rnd(n, 32, scale=1e-3), rnd(n, 32, scale=1e-4))
                sargs = (*up, rnd(n, 32, scale=1e-3),
                         rnd(n, 32, scale=1e-4))
                entries = [
                    ("conv_vup_dgrad", bargs, 3 * f_up + f_merge, (0, 5),
                     (0, 1, 2, 5, 6, 7), ("relu", "relu")),
                    ("conv_vup_wgrad", bargs, f_up + f_merge, (), (),
                     ("relu", "relu")),
                    ("upconv_stats_bwd", sargs, 3 * f_up, (0,), (0, 1, 2),
                     ("relu",))]
            else:
                entries = [("conv_vup", args, f_up + f_merge, (0,),
                            (0, 1, 2), ("relu", "relu")),
                           ("upconv_stats", up, f_up, (), (0, 1),
                            ("relu",))]
            what_body = "" if body == "tc" else f" {body} body"
            for name, fargs, flops, elementwise, keep, tail in entries:
                kfn = getattr(vup, f"{name}_kernel" if name != "conv_vup"
                              else "conv_vup_fwd_kernel")
                pfn = getattr(vup, f"{name}_plain" if name != "conv_vup"
                              else "conv_vup_fwd_plain")
                extra = () if backward else ("per_sample",)
                forms = [("per-sample", fargs, extra)]
                if twin:
                    forms.append(("batch", _batch_twin(fargs),
                                  () if backward else (True,)))
                rows = []
                for form, a, ex in forms:
                    def run(a_, ex=ex):
                        return kfn(*a_, *tail, *ex, body=body)
                    plain = functools.partial(pfn, *a, *tail, *ex)
                    what = f"{name} {label} {form} {dtype}{what_body}"
                    fused.reset_launches()
                    got = run(a)
                    if form == "per-sample" and \
                            fused.PS_LAUNCHES != {name: 1}:
                        raise AssertionError(f"{what}: per-sample launches "
                                             f"{fused.PS_LAUNCHES}")
                    with recompute_as_k3(vup, fused,
                                         name == "conv_vup_dgrad"
                                         and body == vup.vup_body(
                                             dtype, 64, 32)):
                        ref = plain()
                    torch.cuda.synchronize()
                    err = 0.0
                    for i, (g_, r_) in enumerate(zip(got, ref)):
                        if r_ is None:
                            continue
                        w_ = f"{what} output {i}"
                        if i in elementwise:
                            err = max(err, check_close(g_, r_, dtype, w_))
                        elif name != "conv_vup" or not bf16:
                            err = max(err, check_rows_sum(g_, r_, w_))
                    if name == "conv_vup":   # the stored output's sums
                        ks, kq = channel_stats(got[0], form == "per-sample")
                        err = max(err, check_rows_sum(got[1], ks, what),
                                  check_rows_sum(got[2], kq, what))
                    if form == "per-sample":
                        check_ps_repeat(run, a, got, keep, what)
                    bnd = bound(flops, peak, a, got)
                    del got, ref
                    lib = cuda_ms(libs[name]) if bf16 else None
                    rows.append([form, err, functools.partial(run, a),
                                 plain, bnd, lib, []])
                for r in rows + rows[::-1]:     # in turns: A, B, B, A
                    r[6].append(cuda_ms(r[2]))
                for form, err, _, plain, bnd, lib, ms in rows:
                    stats.add(name, f"{label} {form}{what_body}", dtype, err,
                              sum(ms) / len(ms), cuda_ms(plain), bnd, lib,
                              False, lib_op="the vup entries' library "
                              "calls (vup_kernel_phase)", body=body)
            del up, args, libs, entries
            if backward:
                del y, bargs, sargs
            torch.cuda.empty_cache()


def check_vup_bodies(launches, bodies, what):
    """Every vup entry a bf16 path launched ran its tensor-core body
    (``vup.vup_body``'s 'tc' at the headline's C_carry 64, C_up 32): the
    five entries share one recompute of u, and none took a CUDA-core
    body."""
    from elektronn3_tpu_torch.ops import vup
    if vup.vup_body(torch.bfloat16, 64, 32) != "tc":
        raise AssertionError("the headline's vup shapes left the 'tc' bodies")
    bad = {k: (launches[k], bodies.get((k, "tc"), 0)) for k in VUP_KERNELS
           if bodies.get((k, "tc"), 0) != launches[k]
           or bodies.get((k, "cuda-core"), 0)}
    if bad:
        raise AssertionError(f"{what}: vup entries off their 'tc' bodies "
                             f"(launches, 'tc' launches): {bad}")
    print(f"{what}: vup entries by body " + ", ".join(
        f"{k}/tc {bodies.get((k, 'tc'), 0)}" for k in VUP_KERNELS
        if launches[k]), flush=True)


def randomize_norms(model, seed):
    """Random affine parameters (scales of both signs) for every norm,
    and random running statistics for the batch norms."""
    from elektronn3_tpu_torch.modules.layers import GroupNorm
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, GroupNorm):
                m.weight.copy_(torch.randn(m.num_channels, generator=g))
                m.bias.copy_(0.2 * torch.randn(m.num_channels, generator=g))
            if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.BatchNorm3d)):
                c = m.num_features
                m.weight.copy_(torch.randn(c, generator=g))
                m.bias.copy_(0.2 * torch.randn(c, generator=g))
                m.running_mean.copy_(0.2 * torch.randn(c, generator=g))
                m.running_var.copy_(0.5 + torch.rand(c, generator=g))


def headline_unet(UNet, seed, dtype=torch.bfloat16, normalization="batch",
                  pallas_flat="auto", activation="relu", vup=False,
                  input_grad=False, **options):
    """The headline 3D UNet; ``options`` are the UNet's other arguments
    (``conv_mode``, ``merge_mode``, ``up_mode``, ...)."""
    return UNet(in_channels=1, out_channels=2, n_blocks=4, start_filts=32,
                planar_blocks=(0,), activation=activation,
                normalization=normalization, dtype=dtype, device="cuda",
                pallas_flat=pallas_flat, vup=vup, input_grad=input_grad,
                generator=torch.Generator().manual_seed(seed), **options)


def sf64_unet(UNet, seed, dtype=torch.bfloat16, pallas_flat="auto"):
    """The start_filts=64 3D model of BASELINE.md's coverage matrix
    (benchmark/coverage_bench.py)."""
    return UNet(in_channels=1, out_channels=2, n_blocks=4, start_filts=64,
                planar_blocks=(0,), normalization="batch", dtype=dtype,
                device="cuda", pallas_flat=pallas_flat,
                generator=torch.Generator().manual_seed(seed))


def unet_2d(UNet, seed, dtype=torch.bfloat16, normalization="batch",
            pallas_flat="auto"):
    """examples/train_simple2d.py's model."""
    return UNet(in_channels=1, out_channels=2, n_blocks=4, start_filts=32,
                activation="relu", normalization=normalization, dim=2,
                dtype=dtype, device="cuda", pallas_flat=pallas_flat,
                generator=torch.Generator().manual_seed(seed))


def check_forward(model, x, what):
    """An eval forward through the kernels against forward(reference=
    True) on the same input: max abs err <= 5e-2 max|ref| (bf16)."""
    with torch.inference_mode():
        y = model(x)
        y_ref = model(x, reference=True)
    torch.cuda.synchronize()
    if y.shape != x.shape[:-1] + (2,) or y.dtype != torch.bfloat16:
        raise AssertionError(f"{what}: output {tuple(y.shape)} {y.dtype}")
    err = (y.float() - y_ref.float()).abs().max().item()
    scale = y_ref.float().abs().max().item()
    if not (bool(torch.isfinite(y).all()) and err <= 5e-2 * scale):
        raise AssertionError(f"{what} vs reference: err {err}, max|ref| "
                             f"{scale}")
    print(f"model: {what} vs reference on {tuple(x.shape)}: max abs err "
          f"{err:.4e} (max|ref| {scale:.4e}, bound 5e-2 x)", flush=True)


def check_probs(probs, ids, shape, what):
    """Finite probabilities of ``shape`` summing to 1, and uint8 argmax
    ids that agree with them where the margin is above bf16 rounding."""
    if probs.shape != shape or not np.isfinite(probs).all():
        raise AssertionError(f"{what} probabilities: bad shape or "
                             "non-finite")
    if np.abs(probs.sum(1) - 1.0).max() > 1e-2:
        raise AssertionError(f"{what} probabilities sum to 1 within "
                             f"{np.abs(probs.sum(1) - 1).max()}")
    if ids.dtype != np.uint8 or ids.shape != (shape[0], 1) + shape[2:]:
        raise AssertionError(f"{what} argmax output {ids.dtype} "
                             f"{ids.shape}")
    margin = np.abs(probs[:, 1] - probs[:, 0])
    agree = (ids[:, 0] == probs.argmax(1)) | (margin <= 2.0 ** -7)
    if not agree.all():
        raise AssertionError(f"{what} argmax disagrees with the "
                             f"probabilities at {int((~agree).sum())} "
                             "pixels")


def check_launched(launches, names, what):
    missing = [k for k in names if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {what} path: "
                             f"{missing}")


SERVING = ("conv_bnact", "conv1_fwd", "pool_bnact", "upconv_bnact")
PREDICT_KW = dict(tile_shape=(64, 128, 128), overlap_shape=(32, 64, 64),
                  float16=True, batch_size=2)


def seeded_volume():
    return torch.randn((1, 1, 64, 256, 256),
                       generator=torch.Generator().manual_seed(3)).numpy()


def predictor_phase(build, what, Predictor, fused, rows, kernels=SERVING,
                    bn=None, per_call=None, per_sample=False):
    """A model of ``build``: the forward check on one input tile, then
    Predictor requests on a seeded (1, 1, 64, 256, 256) volume: a warm-up
    request (launches of the forward check and that request recorded by
    shape: ``rows``), bf16 probabilities timed with the launch counts
    reset just before (every kernel of ``kernels`` launched; with
    ``per_call``, each of K1-K7 exactly ``per_call.get(kernel, 0)``
    times per model call of that request; with ``per_sample``, every
    launch in the per-sample mode), a uint8 argmax."""
    model = build(0, torch.bfloat16).eval()
    randomize_norms(model, 1)
    x = torch.randn((1, *TILE, 1),
                    generator=torch.Generator().manual_seed(2)).cuda()
    print(f"model {what}: levels at the input tile "
          f"{model.level_kinds(x.shape)}", flush=True)
    vol = seeded_volume()
    pred = Predictor(model, **PREDICT_KW)
    with record_shapes(fused, bn) as seen:
        check_forward(model, x, f"{what} UNet bf16 forward")
        del x
        torch.cuda.empty_cache()
        pred.predict(vol)                              # warm-up request
    torch.cuda.synchronize()
    check_rows(seen, rows, f"predictor {what} (forward check and warm-up "
               "request)")
    calls = []
    hook = model.register_forward_hook(lambda *a: calls.append(1))
    fused.reset_launches()
    t0 = time.perf_counter()
    probs = pred.predict(vol)
    dt = time.perf_counter() - t0
    launches = launch_counts(fused)
    BODY_LAUNCHES[f"predictor_{what}"] = dict(fused.BODY_LAUNCHES)
    hook.remove()
    print(f"predictor {what}: bf16 probabilities {probs.shape} in "
          f"{dt:.3f} s = {vol.size / dt / 1e6:.2f} MVox/s; {len(calls)} "
          f"model calls; launches {launches}", flush=True)
    PREDICTED[what] = (probs, vol.size / dt / 1e6)
    if per_sample:
        check_per_sample(launches, fused, f"{what} serving")
    check_k1_bodies(launches, BODY_LAUNCHES[f"predictor_{what}"],
                    f"{what} serving",
                    len(calls) if "conv1_fwd" in kernels else None)
    if per_call is not None:
        want = {k: per_call.get(k, 0) * len(calls) for k in FUSED_KERNELS}
        if {k: launches[k] for k in FUSED_KERNELS} != want:
            raise AssertionError(f"{what} serving launches {launches}, "
                                 f"expected {want}")
    t0 = time.perf_counter()
    ids = Predictor(model, argmax_with_threshold=True,
                    **PREDICT_KW).predict(vol)
    dt_ids = time.perf_counter() - t0
    print(f"predictor {what}: uint8 argmax {ids.shape} in {dt_ids:.3f} s = "
          f"{vol.size / dt_ids / 1e6:.2f} MVox/s", flush=True)
    check_probs(probs, ids, (1, 2, 64, 256, 256), what)
    check_launched(launches, kernels, f"{what} serving")
    return launches


def check_per_sample(launches, fused, what):
    """Every launch counted in ``launches`` (K1-K7, row 13's and the vup
    entries) was in the per-sample mode (``fused.PS_LAUNCHES``), and
    there was one."""
    want = {k: n for k, n in launches.items() if k in fused.LAUNCHES and n}
    got = {k: fused.PS_LAUNCHES.get(k, 0) for k in want}
    if not want or got != want:
        raise AssertionError(f"{what}: per-sample launches {got}, all "
                             f"launches {want}")
    print(f"{what}: every launch in the per-sample mode: {got}", flush=True)


def predictor_group_phase(build, build_instance, Predictor, fused):
    """The headline model with group norm (8 groups; random affine
    parameters) served through the kernels' per-sample mode:
    :func:`predictor_phase` (its forward check on one tile, the request,
    row 3's kernel once a model call, no CUDA-core K1, and the per-sample
    launches of K1, K2 and K3 at the shapes of :data:`GROUP_SERVE_ROWS`),
    then the same request at ``batch_size=1``, whose probabilities must
    agree with the batch-2 request's within the bf16 forward tolerance
    (per-sample statistics: a tile's output does not depend on its batch),
    the forward check on a batch of two tiles of different scales, and one
    eval forward of the instance-norm model against its reference."""
    launches = predictor_phase(build, "group", Predictor, fused,
                               GROUP_SERVE_ROWS)
    probs2, mvox = PREDICTED["group"]
    model = build(0, torch.bfloat16).eval()
    randomize_norms(model, 1)
    probs1 = Predictor(model, **dict(PREDICT_KW, batch_size=1)).predict(
        seeded_volume())
    err = float(np.abs(probs1 - probs2).max())
    if err > 5e-2 * float(np.abs(probs2).max()):
        raise AssertionError(f"predictor group: batch_size 1 against 2: max "
                             f"abs err {err}")
    print(f"predictor group: batch_size 1 against 2: max abs err {err:.4e} "
          "(bound 5e-2 x max|p|)", flush=True)
    x = torch.randn((2, *TILE, 1),
                    generator=torch.Generator().manual_seed(5)).cuda()
    x[1] *= 3.0
    check_forward(model, x, "group UNet bf16 forward, 2 tiles")
    del model
    torch.cuda.empty_cache()
    inst = build_instance(0, torch.bfloat16).eval()
    randomize_norms(inst, 1)
    check_forward(inst, x[:1], "instance UNet bf16 forward")
    del inst, x
    torch.cuda.empty_cache()
    print(f"predictor MVox/s in this run: group {mvox:.2f} against the "
          f"headline's {PREDICTED['3D'][1]:.2f} ('batchp' "
          f"{PREDICTED['batchp'][1]:.2f})", flush=True)
    return launches


def predictor_2d_phase(UNet, Predictor, fused, normalization="batch"):
    """The 2D model: the forward check on a batch of 8 images, then a
    whole-image request on (8, 1, 640, 640) and a tiled request on
    (1, 1, 2560, 2560), each after a warm-up request; the launch counts
    cover the two timed requests. With a group ``normalization`` (path
    "2D group"): rows 16 and 19 per sample, every launch per sample, and
    an image's probabilities served alone against in the batch."""
    group = normalization != "batch"
    what = "2D group" if group else "2D"
    model = unet_2d(UNet, 0, normalization=normalization).eval()
    randomize_norms(model, 1)
    x = torch.randn((BATCH, *IMAGE, 1),
                    generator=torch.Generator().manual_seed(2)).cuda()
    if group:
        x[1] *= 3.0
    check_forward(model, x, f"{what} UNet bf16 forward")
    del x
    torch.cuda.empty_cache()

    rng = np.random.default_rng(3)
    images = rng.standard_normal((BATCH, 1, *IMAGE), np.float32)
    big = rng.standard_normal((1, 1, 2560, 2560), np.float32)
    tiled_kw = dict(tile_shape=(512, 512), overlap_shape=(64, 64),
                    batch_size=4, float16=True)
    whole = Predictor(model, float16=True)
    tiled = Predictor(model, **tiled_kw)
    with record_shapes(fused) as seen:
        whole.predict(images)                          # warm-up requests
        tiled.predict(big)
    torch.cuda.synchronize()
    check_rows(seen, GROUP_2D_SERVE_ROWS if group else (16, 19),
               f"predictor {what} (warm-up requests)")
    fused.reset_launches()
    t0 = time.perf_counter()
    probs = whole.predict(images)
    dt_w = time.perf_counter() - t0
    t0 = time.perf_counter()
    probs_big = tiled.predict(big)
    dt_t = time.perf_counter() - t0
    launches = launch_counts(fused)
    BODY_LAUNCHES[f"predictor_{what}"] = dict(fused.BODY_LAUNCHES)
    if group:
        check_per_sample(launches, fused, f"{what} serving")
    print(f"predictor {what}: whole-image bf16 probabilities {probs.shape} in "
          f"{dt_w:.3f} s = {images.size / dt_w / 1e6:.2f} MPix/s; tiled "
          f"{probs_big.shape} (tile 512, overlap 64, batch 4) in "
          f"{dt_t:.3f} s = {big.size / dt_t / 1e6:.2f} MPix/s; launches "
          f"{launches}", flush=True)
    t0 = time.perf_counter()
    ids = Predictor(model, argmax_with_threshold=True,
                    **tiled_kw).predict(big)
    dt_ids = time.perf_counter() - t0
    print(f"predictor {what}: tiled uint8 argmax {ids.shape} in "
          f"{dt_ids:.3f} s = {big.size / dt_ids / 1e6:.2f} MPix/s",
          flush=True)
    ids_whole = Predictor(model, argmax_with_threshold=True,
                          float16=True).predict(images)
    check_probs(probs, ids_whole, (BATCH, 2, *IMAGE), f"{what} whole-image")
    check_probs(probs_big, ids, (1, 2, 2560, 2560), f"{what} tiled")
    check_launched(launches, SERVING, f"{what} serving")
    check_k1_bodies(launches, BODY_LAUNCHES[f"predictor_{what}"],
                    f"{what} serving")
    if group:
        # Each image is a sample with its own statistics: served alone,
        # its probabilities are those of the batch (the kernel levels'
        # bits; the library levels' convs may pick other algorithms by
        # batch: the bf16 forward tolerance).
        alone = whole.predict(images[-1:])
        err = float(np.abs(alone[0] - probs[-1]).max())
        if err > 5e-2 * float(np.abs(probs[-1]).max()):
            raise AssertionError(f"{what}: an image alone against in the "
                                 f"batch: max abs err {err}")
        print(f"predictor {what}: the last image alone against in the "
              f"batch of {BATCH}: max abs err {err:.4e} (bound 5e-2 x "
              "max|p|)", flush=True)
    PREDICTED[what] = (probs, images.size / dt_w / 1e6)
    return launches


def _step_grads(model, crit, x, y, reference):
    model.train()
    model.zero_grad(set_to_none=True)
    loss = crit(model(x, reference=reference), y)
    loss.backward()
    return float(loss.detach()), {n: p.grad.float().clone()
                                  for n, p in model.named_parameters()}


def check_train_step(build, crit, x, y, zero_bf16=1e-2, zero_bias=True,
                     what="", grads_fn=None, exact_zero=(), whole=0.0):
    """One step's loss, parameter gradients and new running statistics
    on the kernel path against the same step through reference=True,
    from equal parameters and running statistics, in float32 and in
    bfloat16. Per gradient leaf, in the L2 norm:
    |g - r| <= rel |r| + NOISE_FACTOR |r' - r|, with rel 1e-3 (float32)
    or 1e-2 (bf16) and r' the reference step on an input moved by about one ulp
    of the dtype (2^-23 or 2^-8 relative, seeded): the step's own
    rounding noise. A batch norm over millions of voxels makes a weight
    gradient the small difference of large float32 sums (and in bf16
    each term is rounded before the weight-gradient product, as in JAX),
    so that noise can be a large share of a leaf; the kernels sum in
    another order than the plain versions. The bias of a conv that
    feeds a batch norm has an exact gradient of 0: both of its computed
    gradients must be at most 1e-4 (float32) or ``zero_bf16`` (bf16) of
    the weight gradient's norm (``zero_bias`` False: held like the other
    leaves, as under a group norm of several channels a group, where
    that gradient is no exact 0). The loss within 1e-4 (float32) or 1e-2
    (bf16) relative; each running statistic within 1e-3 (float32) or
    5e-2 (bf16) of its max. Returns the worst gradient err/bound by
    dtype ('float32', 'bfloat16'); ``what`` labels the printed lines.
    ``grads_fn(model, crit, x, y, reference)`` -> (loss, gradients)
    replaces :func:`_step_grads` (a trainer's own step: accumulated
    micro-batches, three forwards); ``exact_zero`` names more leaves whose
    exact gradient is 0, held like the biases above; ``whole`` adds that
    share of the whole reference gradient's norm to each leaf's bound (a
    loss whose gradient is the difference of nearly equal terms, as
    ``_zoo_hold`` does for the zoo: the kernels' float32 sums, in
    another order than the plain versions' and not the same bits from
    run to run, leave a small leaf off by more than its own ulp
    noise)."""
    grads_fn = grads_fn or _step_grads
    failures = []
    worst_q = {}
    for dtype, rel, ulp, zero in ((torch.float32, 1e-3, 2.0 ** -23, 1e-4),
                                  (torch.bfloat16, 1e-2, 2.0 ** -8,
                                   zero_bf16)):
        bf16 = dtype == torch.bfloat16
        model = build(4, dtype)
        ref_model = copy.deepcopy(model)
        lk, grads = grads_fn(model, crit, x, y, False)
        lr, ref = grads_fn(ref_model, crit, x, y, True)
        noise = torch.randn(x.shape, generator=torch.Generator(
            device=x.device).manual_seed(11), device=x.device)
        _, moved = grads_fn(copy.deepcopy(model), crit,
                            x * (1 + ulp * noise), y, True)
        torch.cuda.synchronize()
        if not (np.isfinite(lk) and abs(lk - lr) <= (1e-2 if bf16 else 1e-4)
                * abs(lr)):
            failures.append(f"{dtype} loss {lk} vs reference {lr}")
        rows = []
        worst_zero = [0.0, 0.0]
        floor = whole * float(torch.sqrt(sum(
            (r.float() ** 2).sum() for r in ref.values())))
        for name, g in grads.items():
            r = ref[name]
            if name in exact_zero or (
                    zero_bias and name.endswith(".bias")
                    and name != "conv_final.bias" and "norm" not in name):
                wnorm = float(ref[name[:-len("bias")] + "weight"].norm())
                qg, qr = float(g.norm()) / wnorm, float(r.norm()) / wnorm
                q = max(qg, qr)
                worst_zero = [max(worst_zero[0], qg), max(worst_zero[1], qr)]
                if not bool(torch.isfinite(g).all()) or q > zero:
                    failures.append(f"{dtype} grad {name} (exactly 0): "
                                    f"{qg} (kernels) and {qr} (reference) "
                                    "of the weight gradient")
                continue
            err = float((g - r).norm())
            rn = float(r.norm())
            nz = float((moved[name] - r).norm())
            bound_ = rel * rn + NOISE_FACTOR * nz + floor
            rows.append((err / max(bound_, 1e-30), name, err, nz, rn))
            if not bool(torch.isfinite(g).all()) or err > bound_:
                failures.append(f"{dtype} grad {name}: |g - r| {err} > "
                                f"bound {bound_} (noise {nz}, |r| {rn})")
        rows.sort(reverse=True)
        worst_q[str(dtype)[6:]] = rows[0][0]
        for q, n, e, nz, rn in rows:
            print(f"  leaf {str(dtype)[6:]:8s} {n:28s} |g-r| {e:.3e}  "
                  f"noise |r'-r| {nz:.3e}  |r| {rn:.3e}  err/noise "
                  f"{e / max(nz, 1e-30):6.3f}  err/|r| "
                  f"{e / max(rn, 1e-30):.2e}  err/bound {q:.3f}")
        by_noise = max(rows, key=lambda t: t[2] / max(t[3], 1e-30))
        worst_noise = by_noise[2] / max(by_noise[3], 1e-30)
        buffers = dict(ref_model.named_buffers())
        worst_buf = 0.0
        for name, b in model.named_buffers():
            if b.dtype != torch.float32:
                continue
            rb = buffers[name]
            brel = float((b - rb).abs().max()) / float(rb.abs().max())
            worst_buf = max(worst_buf, brel)
            if brel > (5e-2 if bf16 else 1e-3):
                failures.append(f"{dtype} running statistic {name}: "
                                f"relative err {brel}")
        print(f"train{what}: one {str(dtype)[6:]} step vs reference=True: "
              f"loss "
              f"{lk:.6f} vs {lr:.6f}; {len(rows)} gradients, worst "
              f"err/bound: " + ", ".join(
                  f"{n} {q:.3f} (|g-r| {e:.3e}, noise {nz:.3e}, "
                  f"|r| {rn:.3e})" for q, n, e, nz, rn in rows[:4])
              + f"; worst err/noise {worst_noise:.3f} ({by_noise[1]}); "
              f"worst err/|r| {max(t[2] / max(t[4], 1e-30) for t in rows):.2e}"
              f"; biases before a batch norm at most {worst_zero[0]:.2e} "
              f"(kernels) and {worst_zero[1]:.2e} (reference) of their "
              f"weight gradient; running statistics max rel err "
              f"{worst_buf:.3e}", flush=True)
        del model, ref_model
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))
    return worst_q


def timed_steps(train_step, model, crit, opt, batches, reference,
                before=None, warmup=WARMUP, steps=STEPS):
    """bench.py's loop: ``warmup`` steps, then ``steps`` timed steps
    cycling the device-resident batches, ended by a host read of the
    loss; ``before`` runs just before the timed steps."""
    for _ in range(warmup):
        loss = train_step(model, crit, opt, *batches[0], reference=reference)
    float(loss)
    if before is not None:
        before()
    t0 = time.perf_counter()
    for i in range(steps):
        loss = train_step(model, crit, opt, *batches[i % len(batches)],
                          reference=reference)
    final = float(loss)
    dt = (time.perf_counter() - t0) / steps
    if not np.isfinite(final):
        raise AssertionError(f"non-finite loss {final}")
    return dt


def bench_batches(shape):
    """N_BATCHES seeded device-resident (input, target) batches of
    ``shape``, the same in every phase that times bench.py's loop."""
    g = torch.Generator(device="cuda").manual_seed(7)
    return [(torch.randn(shape, generator=g, device="cuda"),
             torch.randint(0, 2, shape[:-1], generator=g, device="cuda"))
            for _ in range(N_BATCHES)]


def train_phase(build, shape, what, unit, CEDiceLoss, train_step, fused,
                rows=(), kernels=K1_K7, bn=None, zero_bf16=1e-2,
                zero_bias=True, per_sample=False, plain=True):
    """Timed training steps of ``build``'s model on batches of ``shape``
    (kernels, plain (unless not ``plain``), kernels again), every kernel
    of ``kernels``
    launched (``per_sample``: every launch of K1-K7 and row 13's in the
    per-sample mode), the ``rows``' shapes launched (``bn``: the
    'batchp' kernels' too), a falling loss, and one step against the
    reference (``check_train_step`` with ``zero_bf16`` and
    ``zero_bias``)."""
    crit = CEDiceLoss(1.0, 1.0)
    batches = bench_batches(shape)
    model = build(4, torch.bfloat16)

    vox = int(np.prod(shape))
    plain_model = copy.deepcopy(model) if plain else None
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    torch.cuda.reset_peak_memory_stats()
    dt_k = timed_steps(train_step, model, crit, opt, batches, False,
                       fused.reset_launches)
    launches = launch_counts(fused)
    bodies = dict(fused.BODY_LAUNCHES)
    ps_launches = dict(fused.PS_LAUNCHES)
    BODY_LAUNCHES[f"train_{what}"] = bodies
    peak = torch.cuda.max_memory_allocated() / 1e9
    dt_p = peak_p = float("nan")
    if plain:
        torch.cuda.reset_peak_memory_stats()
        dt_p = timed_steps(train_step, plain_model, crit,
                           torch.optim.Adam(plain_model.parameters(),
                                            lr=1e-3),
                           batches, True, warmup=PLAIN_WARMUP,
                           steps=PLAIN_STEPS)
        peak_p = torch.cuda.max_memory_allocated() / 1e9
    del plain_model
    dt_k2 = timed_steps(train_step, model, crit, opt, batches, False)
    STEP_MS[what] = (dt_k * 1e3, dt_p * 1e3, dt_k2 * 1e3)
    for label, dt in (("kernels", dt_k), ("plain", dt_p),
                      ("kernels again", dt_k2)):
        if dt == dt:   # the plain arm may not run (nan)
            print(f"train {what}: {label:13s} step {dt * 1e3:9.2f} ms = "
                  f"{vox / dt / 1e6:7.2f} {unit}/s (batch {shape[0]} of "
                  f"{shape[1:-1]}, bf16, CEDiceLoss, Adam)", flush=True)
    print(f"train {what}: peak device memory {peak:.2f} GB (kernels), "
          f"{peak_p:.2f} GB (plain); launches over {STEPS} steps "
          f"{launches}; by body " + ", ".join(
              f"{k}/{b} {n}" for (k, b), n in sorted(bodies.items())),
          flush=True)
    check_launched(launches, kernels, f"{what} training")
    if per_sample:
        want = {k: launches[k] for k in kernels if k in fused.LAUNCHES}
        if {k: ps_launches.get(k, 0) for k in want} != want:
            raise AssertionError(f"{what} training: per-sample launches "
                                 f"{ps_launches}, all launches {want}")
        print(f"train {what}: every launch of {', '.join(want)} in the "
              f"per-sample mode over {STEPS} steps: {ps_launches}",
              flush=True)
    check_k1_bodies(launches, bodies, f"{what} training",
                    STEPS if "conv1_fwd" in kernels else None)
    # Every bf16 K4 launch on its tensor-core body; row 13's kernel once a
    # step (without dx) wherever L0 runs the kernels.
    if bodies.get(("conv_bnact_dgrad", "tc"), 0) != \
            launches["conv_bnact_dgrad"]:
        raise AssertionError(f"{what} training: K4 bodies {bodies}")
    if "conv1_bwd" in kernels and (
            launches["conv1_bwd"] != STEPS
            or bodies.get(("conv1_bwd", "conv1"), 0) != STEPS):
        raise AssertionError(f"{what} training: row 13's kernel "
                             f"{launches['conv1_bwd']} times, bodies "
                             f"{bodies}")

    # A fixed batch whose target is learnable from the input (the sign
    # of x; the timed batches' targets are noise).
    fixed = (batches[0][0], (batches[0][0][..., 0] > 0).long())
    with record_shapes(fused, bn) as seen:
        losses = [float(train_step(model, crit, opt, *fixed))
                  for _ in range(10)]
    if rows:
        check_rows(seen, rows, f"train {what} (10 fixed-batch steps)")
    if not (np.isfinite(losses).all() and losses[-1] < 0.9 * losses[0]):
        raise AssertionError(f"loss on a fixed batch does not fall: "
                             f"{losses}")
    print(f"train {what}: loss on a fixed batch (target: sign of the "
          f"input) over 10 steps {losses[0]:.4f} -> {losses[-1]:.4f}",
          flush=True)
    check_train_step(build, crit, *batches[0], zero_bf16=zero_bf16,
                     zero_bias=zero_bias)
    return launches, model, crit, opt, batches


def ps_grad_repeat(model, crit, batch, fused, what):
    """The per-sample dinv and dshift of every backward kernel launch of
    one training step, the same bits on a second step from the same
    parameters and batch (cuDNN's deterministic algorithms on the library
    levels, some of whose backward algorithms add with atomics, so that
    each kernel sees the same inputs twice)."""
    from elektronn3_tpu_torch.ops import vup
    # (module, entry, its outputs that are prologue gradients)
    entries = [(fused, n, (1, 2)) for n in (
        "conv_bnact_dgrad_kernel", "conv1_bwd_kernel",
        "pool_bnact_bwd_kernel", "upconv_bnact_bwd_kernel")] + [
        (vup, "conv_vup_dgrad_kernel", (1, 2, 6, 7)),
        (vup, "upconv_stats_bwd_kernel", (1, 2))]
    real = {n: getattr(mod, n) for mod, n, _ in entries}
    items = {n: i for _, n, i in entries}
    got = []

    def spy(n):
        def f(*a, **k):
            out = real[n](*a, **k)
            got.extend(out[i].clone() for i in items[n] if out[i] is not None
                       and out[i].dim() == 2)
            return out
        return f
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = []
    try:
        for mod, n, _ in entries:
            setattr(mod, n, spy(n))
        for _ in range(2):
            got.clear()
            model.zero_grad(set_to_none=True)
            crit(model.train()(batch[0]), batch[1]).backward()
            torch.cuda.synchronize()
            runs.append(list(got))
    finally:
        torch.backends.cudnn.deterministic = det
        for mod, n, _ in entries:
            setattr(mod, n, real[n])
    same = len(runs[0]) == len(runs[1]) and all(
        torch.equal(a, b) for a, b in zip(*runs))
    print(f"train {what}: {len(runs[0])} per-sample dinv/dshift outputs of "
          f"one step, the same bits on a rerun: {same}", flush=True)
    if not same or not runs[0]:
        raise AssertionError(f"{what}: per-sample dinv/dshift differ on a "
                             "rerun (or none was launched)")


def step_breakdown(what, train_step, model, crit, opt, batches):
    """Device time of three training steps by kernel, from
    torch.profiler: each of the port's kernels' and the library's top
    entries per step, and their total; row 3's kernel
    (``conv1_fwd_kernel``) and the per-sample sums' reduction
    (``ps_sum_chunks``) by name."""
    from torch.profiler import ProfilerActivity, profile
    train_step(model, crit, opt, *batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(3):
            train_step(model, crit, opt, *batches[i])
        torch.cuda.synchronize()
    by = collections.Counter()
    for e in prof.events():
        if e.device_type.name == "CUDA":
            name = re.split(r"[<(]", re.sub(
                r"^void ", "", e.name.replace("(anonymous namespace)::",
                                              "")))[0]
            by[name] += e.time_range.elapsed_us() / 3e3
    total = sum(by.values())
    print(f"train {what}: device time a step {total:.3f} ms; row 3's "
          f"conv1_fwd_kernel {by.get('conv1_fwd_kernel', 0.0):.3f} ms, "
          f"ps_sum_chunks {by.get('ps_sum_chunks', 0.0):.3f} ms; by "
          "kernel: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                 by.most_common(16)), flush=True)
    return total, by


def group_train_phase(build, build_library, what, CEDiceLoss, train_step,
                      fused, shape=(BATCH, *PATCH, 1), rows=GROUP_TRAIN_ROWS,
                      unit="MVox", beside="3D"):
    """The headline model with ``what`` norm trained at bench.py's step on
    the kernels' per-sample mode (:func:`train_phase` without its plain
    arm: every launch of K1-K7 and row 13's per sample, the per-sample
    backward rows' shapes, the step against ``reference=True`` in float32
    and bf16, its conv biases held like any leaf under 'group'), the
    per-sample dinv/dshift the same bits on a rerun; with
    ``build_library`` the step's device time by kernel, and then the same
    model with ``pallas_flat=False`` (the library plan: no kernel
    launched) timed with the same loop, beside the 'batch' model's step
    of the same shape (``beside``; the 2D group model: ``shape``, ``rows``
    and ``unit`` its own)."""
    launches, model, crit, opt, batches = train_phase(
        build, shape, what, unit, CEDiceLoss, train_step, fused, rows,
        zero_bias=what == "instance", per_sample=True, plain=False)
    ps_grad_repeat(model, crit, batches[0], fused, what)
    if build_library is None:
        return launches
    step_breakdown(what, train_step, model, crit, opt, batches)
    del model, opt
    torch.cuda.empty_cache()
    lib = build_library(4, torch.bfloat16)
    if lib.level_kinds(shape) != ["library"] * 4:
        raise AssertionError(f"{what} pallas_flat=False levels "
                             f"{lib.level_kinds(shape)}")
    lopt = torch.optim.Adam(lib.parameters(), lr=1e-3)
    dt = timed_steps(train_step, lib, crit, lopt, batches, False,
                     fused.reset_launches)
    if any(launch_counts(fused).values()):
        raise AssertionError(f"{what} pallas_flat=False launched "
                             f"{launch_counts(fused)}")
    k, _, k2 = STEP_MS[what]
    print(f"train {what} pallas_flat=False: step {dt * 1e3:9.2f} ms = "
          f"{int(np.prod(shape)) / dt / 1e6:7.2f} {unit}/s; beside the "
          f"kernel plan in this run: kernels {k:.2f}, kernels again "
          f"{k2:.2f} ms; the 'batch' model's step ({beside}) "
          f"{STEP_MS[beside][0]:.2f} ms", flush=True)
    del lib, lopt, batches
    torch.cuda.empty_cache()
    return launches


def odd_l1_phase(build, CEDiceLoss, fused):
    """Rows 11/12: the headline model on a batch of 2 of (45, 88, 88),
    whose L1 has an odd depth under the (2, 2, 2) pool and declines, so
    L0's decoder upconv takes L1's dense output. One training step with
    the launches recorded by shape, then one step against
    reference=True (``check_train_step``)."""
    crit = CEDiceLoss(1.0, 1.0)
    g = torch.Generator(device="cuda").manual_seed(9)
    shape = (2, *ODD_L1, 1)
    x = torch.randn(shape, generator=g, device="cuda")
    y = torch.randint(0, 2, shape[:-1], generator=g, device="cuda")
    model = build(4, torch.bfloat16)
    plan = model.plan(shape)
    if plan != [True, False, False, False]:
        raise AssertionError(f"odd L1 depth: plan {plan}")
    with record_shapes(fused) as seen:
        _step_grads(model, crit, x, y, False)
    torch.cuda.synchronize()
    check_rows(seen, (11, 12), f"train 3D odd L1 {ODD_L1} (one step)")
    del model
    check_train_step(build, crit, x, y)


def batchp_library_phase(build, CEDiceLoss, train_step, fused, bn,
                         profiling=False):
    """The 'batchp' headline model with ``pallas_flat=False``: every
    level on the library ops, its 17 norms on K8-K11. The forward check
    on one Predictor input tile, then timed steps at batch 2 of
    (44, 88, 88) (kernels, plain; counts reset just before the kernels'
    timed steps: K8-K11 launched, K1-K7 not), one more step with the
    launches recorded by shape (K8-K11 at every level's (R, C),
    BATCHP_LIBRARY_ROWS), and one step against reference=True
    (``check_train_step``)."""
    model = build(0, torch.bfloat16).eval()
    randomize_norms(model, 1)
    x = torch.randn((1, *TILE, 1),
                    generator=torch.Generator().manual_seed(2)).cuda()
    check_forward(model, x, "batchp pallas_flat=False UNet bf16 forward")
    del model, x
    torch.cuda.empty_cache()
    crit = CEDiceLoss(1.0, 1.0)
    g = torch.Generator(device="cuda").manual_seed(8)
    shape = (2, *PATCH, 1)
    batches = [(torch.randn(shape, generator=g, device="cuda"),
                torch.randint(0, 2, shape[:-1], generator=g, device="cuda"))
               for _ in range(N_BATCHES)]
    model = build(4, torch.bfloat16)
    if model.plan(shape) != [False] * 4:
        raise AssertionError(f"pallas_flat=False plan {model.plan(shape)}")
    plain_model = copy.deepcopy(model)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    dt_k = timed_steps(train_step, model, crit, opt, batches, False,
                       fused.reset_launches)
    launches = launch_counts(fused)
    dt_p = timed_steps(train_step, plain_model, crit,
                       torch.optim.Adam(plain_model.parameters(), lr=1e-3),
                       batches, True)
    vox = int(np.prod(shape))
    for label, dt in (("kernels", dt_k), ("plain", dt_p)):
        print(f"train batchp pallas_flat=False: {label:8s} step "
              f"{dt * 1e3:9.2f} ms = {vox / dt / 1e6:7.2f} MVox/s (batch 2 "
              f"of {PATCH}, bf16, CEDiceLoss, Adam)", flush=True)
    print(f"train batchp pallas_flat=False: launches over {STEPS} steps "
          f"{launches}", flush=True)
    check_launched(launches, BN_KERNELS, "batchp pallas_flat=False training")
    if any(launches[k] for k in FUSED_KERNELS):
        raise AssertionError(f"pallas_flat=False launched K1-K7: {launches}")
    with record_shapes(fused, bn) as seen:
        train_step(model, crit, opt, *batches[0])
    torch.cuda.synchronize()
    check_rows(seen, BATCHP_LIBRARY_ROWS,
               "train batchp pallas_flat=False (one step)")
    if profiling:
        profile_phase(train_step, model, crit, opt, batches)
    del model, plain_model, batches, opt
    torch.cuda.empty_cache()
    x = torch.randn(shape, generator=g, device="cuda")
    # On the library path a conv's bias gradient is the sum of its batch
    # norm's dx, which K11 (like JAX's _bn_bwd) stores in bf16: over L0's
    # 681,472 voxels the rounding leaves the exactly-0 gradient of L0
    # conv1's bias (1 input channel, a small weight gradient) at about
    # 1.5e-2 of the weight gradient's norm on an H100, on the kernels and
    # on the reference alike, above the 1e-2 that the kernel levels'
    # float32 bias sums meet.
    check_train_step(build, crit, x, torch.randint(0, 2, shape[:-1],
                                                   generator=g,
                                                   device="cuda"),
                     zero_bf16=5e-2)
    return launches


def crossover_phase(UNet, Predictor, CEDiceLoss, train_step, unet_mod):
    """The card's numbers for JAX's C=128 voxel gate: the sf=64 training
    step (bench.py's loop) on the kernel plan (L1 on the kernels), on the
    library arm (FUSED128_MIN_VOX raised above L1's 85,184 voxels: L1 and
    its decoder on the library, L0 on the kernels) and with
    pallas_flat=False, then the kernel plan again; the headline 3D
    Predictor request with L2 on the kernels and on the library (the
    same raised constant, above its input tile's L2 of 262,144 voxels),
    one request of each in turn, CROSSOVER_PAIRS times after a warm-up
    pair, through one Predictor (the plan follows the constant)."""
    default = unet_mod.FUSED128_MIN_VOX
    raised = 300_000
    crit = CEDiceLoss(1.0, 1.0)
    shape = (BATCH, *PATCH, 1)
    batches = bench_batches(shape)
    vox = int(np.prod(shape))
    try:
        for label, gate, pf in (("kernel plan", default, "auto"),
                                ("library arm", raised, "auto"),
                                ("pallas_flat=False", default, False),
                                ("kernel plan again", default, "auto")):
            unet_mod.FUSED128_MIN_VOX = gate
            model = sf64_unet(UNet, 4, pallas_flat=pf)
            opt = torch.optim.Adam(model.parameters(), lr=1e-3)
            dt = timed_steps(train_step, model, crit, opt, batches, False)
            print(f"crossover sf64 step, {label:17s} (plan "
                  f"{model.plan(shape)}, FUSED128_MIN_VOX {gate}): "
                  f"{dt * 1e3:9.2f} ms = {vox / dt / 1e6:7.2f} MVox/s",
                  flush=True)
            del model, opt
            torch.cuda.empty_cache()
        del batches
        vol = seeded_volume()
        model = headline_unet(UNet, 0).eval()
        randomize_norms(model, 1)
        pred = Predictor(model, **PREDICT_KW)
        arms = (("L2 on the kernels", default),
                ("L2 on the library", raised))
        readings = {label: [] for label, _ in arms}
        for rep in range(1 + CROSSOVER_PAIRS):    # the first pair warms up
            for label, gate in arms:
                unet_mod.FUSED128_MIN_VOX = gate
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pred.predict(vol)
                if rep:
                    readings[label].append(
                        vol.size / (time.perf_counter() - t0) / 1e6)
        for label, gate in arms:
            unet_mod.FUSED128_MIN_VOX = gate
            r = readings[label]
            print(f"crossover headline predictor, {label} (plan "
                  f"{model.plan((2, *TILE, 1))}), {len(r)} requests "
                  f"alternating with the other plan: "
                  + " ".join(f"{v:.2f}" for v in r)
                  + f" MVox/s, median {float(np.median(r)):.2f}", flush=True)
        del model, pred
        torch.cuda.empty_cache()
    finally:
        unet_mod.FUSED128_MIN_VOX = default


def silu_library_phase(build, CEDiceLoss, train_step, fused):
    """The silu model with ``pallas_flat=False`` (every level on the
    library ops; no K1-K11 launched) at bench.py's step, timed with the
    same loop and batches as train_phase's arms."""
    shape = (BATCH, *PATCH, 1)
    batches = bench_batches(shape)
    model = build(4, torch.bfloat16)
    if model.level_kinds(shape) != ["library"] * 4:
        raise AssertionError(f"silu pallas_flat=False levels "
                             f"{model.level_kinds(shape)}")
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    dt = timed_steps(train_step, model, CEDiceLoss(1.0, 1.0), opt, batches,
                     False, fused.reset_launches)
    launches = launch_counts(fused)
    if any(launches.values()):
        raise AssertionError(f"silu pallas_flat=False launched {launches}")
    k, p, k2 = STEP_MS["silu"]
    print(f"train silu pallas_flat=False: step {dt * 1e3:9.2f} ms = "
          f"{int(np.prod(shape)) / dt / 1e6:7.2f} MVox/s; beside "
          f"pallas_flat=True in this run: kernels {k:.2f}, plain {p:.2f}, "
          f"kernels again {k2:.2f} ms", flush=True)
    return launches


def vup_pair_phase(build, CEDiceLoss, train_step, fused, what="vup"):
    """The headline step at bench.py's shapes with ``vup`` off and on in
    turn (off, on, on, off), each arm a fresh model of the same seed, the
    same timed loop and batches as train_phase's, the peak allocated
    memory reset just before each arm's timed steps (the model, its Adam
    state and the batches are live in both arms). Each vup arm's peak
    must be at least 150 MB under each ``vup=False`` arm's: the vup path
    never stores the upconv output of up_2 (174.4 MB in bf16)."""
    shape = (BATCH, *PATCH, 1)
    batches = bench_batches(shape)
    crit = CEDiceLoss(1.0, 1.0)
    readings = {False: [], True: []}
    for on in (False, True, True, False):
        model = build(4, torch.bfloat16, on)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        dt = timed_steps(train_step, model, crit, opt, batches, False,
                         torch.cuda.reset_peak_memory_stats)
        readings[on].append((dt * 1e3, torch.cuda.max_memory_allocated()))
        del model, opt
        torch.cuda.empty_cache()
    for on in (False, True):
        print(f"train {what} vup={on!s:5s}: step " + ", ".join(
            f"{ms:.2f}" for ms, _ in readings[on]) + " ms; peak allocated "
            + ", ".join(f"{b / 1e6:.1f}" for _, b in readings[on])
            + " MB", flush=True)
    saved = min(b for _, b in readings[False]) - max(
        b for _, b in readings[True])
    print(f"train {what}: peak allocated {saved / 1e6:.1f} MB under "
          f"vup=False (batch {BATCH} of {PATCH}, bf16)", flush=True)
    if saved < 150e6:
        raise AssertionError(f"{what} step's peak only {saved / 1e6:.1f} MB"
                             " under vup=False's")


def group_vup_phase(build, Predictor, CEDiceLoss, train_step, fused):
    """The headline model with group norm and ``vup=True`` (random affine
    parameters, bf16): served (:func:`predictor_phase`: ``conv_vup`` and
    row 22's pass once a model call, every launch per sample, rows 1-vup
    and 22 per sample at the request's batch of two tiles, the vup entries
    on their 'tc' bodies), trained at bench.py's step (:func:`train_phase`
    without its plain arm: the five entries once a step, every launch of
    K1-K7, row 13's and the vup entries per sample, rows 1-vup, 9, 22 and
    23 per sample, the step against ``reference=True`` in float32 and
    bf16), the per-sample prologue gradients the same bits on a rerun,
    and the step with ``vup`` off and on in turn, each arm's peak
    allocated memory (:func:`vup_pair_phase`: the vup arm 150 MB under)."""
    launches = {}
    launches["predictor_group_vup"] = predictor_phase(
        build, "group vup", Predictor, fused, GROUP_VUP_SERVE_ROWS,
        SERVING + ("conv_vup", "upconv_stats"),
        per_call={"conv_bnact": 11, "conv1_fwd": 1, "pool_bnact": 3,
                  "upconv_bnact": 2, "conv_vup": 1, "upconv_stats": 1},
        per_sample=True)
    check_vup_bodies(launches["predictor_group_vup"],
                     BODY_LAUNCHES["predictor_group vup"],
                     "group vup serving")
    torch.cuda.empty_cache()
    launches["train_group_vup"], model, crit, opt, batches = train_phase(
        build, (BATCH, *PATCH, 1), "group vup", "MVox", CEDiceLoss,
        train_step, fused, GROUP_VUP_TRAIN_ROWS, K1_K7 + VUP_KERNELS,
        zero_bias=False, per_sample=True, plain=False)
    per_step = {"conv_bnact": 7, "conv1_fwd": 1, "pool_bnact": 2,
                "upconv_bnact": 1, "conv_bnact_dgrad": 6,
                "conv_bnact_wgrad": 6, "conv1_bwd": 1, "pool_bnact_bwd": 2,
                "upconv_bnact_bwd": 1, **dict.fromkeys(VUP_KERNELS, 1)}
    want = {k: per_step.get(k, 0) * STEPS for k in SOURCES}
    if launches["train_group_vup"] != want:
        raise AssertionError(f"group vup training launches "
                             f"{launches['train_group_vup']}, expected "
                             f"{want}")
    check_vup_bodies(launches["train_group_vup"],
                     BODY_LAUNCHES["train_group vup"], "group vup training")
    ps_grad_repeat(model, crit, batches[0], fused, "group vup")
    k, _, k2 = STEP_MS["group vup"]
    print(f"train group vup: step {k:.2f}, again {k2:.2f} ms beside the "
          f"group step {STEP_MS['group'][0]:.2f} and the vup step "
          f"{STEP_MS['vup'][0]:.2f} ms in this run", flush=True)
    del model, opt, batches
    torch.cuda.empty_cache()
    vup_pair_phase(build, CEDiceLoss, train_step, fused, "group vup")
    return launches


def input_grad_phase(build, CEDiceLoss, train_step, fused):
    """The headline model with ``input_grad=True`` at bench.py's step, its
    inputs requiring a gradient: timed steps (row 13's kernel with dx
    once a step, K4 on its tensor-core body), the input's gradient of one
    step against reference=True (in the L2 norm within 1e-2 of its norm
    plus NOISE_FACTOR times the reference step's own difference under a
    one-ulp input change), then the same input through the default model
    (``input_grad=False``), whose gradient is zeros: JAX runs its fused
    conv1 at W = 88 there."""
    shape = (BATCH, *PATCH, 1)
    batches = [(x.requires_grad_(True), y) for x, y in bench_batches(shape)]
    crit = CEDiceLoss(1.0, 1.0)
    model = build(4, torch.bfloat16, True)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    dt = timed_steps(train_step, model, crit, opt, batches, False,
                     fused.reset_launches)
    launches = launch_counts(fused)
    bodies = dict(fused.BODY_LAUNCHES)
    BODY_LAUNCHES["train_input_grad"] = bodies
    if launches["conv1_bwd"] != STEPS \
            or bodies.get(("conv1_bwd", "conv1+dx"), 0) != STEPS \
            or bodies.get(("conv_bnact_dgrad", "tc"), 0) \
            != launches["conv_bnact_dgrad"]:
        raise AssertionError(f"input_grad training launches {launches}, "
                             f"bodies {bodies}")
    check_k1_bodies(launches, bodies, "input_grad training", STEPS)
    grads = [x.grad for x, _ in batches]
    if not all(g is not None and bool(torch.isfinite(g).all())
               and float(g.abs().max()) > 0 for g in grads):
        raise AssertionError("input_grad training: an input gradient is "
                             "missing, zero or not finite")
    print(f"train input_grad: step {dt * 1e3:9.2f} ms (beside the default "
          f"model's {STEP_MS['3D'][0]:.2f} in this run); launches over "
          f"{STEPS} steps {launches}", flush=True)
    del opt, batches, grads

    def grad_x(m, x, y, reference):
        x = x.detach().clone().requires_grad_(True)
        m.zero_grad(set_to_none=True)
        crit(m.train()(x, reference=reference), y).backward()
        return x.grad.float()
    g = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn(shape, generator=g, device="cuda")
    y = torch.randint(0, 2, shape[:-1], generator=g, device="cuda")
    gx = grad_x(model, x, y, False)
    rx = grad_x(model, x, y, True)
    noise = torch.randn(shape, generator=g, device="cuda")
    mx = grad_x(model, x * (1 + 2.0 ** -8 * noise), y, True)
    err, rn, nz = (float((gx - rx).norm()), float(rx.norm()),
                   float((mx - rx).norm()))
    limit = 1e-2 * rn + NOISE_FACTOR * nz
    if not (rn > 0 and err <= limit):
        raise AssertionError(f"input_grad: |dx - ref| {err}, |ref| {rn}, "
                             f"noise {nz}")
    # The control: a zero dx (input_grad=False's), whose error is |ref|,
    # must fail the same limit, or the limit shows nothing.
    if rn <= limit:
        raise AssertionError(f"input_grad: the limit {limit} would pass a "
                             f"zero dx (|ref| {rn}, noise {nz})")
    del model
    fused.reset_launches()
    gx0 = grad_x(build(4, torch.bfloat16, False), x, y, False)
    if bool(gx0.any()) or fused.BODY_LAUNCHES.get(("conv1_bwd", "conv1")) \
            != 1:
        raise AssertionError(f"input_grad=False: max |dx| "
                             f"{float(gx0.abs().max())}, bodies "
                             f"{fused.BODY_LAUNCHES}")
    print(f"train input_grad: one step's input gradient vs reference=True "
          f"|dx - ref| {err:.4e} (|ref| {rn:.4e}, noise {nz:.4e}, limit "
          f"{limit:.4e}; a zero dx's error |ref| is {rn / limit:.3f} times "
          f"the limit); input_grad=False gives zeros, row 13 without dx",
          flush=True)
    torch.cuda.empty_cache()
    return launches


def profile_phase(train_step, model, crit, opt, batches):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(3):
            train_step(model, crit, opt, *batches[i])
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="device_time_total",
                                    row_limit=30), flush=True)


class Patches(torch.utils.data.Dataset):
    """Seeded (1, *spatial) inputs and (*spatial) class targets."""

    def __init__(self, n, shape, seed=0):
        rng = np.random.default_rng(seed)
        self.inp = rng.normal(size=(n,) + shape).astype(np.float32)
        self.target = rng.integers(0, 2, size=(n,) + shape[1:])

    def __len__(self):
        return len(self.inp)

    def __getitem__(self, i):
        return {"inp": self.inp[i], "target": self.target[i]}


def trainer_phase(build, sample, what, CEDiceLoss, Trainer):
    with tempfile.TemporaryDirectory() as root:
        model = build(5, torch.bfloat16)
        tr = Trainer(model, CEDiceLoss(1.0, 1.0),
                     train_dataset=Patches(8, sample), batch_size=2,
                     save_root=root, exp_name="smoke", nan_check_interval=2)
        tr.run(max_steps=4)
        if tr.step != 4 or not np.isfinite(tr.last_stats["tr_loss"]).all():
            raise AssertionError(f"Trainer.run: step {tr.step}, losses "
                                 f"{tr.last_stats['tr_loss']}")
        tr2 = Trainer(build(6, torch.bfloat16), CEDiceLoss(1.0, 1.0),
                      train_dataset=Patches(8, sample), batch_size=2,
                      save_root=root, exp_name="resumed")
        tr2.load_state(f"{tr.save_path}/state_dict_final.pth")
        a, b = model.state_dict(), tr2.model.state_dict()
        if tr2.step != 4 or not all(torch.equal(a[k], b[k]) for k in a):
            raise AssertionError("load_state did not restore the run")
        print(f"trainer {what}: run(max_steps=4) batch 2 of {sample[1:]}: "
              f"losses {[round(v, 4) for v in tr.last_stats['tr_loss']]}, "
              f"last epoch {tr.last_misc['tr_speed_vx']:.2f} M/s; "
              f"load_state restored step {tr2.step} and every tensor",
              flush=True)


OPTIONAL_PACKAGES = ("tensorboard", "tqdm", "matplotlib", "sklearn")
FULL_VALID = 5          # trainer_full_phase's validation patches (2, 2, 1)
FULL_STEPS = 8          # its run: two epochs of 8 patches at batch 2
FULL_TILE = dict(preview_tile_shape=(32, 64, 64),
                 preview_overlap_shape=(8, 16, 16))
FULL_PREVIEW = (1, 1, 64, 128, 128)   # its preview: 8 tiles
FULL_TRACED = "conv_tc"               # a kernel its profiler trace names


def _strict_minima(sched, steps):
    """The steps after which the Trainer sees a strict minimum of the
    rate of a fresh ``sched`` (its ``_handle_lr``)."""
    lrs = [sched.get_lr()] + [sched.step() for _ in range(steps)]
    return [k for k in range(2, steps + 1)
            if lrs[k - 2] > lrs[k - 1] < lrs[k]]


def trainer_full_phase(build, CEDiceLoss, fused):
    """``Trainer.run`` on ``build``'s model (the headline UNet, bf16) at
    ``bench.py``'s patch, with everything the Trainer has: 8 training
    patches at batch 2 (two epochs of four steps), 5 validation patches
    (batches of 2, 2 and 1) with ``default_metrics()`` and ``AUROC``, a
    ``CyclicLR`` with a minimum of the rate inside ``run(max_steps=8)``,
    ``extra_save_steps=(3,)``, ``profile_steps=(2, 4)`` and a preview of
    8 tiles. Checks the files the run wrote; K1, row 3, K2 and K3 in
    each validation batch (the last, of 1, too); the validation logits
    against ``reference=True`` (5e-2 of max|ref|); the Trainer's
    validation stats against a recount from those logits; a ``conv_tc``
    kernel in the profiler's trace; ``apply_swa`` (new running
    statistics, finite validation logits, the parameters back bit for
    bit after a second swap); a resumed Trainer's next rate and
    ``best_val_loss``. Prints each epoch's split, the validation MVox/s
    and the optional packages the card's machine lacks. Returns the
    run's launches (counts at 0 just before it)."""
    import importlib.util
    from elektronn3_tpu_torch.training import CyclicLR, Trainer, metrics
    lacks = [m for m in OPTIONAL_PACKAGES
             if importlib.util.find_spec(m) is None]
    print(f"trainer full: the card's machine lacks {lacks}", flush=True)
    sample = (1, *PATCH)
    train, valid = Patches(8, sample, 11), Patches(FULL_VALID, sample, 12)
    valid_metrics = {**metrics.default_metrics(), "val_AUROC":
                     metrics.AUROC()}

    def cyclic():
        return CyclicLR(1e-4, 1e-3, step_size_up=2)

    minima = _strict_minima(cyclic(), FULL_STEPS)
    if not minima:
        raise AssertionError("trainer full: the schedule has no minimum")
    preview = torch.randn(FULL_PREVIEW,
                          generator=torch.Generator().manual_seed(13)).numpy()
    with tempfile.TemporaryDirectory() as root:
        model = build(21, torch.bfloat16)
        tr = Trainer(model, CEDiceLoss(1.0, 1.0), train_dataset=train,
                     valid_dataset=valid, valid_metrics=valid_metrics,
                     batch_size=2, save_root=root, exp_name="full",
                     schedulers={"lr": cyclic()}, extra_save_steps=(3,),
                     profile_steps=(2, 4), preview_batch=preview,
                     preview_interval=1, inference_kwargs={"batch_size": 2},
                     nan_check_interval=4, **FULL_TILE)
        # each validation forward: (input, logits, its launches)
        batches, in_val = [], [False]

        def pre(mod, args):
            if in_val[0]:
                batches.append([args[0], None, launch_counts(fused)])

        def post(mod, args, out):
            if in_val[0]:
                before = batches[-1][2]
                batches[-1][1:] = [out, {k: n - before[k] for k, n in
                                         launch_counts(fused).items()}]
        hooks = [model.register_forward_pre_hook(pre),
                 model.register_forward_hook(post)]
        validate, epoch = tr._validate, tr._epoch

        def validate_recorded():
            batches.clear()
            in_val[0] = True
            try:
                return validate()
            finally:
                in_val[0] = False

        def epoch_printed(*a):
            epoch(*a)
            sec = tr.last_seconds
            vox = FULL_VALID * int(np.prod(PATCH))
            print(f"trainer full: epoch {tr.epoch} (step {tr.step}) "
                  + ", ".join(f"{k} {v:.3f} s" for k, v in sec.items())
                  + f"; validation {vox / sec['validate'] / 1e6:.2f} "
                  f"MVox/s; stats " + ", ".join(
                      f"{k} {v:.4f}" for k, v in tr.last_stats.items()
                      if k != "tr_loss"), flush=True)
        tr._validate, tr._epoch = validate_recorded, epoch_printed
        fused.reset_launches()
        tr.run(max_steps=FULL_STEPS)
        launches = launch_counts(fused)
        print(f"trainer full: launches over the run {launches}", flush=True)
        check_launched(launches, K1_K7, "trainer full")

        names = set(os.listdir(tr.save_path))
        suffixes = ["", "_initial", "_final", "_best", "_step3"] + [
            f"_minlr_step{k}" for k in minima]
        want = {f"{kind}{s}.{ext}" for s in suffixes
                for kind, ext in (("state_dict", "pth"), ("model", "pt"))}
        want |= {"elektronn3_tpu_torch.log", "profile"}
        if not want <= names:
            raise AssertionError(f"trainer full: missing files "
                                 f"{sorted(want - names)}")
        print(f"trainer full: wrote {sorted(names)}", flush=True)

        if [b[0].shape[0] for b in batches] != [2, 2, 1]:
            raise AssertionError(f"trainer full: validation batches "
                                 f"{[tuple(b[0].shape) for b in batches]}")
        model.eval()
        for i, (x, out, n) in enumerate(batches):
            check_launched(n, SERVING, f"trainer full validation batch {i} "
                           f"(N={x.shape[0]})")
            with torch.inference_mode():
                ref = model(x, reference=True)
            err = (out.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            if not (bool(torch.isfinite(out).all()) and err <= 5e-2 * scale):
                raise AssertionError(f"trainer full: validation batch {i} "
                                     f"vs reference: err {err}, max|ref| "
                                     f"{scale}")
        model.train()
        print(f"trainer full: validation batches (N = 2, 2, 1) each "
              f"launched {SERVING}; logits within 5e-2 x max|ref| of "
              "reference=True", flush=True)

        # the phase's own recount of the kernel pass
        crit = CEDiceLoss(1.0, 1.0)
        targets = [torch.as_tensor(valid.target[i:i + 2]).cuda()
                   for i in range(0, FULL_VALID, 2)]
        with torch.inference_mode():
            losses = torch.stack([crit(b[1], t).float()
                                  for b, t in zip(batches, targets)])
        recount = {"val_loss": float(np.mean(losses.cpu().tolist()))}
        for name, ev in valid_metrics.items():
            if getattr(ev, "supports_streaming", False):
                cm = sum(metrics.confusion_matrix(
                    t, torch.argmax(b[1], -1), 2, nan_when_empty=False,
                    ignore=ev.ignore) for b, t in zip(batches, targets))
                recount[name] = float(ev.from_cm(cm))
            else:
                recount[name] = float(ev(torch.cat(targets), torch.cat(
                    [b[1] for b in batches])))
        got = {k: tr.last_stats[k] for k in recount}
        if got != recount:
            raise AssertionError(f"trainer full: validation stats {got}, "
                                 f"recount {recount}")
        print(f"trainer full: validation stats equal the recount {got}",
              flush=True)

        traces = [os.path.join(tr.save_path, "profile", f) for f in
                  os.listdir(os.path.join(tr.save_path, "profile"))]
        text = "".join(open(f).read() for f in traces)
        if FULL_TRACED not in text:
            raise AssertionError(f"trainer full: no {FULL_TRACED} kernel "
                                 f"in {traces}")
        print(f"trainer full: profiler trace {traces} ({len(text)} bytes) "
              f"names {FULL_TRACED} {text.count(FULL_TRACED)} times",
              flush=True)

        norms = [m for m in model.modules()
                 if isinstance(m, torch.nn.BatchNorm3d)]
        stats0 = [m.running_mean.clone() for m in norms]
        params0 = {k: p.detach().clone()
                   for k, p in model.named_parameters()}
        bn_loader = [{"inp": torch.as_tensor(train.inp[i:i + 2]).cuda()
                      .movedim(1, -1).contiguous()} for i in (0, 2, 4)]
        tr.apply_swa(bn_loader)
        moved = sum(not torch.equal(a, m.running_mean)
                    for a, m in zip(stats0, norms))
        swapped = sum(not torch.equal(params0[k], p)
                      for k, p in model.named_parameters())
        stats = tr._validate()
        if not (moved == len(norms) and swapped and all(
                bool(torch.isfinite(b[1]).all()) for b in batches)
                and np.isfinite(stats["val_loss"])):
            raise AssertionError(f"trainer full: apply_swa moved {moved} of "
                                 f"{len(norms)} norms, {swapped} "
                                 f"parameters, val {stats}")
        tr.apply_swa()
        if not all(torch.equal(params0[k], p)
                   for k, p in model.named_parameters()):
            raise AssertionError("trainer full: a second swap did not "
                                 "restore the parameters")
        print(f"trainer full: apply_swa (average of {tr.swa.n_avg}, "
              f"minima after steps {minima}) swapped {swapped} parameters "
              f"and moved all {moved} running means; validation with it "
              f"{stats['val_loss']:.4f} (finite); the second swap "
              "restored every parameter bit for bit", flush=True)
        for h in hooks:
            h.remove()

        tr2 = Trainer(build(22, torch.bfloat16), CEDiceLoss(1.0, 1.0),
                      train_dataset=train, schedulers={"lr": cyclic()},
                      save_root=root, exp_name="resumed",
                      enable_tensorboard=False)
        tr2.load_state(os.path.join(tr.save_path, "state_dict_final.pth"))
        nxt = (copy.deepcopy(tr.lr_scheduler).step(),
               copy.deepcopy(tr2.lr_scheduler).step())
        if tr2.best_val_loss != tr.best_val_loss or nxt[0] != nxt[1] \
                or tr2.step != FULL_STEPS:
            raise AssertionError(f"trainer full: resumed best_val_loss "
                                 f"{tr2.best_val_loss} vs "
                                 f"{tr.best_val_loss}, next rate {nxt}")
        print(f"trainer full: resumed at step {tr2.step}, next rate "
              f"{nxt[1]:.3e}, best_val_loss {tr2.best_val_loss:.4f} as the "
              "first Trainer's", flush=True)
    return launches


# The data pipeline feeding the headline UNet's Trainer (pipeline_phase).
PIPE_SRC = (160, 448, 448)   # make_synthetic_neurodata.py's cube: the
                             # neurodata set's scale
PIPE_NORM = (155.291411, 41.812504)   # the neurodata example's Normalize
PIPE_WARMUP = 3              # Trainer steps before the timed STEPS
PIPE_SPLIT = 6               # batches timed phase by phase
PIPE_PROFILED = 6            # Trainer steps after the timed ones, under
                             # torch.profiler for the card's idle share
PIPE_WORKERS = 4             # PatchCreator's worker processes
# Batches a PatchCreator epoch holds beyond the steps run: the workers'
# prefetch (torch's 2 each) and 2 more, so that the workers still make
# batches through the profiled steps.
PIPE_AHEAD = PIPE_WORKERS * 2 + 2
PIPE_WARP_TOL = 1e-4         # the card's warp against the host's, of max|ref|
# Nearest-neighbour labels: the card and numpy round halves to even, the
# C++ kernel away from zero, and the three compute the coordinates in
# other orders; voxels this close to a .5 tie are not compared.
PIPE_TIE = 1e-3


def make_cube(rng, shape=PIPE_SRC, uint8=False):
    """``benchmark/make_synthetic_neurodata.py``'s ``make_cube``: smoothed
    multi-scale noise as membrane-like raw data (float32 around 155, or
    uint8) and int16 'barrier' labels where its ridges are."""
    small = rng.normal(size=(shape[0] // 8, shape[1] // 16,
                             shape[2] // 16)).astype(np.float32)
    vol = np.repeat(np.repeat(np.repeat(small, 8, 0), 16, 1), 16, 2)
    for ax in range(3):
        vol = (vol + np.roll(vol, 1, ax) + np.roll(vol, -1, ax)) / 3.0
    lab = (np.abs(vol) < 0.25).astype(np.int16)
    raw = (155.0 + 41.0 * vol + 5.0 * rng.normal(size=shape)
           ).astype(np.float32)
    if uint8:
        raw = np.clip(np.rint(raw), 0, 255).astype(np.uint8)
    return raw, lab


def neurodata_transform(T):
    """``examples/train_unet_neurodata_torch.py``'s training transforms."""
    return T.Compose([
        T.SqueezeTarget(dim=0), T.Normalize(mean=PIPE_NORM[0],
                                            std=PIPE_NORM[1]),
        T.RandomGrayAugment(channels=[0], prob=0.3),
        T.RandomGammaCorrection(gamma_std=0.25, channels=[0], prob=0.3),
        T.AdditiveGaussianNoise(sigma=0.1, channels=[0], prob=0.3)])


def neurodata_criterion():
    from elektronn3_tpu_torch.modules.loss import (
        CombinedLoss, CrossEntropyLoss, DiceLoss)
    return CombinedLoss([CrossEntropyLoss(), DiceLoss(apply_softmax=True)],
                        weight=[0.5, 0.5])


def pipeline_warp_check(data, sources):
    """(a) The card's warp of 16 ``DeviceWarpPatchLoader`` samples
    (``warp_prob=1``; 8 affine, 8 perspective) against the host's C++
    ``warp_interp`` and the numpy ``map_coordinates_*`` on the same
    ``M_inv`` and ``lo``: inputs within PIPE_WARP_TOL of max|ref|, labels
    equal but near .5 ties, and on the perspective samples no voxel
    outside the window that was read."""
    from elektronn3_tpu_torch.data import coord_transforms as ct
    from elektronn3_tpu_torch.data import native, warp
    grid = ct.make_dest_coords(PATCH)
    for persp in (False, True):
        loader = data.DeviceWarpPatchLoader(
            *sources, PATCH, batch_size=BATCH, warp_prob=1.0,
            warp_kwargs=dict(sample_aniso=True, warp_amount=1.0,
                             perspective=persp), aniso_factor=2,
            seed=21 + persp)
        host = loader.sample_batch()
        windows, t_windows, M_invs, los = loader.to_device(host)
        inp = warp.warp_interpolate_batch(windows[:, 0], M_invs, los,
                                          PATCH).cpu().numpy()
        lab = warp.warp_interpolate_batch(t_windows[:, 0], M_invs, los,
                                          PATCH, discrete=True).cpu().numpy()
        clamped = warp.out_of_window(M_invs, los, PATCH, loader.window_shape)
        errs, ties, n_persp = [], 0, 0
        for n in range(BATCH):
            w = host[0][n, 0].astype(np.float32)
            tw = host[1][n, 0].astype(np.float32)
            M_inv, lo = host[2][n], host[3][n]
            n_persp += bool(np.any(M_inv[3, :3] != 0))
            src = np.tensordot(grid, M_inv, axes=[[-1], [1]])
            src = (src[..., :3] / src[..., 3:4]).astype(np.float32)
            frac = (src - lo) % 1
            keep = ~np.any(np.abs(frac - 0.5) < PIPE_TIE, axis=-1)
            ties += int((~keep).sum())
            for what, ref, ref_lab in (
                    ("C++", native.warp_interp(w, M_inv, PATCH, lo, persp,
                                               False),
                     native.warp_interp(tw, M_inv, PATCH, lo, persp, True)),
                    ("numpy", ct.map_coordinates_linear(w, src, lo),
                     ct.map_coordinates_nearest(tw, src, lo))):
                err = float(np.max(np.abs(inp[n] - ref))
                            / np.max(np.abs(ref)))
                errs.append(err)
                if not err <= PIPE_WARP_TOL:
                    raise AssertionError(f"card warp sample {n} against "
                                         f"{what}: {err:.2e} of max|ref|")
                bad = int((lab[n] != ref_lab)[keep].sum())
                if bad:
                    raise AssertionError(f"card warp sample {n}: {bad} labels "
                                         f"differ from {what}'s off ties")
        if persp and (clamped or n_persp != BATCH):
            raise AssertionError(f"perspective samples: {n_persp} of {BATCH}"
                                 f" perspective, {clamped} voxels outside "
                                 f"their windows")
        print(f"pipeline warp ({'perspective' if persp else 'affine'}): "
              f"{BATCH} card warps of {PATCH} from windows "
              f"{loader.window_shape} against C++ and numpy: max err "
              f"{max(errs):.2e} of max|ref|, labels equal off {ties} "
              f"near-tie voxels, {clamped} voxels outside their windows, "
              f"{loader.n_failed} retried draws", flush=True)


def idle_share(prof, seconds):
    """1 - (the union of the card's records in ``prof``: kernels, copies,
    memsets) / ``seconds`` of wall time."""
    busy, end = 0.0, -np.inf
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type.name == "CUDA"):
        if b > end:
            busy += b - max(a, end)
            end = b
    return 1 - busy / 1e6 / seconds


def timed_trainer_run(tr, fused, warmup=PIPE_WARMUP):
    """``tr.run(max_steps=warmup + STEPS + PIPE_PROFILED)``, the counts at
    0 and the clock started after step ``warmup``, then PIPE_PROFILED
    steps under torch.profiler (CUDA records only); returns (seconds of
    the STEPS steps, their launches, their launches by body, (the card's
    idle share in the profiled steps, their seconds), the first batch
    the Trainer trained on)."""
    from torch.profiler import ProfilerActivity, profile
    state, first = {"n": 0}, []
    prof = profile(activities=[ProfilerActivity.CUDA])
    batch = tr._batch

    def recording_batch(b):
        out = batch(b)
        if not first:
            first.append(tuple(t.clone() for t in out))
        return out

    def hook(opt, args, kwargs):
        state["n"] += 1
        if state["n"] == warmup:
            torch.cuda.synchronize()
            fused.reset_launches()
            state["t0"] = time.perf_counter()
        elif state["n"] == warmup + STEPS:
            torch.cuda.synchronize()
            state["t1"] = time.perf_counter()
            state["launches"] = launch_counts(fused)
            state["bodies"] = dict(fused.BODY_LAUNCHES)
            prof.start()
            torch.cuda.synchronize()
            state["t2"] = time.perf_counter()
        elif state["n"] == warmup + STEPS + PIPE_PROFILED:
            torch.cuda.synchronize()
            state["t3"] = time.perf_counter()
            prof.stop()

    tr._batch = recording_batch
    handle = tr.optimizer.register_step_post_hook(hook)
    steps = warmup + STEPS + PIPE_PROFILED
    try:
        tr.run(max_steps=steps)
    finally:
        handle.remove()
        tr._batch = batch
    losses = tr.last_stats["tr_loss"]
    if tr.step != steps or len(losses) != tr.step \
            or not np.isfinite(losses).all():
        raise AssertionError(f"Trainer.run: step {tr.step}, losses {losses}")
    profiled = state["t3"] - state["t2"]
    return (state["t1"] - state["t0"], state["launches"], state["bodies"],
            (idle_share(prof, profiled), profiled), first[0])


def check_fed_run(what, seconds, launches, bodies, idle, want, repeat,
                  smi):
    """A fed run's launches are ``want``, the headline train path's over
    as many steps, on the same bodies; its first batch repeats. ``idle``
    is (the card's idle share, seconds) of the profiled steps."""
    check_launched(launches, K1_K7, what)
    if launches != want or bodies != BODY_LAUNCHES["train_3D"]:
        raise AssertionError(f"{what}: launches {launches}, bodies {bodies};"
                             f" the headline train path's {want}, "
                             f"{BODY_LAUNCHES['train_3D']}")
    if not all(torch.equal(a, b) for a, b in repeat):
        raise AssertionError(f"{what}: the first batch does not repeat "
                             "under the same seed")
    vox = BATCH * int(np.prod(PATCH))
    print(f"pipeline {what}: {STEPS} Trainer steps after {PIPE_WARMUP}: "
          f"{seconds / STEPS * 1e3:.2f} ms/step = "
          f"{vox * STEPS / seconds / 1e6:.2f} MVox/s (batch {BATCH} of "
          f"{PATCH}, bf16; the bench step {STEP_MS['3D'][0]:.2f} ms) on "
          f"{smi}; the card idle {idle[0]:.1%} of {PIPE_PROFILED} more "
          f"steps (torch.profiler) at {idle[1] / PIPE_PROFILED * 1e3:.2f} "
          f"ms/step; launches over {STEPS} steps as the headline "
          f"train path's; the first batch repeats bit for bit", flush=True)


def print_split(what, split, mb, smi):
    print(f"pipeline {what} per batch (ms, median of {PIPE_SPLIT}): "
          + ", ".join(f"{k} {np.median(v):.2f}" for k, v in split.items())
          + f"; H2D {mb:.2f} MB a batch; on {smi}", flush=True)


def patch_creator_run(data, cubes, UNet, fused, want, smi):
    """(b) The headline UNet's Trainer fed by PatchCreator (host warp in
    the C++ kernels, the neurodata example's transforms, warp_prob=0.2,
    perspective) through 4 worker processes."""
    from elektronn3_tpu_torch.training import Trainer, train_step

    class CubeCreator(data.PatchCreator):
        """PatchCreator over the cubes in memory (no HDF5 files)."""

        def open_files(self):
            return ([data.ArrayDataSource(r) for r, _ in cubes],
                    [data.ArrayDataSource(t) for _, t in cubes])

    ds = CubeCreator(
        input_sources=[("cube", "raw")] * 2,
        target_sources=[("cube", "lab")] * 2, patch_shape=PATCH,
        aniso_factor=2,
        epoch_size=(PIPE_WARMUP + STEPS + PIPE_PROFILED + PIPE_AHEAD)
        * BATCH,
        warp_prob=0.2, warp_kwargs=dict(sample_aniso=True, perspective=True,
                                        warp_amount=1.0),
        transform=neurodata_transform(data.transforms))
    model = headline_unet(UNet, 31)
    crit = neurodata_criterion()
    with tempfile.TemporaryDirectory() as root:
        tr = Trainer(model, crit, train_dataset=ds, batch_size=BATCH,
                     num_workers=PIPE_WORKERS, seed=0, save_root=root,
                     exp_name="patch_creator", enable_tensorboard=False)
        seconds, launches, bodies, idle, first = timed_trainer_run(tr,
                                                                   fused)
        tr.epoch = 0   # the run's first epoch again, from a new loader
        again = tr._batch(next(iter(tr._loader())))
        check_fed_run("PatchCreator", seconds, launches, bodies, idle, want,
                      zip(first, again), smi)
        split = collections.defaultdict(list)
        tr.epoch = 1
        it = iter(tr._loader())
        next(it)   # the workers' start
        mb = 0.0
        for _ in range(PIPE_SPLIT):
            t0 = time.perf_counter()
            b = next(it)
            t1 = time.perf_counter()
            inp, target = tr._batch(b)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            train_step(model, crit, tr.optimizer, inp, target)
            te = time.perf_counter()
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            split[f"host wait ({PIPE_WORKERS} workers)"].append(
                (t1 - t0) * 1e3)
            split["H2D"].append((t2 - t1) * 1e3)
            split["warp (on the host)"].append(0.0)
            split["train"].append((t3 - t2) * 1e3)
            split["its launches on the host"].append((te - t2) * 1e3)
            mb = (b["inp"].nbytes + b["target"].nbytes) / 1e6
        del it
        for _ in range(2):
            t0 = time.perf_counter()
            for i in range(BATCH):
                ds[i]
            split["host sampling (1 process)"].append(
                (time.perf_counter() - t0) * 1e3)
        print_split("PatchCreator", split, mb, smi)
        print(f"pipeline PatchCreator: warp stats in this process "
              f"{ds.warp_stats}", flush=True)
    return launches, bodies


def device_loader_run(data, sources, UNet, fused, want, smi):
    """(c) The same Trainer fed by DeviceWarpPatchLoader: window reads
    on the host, warp and normalization on the card (pipeline_probe.py's
    loader)."""
    from elektronn3_tpu_torch.training import Trainer, train_step

    def loader():
        return data.DeviceWarpPatchLoader(
            *sources, PATCH, batch_size=BATCH, warp_prob=0.2,
            warp_kwargs=dict(sample_aniso=True, warp_amount=1.0),
            aniso_factor=2, epoch_size=PIPE_WARMUP + STEPS + PIPE_PROFILED,
            normalize=PIPE_NORM, seed=0)

    model = headline_unet(UNet, 31)
    crit = neurodata_criterion()
    with tempfile.TemporaryDirectory() as root:
        ld = loader()
        tr = Trainer(model, crit, train_dataset=ld, batch_size=BATCH,
                     seed=0, save_root=root, exp_name="device_loader",
                     enable_tensorboard=False)
        seconds, launches, bodies, idle, first = timed_trainer_run(tr,
                                                                   fused)
        again = tr._batch(next(iter(loader())))
        check_fed_run("DeviceWarpPatchLoader", seconds, launches, bodies,
                      idle, want, zip(first, again), smi)
        split = collections.defaultdict(list)
        probe = loader()
        for _ in range(PIPE_SPLIT):
            t0 = time.perf_counter()
            host = probe.sample_batch()
            t1 = time.perf_counter()
            dev = probe.to_device(host)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            b = probe.process(*dev)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            inp, target = tr._batch(b)
            train_step(model, crit, tr.optimizer, inp, target)
            te = time.perf_counter()
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            for k, v in (("host sampling", t1 - t0), ("H2D", t2 - t1),
                         ("warp", t3 - t2), ("train", t4 - t3),
                         ("its launches on the host", te - t3)):
                split[k].append(v * 1e3)
        mb = sum(a.nbytes for a in host) / 1e6
        print_split("DeviceWarpPatchLoader", split, mb, smi)
        print(f"pipeline DeviceWarpPatchLoader: {ld.n_failed} retried and "
              f"{ld.n_ok} accepted draws in the run", flush=True)
    return launches, bodies


def example_run(cubes):
    """``examples/train_unet_neurodata_torch.py`` for 3 steps on the
    synthetic cubes as HDF5 files (raw_2, the validation cube, a copy of
    raw_0), where h5py is installed; HOME points into the same temporary
    directory, where the Trainer writes its run."""
    import importlib.util
    if importlib.util.find_spec("h5py") is None:
        print("pipeline example: h5py is not installed on this machine; "
              "examples/train_unet_neurodata_torch.py not run", flush=True)
        return
    import h5py
    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as root:
        for i, (raw, lab) in enumerate(cubes + cubes[:1]):
            with h5py.File(os.path.join(root, f"raw_{i}.h5"), "w") as f:
                f.create_dataset("raw", data=raw)
            with h5py.File(os.path.join(root, f"barrier_int16_{i}.h5"),
                           "w") as f:
                f.create_dataset("lab", data=lab)
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "examples/train_unet_neurodata_torch.py", "-d",
             root, "-m", "3", "--bf16", "-j", "2", "-n", "example"],
            cwd=repo, capture_output=True, text=True, timeout=300,
            env=dict(os.environ, HOME=root, PYTHONPATH=repo))
        final = os.path.join(root, "e3tpu_training", "example",
                             "state_dict_final.pth")
        if res.returncode != 0 or not os.path.isfile(final):
            raise AssertionError(f"the example failed ({res.returncode}):\n"
                                 f"{res.stderr[-3000:]}")
        info = torch.load(final, weights_only=False)["info"]
        print(f"pipeline example: examples/train_unet_neurodata_torch.py -m 3"
              f" --bf16 on the synthetic HDF5 cubes ran in "
              f"{time.perf_counter() - t0:.1f} s to step {info['step']}",
              flush=True)


def pipeline_phase(UNet, fused, want, smi):
    """The data pipeline at full width: two synthetic (160, 448, 448)
    cubes; (a) the card's warp against the host's; (b) and (c) the
    headline UNet's Trainer fed by PatchCreator and by
    DeviceWarpPatchLoader, each launching ``want`` (the headline train
    path's launches) over its timed steps; the example. Returns the two
    runs' launches."""
    from elektronn3_tpu_torch import data
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    cubes = [make_cube(rng) for _ in range(2)]
    sources = ([data.ArrayDataSource(r) for r, _ in cubes],
               [data.ArrayDataSource(t) for _, t in cubes])
    print(f"pipeline data: 2 cubes {PIPE_SRC} (raw float32, labels int16, "
          f"foreground {np.mean([l.mean() for _, l in cubes]):.3f}) made "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"pipeline host: os.cpu_count() {os.cpu_count()}, "
          f"{len(os.sched_getaffinity(0))} cores for this process, "
          f"torch.get_num_threads() {torch.get_num_threads()}", flush=True)
    pipeline_warp_check(data, sources)
    out = {}
    launches, bodies = patch_creator_run(data, cubes, UNet, fused, want,
                                         smi)
    out["train_patch_creator"] = launches
    BODY_LAUNCHES["train_patch_creator"] = bodies
    torch.cuda.empty_cache()
    launches, bodies = device_loader_run(data, sources, UNet, fused, want,
                                         smi)
    out["train_device_loader"] = launches
    BODY_LAUNCHES["train_device_loader"] = bodies
    torch.cuda.empty_cache()
    example_run(cubes)
    return out



# validate_phase: examples/validate_torch.py's defaults (-n 10 -b 4) and
# patch, on synthetic cubes of its validation source's kind.
VALIDATE_BATCHES, VALIDATE_BATCH = 10, 4
VALIDATE_CUBE = (96, 256, 256)
VALIDATE_TIE = 5e-2          # check_forward's bf16 bound, of max|ref|
VALIDATE_RECOUNT_TOL = 1e-6
PLAIN_FWD = ("conv_bnact_fwd_plain", "pool_bnact_fwd_plain",
             "upconv_bnact_fwd_plain")


def _host_metrics(script, target, logits):
    """The script's five metrics recomputed with numpy from host
    logits: per class (tp, tn, fp, fn), NaN for a class absent from the
    target, the mean over the other classes, in percent."""
    pred = logits.argmax(-1)
    c = logits.shape[-1]
    cm = np.array([[np.sum((pred == k) & (target == k)),
                    np.sum((pred != k) & (target != k)),
                    np.sum((pred == k) & (target != k)),
                    np.sum((pred != k) & (target == k))] for k in range(c)],
                  np.float64)
    cm[(cm[:, 0] + cm[:, 3]) == 0] = np.nan
    tp, tn, fp, fn = cm.T
    with np.errstate(divide="ignore", invalid="ignore"):
        per = {"val_accuracy": (tp + tn) / (tp + tn + fp + fn),
               "val_precision": tp / (tp + fp),
               "val_recall": tp / (tp + fn),
               "val_DSC": 2 * tp / (2 * tp + fp + fn),
               "val_IoU": tp / (tp + fp + fn)}
    assert list(per) == list(script.VALID_METRICS)
    return {k: float(np.nanmean(v) * 100) for k, v in per.items()}


def validate_phase(UNet, fused, smi):
    """``examples/validate_torch.py``'s ``validate()`` on the card: the
    headline UNet (bf16, 'batch', its head's class-1 bias at the median
    margin of a first batch, so that it predicts both classes) through
    ``save_model`` and ``load_model(device="cuda")``, over the script's
    ``valid_dataset`` and loader, with ``PatchCreator.open_files`` giving
    synthetic cubes (the card's machine may have no h5py): 10 batches of
    4 (44, 88, 88) patches. Every batch's forward launches K1 on its
    tensor-core body, row 3's kernel, K2 and K3, the same counts each,
    and no plain version runs; every argmax that differs from the
    ``reference=True`` forward's is a near-tie of the reference's logits
    (margin <= 5e-2 max|ref|); the five metrics recomputed on the host
    from the same logits equal the card's. Runs the script itself where
    h5py is installed. Returns the run's launches."""
    import importlib.util
    from elektronn3_tpu_torch import data
    from elektronn3_tpu_torch.training import load_model, save_model
    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "validate_torch", os.path.join(repo, "examples", "validate_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    rng = np.random.default_rng(7)
    cubes = [make_cube(rng, VALIDATE_CUBE) for _ in range(2)]

    class CubeCreator(data.PatchCreator):
        """PatchCreator over the cubes in memory (no HDF5 files)."""

        def open_files(self):
            return ([data.ArrayDataSource(r) for r, _ in cubes],
                    [data.ArrayDataSource(t) for _, t in cubes])

    n = VALIDATE_BATCHES * VALIDATE_BATCH
    real = data.PatchCreator
    data.PatchCreator = CubeCreator   # the script's own dataset arguments
    try:
        ds = script.valid_dataset("synthetic", [0, 1], n)
    finally:
        data.PatchCreator = real

    def loader():
        return data.DataLoader(ds, batch_size=VALIDATE_BATCH, num_workers=2,
                               shuffle=False, seed=0)

    first = next(iter(loader()))
    x0 = torch.as_tensor(first["inp"]).cuda()
    model0 = headline_unet(UNet, 41)
    randomize_norms(model0, 42)
    with torch.inference_mode():
        y0 = model0.eval()(x0).float()
        model0.conv_final.bias[1] -= (y0[..., 1] - y0[..., 0]).median().to(
            model0.conv_final.bias.dtype)
    with tempfile.TemporaryDirectory() as root:
        path = os.path.join(root, "model_best.pt")
        save_model(model0, path)
        model, _ = load_model(path, device="cuda")
    del model0
    print(f"validate: levels at {tuple(x0.shape)} "
          f"{model.level_kinds(x0.shape)}", flush=True)
    with torch.inference_mode():
        model.eval()(x0)              # warm-up: cuDNN's plans for L2/L3
    torch.cuda.synchronize()

    seen, calls = [], []
    hook = model.register_forward_hook(
        lambda m, a, out: calls.append(out.detach().clone()))

    def recorded():
        for b in loader():
            seen.append(b)
            yield b

    plain = {name: 0 for name in PLAIN_FWD}
    real_plain = {name: getattr(fused, name) for name in PLAIN_FWD}

    def spy(name):
        def counted(*a, **k):
            plain[name] += 1
            return real_plain[name](*a, **k)
        return counted

    for name in PLAIN_FWD:
        setattr(fused, name, spy(name))
    try:
        fused.reset_launches()
        t0 = time.perf_counter()
        vals = script.validate(model, recorded(),
                               next(model.parameters()).device)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = launch_counts(fused)
        bodies = dict(fused.BODY_LAUNCHES)
    finally:
        for name in PLAIN_FWD:
            setattr(fused, name, real_plain[name])
        hook.remove()
    BODY_LAUNCHES["validate"] = bodies
    if len(calls) != VALIDATE_BATCHES or len(seen) != VALIDATE_BATCHES:
        raise AssertionError(f"validate: {len(calls)} forwards of "
                             f"{len(seen)} batches")
    if any(plain.values()):
        raise AssertionError(f"validate: plain versions ran {plain}")
    per = {k: launches[k] // VALIDATE_BATCHES for k in SERVING}
    if any(v == 0 for v in per.values()) or any(
            launches[k] != per[k] * VALIDATE_BATCHES for k in SERVING) or \
            any(launches[k] for k in FUSED_KERNELS if k not in SERVING):
        raise AssertionError(f"validate launches {launches}: not "
                             f"{SERVING} each batch alone")
    check_k1_bodies(launches, bodies, "validate", VALIDATE_BATCHES)
    vox = n * int(np.prod(PATCH))
    print(f"validate: {VALIDATE_BATCHES} batches of {VALIDATE_BATCH} "
          f"{PATCH} in {dt:.3f} s = {vox / dt / 1e6:.2f} MVox/s (loader "
          f"with 2 workers included) [{smi}]; launches per forward {per}, "
          f"K1 bodies {bodies}; plain versions {plain}", flush=True)

    flips, worst, targets, logits = 0, 0.0, [], []
    for b, y in zip(seen, calls):
        x = torch.as_tensor(b["inp"]).cuda()
        with torch.inference_mode():
            ref = model(x, reference=True).float()
        yk = y.float()
        if yk.shape != x.shape[:-1] + (2,) or not bool(
                torch.isfinite(yk).all()):
            raise AssertionError(f"validate: logits {tuple(yk.shape)}")
        differ = yk.argmax(-1) != ref.argmax(-1)
        margin = (ref[..., 1] - ref[..., 0]).abs()
        bound = VALIDATE_TIE * ref.abs().max().item()
        if differ.any():
            m = margin[differ].max().item()
            worst = max(worst, m / bound)
            if m > bound:
                raise AssertionError(
                    f"validate: an argmax differs from the reference at a "
                    f"margin {m:.4e} > {bound:.4e}")
        flips += int(differ.sum())
        targets.append(np.asarray(b["target"]))
        logits.append(yk.cpu().numpy())
    target = np.concatenate(targets)
    if set(np.unique(target)) != {0, 1}:
        raise AssertionError("validate: labels of one class")
    host = _host_metrics(script, target, np.concatenate(logits))
    for k, v in vals.items():
        if not (np.isfinite(v) and abs(v - host[k]) <= VALIDATE_RECOUNT_TOL):
            raise AssertionError(f"validate: {k} {v} on the card, {host[k]} "
                                 "recounted on the host")
    print(f"validate: {flips} of {vox} voxels' argmax differ from the "
          f"reference forward, all near-ties (largest margin "
          f"{worst:.3f} of the bound 5e-2 max|ref|); metrics "
          + ", ".join(f"{k} {v:.4f}" for k, v in vals.items())
          + " (host recount equal within 1e-6)", flush=True)
    validate_example_run(cubes)
    print(f"validate: phase {time.perf_counter() - t_phase:.1f} s [{smi}]",
          flush=True)
    return launches


def validate_example_run(cubes):
    """``examples/validate_torch.py`` on the cubes as HDF5 files with a
    saved headline UNet, where h5py is installed."""
    import importlib.util
    if importlib.util.find_spec("h5py") is None:
        print("validate example: h5py is not installed on this machine; "
              "examples/validate_torch.py not run", flush=True)
        return
    import h5py
    from elektronn3_tpu_torch.models import UNet
    from elektronn3_tpu_torch.training import save_model
    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as root:
        for i, (raw, lab) in enumerate(cubes):
            with h5py.File(os.path.join(root, f"raw_{i}.h5"), "w") as f:
                f.create_dataset("raw", data=raw)
            with h5py.File(os.path.join(root, f"barrier_int16_{i}.h5"),
                           "w") as f:
                f.create_dataset("lab", data=lab)
        path = os.path.join(root, "model_best.pt")
        save_model(headline_unet(UNet, 41), path)
        outs = []
        for _ in range(2):
            res = subprocess.run(
                [sys.executable, "examples/validate_torch.py", path, "-d",
                 root, "-i", "0", "1"], cwd=repo, capture_output=True,
                text=True, timeout=300, env=dict(os.environ, PYTHONPATH=repo))
            if res.returncode != 0:
                raise AssertionError(f"the example failed ({res.returncode})"
                                     f":\n{res.stderr[-3000:]}")
            outs.append(res.stdout)
        if outs[0] != outs[1] or not outs[0].startswith("Validated on 40 "):
            raise AssertionError(f"the example printed {outs}")
        print("validate example: examples/validate_torch.py on the HDF5 "
              "cubes, twice the same lines: " + " | ".join(
                  outs[0].strip().splitlines()), flush=True)


# The rest of the Predictor and the UNet options serving needs.
TTA_FLIPS = 8            # predictor_tta_phase: the 3D default flips
TTA_TOL = 1e-2           # its probabilities against the host's average
# valid_phase: JAX's valid coverage shape (benchmark/coverage_bench.py
# --conv-mode valid): the headline UNet takes (44, 140, 140) to
# (4, 52, 52), an offset of (20, 44, 44); the request's volume is 1 x 3
# x 3 such tiles, each the offset wider on each side.
VALID_PATCH = (44, 140, 140)
VALID_OUT = (4, 52, 52)
VALID_VOLUME = (44, 244, 244)
VALID_STEPS = 5
OPTION_STEPS = 5


def _flipped_logits(model, Predictor, vol, axes):
    """The host's view of one flip: the logits (float32) of a request on
    ``vol`` flipped along NC(D)HW ``axes``, flipped back."""
    pred = Predictor(model, apply_softmax=False, out_dtype=np.float32,
                     **PREDICT_KW)
    out = pred.predict(np.ascontiguousarray(np.flip(vol, axes)))
    return np.flip(out, axes) if axes else out


def predictor_tta_phase(build, Predictor, fused, save_model):
    """The headline model served with flip test-time augmentation
    (``augmentations=8``) on the seeded volume: eight times the model
    calls and the launches of the request without it, the probabilities
    against the host's average of eight requests of flipped volumes'
    logits (``TTA_TOL``), MVox/s of both requests, the six phases of a
    ``collect_phase_times=True`` request of each, and the Predictor
    loading the model from ``save_model``'s file and the weights from a
    reference-style ``state_dict.pth`` (``module.`` prefixes) into a
    model of other weights: the in-memory request's bits."""
    from elektronn3_tpu_torch.inference import DEFAULT_AUGMENTATIONS_3D
    model = build(0, torch.bfloat16).eval()
    randomize_norms(model, 1)
    vol = seeded_volume()
    plain = Predictor(model, **PREDICT_KW)
    tta = Predictor(model, augmentations=TTA_FLIPS, **PREDICT_KW)
    counts, times, outs = {}, {}, {}
    for what, pred in (("plain", plain), ("tta", tta)):
        pred.predict(vol)                                  # warm-up
        torch.cuda.synchronize()
        calls = []
        hook = model.register_forward_hook(lambda *a: calls.append(1))
        fused.reset_launches()
        t0 = time.perf_counter()
        outs[what] = pred.predict(vol)
        times[what] = time.perf_counter() - t0
        hook.remove()
        counts[what] = (len(calls), launch_counts(fused))
    (calls_p, launches_p), (calls_t, launches_t) = counts["plain"], \
        counts["tta"]
    print(f"predictor tta: {TTA_FLIPS} flips: {calls_t} model calls, "
          f"{vol.size / times['tta'] / 1e6:.2f} MVox/s ({times['tta']:.3f} "
          f"s); without: {calls_p} calls, "
          f"{vol.size / times['plain'] / 1e6:.2f} MVox/s "
          f"({times['plain']:.3f} s); launches {launches_t}", flush=True)
    if calls_t != TTA_FLIPS * calls_p or any(
            launches_t[k] != TTA_FLIPS * launches_p[k] for k in launches_p):
        raise AssertionError(f"TTA: {calls_t} model calls and launches "
                             f"{launches_t} against {TTA_FLIPS} x {calls_p} "
                             f"and {launches_p}")
    check_launched(launches_t, SERVING, "tta serving")
    logits = np.mean([_flipped_logits(model, Predictor, vol, axes)
                      for axes in DEFAULT_AUGMENTATIONS_3D[:TTA_FLIPS]],
                     axis=0, dtype=np.float32)
    host = np.exp(logits - logits.max(1, keepdims=True))
    host /= host.sum(1, keepdims=True)
    err = float(np.abs(outs["tta"] - host).max())
    if not (np.isfinite(outs["tta"]).all() and err <= TTA_TOL):
        raise AssertionError(f"TTA probabilities against the host's "
                             f"average: max abs err {err}")
    print(f"predictor tta: probabilities against the host's average of "
          f"{TTA_FLIPS} flipped requests' logits: max abs err {err:.4e} "
          f"(bound {TTA_TOL})", flush=True)
    for what, aug in (("plain", None), ("tta", TTA_FLIPS)):
        pred = Predictor(model, augmentations=aug, collect_phase_times=True,
                         **PREDICT_KW)
        t0 = time.perf_counter()
        pred.predict(vol)
        dt = time.perf_counter() - t0
        print(f"predictor tta: {what} request with collect_phase_times: "
              f"{vol.size / dt / 1e6:.2f} MVox/s ({dt:.3f} s); phases (s) "
              + ", ".join(f"{k} {v:.4f}" for k, v in
                          pred.last_phase_times.items()), flush=True)
    with tempfile.TemporaryDirectory() as root:
        path = os.path.join(root, "model_final.pt")
        save_model(model, path)
        from_file = Predictor(path, **PREDICT_KW).predict(vol)
        ref_path = os.path.join(root, "state_dict.pth")
        torch.save({"model_state_dict": {
            "module." + k: t for k, t in model.state_dict().items()}},
            ref_path)
        other = build(5, torch.bfloat16)
        from_state = Predictor(other, state=ref_path,
                               **PREDICT_KW).predict(vol)
    for what, got in (("model=<save_model file>", from_file),
                      ("state=<reference state_dict.pth>", from_state)):
        if not np.array_equal(got, outs["plain"]):
            raise AssertionError(f"Predictor({what}): max abs err "
                                 f"{np.abs(got - outs['plain']).max()} "
                                 "against the in-memory model")
        print(f"predictor tta: Predictor({what}) gives the in-memory "
              "request's bits", flush=True)
    return launches_t


def valid_phase(build, Predictor, CEDiceLoss, train_step, fused):
    """The headline model with ``conv_mode='valid'`` (every level on the
    library ops, as JAX plans it): a tiled ``offset='auto'`` request
    (tiles (4, 52, 52) of a (44, 244, 244) volume; the probed offset
    printed and checked, the first tile against the model on its input),
    timed ``train_step``s at batch 8 of (44, 140, 140) and one step
    against ``reference=True``."""
    model = build(0, torch.bfloat16).eval()
    randomize_norms(model, 1)
    shape = (BATCH, *VALID_PATCH, 1)
    kinds = model.level_kinds(shape)
    print(f"valid: levels at {shape[1:-1]} {kinds}, decoder "
          f"{model.decoder_kinds(shape)}", flush=True)
    if kinds != ["library"] * 4:
        raise AssertionError(f"valid: level kinds {kinds}")
    vol = torch.randn((1, 1, *VALID_VOLUME),
                      generator=torch.Generator().manual_seed(8)).numpy()
    pred = Predictor(model, tile_shape=VALID_OUT, offset="auto",
                     float16=True, batch_size=3)
    fused.reset_launches()
    t0 = time.perf_counter()
    probs = pred.predict(vol)
    dt = time.perf_counter() - t0
    offset = pred._offset_by_rank[5]
    want = tuple((v - o) // 2 for v, o in zip(VALID_PATCH, VALID_OUT))
    out_shape = (1, 2) + tuple(v - 2 * o for v, o in
                               zip(VALID_VOLUME, offset))
    print(f"valid: probed offset {offset}; request {vol.shape} -> "
          f"{probs.shape} in {dt:.3f} s ({vol.size / dt / 1e6:.2f} MVox/s "
          f"input, {probs[:, :1].size / dt / 1e6:.2f} output); launches "
          f"{launch_counts(fused)}", flush=True)
    if offset != want or probs.shape != out_shape \
            or not np.isfinite(probs).all() \
            or np.abs(probs.sum(1) - 1).max() > 1e-2:
        raise AssertionError(f"valid request: offset {offset}, output "
                             f"{probs.shape}")
    with torch.inference_mode():
        tile = torch.from_numpy(np.ascontiguousarray(np.moveaxis(
            vol[:, :, :VALID_PATCH[0], :VALID_PATCH[1], :VALID_PATCH[2]],
            1, -1))).cuda()
        first = torch.softmax(model(tile).float(), -1).movedim(-1, 1).cpu()
    err = float(np.abs(first.numpy() - probs[:, :, :VALID_OUT[0],
                                             :VALID_OUT[1],
                                             :VALID_OUT[2]]).max())
    if err > TTA_TOL:
        raise AssertionError(f"valid: first tile against the model: {err}")
    print(f"valid: first tile against the model on its input: max abs err "
          f"{err:.4e} (bound {TTA_TOL})", flush=True)
    del model, pred
    crit = CEDiceLoss(1.0, 1.0)
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(shape, generator=g, device="cuda")
    y = torch.randint(0, 2, (BATCH,) + VALID_OUT, generator=g,
                      device="cuda")
    model = build(4, torch.bfloat16)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    torch.cuda.reset_peak_memory_stats()
    dt = timed_steps(train_step, model, crit, opt, [(x, y)], False,
                     warmup=2, steps=VALID_STEPS)
    print(f"valid: train step {dt * 1e3:.2f} ms = "
          f"{x.numel() / dt / 1e6:.2f} MVox/s input "
          f"({y.numel() / dt / 1e6:.2f} output; batch {BATCH} of "
          f"{VALID_PATCH} -> {VALID_OUT}, bf16), peak "
          f"{torch.cuda.max_memory_allocated() / 1e6:.1f} MB", flush=True)
    del model, opt
    torch.cuda.empty_cache()
    # Every level is a library level: the exactly-0 bias gradient of L0
    # conv1 (one input channel) is summed by cuDNN from the bf16 dx of
    # its batch norm, as on the silu model's library L0 conv1 (train
    # silu's bound, 1e-1).
    check_train_step(build, crit, x, y, zero_bf16=1e-1)


def merge_add_phase(build, Predictor, CEDiceLoss, train_step, fused):
    """The headline model with ``merge_mode='add'``: its forward against
    ``reference=True`` on the tile with every decoder merge conv on K1
    with the weight doubled along C_in, a Predictor request, and one
    training step at the bench with the merges' K1, K4 and K5 launches
    recorded (main then runs :func:`train_phase`'s timed and checked
    steps, ``check_train_step`` in bf16 and float32)."""
    model = build(0, torch.bfloat16).eval()
    randomize_norms(model, 1)
    x = torch.randn((1, *TILE, 1),
                    generator=torch.Generator().manual_seed(2)).cuda()
    print(f"add: levels at the tile {model.level_kinds(x.shape)}",
          flush=True)
    merges = []
    real = fused.conv_bnact

    def spy(xs, inv, shift, w, *a, **k):
        if len(xs) == 2:
            merges.append((tuple(xi.shape[-1] for xi in xs),
                           tuple(w.shape)))
        return real(xs, inv, shift, w, *a, **k)
    fused.conv_bnact = spy
    try:
        check_forward(model, x, "add UNet bf16 forward")
    finally:
        fused.conv_bnact = real
    del x
    torch.cuda.empty_cache()
    print(f"add: merge convs on K1 (inputs' channels, weight) {merges}",
          flush=True)
    if not merges or any(w[1] != sum(c) for c, w in merges):
        raise AssertionError(f"add: merges {merges}")
    vol = seeded_volume()
    pred = Predictor(model, **PREDICT_KW)
    pred.predict(vol)
    fused.reset_launches()
    t0 = time.perf_counter()
    probs = pred.predict(vol)
    dt = time.perf_counter() - t0
    launches = launch_counts(fused)
    print(f"predictor add: {vol.size / dt / 1e6:.2f} MVox/s; launches "
          f"{launches}", flush=True)
    if not np.isfinite(probs).all():
        raise AssertionError("add request: non-finite probabilities")
    check_launched(launches, SERVING, "add serving")
    del pred
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    model.train()
    with record_shapes(fused) as seen:
        train_step(model, CEDiceLoss(1.0, 1.0), opt,
                   *bench_batches((BATCH, *PATCH, 1))[0])
        torch.cuda.synchronize()
    on_merges = {k: n for k, n in seen.items() if k[0] in (
        "conv_bnact", "conv_bnact_dgrad", "conv_bnact_wgrad")
        and len(k[1]) == 2}
    print("train add: one step's launches on the merge convs (kernel, "
          "inputs' channels, C_out, kd, prologue): " + ", ".join(
              f"{k} {n}" for k, n in sorted(on_merges.items())), flush=True)
    if {k[0] for k in on_merges} != {"conv_bnact", "conv_bnact_dgrad",
                                     "conv_bnact_wgrad"}:
        raise AssertionError(f"add training: merge launches {on_merges}")
    del model, opt
    torch.cuda.empty_cache()
    return launches


def _zero_bias(name):
    """A conv bias that feeds a batch norm: its gradient is exactly 0."""
    return name.endswith(".bias") and "norm" not in name \
        and name != "conv_final.bias"


def options_phase(build, CEDiceLoss, train_step, fused):
    """One timed ``train_step`` at the bench of the headline model with
    ``up_mode='resizeconv_linear'``, ``attention=True``,
    ``checkpointing=True`` and ``'policy'``, beside the plain model's:
    each one's level kinds, ms a step and peak memory (a checkpointed
    step's must be under the plain one's); then a checkpointed float32
    step against the plain float32 step from the same weights and batch,
    as ``check_train_step`` holds the kernels against the reference: the
    loss within 1e-5 (relative), each gradient leaf within 1e-3 |r| +
    NOISE_FACTOR |r' - r| (r' the plain step on an input moved by one
    ulp: the recompute's batch statistics sum in another order), the
    exactly-0 biases within 1e-4 of their weight gradient."""
    crit = CEDiceLoss(1.0, 1.0)
    batches = bench_batches((BATCH, *PATCH, 1))
    peaks = {}
    for what, opts in (("plain", {}),
                       ("resizeconv_linear",
                        dict(up_mode="resizeconv_linear")),
                       ("attention", dict(attention=True)),
                       ("checkpointing", dict(checkpointing=True)),
                       ("checkpointing policy",
                        dict(checkpointing="policy"))):
        model = build(4, torch.bfloat16, **opts)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fused.reset_launches()
        dt = timed_steps(train_step, model, crit, opt, batches, False,
                         warmup=2, steps=OPTION_STEPS)
        peaks[what] = torch.cuda.max_memory_allocated() / 1e6
        shape = batches[0][0].shape
        print(f"option {what}: levels {model.level_kinds(shape)}, decoder "
              f"{model.decoder_kinds(shape)}; step {dt * 1e3:.2f} ms = "
              f"{batches[0][0].numel() / dt / 1e6:.2f} MVox/s; peak "
              f"{peaks[what]:.1f} MB; launches {launch_counts(fused)}",
              flush=True)
        del model, opt
    torch.cuda.empty_cache()
    x, y = batches[0]
    noise = torch.randn(x.shape, generator=torch.Generator(
        device=x.device).manual_seed(11), device=x.device)
    loss0, ref = _step_grads(build(4, torch.float32), crit, x, y, False)
    _, moved = _step_grads(build(4, torch.float32), crit,
                           x * (1 + 2.0 ** -23 * noise), y, False)
    failures = []
    for what, opts in (("checkpointing", dict(checkpointing=True)),
                       ("checkpointing policy",
                        dict(checkpointing="policy"))):
        loss, grads = _step_grads(build(4, torch.float32, **opts), crit, x,
                                  y, False)
        worst, worst_zero = (0.0, ""), 0.0
        for n, g in grads.items():
            r = ref[n]
            if _zero_bias(n):
                w = float(ref[n[:-len("bias")] + "weight"].norm())
                worst_zero = max(worst_zero, float(g.norm()) / w)
                continue
            b = 1e-3 * float(r.norm()) \
                + NOISE_FACTOR * float((moved[n] - r).norm())
            worst = max(worst, (float((g - r).norm()) / max(b, 1e-30), n))
        print(f"option {what}: peak {peaks[what]:.1f} MB against the plain "
              f"step's {peaks['plain']:.1f} MB; float32 step against the "
              f"plain step: loss {loss:.6f} vs {loss0:.6f}, worst gradient "
              f"err/bound {worst[0]:.3f} ({worst[1]}), biases before a "
              f"batch norm at most {worst_zero:.2e} of their weight "
              "gradient", flush=True)
        if abs(loss - loss0) > 1e-5 * abs(loss0) or worst[0] > 1 \
                or worst_zero > 1e-4 or peaks[what] >= peaks["plain"]:
            failures.append(f"{what}: loss {loss} vs {loss0}, gradient "
                            f"err/bound {worst}, zero biases {worst_zero}, "
                            f"peak {peaks[what]} MB")
    if failures:
        raise AssertionError("; ".join(failures))
    # The checkpointed step on the kernels against the same checkpointed
    # step through reference=True, in float32 and bf16, under
    # check_train_step's bounds: the recompute must normalise with the
    # forward's statistics (fused.StatsTape), not with atomic sums taken
    # again in another order.
    for what, opts in (("checkpointing", dict(checkpointing=True)),
                       ("checkpointing policy",
                        dict(checkpointing="policy"))):
        worst = check_train_step(functools.partial(build, **opts), crit, x,
                                 y, what=f" {what}")
        print(f"option {what}: the kernel step against reference=True, "
              f"both checkpointed: worst gradient err/bound "
              f"{worst['float32']:.3f} (float32), {worst['bfloat16']:.3f} "
              "(bf16)", flush=True)


RES_KW = dict(enc_res_blocks=1, dec_res_blocks=1)   # the residual ResUNet


def resunet_phase(ResUNet, UNet, Predictor, CEDiceLoss, train_step, fused,
                  headline):
    """The headline ResUNet in both forms. Without residual blocks
    (res0, the UNet): the Predictor and :func:`train_phase` (forward
    check, timed and checked steps), each path's launches equal to the
    headline UNet's (``headline``: its 'predictor' and 'train'
    launches), and one eval forward on the tile and one training step
    at the bench launching K1-K7 and row 13's at exactly the headline's
    shapes and counts (``record_shapes``). With one residual block a
    level (``RES_KW``, every level on the library ops): a Predictor
    request and timed steps with no launch of any kernel of K1-K7, row
    13's or the vup entries, and ``check_train_step``."""
    def res0(seed, dtype):
        return headline_unet(ResUNet, seed, dtype)

    def res1(seed, dtype):
        return headline_unet(ResUNet, seed, dtype, **RES_KW)

    out = {"predictor_res0": predictor_phase(res0, "res0", Predictor, fused,
                                             ("24/222",))}
    out["train_res0"], model, crit, opt, batches = train_phase(
        res0, (BATCH, *PATCH, 1), "res0", "MVox", CEDiceLoss, train_step,
        fused)
    del model, opt
    torch.cuda.empty_cache()
    for path in ("predictor", "train"):
        if out[f"{path}_res0"] != headline[path]:
            raise AssertionError(f"res0 {path} launches "
                                 f"{out[f'{path}_res0']} != the headline "
                                 f"UNet's {headline[path]}")
    tile = torch.randn((1, *TILE, 1),
                       generator=torch.Generator().manual_seed(2)).cuda()
    shapes = []
    for build in (functools.partial(headline_unet, UNet), res0):
        m = build(4, torch.bfloat16)
        with record_shapes(fused) as seen:
            with torch.inference_mode():
                m.eval()(tile)
            train_step(m, crit, torch.optim.Adam(m.parameters(), lr=1e-3),
                       *batches[0])
            torch.cuda.synchronize()
        shapes.append(dict(seen))
        del m
        torch.cuda.empty_cache()
    if shapes[0] != shapes[1] or not shapes[0]:
        raise AssertionError(f"res0 launches by shape {shapes[1]} != the "
                             f"headline UNet's {shapes[0]}")
    print(f"res0: launches by (kernel, shape) on a tile forward and a "
          f"bench step the headline UNet's, {len(shapes[0])} shapes, "
          f"{sum(shapes[0].values())} launches", flush=True)

    model = res1(0, torch.bfloat16).eval()
    randomize_norms(model, 1)
    vol = seeded_volume()
    pred = Predictor(model, **PREDICT_KW)
    pred.predict(vol)
    fused.reset_launches()
    t0 = time.perf_counter()
    probs = pred.predict(vol)
    dt = time.perf_counter() - t0
    served = launch_counts(fused)
    print(f"predictor res1: levels {model.level_kinds((1, *TILE, 1))}; "
          f"bf16 probabilities in {dt:.3f} s = {vol.size / dt / 1e6:.2f} "
          f"MVox/s; launches {served}", flush=True)
    if not np.isfinite(probs).all() \
            or np.abs(probs.sum(1) - 1).max() > 1e-2:
        raise AssertionError("res1 request: bad probabilities")
    del pred, model
    torch.cuda.empty_cache()
    model = res1(4, torch.bfloat16)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    torch.cuda.reset_peak_memory_stats()
    dt = timed_steps(train_step, model, crit, opt, batches, False,
                     fused.reset_launches, warmup=2, steps=OPTION_STEPS)
    trained = launch_counts(fused)
    STEP_MS["res1"] = (dt * 1e3,)
    print(f"train res1: step {dt * 1e3:.2f} ms = "
          f"{batches[0][0].numel() / dt / 1e6:.2f} MVox/s (batch {BATCH} "
          f"of {PATCH}, bf16, CEDiceLoss, Adam); peak "
          f"{torch.cuda.max_memory_allocated() / 1e6:.1f} MB; launches "
          f"{trained}; the headline UNet's step in this run "
          f"{STEP_MS['3D'][0]:.2f} ms, res0's {STEP_MS['res0'][0]:.2f} ms",
          flush=True)
    del model, opt
    torch.cuda.empty_cache()
    if any(served.values()) or any(trained.values()):
        raise AssertionError(f"res1 launched kernels: serving {served}, "
                             f"training {trained}")
    # Every level on the library ops: L0 conv1's bias gradient (one input
    # channel, a small weight gradient), exactly 0 before its batch norm,
    # is cuDNN's sum over L0's 2,725,888 voxels of the bf16 dx, on both
    # sides alike (1.586e-2 of the weight gradient's norm on an H100 at
    # 700 W, as the silu model's library conv1 in train_phase): the
    # silu phase's 1e-1 for it; the kernel-plan models keep 1e-2.
    check_train_step(res1, crit, *batches[0], zero_bf16=1e-1, what=" res1")
    out["predictor_res1"], out["train_res1"] = served, trained
    return out


def _signed_distance(y):
    """A float regression target from class ids: -1 inside (class 1), +1
    outside, two channels (the logits' shape)."""
    d = 1.0 - 2.0 * y.float()
    return torch.stack([d, -d], -1)


def loss_zoo_phase(build, loss, train_step, fused, Trainer):
    """Timed training steps of the headline UNet (bf16, Adam, bench.py's
    batches) under each loss of the zoo that the port adds, each with
    K1-K7 and row 13's launched and a finite loss, beside CEDiceLoss's
    step; then ``Trainer.run`` with an unlabeled set and
    ``FixMatchSegLoss`` as ``ss_criterion``, whose every call gets the
    Trainer's generator as ``rng`` and the model as ``apply_fn`` (three
    forwards a step)."""
    batches = bench_batches((BATCH, *PATCH, 1))
    mix = torch.tensor([True, False] * (BATCH // 2))
    ce_dice = loss.CombinedLoss([loss.CrossEntropyLoss(), loss.DiceLoss()])
    cases = {
        "CEDiceLoss": loss.CEDiceLoss(1.0, 1.0),
        "FocalLoss": loss.FocalLoss(weight=[0.3, 1.0]),
        "SoftmaxBCELoss": loss.SoftmaxBCELoss(),
        "MixedCombinedLoss": lambda o, t: loss.MixedCombinedLoss(
            ce_dice, loss.FocalLoss())(o, t, mix),
        "MaskedMSELoss": lambda o, t: loss.MaskedMSELoss()(
            o, _signed_distance(t), (t > 0)[..., None].expand(o.shape)),
        "DistanceWeightedMSELoss": lambda o, t: loss.DistanceWeightedMSELoss(
            fg_weight=10.0, mask_borders=8)(o, _signed_distance(t)),
        "GAPTripletMarginLoss": lambda o, t: loss.GAPTripletMarginLoss()(
            o[:BATCH // 2], o[:BATCH // 2].flip(2), o[BATCH // 2:]),
        "LovaszLoss": loss.LovaszLoss(),
        "ACLoss": loss.ACLoss(),
        "NorpfDiceLoss": loss.NorpfDiceLoss(),
    }
    out = {}
    for name, crit in cases.items():
        model = build(4, torch.bfloat16)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        dt = timed_steps(train_step, model, crit, opt, batches, False,
                         fused.reset_launches, warmup=2, steps=OPTION_STEPS)
        launches = launch_counts(fused)
        final = float(train_step(model, crit, opt, *batches[0]))
        STEP_MS[f"loss {name}"] = (dt * 1e3,)
        print(f"loss {name}: headline step {dt * 1e3:.2f} ms = "
              f"{batches[0][0].numel() / dt / 1e6:.2f} MVox/s; loss "
              f"{final:.5f}; launches {launches}", flush=True)
        check_launched(launches, K1_K7, f"loss {name} training")
        if not np.isfinite(final):
            raise AssertionError(f"loss {name}: non-finite loss {final}")
        out[f"train_loss_{name}"] = launches
        del model, opt
        torch.cuda.empty_cache()

    class Recording(loss.FixMatchSegLoss):
        def __call__(self, inp, rng=None, apply_fn=None):
            self.seen.append((rng, apply_fn))
            return super().__call__(inp, rng=rng, apply_fn=apply_fn)

    fm = Recording()
    fm.seen = []
    calls = []
    with tempfile.TemporaryDirectory() as root:
        model = build(5, torch.bfloat16)
        hook = model.register_forward_hook(lambda *a: calls.append(1))
        tr = Trainer(model, loss.CEDiceLoss(1.0, 1.0),
                     train_dataset=Patches(8, (1, *PATCH)),
                     unlabeled_dataset=Patches(8, (1, *PATCH), seed=1),
                     ss_criterion=fm, batch_size=2, save_root=root,
                     exp_name="fixmatch", nan_check_interval=2, seed=7,
                     enable_tensorboard=False)
        fused.reset_launches()
        t0 = time.perf_counter()
        tr.run(max_steps=4)
        dt = time.perf_counter() - t0
        launches = launch_counts(fused)
        hook.remove()
    print(f"loss FixMatchSegLoss: Trainer.run(max_steps=4) at batch 2 of "
          f"{PATCH} with 2 unlabeled patches a step: {dt:.2f} s; losses "
          f"{[round(v, 4) for v in tr.last_stats['tr_loss']]}; "
          f"{len(calls)} model calls; launches {launches}", flush=True)
    if tr.step != 4 or len(fm.seen) != 4 or len(calls) != 12 \
            or not all(r is tr._ss_rng and f is model for r, f in fm.seen) \
            or not np.isfinite(tr.last_stats["tr_loss"]).all():
        raise AssertionError(f"FixMatch Trainer.run: step {tr.step}, "
                             f"{len(fm.seen)} ss calls, {len(calls)} model "
                             f"calls, losses {tr.last_stats['tr_loss']}")
    check_launched(launches, K1_K7, "FixMatch Trainer.run")
    out["trainer_fixmatch"] = launches
    return out


MG_STEPS = 3     # multigpu_phase's Trainer steps
MG_HALO = 32     # its spatial requests' halo along H


def rf_radius_h(UNet):
    """The headline UNet's receptive-field half width along H, probed: a
    copy of its architecture two filters wide (tanh, no norm, float32,
    library ops) and the extent along H of the nonzero gradient of one
    output voxel with respect to the input."""
    m = UNet(in_channels=1, out_channels=1, n_blocks=4, start_filts=2,
             planar_blocks=(0,), activation="tanh", normalization="none",
             dtype=torch.float32, device="cuda", pallas_flat=False,
             generator=torch.Generator().manual_seed(9)).train()
    x = torch.randn((1, 8, 256, 16, 1), device="cuda", requires_grad=True)
    # 16 neighbouring voxels: every alignment to the pools' windows
    m(x)[0, 4, 120:136, 8, 0].sum().backward()
    rows = torch.nonzero(x.grad[0].abs().sum((0, 2, 3))).flatten()
    return int(max(120 - rows.min(), rows.max() - 135))


def _trainer_3(UNet, CEDiceLoss, Trainer, fused, state, data, root, name,
               mesh=None):
    """A headline Trainer from ``state`` run MG_STEPS steps of batch 8,
    SGD (Adam would turn the atomics' rounding of a gradient near 0
    into a step of the full rate, in either direction); (trainer, wall
    s, launches)."""
    m = headline_unet(UNet, 21)
    m.load_state_dict(state)
    tr = Trainer(m, CEDiceLoss(1.0, 1.0),
                 optimizer=torch.optim.SGD(m.parameters(), lr=1e-2,
                                           momentum=0.9),
                 train_dataset=data,
                 batch_size=BATCH, save_root=root, exp_name=name,
                 enable_tensorboard=False, nan_check_interval=1, mesh=mesh,
                 seed=3)
    fused.reset_launches()
    t = time.perf_counter()
    tr.run(max_steps=MG_STEPS)
    torch.cuda.synchronize()
    return tr, time.perf_counter() - t, launch_counts(fused)


def _mg_distance(a, b):
    """Max abs difference per float tensor of two state dicts."""
    return {k: float((a[k].float() - b[k].float()).abs().max())
            for k in a if a[k].is_floating_point()}


def multigpu_rank(spec_path):
    """One rank of ``multigpu_phase`` (b), in a process of its own on
    ``cuda:0`` over gloo: one ``train_step(mesh=...)`` of its 4 rows of
    the batch-8 step, then a 'tiles' and a 'spatial' request of the
    stepped model; writes what the phase compares next to the spec."""
    import torch.distributed as dist
    from elektronn3_tpu_torch.inference import Predictor
    from elektronn3_tpu_torch.models import UNet
    from elektronn3_tpu_torch.modules.loss import CEDiceLoss
    from elektronn3_tpu_torch.ops import fused
    from elektronn3_tpu_torch.parallel import make_mesh
    from elektronn3_tpu_torch.training import default_optimizer, train_step
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = torch.load(spec_path, weights_only=False)
    model = headline_unet(UNet, 21)
    model.load_state_dict(spec["state"])
    mesh = make_mesh()
    x, y = spec["x"].cuda(), spec["y"].cuda()
    opt = default_optimizer(model)
    train_step(model, CEDiceLoss(1.0, 1.0), opt, x, y, mesh=mesh)  # warm-up
    model.load_state_dict(spec["state"])
    opt = default_optimizer(model)
    torch.cuda.synchronize()
    fused.reset_launches()
    t = time.perf_counter()
    loss = train_step(model, CEDiceLoss(1.0, 1.0), opt, x, y, mesh=mesh)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t
    launches = launch_counts(fused)
    out = dict(loss=float(loss), step_s=step_s, launches=launches,
               backend=dist.get_backend(), world=dist.get_world_size(),
               grads={n: p.grad.float().cpu()
                      for n, p in model.named_parameters()},
               state={k: v.cpu() for k, v in model.state_dict().items()})
    model.eval()
    for mode, m, kw in (("tiles", mesh, {}),
                        ("spatial", make_mesh({"space": 2}),
                         dict(shard_axis=3, halo=MG_HALO))):
        t = time.perf_counter()
        out[mode] = Predictor(model, mesh=m, shard_mode=mode, **kw,
                              **PREDICT_KW).predict(spec["vol"])
        out[mode + "_s"] = time.perf_counter() - t
    # The control: the same step with every batch norm blind to the
    # statistics group (each rank's own statistics, as a rank that
    # skipped the psum in bn_train_prologue or apply_norm would have;
    # the logits' gather and the gradients' sum still run).
    from elektronn3_tpu_torch.modules import flat_norm, layers
    model.load_state_dict(spec["state"])
    opt = default_optimizer(model)
    real = flat_norm.current_stats_group, layers.current_stats_group
    flat_norm.current_stats_group = layers.current_stats_group = \
        lambda: None
    try:
        loss = train_step(model, CEDiceLoss(1.0, 1.0), opt, x, y, mesh=mesh)
    finally:
        flat_norm.current_stats_group, layers.current_stats_group = real
    out["control"] = dict(
        loss=float(loss),
        grads={n: p.grad.float().cpu() for n, p in model.named_parameters()},
        state={k: v.cpu() for k, v in model.state_dict().items()})
    out["fsdp"] = _fsdp_rank(model, spec["state"], CEDiceLoss(1.0, 1.0),
                             x, y, mesh.axis("data"), fused)
    torch.save(out, os.path.join(os.path.dirname(spec_path),
                                 f"rank{dist.get_rank()}.pt"))


def _fsdp_rank(model, state, crit, x, y, axis, fused):
    """The dry run's fsdp leg on this rank at the headline geometry: one
    SGD step of rate 1 from ``state`` after a warm-up step (the whole
    parameters before less after: the step's gradient, which the phase
    holds), its seconds, launches, the running statistics after it and
    each leaf's size."""
    from elektronn3_tpu_torch.parallel.dryrun import (
        fsdp_dims, fsdp_gather, fsdp_shard, fsdp_step)
    dims = fsdp_dims(model, axis.size)

    def start():
        model.load_state_dict(state)
        params = fsdp_shard(model, dims, axis)
        return params, torch.optim.SGD(params.values(), lr=1.0)
    params, opt = start()
    fsdp_step(model, params, dims, crit, opt, x, y, axis)   # warm-up
    params, opt = start()
    torch.cuda.synchronize()
    fused.reset_launches()
    t = time.perf_counter()
    loss = fsdp_step(model, params, dims, crit, opt, x, y, axis)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t
    launches = launch_counts(fused)
    with torch.no_grad():
        whole = fsdp_gather(params, dims, axis)
    return dict(loss=float(loss), step_s=step_s, launches=launches,
                dims=dims, sizes={k: p.numel() for k, p in params.items()},
                grads={k: (state[k].to(v.device).float()
                           - v.detach().float()).cpu()
                       for k, v in whole.items()},
                state={k: v.cpu() for k, v in model.state_dict().items()})


def _step_failures(got_loss, got_grads, got_state, ref, moved):
    """A data-parallel step against the one-process step ``ref`` (loss,
    grads, state) under check_train_step's bf16 rule: the loss within
    1e-2 relative; per gradient leaf |g - r| <= 1e-2 |r| + NOISE_FACTOR
    |r' - r| in the L2 norm, r' the one-process step on the moved input
    ``moved``; a conv bias that feeds a batch norm (exact gradient 0) at
    most 1e-2 of its weight gradient's norm; each running statistic
    within 5e-2 of its max. Returns the worst gradient err/bound and the
    checks that failed."""
    failures, worst = [], 0.0
    lr_, grads, state = ref
    if not (np.isfinite(got_loss) and abs(got_loss - lr_) <= 1e-2 * abs(lr_)):
        failures.append(f"loss {got_loss} vs {lr_}")
    for name, r in grads.items():
        g = got_grads[name]
        if name.endswith(".bias") and name != "conv_final.bias" \
                and "norm" not in name:
            q = float(g.norm()) / float(grads[name[:-4] + "weight"].norm())
            if not bool(torch.isfinite(g).all()) or q > 1e-2:
                failures.append(f"grad {name} (exactly 0): {q}")
            continue
        bound_ = 1e-2 * float(r.norm()) + NOISE_FACTOR * float(
            (moved[name] - r).norm())
        err = float((g - r).norm())
        worst = max(worst, err / max(bound_, 1e-30))
        if not bool(torch.isfinite(g).all()) or err > bound_:
            failures.append(f"grad {name}: {err} > {bound_}")
    for k, b in state.items():
        if "running" in k:
            rel = float((got_state[k].float() - b.float()).abs().max()) \
                / float(b.float().abs().max())
            if rel > 5e-2:
                failures.append(f"running statistic {k}: {rel}")
    return worst, failures


def _hold_step(got_loss, got_grads, got_state, ref, moved, what):
    """:func:`_step_failures`, raising if a check failed; returns the
    worst gradient err/bound."""
    worst, failures = _step_failures(got_loss, got_grads, got_state, ref,
                                     moved)
    if failures:
        raise AssertionError(f"{what}: " + "; ".join(failures))
    return worst


def multigpu_phase(UNet, Predictor, CEDiceLoss, Trainer, train_step, fused,
                   smi):
    """Step 21 of the module docstring. Returns the launches of (a)'s
    mesh Trainer run and of (b)'s step on each rank, by path."""
    import torch.distributed as dist
    from elektronn3_tpu_torch.parallel import (init_distributed, launch,
                                               make_mesh)
    print(f"multigpu: card {smi}", flush=True)
    radius = rf_radius_h(UNet)
    base = headline_unet(UNet, 21)
    randomize_norms(base, 22)
    state = copy.deepcopy(base.state_dict())
    vol = seeded_volume()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) one NCCL rank on the card
        t0 = time.perf_counter()
        init_distributed(f"file://{tmp}/store", 1, 0)
        try:
            backend, world = dist.get_backend(), dist.get_world_size()
            t = time.perf_counter()
            dist.all_reduce(torch.zeros(1, device="cuda"))  # NCCL's setup
            torch.cuda.synchronize()
            print(f"multigpu (a): the first collective (NCCL's communicator "
                  f"setup) {time.perf_counter() - t:.3f} s", flush=True)
            data = Patches(BATCH * MG_STEPS, (1, *PATCH), seed=4)
            runs = [_trainer_3(UNet, CEDiceLoss, Trainer, fused, state, data,
                               tmp, name, mesh)
                    for name, mesh in (("plain", None), ("mesh", make_mesh()),
                                       ("plain2", None))]
            (a, _, _), (b, b_s, out["train_mesh1"]), (a2, a_s, _) = runs
            la, lb, la2 = (np.array(t.last_stats["tr_loss"])
                           for t in (a, b, a2))
            if not np.abs(lb - la).max() <= NOISE_FACTOR * np.abs(
                    la2 - la).max() + 1e-3 * np.abs(la).max():
                raise AssertionError(f"multigpu (a): mesh losses {lb}, "
                                     f"no-mesh {la} and {la2}")
            sa, sb, sa2 = (t.model.state_dict() for t in (a, b, a2))
            d_mesh, d_noise = _mg_distance(sb, sa), _mg_distance(sa2, sa)
            bad = [k for k in d_mesh if d_mesh[k] > NOISE_FACTOR * d_noise[k]
                   + 1e-3 * max(float(sa[k].float().abs().max()), 1e-2)]
            if bad:
                raise AssertionError(
                    f"multigpu (a): the mesh Trainer's {bad[:4]} differ from "
                    f"the no-mesh one's: {[d_mesh[k] for k in bad[:4]]}, "
                    f"run to run {[d_noise[k] for k in bad[:4]]}")
            check_launched(out["train_mesh1"], ("conv_bnact", "conv1_fwd",
                                                "conv_bnact_dgrad",
                                                "conv_bnact_wgrad"),
                           "world-1 mesh training")
            print(f"multigpu (a): backend {backend}, world {world}: "
                  f"Trainer(mesh) {MG_STEPS} steps of batch {BATCH} in "
                  f"{b_s:.2f} s (no mesh {a_s:.2f} s); losses {lb.tolist()} "
                  f"vs {la.tolist()} (rerun {la2.tolist()}); worst tensor "
                  f"distance {max(d_mesh.values()):.3e} (run to run "
                  f"{max(d_noise.values()):.3e}); launches "
                  f"{out['train_mesh1']}", flush=True)
            del a, b, a2, runs
            base.eval()
            ref = Predictor(base, **PREDICT_KW).predict(vol)
            for mode, mesh, kw in (("tiles", make_mesh(), {}),
                                   ("spatial", make_mesh({"space": 1}),
                                    dict(shard_axis=3, halo=MG_HALO))):
                t = time.perf_counter()
                got = Predictor(base, mesh=mesh, shard_mode=mode, **kw,
                                **PREDICT_KW).predict(vol)
                dt = time.perf_counter() - t
                err = float(np.abs(got - ref).max())
                print(f"multigpu (a): Predictor '{mode}' request {got.shape} "
                      f"in {dt:.3f} s ({vol.size / dt / 1e6:.2f} MVox/s); "
                      f"max abs err {err:.3e} vs unsharded", flush=True)
                if got.shape != ref.shape or not err <= 1e-2:
                    raise AssertionError(f"multigpu (a) '{mode}': err {err}")
        finally:
            dist.destroy_process_group()
        print(f"multigpu (a): {time.perf_counter() - t0:.1f} s", flush=True)

        # (b) two gloo ranks sharing the card, batch 4 each
        t0 = time.perf_counter()
        g = torch.Generator().manual_seed(8)
        x = torch.randn((BATCH, *PATCH, 1), generator=g)
        # rank 1's rows from another distribution than rank 0's, so that
        # each rank's own batch statistics are far from the global ones
        x[BATCH // 2:] = 3 * x[BATCH // 2:] + 1
        y = torch.randint(0, 2, (BATCH, *PATCH), generator=g)
        torch.save(dict(state=state, x=x, y=y, vol=vol),
                   os.path.join(tmp, "spec.pt"))
        launch("chip_smoke:multigpu_rank", 2, [os.path.join(tmp, "spec.pt")],
               device="cuda:0", backend="gloo", timeout=400, workdir=tmp)
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(2)]
        t_ranks = time.perf_counter() - t0
        xc, yc = x.cuda(), y.cuda()
        crit = CEDiceLoss(1.0, 1.0)

        def one_step(inp):
            m = headline_unet(UNet, 21)
            m.load_state_dict(state)
            loss, grads = _step_grads(m, crit, inp, yc, False)
            return loss, {k: v.cpu() for k, v in grads.items()}, \
                {k: v.cpu() for k, v in m.state_dict().items()}
        ref = one_step(xc)
        noise = torch.randn(xc.shape, generator=torch.Generator(
            device="cuda").manual_seed(11), device="cuda")
        moved = one_step(xc * (1 + 2.0 ** -8 * noise))[1]
        for r, got in enumerate(ranks):
            worst = _hold_step(got["loss"], got["grads"], got["state"], ref,
                               moved, f"multigpu (b) rank {r}")
            check_launched(got["launches"], ("conv_bnact", "conv_bnact_dgrad",
                                             "conv_bnact_wgrad"),
                           f"rank {r} of the two-rank step")
            out[f"train_dp2_rank{r}"] = got["launches"]
            print(f"multigpu (b) rank {r}: backend {got['backend']}, world "
                  f"{got['world']}: step of 4 rows in {got['step_s']:.3f} s, "
                  f"loss {got['loss']:.6f} vs one process {ref[0]:.6f}, "
                  f"worst gradient err/bound {worst:.3f}; launches "
                  f"{got['launches']}", flush=True)
            c = got["control"]
            c_worst, c_fail = _step_failures(c["loss"], c["grads"],
                                             c["state"], ref, moved)
            print(f"multigpu (b) rank {r}: control with per-rank batch "
                  f"statistics: loss {c['loss']:.6f}, worst gradient "
                  f"err/bound {c_worst:.3f}, {len(c_fail)} checks fail "
                  f"({'; '.join(c_fail[:3])})", flush=True)
            if not c_fail:
                raise AssertionError(
                    f"multigpu (b) rank {r}: the step with per-rank batch "
                    f"statistics passes the check of the global step")
        diff = [k for k in ranks[0]["state"]
                if not torch.equal(ranks[0]["state"][k], ranks[1]["state"][k])]
        if diff:
            raise AssertionError(f"multigpu (b): ranks differ in {diff[:4]}")
        for r, got in enumerate(ranks):
            f = got["fsdp"]
            worst = _hold_step(f["loss"], f["grads"], f["state"], ref, moved,
                               f"multigpu (b) rank {r} fsdp")
            split = [k for k, d in f["dims"].items() if d is not None]
            half = [k for k in split
                    if f["sizes"][k] * 2 != state[k].numel()]
            if not split or half:
                raise AssertionError(f"multigpu (b) rank {r} fsdp: split "
                                     f"{split}, not halves {half}")
            check_launched(f["launches"], ("conv_bnact", "conv_bnact_dgrad",
                                           "conv_bnact_wgrad"),
                           f"rank {r} of the two-rank fsdp step")
            out[f"train_fsdp2_rank{r}"] = f["launches"]
            print(f"multigpu (b) rank {r} fsdp: {len(split)} of "
                  f"{len(f['dims'])} parameters split "
                  f"({sum(f['sizes'][k] for k in split)} of "
                  f"{sum(state[k].numel() for k in split)} elements held), "
                  f"step of 4 rows in {f['step_s']:.3f} s, loss "
                  f"{f['loss']:.6f} vs one process {ref[0]:.6f}, worst "
                  f"gradient err/bound {worst:.3f}; launches "
                  f"{f['launches']}", flush=True)
        stepped = headline_unet(UNet, 21)
        stepped.load_state_dict(ranks[0]["state"])
        stepped.eval()
        plain = Predictor(stepped, **PREDICT_KW).predict(vol)
        # voxels whose receptive field lies inside shard + halo: away from
        # each tile's shard boundary (H = 128 of its 256 input rows, 64 of
        # its core's 128) by more than radius - halo
        core, cut = PREDICT_KW["tile_shape"][1], PREDICT_KW["tile_shape"][1] // 2
        h = np.arange(vol.shape[3]) % core
        inside = np.abs(h + 0.5 - cut) > max(radius - MG_HALO, 0)
        if not inside.any():
            raise AssertionError(f"multigpu (b): no voxel's receptive field "
                                 f"(radius {radius}) lies inside a shard "
                                 f"and its halo {MG_HALO}")
        for r, got in enumerate(ranks):
            err_t = float(np.abs(got["tiles"] - plain).max())
            diff_s = np.abs(got["spatial"] - plain)
            err_in = float(diff_s[:, :, :, inside].max())
            err_out = float(diff_s[:, :, :, ~inside].max()) \
                if (~inside).any() else 0.0
            print(f"multigpu (b) rank {r}: 'tiles' request in "
                  f"{got['tiles_s']:.3f} s, max abs err {err_t:.3e}; "
                  f"'spatial' in {got['spatial_s']:.3f} s, max abs err "
                  f"{err_in:.3e} where the receptive field (radius "
                  f"{radius}) lies inside shard + halo ({int(inside.sum())}"
                  f" of {inside.size} H rows), {err_out:.3e} elsewhere",
                  flush=True)
            if not (err_t <= 1e-2 and err_in <= 1e-2):
                raise AssertionError(f"multigpu (b) rank {r}: tiles err "
                                     f"{err_t}, spatial err {err_in}")
        print(f"multigpu (b): {time.perf_counter() - t0:.1f} s (ranks "
              f"{t_ranks:.1f} s with their start)", flush=True)
    return out


# ---------------------------------------------------------------------------
# The model zoo (no hand-written kernel: cuDNN, cuBLAS and ATen)
# ---------------------------------------------------------------------------

ZOO_WARMUP = 3                     # zoo_phase's untimed bf16 steps
ZOO_STEPS = 10                     # and timed ones
ZOO_NOISE = 1e-6                   # input noise of the card's own step


def _zoo_cases(Z):
    """(name, builder(dtype, device), bf16 training batch shape, float32
    check batch shape, unit, classes, request) of zoo_phase: every model
    at its full width; the float32 card-against-CPU check at batch 1
    (VNet's and fcn8s' on a crop that keeps their pools whole), so the
    CPU's step stays within seconds, but the classifier's at its batch
    of 16: its last batch norms see one value a sample."""
    def build(ctor, **kw):
        return lambda dtype, device: ctor(dtype=dtype, device=device, **kw)
    return [
        ("VNet", build(Z.VNet, fac=1), (2, 64, 128, 128, 1),
         (1, 32, 64, 64, 1), "MVox", 2, (1, 1, 64, 128, 128)),
        ("UNet3dLite", build(Z.UNet3dLite), (8, 22, 140, 140, 1),
         (1, 22, 140, 140, 1), "MVox", 2, (1, 1, 64, 512, 512)),
        ("fcn8s", build(Z.fcn8s, n_classes=2, red_fac=16),
         (4, 64, 128, 128, 1), (1, 32, 64, 64, 1), "MVox", 2,
         (1, 1, 64, 128, 128)),
        ("FCN8s", build(Z.FCN8s, n_class=2, backbone="vgg16",
                        in_channels=3), (8, 224, 224, 3), (1, 224, 224, 3),
         "MPix", 2, (8, 3, 224, 224)),
        ("FCDenseNet103", lambda dtype, device: Z.FCDenseNet103(
            12, 3, dtype=dtype, device=device), (4, 224, 224, 3),
         (1, 224, 224, 3), "MPix", 12, (4, 3, 224, 224)),
        ("MSDNet", build(Z.MSDNet, num_layers=40, volumetric=True),
         (2, 44, 88, 88, 1), (1, 44, 88, 88, 1), "MVox", 2,
         (1, 1, 44, 88, 88)),
        ("StackedConv2Scalar", build(Z.StackedConv2Scalar, in_channels=1,
                                     n_classes=5), (16, 1, 128, 128, 1),
         (16, 1, 128, 128, 1), "MPix", 5, None),
    ]


def _zoo_targets(model, x, classes, g):
    """Random targets of the model's output shape: (N,) class ids for a
    classifier, else one id a voxel of its (valid-conv smaller) output."""
    with torch.no_grad():
        shape = model(x[:1]).shape
    if len(shape) == 2:
        return torch.randint(0, classes, x.shape[:1], generator=g,
                             device=x.device)
    return torch.randint(0, classes, (x.shape[0],) + tuple(shape[1:-1]),
                         generator=g, device=x.device)


def _zoo_step(model, crit, x, y):
    """(loss, logits, {name: grad}) of one float32 training forward and
    backward, dropout off."""
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    model.train()
    model.zero_grad(set_to_none=True)
    out = model(x)
    loss = crit(out, y)
    loss.backward()
    return (loss.detach().cpu(), out.detach().float().cpu(),
            {n: p.grad.detach().cpu() for n, p in model.named_parameters()})


def _zoo_hold(card, cpu, moved, what):
    """The card's float32 step against the CPU's: loss and logits within
    1e-4 of max |CPU|. Each parameter's gradient, in the L2 norm, within
    1e-3 |CPU| + NOISE_FACTOR |moved - card| + 1e-4 of the whole
    gradient's norm, ``moved`` the card's step on an input moved by
    ZOO_NOISE (as ``check_train_step``: the step's own rounding noise,
    relu and max-pool decisions that flip), the last term for sums of
    millions of cancelling float32 terms that two devices round apart
    (the classifier's first batch-norm bias: 1.2e-3 of its own norm
    apart on an H100 at 700 W, 1.8e-5 of the whole gradient's). A
    gradient that is zero but for rounding (below 1e-5 of the whole
    gradient's norm on the CPU, a conv bias feeding a batch norm) below
    1e-4 of that norm on the card."""
    (l1, o1, g1), (l0, o0, g0), (_, _, gm) = card, cpu, moved
    errs = []
    if abs(float(l1) - float(l0)) > 1e-4 * max(abs(float(l0)), 1e-12):
        errs.append(f"loss {float(l1)} vs {float(l0)}")
    e = float((o1 - o0).abs().max() / o0.abs().max().clamp_min(1e-30))
    if e > 1e-4:
        errs.append(f"logits {e:.3g}")
    total = float(torch.sqrt(sum((g.double() ** 2).sum()
                                 for g in g0.values())))
    worst, worst_q = 0.0, 0.0
    for n, ref in g0.items():
        r = float(ref.double().norm())
        d = float((g1[n].double() - ref.double()).norm())
        if r <= 1e-5 * total:
            if float(g1[n].double().norm()) > 1e-4 * total:
                errs.append(f"{n} not zero")
            continue
        mv = float((gm[n].double() - g1[n].double()).norm())
        b = 1e-3 * r + NOISE_FACTOR * mv + 1e-4 * total
        worst = max(worst, d / max(r, 1e-30))
        worst_q = max(worst_q, d / b)
        if d > b:
            errs.append(f"{n} |d| {d:.3g} > {b:.3g} (|CPU| {r:.3g}, move "
                        f"{mv:.3g}, whole {total:.3g})")
    print(f"zoo {what}: float32 step card vs CPU: loss {float(l1):.6f} / "
          f"{float(l0):.6f}, logits {e:.2e}, worst gradient err/|CPU| "
          f"{worst:.2e}, worst err/bound {worst_q:.3f}", flush=True)
    if errs:
        raise AssertionError(f"zoo {what}: card vs CPU: {errs[:6]}")


def zoo_model_run(name, build, shape, check_shape, unit, classes, request,
                  Predictor, train_step, loss_mod, fused, smi):
    """One zoo model: served (where it is dense), timed bf16 training
    steps with Adam, and the float32 card-against-CPU step. Returns the
    kernel launches of its serving and training."""
    crit = loss_mod.CrossEntropyLoss() if request is None \
        else loss_mod.CEDiceLoss(1.0, 1.0)
    g = torch.Generator(device="cuda").manual_seed(11)
    torch.manual_seed(11)
    model = build(torch.bfloat16, "cuda")
    fused.reset_launches()
    rate = ""
    if request is not None:
        vol = torch.randn(request, generator=g, device="cuda").cpu().numpy()
        kw = dict(batch_size=8)
        if name == "UNet3dLite":
            kw.update(tile_shape=(22, 140, 140), offset=model.offset)
        pred = Predictor(model, **kw)
        pred.predict(vol[:1, :, :22] if name == "UNet3dLite" else vol)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pred.predict(vol)
        dt = time.perf_counter() - t0
        if not np.isfinite(out).all() or out.shape[:2] != (request[0],
                                                           classes):
            raise AssertionError(f"zoo {name}: request output "
                                 f"{out.shape}, finite "
                                 f"{np.isfinite(out).all()}")
        rate = (f"; request {request}: {dt:.3f} s = "
                f"{np.prod(request) / request[1] / dt / 1e6:.2f} "
                f"{unit}/s")
    else:
        with torch.no_grad():
            probe = model.eval()(torch.randn(shape, generator=g,
                                             device="cuda"))
        if probe.shape != (shape[0], classes) \
                or not torch.isfinite(probe).all():
            raise AssertionError(f"zoo {name}: eval logits {probe.shape}")
    served = launch_counts(fused)
    x = torch.randn(shape, generator=g, device="cuda")
    y = _zoo_targets(model, x, classes, g)
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)
    torch.cuda.reset_peak_memory_stats()
    fused.reset_launches()
    dt = timed_steps(train_step, model, crit, opt, [(x, y)], False,
                     warmup=ZOO_WARMUP, steps=ZOO_STEPS)
    trained = launch_counts(fused)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    vox = np.prod(shape[:-1]) / (shape[1] if name == "StackedConv2Scalar"
                                 else 1)
    STEP_MS[f"zoo {name}"] = (dt * 1e3,)
    print(f"zoo {name}: bf16 Adam step at batch {shape}: {dt * 1e3:.2f} ms "
          f"= {vox / dt / 1e6:.2f} {unit}/s, peak {peak:.0f} MB{rate} "
          f"({smi})", flush=True)
    del model, opt, x, y
    torch.cuda.empty_cache()

    torch.manual_seed(12)
    cpu = build(torch.float32, "cpu")
    card = build(torch.float32, "cuda")
    card.load_state_dict(cpu.state_dict())
    gc = torch.Generator().manual_seed(13)
    xc = torch.randn(check_shape, generator=gc)
    yc = _zoo_targets(cpu, xc, classes, gc)
    ref = _zoo_step(cpu, crit, xc, yc)
    got = _zoo_step(card, crit, xc.cuda(), yc.cuda())
    moved = _zoo_step(card, crit, (xc + ZOO_NOISE * torch.randn(
        check_shape, generator=gc)).cuda(), yc.cuda())
    _zoo_hold(got, ref, moved, name)
    del cpu, card
    torch.cuda.empty_cache()
    for what, n in (("serving", served), ("training", trained)):
        if any(n.values()):
            raise AssertionError(f"zoo {name} {what} launched hand "
                                 f"kernels: {n}")
    return served, trained


def zoo_module_run(PM, smi):
    """The zoo's norm and conv modules at (8, 44, 88, 88, 32): forward
    and backward on the card, timed, held against the CPU (float32),
    and the reversible axial transformer's gradients against plain
    autograd through its blocks, with both arms' peak memory."""
    shape = (8, 44, 88, 88, 32)
    mods = {
        "WSConv": lambda d: PM.WSConv(32, 32, (3, 3, 3), device=d),
        "EvoNorm B0": lambda d: PM.EvoNorm(32, "B0", device=d),
        "EvoNorm S0": lambda d: PM.EvoNorm(32, "S0", device=d),
        "L1BatchNorm": lambda d: PM.L1BatchNorm(32, device=d),
        "L1GroupNorm": lambda d: PM.L1GroupNorm(32, device=d),
        "GatherExcite": lambda d: PM.GatherExcite(
            32, 4, True, True, spatial_dim=3, device=d),
    }
    gc = torch.Generator().manual_seed(21)
    x = torch.randn(shape, generator=gc)
    gy = torch.randn(shape, generator=gc)
    for name, make in mods.items():
        torch.manual_seed(22)
        cpu = make("cpu").train()
        card = make("cuda").train()
        init = copy.deepcopy(cpu.state_dict())
        card.load_state_dict(init)
        # The conv runs the CPU on two samples: no batch statistics.
        n = 2 if name == "WSConv" else shape[0]
        xs = x[:n].clone().requires_grad_(True)
        ref = cpu(xs)
        (ref * gy[:n]).sum().backward()
        xd = x.cuda().requires_grad_(True)
        gyd = gy.cuda()

        def fwd_bwd():
            card.zero_grad(set_to_none=True)
            xd.grad = None
            (card(xd) * gyd).sum().backward()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(fwd_bwd)
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        card.load_state_dict(init)      # the buffers before the timing
        xd.grad = None
        card.zero_grad(set_to_none=True)
        out = card(xd)
        (out * gyd).sum().backward()
        pairs = [("out", out[:n], ref), ("dx", xd.grad[:n], xs.grad)]
        if n == shape[0]:
            pairs += [(p, q.grad, cpu.get_parameter(p).grad)
                      for p, q in card.named_parameters()]
            pairs += [(b, q, cpu.get_buffer(b))
                      for b, q in card.named_buffers()]
        # Relative norm errors: the output and the running statistics
        # within 1e-4, the gradients within 1e-3.
        errs = []
        buffers = dict(card.named_buffers())
        for what, a, b in pairs:
            b = b.detach()
            e = float((a.detach().cpu() - b).norm() / b.norm().clamp_min(
                1e-30))
            if e > (1e-4 if what == "out" or what in buffers else 1e-3):
                errs.append(f"{what} {e:.3g}")
        print(f"zoo module {name}: forward + backward at {shape} "
              f"{ms:.2f} ms, peak {peak:.0f} MB ({smi})"
              + (f"; card vs CPU on batch {n}" if n != shape[0] else
                 "; card vs CPU") + (f": {errs}" if errs else ": ok"),
              flush=True)
        if errs:
            raise AssertionError(f"zoo module {name}: card vs CPU {errs}")
        del cpu, card, xd, out
        torch.cuda.empty_cache()

    torch.manual_seed(23)
    ait = PM.AxialImageTransformer(64, 6, heads=8, num_dimensions=2,
                                   device="cuda").train()
    with torch.no_grad():
        for m in ait.modules():
            if hasattr(m, "g") and isinstance(m.g, torch.nn.Parameter):
                m.g.uniform_(-0.5, 0.5)
    xa = torch.randn(8, 64, 64, 64, device="cuda")
    seq = ait.ReversibleSequence_0

    def reversible():
        ait.zero_grad(set_to_none=True)
        ait(xa).square().mean().backward()

    def plain():
        ait.zero_grad(set_to_none=True)
        a = b = xa
        for f, gb in seq.blocks():
            a = a + f(b)
            b = b + gb(a)
        ((a + b) / 2).square().mean().backward()

    arms = {}
    for what, fn in (("reversible", reversible), ("plain autograd", plain)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        grads = {n: p.grad.clone() for n, p in ait.named_parameters()}
        ms = cuda_ms(fn)
        arms[what] = (grads, peak)
        print(f"zoo AxialImageTransformer(64, depth 6, 8 heads) {what}: "
              f"batch 8 of (64, 64, 64) forward + backward {ms:.2f} ms, "
              f"peak {peak:.0f} MB above the inputs ({smi})", flush=True)
    (gr, pr), (gp, pp) = arms["reversible"], arms["plain autograd"]
    worst = max(float((gr[n] - gp[n]).norm() / gp[n].norm().clamp_min(1e-30))
                for n in gp)
    print(f"zoo reversible vs plain gradients: worst {worst:.2e}; peak "
          f"{pr:.0f} MB vs {pp:.0f} MB", flush=True)
    if worst > 1e-3 or not pr < pp:
        raise AssertionError(f"zoo reversible transformer: gradients "
                             f"{worst:.3g}, peak {pr:.0f} vs {pp:.0f} MB")


def zoo_phase(Predictor, train_step, loss_mod, fused, smi):
    """ROADMAP Queue 1 item 8's model zoo and modules (no hand-written
    kernel; their launch counts, all 0, go to ``launches_by_path``)."""
    from elektronn3_tpu_torch import models as Z
    from elektronn3_tpu_torch import modules as PM
    out = {}
    for name, build, shape, check_shape, unit, classes, request in \
            _zoo_cases(Z):
        out[f"predictor_zoo_{name}"], out[f"train_zoo_{name}"] = \
            zoo_model_run(name, build, shape, check_shape, unit, classes,
                          request, Predictor, train_step, loss_mod, fused,
                          smi)
    zoo_module_run(PM, smi)
    return out


# ---------------------------------------------------------------------------
# ROADMAP Queue 1 item 9: the Noise2Void, gradient-accumulation and
# triplet trainers on the kernels, the GNN stack and the config layer.
# ---------------------------------------------------------------------------

N2V_PATCH = (32, 64, 64)        # examples/train_noise2void.py's patch
N2V_BATCH = 4                   # and batch
N2V_RATIO = 0.002               # and n2v_ratio
N2V_CUBE = (128, 512, 512)      # the KNOSSOS stand-in's extent (z, y, x)
MULTI_CROP = (2, 8, 8)          # trainer_multi_phase's loss_crop
TRIPLETS = 8                    # triplet_phase's triplets a step
ITEM9_WARMUP, ITEM9_STEPS = 2, 6  # each trainer phase's untimed, timed steps
ITEM9_WORKERS = 2               # their loaders' workers (the examples')
# Public graph sizes (no download: the graphs are synthetic, seeded).
CORA = dict(n=2708, f=1433, e=10556, classes=7, split=(140, 500, 1000))
ARXIV = dict(n=169_343, f=128, e=1_166_243, classes=40,
             split=(90_941, 29_799, 48_603))
GNN_TOL = 1e-4   # card against CPU, float32: of each leaf's max |ref|


class CubeKD:
    """An in-memory stand-in of ``knossos_utils.KnossosDataset``: a seeded
    uint8 cube (blocks of 8 voxels of random grey with noise on top)."""
    boundary = N2V_CUBE   # the adapter reads it as its (z, y, x) extent

    def __init__(self, path, show_progress=False):
        rng = np.random.default_rng(0)
        coarse = rng.integers(40, 216, [s // 8 for s in N2V_CUBE],
                              dtype=np.int16)
        vol = coarse.repeat(8, 0).repeat(8, 1).repeat(8, 2)
        vol += rng.integers(-30, 31, N2V_CUBE, dtype=np.int16)
        self.vol = vol.clip(0, 255).astype(np.uint8)

    def load_raw(self, offset, size, mag=1, datatype=None):
        out = self.vol[tuple(slice(o, o + s) for o, s in zip(offset, size))]
        return out if datatype is None else out.astype(datatype)


def n2v_unet(UNet, seed, dtype=torch.bfloat16):
    """examples/train_noise2void.py's model."""
    return UNet(in_channels=1, out_channels=1, n_blocks=3, start_filts=32,
                planar_blocks=(0,), activation="relu",
                normalization="batch", dim=3, dtype=dtype, device="cuda",
                generator=torch.Generator().manual_seed(seed))


class MetaPatches(Patches):
    """:class:`Patches` with a per-sample ``cube_meta`` (one NaN)."""

    def __init__(self, n, shape, seed=0):
        super().__init__(n, shape, seed)
        self.meta = np.random.default_rng(seed + 1).uniform(
            0.5, 2.0, (n, 1)).astype(np.float32)
        self.meta[1] = np.nan

    def __getitem__(self, i):
        return {**super().__getitem__(i), "cube_meta": self.meta[i]}


class TripletImages(torch.utils.data.Dataset):
    """Seeded (1, H, W) triplets of independent images (a positive near
    its anchor would make the step's gradient the small difference of
    two nearly equal ones)."""

    def __init__(self, n, shape, seed=0):
        rng = np.random.default_rng(seed)
        self.x = {k: rng.standard_normal((n, 1) + shape, np.float32)
                  for k in ("anchor", "pos", "neg")}

    def __len__(self):
        return len(self.x["anchor"])

    def __getitem__(self, i):
        return {k: v[i] for k, v in self.x.items()}


def stepwise_run(tr, fused, warmup, steps):
    """``tr.run(max_steps=warmup + steps)`` with the launches recorded at
    each optimizer step; the counts set to 0 and the clock started after
    step ``warmup``. Returns (seconds of the timed steps, their
    launches, the launches of each timed step, peak MB)."""
    state = {"n": 0, "per": []}

    def hook(opt, args, kwargs):
        state["n"] += 1
        if state["n"] == warmup:
            torch.cuda.synchronize()
            fused.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            state["last"] = launch_counts(fused)
            state["t0"] = time.perf_counter()
        elif state["n"] > warmup:
            now = launch_counts(fused)
            state["per"].append({k: now[k] - state["last"][k]
                                 for k in now})
            state["last"] = now
            if state["n"] == warmup + steps:
                torch.cuda.synchronize()
                state["t1"] = time.perf_counter()
    handle = tr.optimizer.register_step_post_hook(hook)
    try:
        tr.run(max_steps=warmup + steps)
    finally:
        handle.remove()
    losses = tr.last_stats["tr_loss"]
    if tr.step != warmup + steps or not np.isfinite(losses).all():
        raise AssertionError(f"run: step {tr.step}, losses {losses}")
    return (state["t1"] - state["t0"], launch_counts(fused), state["per"],
            torch.cuda.max_memory_allocated() / 1e6)


def check_item9_launches(what, launches, per, kernels, fused):
    """Every kernel of ``kernels`` launched, no other (no vup entry, no
    K8-K11), and each timed step's launches the same."""
    check_launched(launches, kernels, what)
    stray = {k: n for k, n in launches.items() if n and k not in kernels}
    if stray:
        raise AssertionError(f"{what}: kernels off its plan launched: "
                             f"{stray}")
    if any(p != per[0] for p in per):
        raise AssertionError(f"{what}: launches differ by step: {per}")
    print(f"{what}: launches a step (the same in each of {len(per)}): "
          + ", ".join(f"{k} {n}" for k, n in per[0].items() if n),
          flush=True)


def check_plan(model, shape, want, what):
    kinds = model.level_kinds(shape)
    if kinds != want:
        raise AssertionError(f"{what}: level plan {kinds}, expected {want}")
    print(f"{what}: level plan at {shape}: {kinds}", flush=True)


def n2v_phase(UNet, fused, smi):
    """Noise2Void (``training/noise2void.py``) on the model, patch, batch
    and ratio of examples/train_noise2void.py, bf16, fed by
    ``KnossosRawData`` ('in_memory') over :class:`CubeKD`: the plan (L0
    and L1 on the kernels), K1-K7 and rows 3/13 launched the same in
    every step, and one step's gradients against the plain path with the
    masked MSE of a fixed mask."""
    from elektronn3_tpu_torch.data import knossos, transforms
    from elektronn3_tpu_torch.modules.loss import masked_mse_loss
    from elektronn3_tpu_torch.training.noise2void import (
        Noise2VoidTrainer, mask_batch)
    knossos.KnossosDataset = CubeKD
    shape = (N2V_BATCH, *N2V_PATCH, 1)
    raw = knossos.KnossosRawData(
        "stand-in", patch_shape=N2V_PATCH, mode="in_memory",
        epoch_size=N2V_BATCH * (ITEM9_WARMUP + ITEM9_STEPS),
        transform=transforms.Normalize(mean=128.0, std=50.0))
    model = n2v_unet(UNet, 3)
    check_plan(model, shape, ["kernels", "kernels", "library"], "n2v")
    with tempfile.TemporaryDirectory() as root:
        tr = Noise2VoidTrainer(model, None, train_dataset=raw,
                               batch_size=N2V_BATCH, n2v_ratio=N2V_RATIO,
                               num_workers=ITEM9_WORKERS,
                               save_root=root, exp_name="n2v",
                               enable_tensorboard=False,
                               nan_check_interval=ITEM9_STEPS)
        dt, launches, per, peak = stepwise_run(tr, fused, ITEM9_WARMUP,
                                               ITEM9_STEPS)
    check_item9_launches("n2v training", launches, per, K1_K7, fused)
    vox = np.prod(shape)
    print(f"n2v: Noise2VoidTrainer step {dt / ITEM9_STEPS * 1e3:.2f} ms = "
          f"{vox * ITEM9_STEPS / dt / 1e6:.2f} MVox/s (batch {N2V_BATCH} "
          f"of {N2V_PATCH}, bf16, ratio {N2V_RATIO}, KNOSSOS in_memory "
          f"{N2V_CUBE}), peak {peak:.1f} MB; losses "
          f"{[round(v, 4) for v in tr.last_stats['tr_loss']]}", flush=True)
    np.random.seed(1)
    batch = np.stack([raw[i]["inp"] for i in range(N2V_BATCH)])
    parts = mask_batch(batch, N2V_RATIO, np.random.default_rng(2))
    x, target, mask = (torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(a, 1, -1))).cuda() for a in parts)
    check_train_step(lambda seed, dtype: n2v_unet(UNet, seed, dtype),
                     lambda out, t: masked_mse_loss(out, t, mask),
                     x, target, what=" n2v")
    return launches


def trainer_multi_phase(UNet, CEDiceLoss, fused, smi):
    """``TrainerMulti`` on the headline UNet: bench.py's batch 8 of
    (44, 88, 88) as ``optimizer_iterations=2`` micro-batches of 4,
    CEDiceLoss with ``loss_crop`` (2, 8, 8) and a ``cube_meta`` weight,
    bf16, Adam: the kernels' dW and db accumulate in ``.grad`` over two
    forwards and backwards before each step. One step's accumulated
    gradients against the plain path."""
    from elektronn3_tpu_torch.training import TrainerMulti
    from elektronn3_tpu_torch.training._trainer_multi import (
        crop_loss_region, cube_weight)
    micro = BATCH // 2
    # one epoch: the timed steps see no epoch's end (its checkpoint)
    data = MetaPatches(2 * micro * (ITEM9_WARMUP + ITEM9_STEPS), (1, *PATCH),
                       seed=5)
    model = headline_unet(UNet, 3)
    check_plan(model, (micro, *PATCH, 1),
               ["kernels", "kernels", "library", "library"], "multi")
    with tempfile.TemporaryDirectory() as root:
        tr = TrainerMulti(model, CEDiceLoss(1.0, 1.0), train_dataset=data,
                          batch_size=micro, optimizer_iterations=2,
                          num_workers=ITEM9_WORKERS,
                          loss_crop=MULTI_CROP, save_root=root,
                          exp_name="multi", enable_tensorboard=False,
                          nan_check_interval=2 * ITEM9_STEPS)
        dt, launches, per, peak = stepwise_run(tr, fused, ITEM9_WARMUP,
                                               ITEM9_STEPS)
    check_item9_launches("multi training", launches, per, K1_K7, fused)
    if per[0]["conv1_bwd"] != 2:
        raise AssertionError(f"multi: row 13's kernel {per[0]['conv1_bwd']}"
                             " times a step, expected once a micro-batch")
    vox = BATCH * np.prod(PATCH)
    print(f"multi: TrainerMulti step (2 micro-batches of {micro}) "
          f"{dt / ITEM9_STEPS * 1e3:.2f} ms = "
          f"{vox * ITEM9_STEPS / dt / 1e6:.2f} MVox/s (bf16, loss_crop "
          f"{MULTI_CROP}, cube_meta), peak {peak:.1f} MB", flush=True)
    crit = CEDiceLoss(1.0, 1.0)
    x = torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(data.inp[:BATCH], 1, -1))).cuda()
    y = torch.from_numpy(data.target[:BATCH]).cuda()
    weights = [cube_weight(data.meta[i:i + micro])
               for i in range(0, BATCH, micro)]

    def accumulated(model, crit, x, y, reference):
        model.train()
        model.zero_grad(set_to_none=True)
        total = 0.0
        for xi, yi, w in zip(x.chunk(2), y.chunk(2), weights):
            o, t = crop_loss_region(model(xi, reference=reference), yi,
                                    MULTI_CROP)
            loss = crit(o, t).float() * w
            loss.backward()
            total += float(loss.detach())
        return total / 2, {n: p.grad.float() / 2
                           for n, p in model.named_parameters()}
    check_train_step(lambda seed, dtype: headline_unet(UNet, seed, dtype),
                     crit, x, y, what=" multi (2 micro-batches)",
                     grads_fn=accumulated)
    return launches


def triplet_phase(UNet, fused, smi):
    """``TripletTrainer`` on the 2D UNet of examples/train_simple2d.py at
    8 triplets of (640, 640), bf16: three training forwards through the
    2D kernel levels (rows 16/17 and 19/20, K1-K7 on the D=1 view) and
    one backward a step; the running statistics take three updates a
    step. One step's gradients against the plain path (conv_final's bias
    has an exact gradient of 0: the loss takes differences)."""
    from elektronn3_tpu_torch.modules.loss import GAPTripletMarginLoss
    from elektronn3_tpu_torch.training import TripletTrainer
    # one epoch: the timed steps see no epoch's end (its checkpoint)
    data = TripletImages(TRIPLETS * (ITEM9_WARMUP + ITEM9_STEPS), IMAGE,
                         seed=6)
    model = unet_2d(UNet, 3)
    check_plan(model, (TRIPLETS, *IMAGE, 1),
               ["kernels", "kernels", "library", "library"], "triplet")
    with tempfile.TemporaryDirectory() as root:
        tr = TripletTrainer(model, train_dataset=data, batch_size=TRIPLETS,
                            num_workers=ITEM9_WORKERS,
                            save_root=root, exp_name="triplet",
                            enable_tensorboard=False,
                            nan_check_interval=ITEM9_STEPS)
        with record_shapes(fused) as seen:
            dt, launches, per, peak = stepwise_run(tr, fused, ITEM9_WARMUP,
                                                   ITEM9_STEPS)
        check_item9_launches("triplet training", launches, per, K1_K7,
                             fused)
        check_rows(seen, (16, 17, 19, 20), "triplet training")
        if (per[0]["conv1_fwd"], per[0]["conv1_bwd"]) != (3, 3):
            raise AssertionError(f"triplet: rows 3 and 13 {per[0]}, "
                                 "expected each once a forward")
        # The running statistics of one step: three momentum updates, as
        # three training forwards of a copy give them.
        batch = {k: torch.from_numpy(np.ascontiguousarray(
            np.moveaxis(v[:TRIPLETS], 1, -1))).cuda()
            for k, v in data.x.items()}
        ref = copy.deepcopy(model)
        with torch.no_grad():
            ref.train()
            for k in ("anchor", "pos", "neg"):
                ref(batch[k])
        tr._train_batch(batch, None)
        torch.cuda.synchronize()
    worst = 0.0
    for (n, b), (_, r) in zip(model.named_buffers(), ref.named_buffers()):
        if b.dtype == torch.float32:
            worst = max(worst, float((b - r).abs().max())
                        / float(r.abs().max()))
    # 1e-3: the kernels' float32 statistics sums vary in their last bits
    # between two runs (4.5e-5 of max seen on an H100); one update more
    # or less moves a running statistic by about 1e-2 of it (momentum
    # 0.99).
    if not worst <= 1e-3:
        raise AssertionError(f"triplet: running statistics {worst} from "
                             "three training forwards")
    pix = 3 * TRIPLETS * np.prod(IMAGE)
    print(f"triplet: TripletTrainer step (3 forwards of {TRIPLETS}) "
          f"{dt / ITEM9_STEPS * 1e3:.2f} ms = "
          f"{pix * ITEM9_STEPS / dt / 1e6:.2f} MPix/s (bf16, "
          f"GAPTripletMarginLoss), peak {peak:.1f} MB; one step's running "
          f"statistics against three training forwards: max rel err "
          f"{worst:.2e}", flush=True)
    x = torch.cat([torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(data.x[k][:TRIPLETS], 1, -1)))
        for k in ("anchor", "pos", "neg")]).cuda()

    def three_forwards(model, crit, x, y, reference):
        model.train()
        model.zero_grad(set_to_none=True)
        outs = [model(xi, reference=reference) for xi in x.chunk(3)]
        loss = crit(*outs).float()
        loss.backward()
        return float(loss.detach()), {n: p.grad.float().clone()
                                      for n, p in model.named_parameters()}
    # zero_bf16 0.5: the triplet loss's gradients are small, and in bf16
    # the exactly-0 bias gradients keep a rounding residue of up to 0.262
    # of their weight gradient on the reference path itself (conv_final's
    # bias; 0.066 up_2's conv2). whole 1e-4: in float32 the last decoder
    # norm's scale gradient (6.6e-4 of a leaf) came 0.87-1.06 of its
    # bound in three calls (NVIDIA H100 80GB HBM3, 700.00 W).
    check_train_step(lambda seed, dtype: unet_2d(UNet, seed, dtype),
                     GAPTripletMarginLoss(), x, None, zero_bf16=0.5,
                     whole=1e-4,
                     what=" triplet (3 forwards)", grads_fn=three_forwards,
                     exact_zero=("conv_final.bias",))
    return launches


def synthetic_graph(rng, n, f, e, classes, split, binary=False,
                    symmetric=True):
    """A seeded graph dict of ``n`` nodes, ``f`` features (binary at the
    density of a bag of words, else normal), ``e`` directed edges (pairs
    and their reverses with ``symmetric``), labels that shift the
    features, and train, validation and test masks of ``split``'s
    sizes."""
    y = rng.integers(0, classes, n)
    if binary:
        x = (rng.random((n, f), np.float32) < 0.0127).astype(np.float32)
    else:
        x = rng.standard_normal((n, f), np.float32)
    x[:, :classes] += np.eye(classes, dtype=np.float32)[y]
    if symmetric:
        half = rng.integers(0, n, (2, e // 2))
        ei = np.concatenate([half, half[::-1]], 1)
    else:
        ei = rng.integers(0, n, (2, e))
    g = {"x": x, "edge_index": ei.astype(np.int64), "y": y.astype(np.int64)}
    order = rng.permutation(n)
    lo = 0
    for name, size in zip(("train_mask", "val_mask", "test_mask"), split):
        m = np.zeros(n, bool)
        m[order[lo:lo + size]] = True
        g[name] = m
        lo += size
    return g


def _hold_gnn(card, cpu, what):
    """The card's step (loss, gradients) against the CPU's: within
    GNN_TOL of each leaf's max |ref| (float32; ``index_add_`` sums with
    atomics on the card, in another order than the CPU)."""
    (lk, gk), (lc, gc) = card, cpu
    worst = abs(lk - lc) / abs(lc)
    if not worst <= GNN_TOL:
        raise AssertionError(f"{what}: loss {lk} on the card, {lc} on the "
                             "CPU")
    for n, g in gc.items():
        err = float((gk[n].cpu() - g).abs().max())
        q = err / max(float(g.abs().max()), 1e-30)
        worst = max(worst, q)
        if not q <= GNN_TOL:
            raise AssertionError(f"{what}: gradient {n} {err} of max "
                                 f"{float(g.abs().max())}")
    return worst


def _gnn_grads(tr, step):
    loss = step()
    return float(loss), {n: p.grad.detach().clone()
                         for n, p in tr.model.named_parameters()}


def gnn_phase(fused, smi):
    """The GNN stack (``modules/graph.py``, ``training/trainer_gnn*.py``;
    no TPU kernel behind it in JAX: ATen's scatter and GEMM kernels) on
    synthetic graphs of the public datasets' sizes, float32: GCN, SAGE
    and GAT full batch on a Cora-sized graph, the multi-graph trainer on
    64 graphs of about 1000 nodes, and the minibatch trainer on an
    ogbn-arxiv-sized graph at 1024 seeds and fanout (10, 5). Each one
    step on the card against the same step on the CPU (dropout 0)."""
    from elektronn3_tpu_torch.modules.graph import GNN
    from elektronn3_tpu_torch.training import (
        trainer_gnn, trainer_gnn_batch, trainer_gnn_minibatch)
    rng = np.random.default_rng(8)
    cora = synthetic_graph(rng, binary=True, **CORA)
    fused.reset_launches()
    for conv in ("gcn", "sage", "gat"):
        torch.manual_seed(1)
        cpu = GNN(CORA["f"], hidden=64, out_channels=CORA["classes"],
                  conv=conv, dropout=0.0, device="cpu")
        card = copy.deepcopy(cpu).cuda()
        tk = trainer_gnn.GNNTrainer(card, cora, lr=0.01)
        tc = trainer_gnn.GNNTrainer(cpu, cora, lr=0.01)
        worst = _hold_gnn(_gnn_grads(tk, tk._train_step),
                          _gnn_grads(tc, tc._train_step), f"gnn {conv}")
        card.dropout = 0.5
        tk.run(3)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        stats = tk.run(20)
        dt = (time.perf_counter() - t0) / 20
        if not np.isfinite(stats["tr_loss"]):
            raise AssertionError(f"gnn {conv}: {stats}")
        print(f"gnn {conv} (Cora size: {CORA['n']} nodes, {CORA['f']} "
              f"features, {CORA['e']} edges; hidden 64, dropout 0.5): "
              f"epoch (step and eval) {dt * 1e3:.2f} ms = "
              f"{CORA['n'] / dt / 1e6:.3f} M nodes/s, peak "
              f"{torch.cuda.max_memory_allocated() / 1e6:.1f} MB; card "
              f"against CPU, worst err/max {worst:.2e}; val_acc "
              f"{stats['val_acc']:.3f}", flush=True)
    graphs = [synthetic_graph(rng, n=int(rng.integers(900, 1100)), f=32,
                              e=8000, classes=6, split=(0, 0, 0))
              for _ in range(64)]
    for g in graphs:
        for k in ("train_mask", "val_mask", "test_mask"):
            del g[k]
    torch.manual_seed(2)
    cpu = GNN(32, hidden=64, out_channels=6, conv="sage", dropout=0.0,
              device="cpu")
    tb = trainer_gnn_batch.GNNTrainer(copy.deepcopy(cpu).cuda(), graphs)
    tc = trainer_gnn_batch.GNNTrainer(cpu, graphs[:1])
    worst = _hold_gnn(
        _gnn_grads(tb, lambda: tb._train_step(tb.graphs[0])),
        _gnn_grads(tc, lambda: tc._train_step(tc.graphs[0])), "gnn batch")
    tb.run(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats = tb.run(1)
    dt = (time.perf_counter() - t0) / len(graphs)
    peak = torch.cuda.max_memory_allocated() / 1e6
    nodes = sum(len(g["y"]) for g in graphs) / len(graphs)
    print(f"gnn batch (64 graphs of {nodes:.0f} nodes on average, 32 "
          f"features, SAGE): step {dt * 1e3:.2f} ms = "
          f"{nodes / dt / 1e6:.3f} M nodes/s (epoch and evaluate), peak "
          f"{peak:.1f} MB; card "
          f"against CPU, worst err/max {worst:.2e}; {stats}", flush=True)
    arxiv = synthetic_graph(rng, symmetric=False, **ARXIV)
    torch.manual_seed(3)
    cpu = GNN(ARXIV["f"], hidden=256, out_channels=ARXIV["classes"],
              conv="sage", dropout=0.0, device="cpu")
    card = copy.deepcopy(cpu).cuda()
    kw = dict(batch_size=1024, num_neighbors=(10, 5), seed=4)
    tm = trainer_gnn_minibatch.GNNTrainer(card, arxiv, **kw)
    tc = trainer_gnn_minibatch.GNNTrainer(cpu, arxiv, **kw)
    worst = _hold_gnn(_gnn_grads(tm, lambda: tm.train_step()[0]),
                      _gnn_grads(tc, lambda: tc.train_step()[0]),
                      "gnn minibatch")
    card.dropout = 0.5
    tm.train_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    host0, t0 = tm.host_seconds, time.perf_counter()
    steps = 3
    for _ in range(steps):
        loss, _, _ = tm.train_step()
    float(loss)
    dt = (time.perf_counter() - t0) / steps
    host = (tm.host_seconds - host0) / steps
    ev = {**tm.evaluate(), **tm.validate_sampled(max_batches=2)}
    if not all(np.isfinite(v) for v in ev.values()):
        raise AssertionError(f"gnn minibatch: {ev}")
    print(f"gnn minibatch (ogbn-arxiv size: {ARXIV['n']} nodes, "
          f"{ARXIV['e']} edges, {ARXIV['f']} features; 1024 seeds, fanout "
          f"(10, 5), SAGE hidden 256): step {dt * 1e3:.2f} ms = "
          f"{1024 / dt / 1e6:.4f} M seeds/s, of which host sampling "
          f"{host * 1e3:.2f} ms ({100 * host / dt:.1f}%), peak "
          f"{torch.cuda.max_memory_allocated() / 1e6:.1f} MB; card against "
          f"CPU, worst err/max {worst:.2e}; {ev}", flush=True)
    launches = launch_counts(fused)
    if any(launches.values()):
        raise AssertionError(f"gnn: hand-written kernels launched: "
                             f"{launches}")
    return launches


def config_phase(UNet, CEDiceLoss, fused, smi):
    """The config layer: a ``TrainingConfig`` of the headline UNet (bf16)
    saved to JSON, loaded and built with ``build_trainer(worker_type=
    'thread')``; two ``Trainer.run`` steps on the card through K1-K7;
    ``sync_overhead_s`` and ``device_memory_stats``."""
    from elektronn3_tpu_torch.config import (
        ModelConfig, OptimizerConfig, TrainingConfig)
    from elektronn3_tpu_torch.utils import (
        device_memory_stats, sync_overhead_s)
    with tempfile.TemporaryDirectory() as root:
        cfg = TrainingConfig(
            model=ModelConfig("UNet", dict(
                in_channels=1, out_channels=2, n_blocks=4, start_filts=32,
                planar_blocks=(0,), activation="relu",
                normalization="batch", dim=3), dtype="bfloat16"),
            optimizer=OptimizerConfig("adam", lr=1e-3), batch_size=2,
            max_steps=2, save_root=root, exp_name="config",
            trainer_kwargs={"enable_tensorboard": False})
        path = os.path.join(root, "run.json")
        cfg.save(path)
        back = TrainingConfig.load(path)
        if back.to_json() != cfg.to_json():
            raise AssertionError("config: the JSON round trip changed it")
        fused.reset_launches()
        tr = back.build_trainer(CEDiceLoss(1.0, 1.0),
                                train_dataset=Patches(4, (1, *PATCH)),
                                worker_type="thread")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr.run(max_steps=back.max_steps)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e6
        launches = launch_counts(fused)
        if not isinstance(tr.model, UNet) or tr.model.dtype != \
                torch.bfloat16 or tr.worker_type != "thread" or \
                tr.step != 2 or not np.isfinite(
                    tr.last_stats["tr_loss"]).all():
            raise AssertionError(f"config: built {type(tr.model)}, step "
                                 f"{tr.step}, {tr.last_stats}")
        if not os.path.isfile(os.path.join(tr.save_path, "config.json")):
            raise AssertionError("config: no config.json in the run")
    check_launched(launches, K1_K7, "config-built training")
    stats = device_memory_stats()
    vox = back.batch_size * np.prod(PATCH) * back.max_steps
    print(f"config: TrainingConfig -> JSON -> build_trainer(worker_type="
          f"'thread'), Trainer.run(2) at batch 2 of {PATCH} {dt:.2f} s "
          f"(the run's files and both steps, {dt / 2 * 1e3:.2f} ms a step "
          f"= {vox / dt / 1e6:.2f} MVox/s), peak {peak:.1f} MB, "
          f"launches {launches}; "
          f"sync_overhead_s {sync_overhead_s() * 1e6:.1f} us; "
          f"device_memory_stats {stats}", flush=True)
    return launches


# The program's bf16 probabilities against the pallas_flat=False model's
# request on the same tiles: one bf16 unit of a probability near 1 (both
# run the same library ops in the same order).
EXPORT_TOL = 2.0 ** -8
EXPORT_TILE = dict(PREDICT_KW, batch_size=1)   # the program's batch
TRAINED_TILE = dict(tile_shape=(22, 44, 44), overlap_shape=(11, 22, 22),
                    float16=True)   # the Trainer's program: PATCH


_LOAD_ALONE = """
import sys, torch
import elektronn3_tpu_torch.ops.pallas_bn
m = torch.export.load(sys.argv[1]).module()
x = torch.load(sys.argv[2])
torch.save(m(x).cpu(), sys.argv[3])
bad = [k for k in sys.modules if k.startswith(tuple(
    'elektronn3_tpu_torch.' + p for p in ('models', 'training',
                                          'inference')))]
assert not bad, bad
"""


def _request(pred, vol):
    """(probabilities, MVox/s) of one timed request after a warm-up."""
    pred.predict(vol)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probs = pred.predict(vol)
    return probs, vol.size / (time.perf_counter() - t0) / 1e6


def _hold_request(got, ref, bound, what):
    err = float(np.abs(got - ref).max())
    if got.shape != ref.shape or not np.isfinite(got).all() or err > bound:
        raise AssertionError(f"{what}: {got.shape} vs {ref.shape}, max abs "
                             f"err {err} > {bound}")
    return err


def export_phase(UNet, Predictor, CEDiceLoss, Trainer, fused, smi):
    """Step 24 of the module docstring; returns the launches of the
    'batchp' program's request."""
    from elektronn3_tpu_torch.modules.pallas_norm import PallasBatchNorm
    from elektronn3_tpu_torch.training import export_program, load_program
    vol = seeded_volume()
    root = os.path.dirname(os.path.abspath(__file__))
    launches = None
    with tempfile.TemporaryDirectory() as tmp:
        for norm in ("batch", "batchp"):
            model = headline_unet(UNet, 0, normalization=norm).eval()
            randomize_norms(model, 1)
            path = os.path.join(tmp, f"unet_{norm}.pt2")
            t0 = time.perf_counter()
            export_program(model, (1, *TILE, 1), path)
            t_export = time.perf_counter() - t0
            t0 = time.perf_counter()
            program = load_program(path)
            t_load = time.perf_counter() - t0
            mb = os.path.getsize(path) / 1e6
            nodes = sum(1 for n in program.graph.nodes
                        if str(n.target) == "e3tpu.bn_normalize.default")
            norms = sum(isinstance(m, PallasBatchNorm)
                        for m in model.modules())
            if nodes != norms or (norm == "batchp") != (norms > 0):
                raise AssertionError(f"export {norm}: {nodes} K9 nodes for "
                                     f"{norms} PallasBatchNorm modules")
            if norm == "batchp":
                x = torch.randn((1, *TILE, 1), generator=torch.Generator(
                    ).manual_seed(5)).cuda()
                with torch.inference_mode():
                    y = program(x).cpu()
                torch.save(x, os.path.join(tmp, "x.pt"))
                del x
                t0 = time.perf_counter()
                subprocess.run(
                    [sys.executable, "-c", _LOAD_ALONE, path,
                     os.path.join(tmp, "x.pt"), os.path.join(tmp, "y.pt")],
                    check=True, timeout=300,
                    env=dict(os.environ, PYTHONPATH=root))
                if not torch.equal(torch.load(os.path.join(tmp, "y.pt")), y):
                    raise AssertionError("export batchp: the program loaded "
                                         "alone gives other bits")
                print(f"export {norm}: the program loaded and run by a new "
                      f"interpreter with torch and ops.pallas_bn alone in "
                      f"{time.perf_counter() - t0:.1f} s, the same bits",
                      flush=True)
            del program
            ref, mvox = _request(Predictor(model, **EXPORT_TILE), vol)
            library = copy.deepcopy(model)
            library.pallas_flat = False
            lib, lib_mvox = _request(Predictor(library, **EXPORT_TILE), vol)
            del library
            pred = Predictor(path, **EXPORT_TILE)
            calls = []
            pred.model.module.register_forward_pre_hook(
                lambda *a: calls.append(1))
            pred.predict(vol)                              # warm-up
            torch.cuda.synchronize()
            calls.clear()
            fused.reset_launches()
            t0 = time.perf_counter()
            got = pred.predict(vol)
            got_mvox = vol.size / (time.perf_counter() - t0) / 1e6
            counts = launch_counts(fused)
            want = {k: norms * len(calls) if k == "bn_normalize" else 0
                    for k in counts}
            if counts != want:
                raise AssertionError(f"export {norm}: the program's request "
                                     f"launched {counts}, expected {want}")
            err_k = _hold_request(got, ref, 5e-2, f"export {norm} vs the "
                                  "kernel plan")
            err_l = _hold_request(got, lib, EXPORT_TOL, f"export {norm} vs "
                                  "pallas_flat=False")
            print(f"export {norm}: export_program (trace and save) at (1, "
                  f"{TILE}, 1) {t_export:.2f} s, load_program {t_load:.2f} "
                  f"s, {mb:.2f} MB, "
                  f"{nodes} K9 nodes; Predictor(.pt2) {got.shape} "
                  f"{got_mvox:.2f} MVox/s ({len(calls)} program calls, "
                  f"launches {counts}) against the model's {mvox:.2f} "
                  f"(kernel plan, max abs err {err_k:.3e}, bound 5e-2) and "
                  f"the pallas_flat=False model's {lib_mvox:.2f} (max abs "
                  f"err {err_l:.3e}, bound {EXPORT_TOL:.3e}); {smi}",
                  flush=True)
            if norm == "batchp":
                launches = counts
            del model, pred
            torch.cuda.empty_cache()

        model = headline_unet(UNet, 0)
        tr = Trainer(model, CEDiceLoss(1.0, 1.0),
                     train_dataset=Patches(2, (1, *PATCH)), batch_size=2,
                     save_root=tmp, exp_name="export",
                     example_input=np.zeros((1, *PATCH, 1), np.float32),
                     enable_tensorboard=False)
        t0 = time.perf_counter()
        tr.run(max_steps=1)
        t_run = time.perf_counter() - t0
        path = os.path.join(tr.save_path, "model_final.pt2")
        if not os.path.isfile(path):
            raise AssertionError("export: Trainer.run wrote no "
                                 "model_final.pt2")
        small = vol[:, :, :44, :88, :88]
        got, got_mvox = _request(Predictor(path, **TRAINED_TILE), small)
        library = copy.deepcopy(tr.model).eval()
        library.pallas_flat = False
        lib, _ = _request(Predictor(library, batch_size=1, **TRAINED_TILE),
                          small)
        err = _hold_request(got, lib, EXPORT_TOL, "export: the Trainer's "
                            "model_final.pt2")
        print(f"export: Trainer.run(1) with example_input {(1, *PATCH, 1)} "
              f"{t_run:.2f} s, model_final.pt2 served {got.shape} at "
              f"{got_mvox:.2f} MVox/s, max abs err {err:.3e} against the "
              f"trained model's library plan", flush=True)
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    from elektronn3_tpu_torch.inference import Predictor
    from elektronn3_tpu_torch.models import ResUNet, UNet
    from elektronn3_tpu_torch.models import unet as unet_mod
    from elektronn3_tpu_torch.modules import loss as loss_mod
    from elektronn3_tpu_torch.modules.loss import CEDiceLoss
    from elektronn3_tpu_torch.ops import (_build, fused, pallas_bn,
                                         pallas_conv, vup)
    from elektronn3_tpu_torch.training import Trainer, save_model, train_step

    print(f"card: {smi}; torch {torch.__version__} CUDA {torch.version.cuda}",
          flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    profiling = "--profile" in sys.argv[1:]

    t0 = _MARK[0] = time.perf_counter()
    _build.build(verbose=True)
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          + ("(nvcc ran)" if _build.build_seconds is not None
             else "(library already built)"), flush=True)
    kernel = "?"
    for line in _build.build_log.splitlines():
        m = re.search(r"Compiling entry function '_Z.*?\d((?:[a-z]+_)+kernel)"
                      r"(I\w*?E)?E*v", line)
        if m:
            kernel = m.group(1) + (m.group(2) or "")
        elif "registers" in line:
            print(f"  ptxas {kernel}: {line.split(':', 1)[1].strip()}")
    mark("build")

    def build3d(seed, dtype):
        return headline_unet(UNet, seed, dtype)

    def build2d(seed, dtype):
        return unet_2d(UNet, seed, dtype)

    def build_sf64(seed, dtype):
        return sf64_unet(UNet, seed, dtype)

    def build_batchp(seed, dtype):
        return headline_unet(UNet, seed, dtype, normalization="batchp")

    def build_group(seed, dtype):
        return headline_unet(UNet, seed, dtype, normalization="group")

    def build_instance(seed, dtype):
        return headline_unet(UNet, seed, dtype, normalization="instance")

    def build_group_library(seed, dtype):
        return headline_unet(UNet, seed, dtype, normalization="group",
                             pallas_flat=False)


    def build_batchp_library(seed, dtype):
        return headline_unet(UNet, seed, dtype, normalization="batchp",
                             pallas_flat=False)

    def build_silu(seed, dtype):
        return headline_unet(UNet, seed, dtype, activation="silu",
                             pallas_flat=True)

    def build_silu_library(seed, dtype):
        return headline_unet(UNet, seed, dtype, activation="silu",
                             pallas_flat=False)

    def build_group_vup(seed, dtype, vup=True):
        return headline_unet(UNet, seed, dtype, normalization="group",
                             vup=vup)

    def build_2d_group(seed, dtype):
        return unet_2d(UNet, seed, dtype, normalization="group")

    def build_2d_group_library(seed, dtype):
        return unet_2d(UNet, seed, dtype, normalization="group",
                       pallas_flat=False)

    def build_vup(seed, dtype, vup=True):
        return headline_unet(UNet, seed, dtype, vup=vup)

    def build_input_grad(seed, dtype, on=True):
        return headline_unet(UNet, seed, dtype, input_grad=on)

    def build_valid(seed, dtype):
        return headline_unet(UNet, seed, dtype, conv_mode="valid")

    def build_add(seed, dtype):
        return headline_unet(UNet, seed, dtype, merge_mode="add")

    def build_option(seed, dtype, **options):
        return headline_unet(UNet, seed, dtype, **options)

    stats = Stats()
    kernel_phase(fused, stats, VARIANTS, total=True)
    train_kernel_phase(fused, stats, TRAIN_VARIANTS, total=True,
                       serve=False)
    train_kernel_phase(fused, stats, TRAIN_VARIANTS_2D, total=False,
                       serve=True)
    kernel_phase(fused, stats, VARIANTS_TILE_C128, total=False)
    kernel_phase(fused, stats, VARIANTS_SF64_TILE, total=False)
    kernel_phase(fused, stats, VARIANTS_CONV1, total=False)
    mark("kernels: tile, bench, 2D")
    per_sample_phase(fused, stats)
    per_sample_vup_phase(vup, fused, stats, backward=False)
    mark("kernels: per-sample forward")
    per_sample_bwd_phase(fused, stats)
    per_sample_vup_phase(vup, fused, stats, backward=True)
    mark("kernels: per-sample backward")
    train_kernel_phase(fused, stats, TRAIN_VARIANTS_SF64, total=False,
                       serve=False)
    bn_kernel_phase(pallas_bn, stats)
    bn_layer_phase()
    kernel_phase(fused, stats, VARIANTS_FLAT_TILE, total=False)
    train_kernel_phase(fused, stats, TRAIN_VARIANTS_FLAT, total=False,
                       serve=True)
    conv_direct_phase(pallas_conv, stats)
    nd_check(fused)
    mark("kernels: sf64, batchp, flat")

    launches = {"predictor": predictor_phase(build3d, "3D", Predictor,
                                             fused, ("24/222",))}
    launches["train"], model, crit, opt, batches = train_phase(
        build3d, (BATCH, *PATCH, 1), "3D", "MVox", CEDiceLoss, train_step,
        fused)
    if profiling:
        profile_phase(train_step, model, crit, opt, batches)
    del model, opt, batches
    torch.cuda.empty_cache()
    trainer_phase(build3d, (1, *PATCH), "3D", CEDiceLoss, Trainer)
    mark("3D paths")
    launches["trainer_full"] = trainer_full_phase(build3d, CEDiceLoss, fused)
    torch.cuda.empty_cache()
    mark("trainer full")
    launches.update(pipeline_phase(UNet, fused, launches["train"], smi))
    mark("data pipeline")
    launches["validate"] = validate_phase(UNet, fused, smi)
    torch.cuda.empty_cache()
    mark("validate")
    launches["train_input_grad"] = input_grad_phase(
        build_input_grad, CEDiceLoss, train_step, fused)
    mark("3D input_grad")
    launches["predictor_tta"] = predictor_tta_phase(build3d, Predictor,
                                                    fused, save_model)
    torch.cuda.empty_cache()
    mark("predictor tta")
    valid_phase(build_valid, Predictor, CEDiceLoss, train_step, fused)
    torch.cuda.empty_cache()
    mark("valid")
    launches["predictor_add"] = merge_add_phase(
        build_add, Predictor, CEDiceLoss, train_step, fused)
    launches["train_add"], model, crit, opt, batches = train_phase(
        build_add, (BATCH, *PATCH, 1), "add", "MVox", CEDiceLoss,
        train_step, fused, plain=False)
    del model, opt, batches
    torch.cuda.empty_cache()
    mark("merge add")
    options_phase(build_option, CEDiceLoss, train_step, fused)
    torch.cuda.empty_cache()
    mark("options")
    launches.update(resunet_phase(ResUNet, UNet, Predictor, CEDiceLoss,
                                  train_step, fused, launches))
    torch.cuda.empty_cache()
    mark("resunet")
    launches.update(loss_zoo_phase(build3d, loss_mod, train_step, fused,
                                   Trainer))
    torch.cuda.empty_cache()
    mark("loss zoo")
    launches.update(multigpu_phase(UNet, Predictor, CEDiceLoss, Trainer,
                                   train_step, fused, smi))
    torch.cuda.empty_cache()
    mark("multi-GPU")
    launches.update(zoo_phase(Predictor, train_step, loss_mod, fused, smi))
    torch.cuda.empty_cache()
    mark("model zoo")
    launches["train_n2v"] = n2v_phase(UNet, fused, smi)
    torch.cuda.empty_cache()
    mark("noise2void")
    launches["train_multi"] = trainer_multi_phase(UNet, CEDiceLoss, fused,
                                                  smi)
    torch.cuda.empty_cache()
    mark("trainer multi")
    launches["train_triplet"] = triplet_phase(UNet, fused, smi)
    torch.cuda.empty_cache()
    mark("triplet")
    launches["gnn"] = gnn_phase(fused, smi)
    torch.cuda.empty_cache()
    mark("gnn")
    launches["train_config"] = config_phase(UNet, CEDiceLoss, fused, smi)
    torch.cuda.empty_cache()
    mark("config")
    launches["export"] = export_phase(UNet, Predictor, CEDiceLoss, Trainer,
                                      fused, smi)
    torch.cuda.empty_cache()
    mark("export")

    launches["predictor_2d"] = predictor_2d_phase(UNet, Predictor, fused)
    torch.cuda.empty_cache()
    launches["train_2d"], model, crit, opt, batches = train_phase(
        build2d, (BATCH, *IMAGE, 1), "2D", "MPix", CEDiceLoss, train_step,
        fused, rows=(16, 17, 19, 20))
    if profiling:
        profile_phase(train_step, model, crit, opt, batches)
    del model, opt, batches
    torch.cuda.empty_cache()
    trainer_phase(build2d, (1, 256, 256), "2D", CEDiceLoss, Trainer)
    mark("2D paths")

    odd_l1_phase(build3d, CEDiceLoss, fused)
    torch.cuda.empty_cache()
    launches["predictor_sf64"] = predictor_phase(build_sf64, "sf64",
                                                 Predictor, fused, (24,))
    torch.cuda.empty_cache()
    launches["train_sf64"], model, crit, opt, batches = train_phase(
        build_sf64, (BATCH, *PATCH, 1), "sf64", "MVox", CEDiceLoss,
        train_step, fused, rows=(24, 25))
    if profiling:
        profile_phase(train_step, model, crit, opt, batches)
    del model, opt, batches
    torch.cuda.empty_cache()
    trainer_phase(build_sf64, (1, *PATCH), "sf64", CEDiceLoss, Trainer)
    crossover_phase(UNet, Predictor, CEDiceLoss, train_step, unet_mod)
    mark("sf64 paths")

    launches["predictor_batchp"] = predictor_phase(
        build_batchp, "batchp", Predictor, fused, BATCHP_SERVE_ROWS,
        SERVING + ("bn_normalize",), pallas_bn)
    torch.cuda.empty_cache()
    launches["predictor_group"] = predictor_group_phase(
        build_group, build_instance, Predictor, fused)
    mark("predictor batchp, group")
    launches["train_group"] = group_train_phase(
        build_group, build_group_library, "group", CEDiceLoss, train_step,
        fused)
    mark("train group")
    launches["train_instance"] = group_train_phase(
        build_instance, None, "instance", CEDiceLoss, train_step, fused)
    mark("train instance")
    launches["train_batchp"], model, crit, opt, batches = train_phase(
        build_batchp, (BATCH, *PATCH, 1), "batchp", "MVox", CEDiceLoss,
        train_step, fused, BATCHP_TRAIN_ROWS, K1_K7 + BN_KERNELS, pallas_bn)
    if profiling:
        profile_phase(train_step, model, crit, opt, batches)
    del model, opt, batches
    torch.cuda.empty_cache()
    print("train batchp against batch in this run (kernels, plain, "
          "kernels again; ms): " + "; ".join(
              f"{k} {', '.join(f'{v:.2f}' for v in STEP_MS[k])}"
              for k in ("3D", "batchp")), flush=True)
    trainer_phase(build_batchp, (1, *PATCH), "batchp", CEDiceLoss, Trainer)
    launches["train_batchp_library"] = batchp_library_phase(
        build_batchp_library, CEDiceLoss, train_step, fused, pallas_bn,
        profiling)
    torch.cuda.empty_cache()
    mark("train batchp")

    launches["predictor_silu"] = predictor_phase(
        build_silu, "silu", Predictor, fused, FLAT_SERVE_ROWS,
        ("conv_bnact",), per_call={"conv_bnact": 3})
    torch.cuda.empty_cache()
    # The silu model's L0 conv1 and its upconvs are library convs, whose
    # bias gradient cuDNN sums from the bf16 dx of the flat batch norm
    # (rounded as in JAX): over L0's 2,725,888 voxels that leaves the
    # exactly-0 gradient of L0 conv1's bias (1 input channel, a small
    # weight gradient) at 6.96e-2 of the weight gradient's norm on the
    # kernel path and 6.97e-2 on the reference (an H100 at 700 W); the
    # biases of the K1 convs stay under the 1e-2 of the other phases.
    launches["train_silu"], model, crit, opt, batches = train_phase(
        build_silu, (BATCH, *PATCH, 1), "silu", "MVox", CEDiceLoss,
        train_step, fused, FLAT_TRAIN_ROWS, FLAT_KERNELS, zero_bf16=1e-1)
    want = {k: 3 * STEPS if k in FLAT_KERNELS else 0 for k in SOURCES}
    if launches["train_silu"] != want:
        raise AssertionError(f"silu training launches "
                             f"{launches['train_silu']}, expected {want}")
    if profiling:
        profile_phase(train_step, model, crit, opt, batches)
    del model, opt, batches
    torch.cuda.empty_cache()
    trainer_phase(build_silu, (1, *PATCH), "silu", CEDiceLoss, Trainer)
    launches["train_silu_library"] = silu_library_phase(
        build_silu_library, CEDiceLoss, train_step, fused)
    torch.cuda.empty_cache()
    mark("silu paths")

    vup_kernel_phase(vup, stats)
    launches["predictor_vup"] = predictor_phase(
        build_vup, "vup", Predictor, fused, VUP_SERVE_ROWS,
        SERVING + ("conv_vup",), per_call={"conv_bnact": 11, "conv1_fwd": 1,
                                           "pool_bnact": 3,
                                           "upconv_bnact": 2, "conv_vup": 1})
    check_vup_bodies(launches["predictor_vup"],
                     BODY_LAUNCHES["predictor_vup"], "vup serving")
    torch.cuda.empty_cache()
    launches["train_vup"], model, crit, opt, batches = train_phase(
        build_vup, (BATCH, *PATCH, 1), "vup", "MVox", CEDiceLoss, train_step,
        fused, VUP_TRAIN_ROWS, K1_K7 + VUP_KERNELS)
    # up_2's K3, K7 and its merge's K1, K4, K5 give way to the five vup
    # entries; every other launch as on the 'batch' headline step.
    per_step = {"conv_bnact": 7, "conv1_fwd": 1, "pool_bnact": 2,
                "upconv_bnact": 1,
                "conv_bnact_dgrad": 6, "conv_bnact_wgrad": 6, "conv1_bwd": 1,
                "pool_bnact_bwd": 2, "upconv_bnact_bwd": 1,
                **dict.fromkeys(VUP_KERNELS, 1)}
    want = {k: per_step.get(k, 0) * STEPS for k in SOURCES}
    if launches["train_vup"] != want:
        raise AssertionError(f"vup training launches {launches['train_vup']}"
                             f", expected {want}")
    check_vup_bodies(launches["train_vup"], BODY_LAUNCHES["train_vup"],
                     "vup training")
    if profiling:
        profile_phase(train_step, model, crit, opt, batches)
    del model, opt, batches
    torch.cuda.empty_cache()
    trainer_phase(build_vup, (1, *PATCH), "vup", CEDiceLoss, Trainer)
    vup_pair_phase(build_vup, CEDiceLoss, train_step, fused)
    mark("vup paths")

    launches.update(group_vup_phase(build_group_vup, Predictor, CEDiceLoss,
                                    train_step, fused))
    mark("group vup paths")
    launches["predictor_2d_group"] = predictor_2d_phase(
        UNet, Predictor, fused, normalization="group")
    torch.cuda.empty_cache()
    launches["train_2d_group"] = group_train_phase(
        build_2d_group, build_2d_group_library, "2D group", CEDiceLoss,
        train_step, fused, shape=(BATCH, *IMAGE, 1),
        rows=GROUP_2D_TRAIN_ROWS, unit="MPix", beside="2D")
    torch.cuda.empty_cache()
    mark("2D group paths")
    stray = {p: {k: n[k] for k in VUP_KERNELS if n[k]}
             for p, n in launches.items() if "vup" not in p}
    if any(stray.values()):
        raise AssertionError(f"vup entries launched off the vup paths: "
                             f"{stray}")
    print(f"phases (wall s, {sum(PHASE_S.values()):.1f} in all): "
          + "; ".join(f"{k} {v}" for k, v in PHASE_S.items()), flush=True)

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES[k][0],
         "replaces": SOURCES[k][1],
         "launches": sum(path[k] for path in launches.values()),
         "launches_by_path": {p: n[k] for p, n in launches.items()},
         "launches_by_body": {
             b: sum(n.get(ROW3 if k == "conv1_fwd" else (k, b), 0)
                    for n in BODY_LAUNCHES.values())
             for b in BODIES.get(k, ())},
         **stats.totals(k)} for k in SOURCES]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
