"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, in order; any mismatch or exception exits non-zero before the
final line:

1. card    — the GPU's name and power limit (nvidia-smi);
2. build   — ``nvcc`` builds every kernel source in
             ``src/repro_torch/kernels/csrc/`` (``event_scan``,
             ``event_select``, ``flash_attention``, ``admission`` — which
             holds ``fleet_feasibility`` and ``link_cost`` —, ``rmsnorm``,
             ``moe_gemm``), one process each, started together, and prints
             ``ptxas``'s registers, shared memory and spills of each kernel;
             then one ``rmsnorm`` call at each shape of phase 5c, f32 and
             bf16 with the scale in x's dtype, shown to run one device
             kernel (profiled here, before anything else is profiled);
3. fleet   — the event-time fleet simulator (``repro_torch.fleetsim.
             simulate``, seed 0, full mesh, campus pricing,
             ``batched_feasible``), whose CUDA path is one ``event_scan``
             launch per run:
             a. ``event_select`` against its plain PyTorch version on
                random fleets (K in {3, 6, 32}, W in {64, 512}) with
                head-pointer rows, ties and a priced network;
             b. for each main-path run, its first 250 events through the
                eager per-event loop on the card (``fleetsim.core.
                _simulate_eager``, ``event_scan``'s plain version): wall
                time per event, keeping every 75th ``event_select``
                input; then its first 25 events profiled (device busy,
                idle share, launches per event);
             c. the main path: ``paper/scenario1..3`` and the full
                16,000-request 32-node fleet, then ``paper/scenario1``,
                ``paper/scenario3`` and the 32-node fleet under the
                stochastic policies ``random`` and ``power_of_two`` (the
                kernel's threefry draws), each held against the JAX
                reference's aggregates, digests and floats in
                ``tests/data/torch_fleetsim_golden.json``, with exactly one
                ``event_scan`` and no ``event_select`` launch per run (the
                counts set to 0 before each run);
             d. ``event_scan`` against the eager loop on the CPU, on a hot
                3-node fleet under the four deterministic policies and the
                two stochastic ones, priced and not, and under the
                stochastic ones on a 2-node mesh, a 4-node star (degree 1)
                and a 32-node mesh with four hot nodes (degree 31): every
                per-request field and counter equal; the check is shown to
                reject a planted fault (one request's ``served_by``
                changed, one request's deadline moved);
             e. ``event_scan``'s time: each whole run in one launch, and
                each run's first 250 events beside the eager loop's time
                there, with the bound per event (the bytes of one step,
                the live blocks it scores counted by the kernel, at the
                HBM rate) beside the serial chain between events;
                each stochastic run's whole time; then ``event_select``
                against its plain version on the kept inputs (every (K, W)
                of the main path) and its time there beside the plain
                version's and the bound;
             f. the event heap, the main path's checker (host Python, its
                ``batched_feasible`` router scoring on the card, one
                ``fleet_feasibility`` launch a decision): the port's
                ``run_simulation`` against all 18 entries of
                ``tests/golden_simulator.json`` (the paper's Table II grid:
                every integer field equal, the mean response time within
                1e-9 relative); ``fleetsim.validate.run_validation`` on
                ``paper/scenario1..3`` under campus pricing, the fleet side
                one ``event_scan`` launch, ``batched_feasible`` and
                ``round_robin`` replayed directly and ``random`` and
                ``power_of_two`` by the heap's trace, each report the JAX
                reference's in the golden file (exact but in one cell,
                where the reference's f32 / f64 flips show in both
                packages); the check shown to reject a trace with one
                recorded forward target changed; each heap run's wall time
                beside its fleet run's; in each cell, the router's
                ``fleet_feasibility`` launches equal its decisions and
                ``torch_queue.feasible_nodes`` is never called; then every
                decision's verdicts (its packed inputs kept) against the
                plain version's on the card, every 16th against
                ``torch_queue.feasible_nodes``, the distribution of the
                ledger width ``cap``, and the kept decisions replayed in
                turns through the router's path (pack, one copy, one
                launch, one read) and through the form it had until PR 21
                (three numpy ledgers, their copies, ``feasible_nodes``'
                launches, a read): each whole and stage by stage, and one
                of each profiled;
             g. sweeps and telemetry: the 32-cell sweep of
                ``examples/fleet_sweep.py`` (``paper/scenario1``,
                ``random``, seeds 0-7 x ``sla_scale`` 0.5 / 0.8 / 1.0 /
                2.0) as one ``simulate_fn`` call, one ``event_scan``
                launch of 32 blocks, each cell its golden entry, timed
                against the same cells launched one by one (in turns):
                cells/s, requests/s, us per event; the 12-cell latency x
                bandwidth grid of ``examples/mobility_sweep.py`` in one
                launch, each cell its golden entry; telemetry on the main
                path (``paper/scenario1..3``, 32 buckets over the golden
                run's end time): counters and occupancy the JAX cube's,
                the integrals within ``DERIVED_ATOL``, every other output
                the telemetry-off run's and the golden digests, the check
                shown to reject a moved counter and a moved busy time,
                telemetry on against off per event (in turns); the paper
                sweep with telemetry, each cell's cube the JAX one;
                ``run_validation(telemetry=32)`` on ``paper/scenario1..3``
                under ``random``, each report and agreement the
                reference's, one Chrome trace written (``build/
                telemetry/``) and validated; the eager loop on the CPU
                against ``event_scan`` with telemetry on the hot fleet,
                six policies, priced and not;
             h. the other arrival processes and the 256-node fleet: the
                golden file's eight ``workloads`` runs (Poisson and
                diurnal arrivals, ``paper/scenario1`` through the static
                and the mobile campus radio, each under
                ``batched_feasible`` and ``random``), one ``event_scan``
                launch each, held to the reference's digests;
                ``paper/scenario1`` written by ``dump_trace`` and replayed
                by ``TraceWorkload`` (``build/traces/``), held to the
                ``paper/scenario1`` entry; the 256-node, 128,000-request
                fleet of ``benchmarks/fleetsim_bench.py`` (no network,
                capacity 1024, depth 512) under ``random``,
                ``least_loaded`` and ``batched_feasible``, one launch
                each, held to the reference's digests, then timed: us per
                event (CUDA events around one launch), ``simulate``'s
                wall, requests/s, the bytes bound, the live blocks scored
                a step, the ring's memory; the eager loop's first 250
                events of the ``batched_feasible`` run beside the
                kernel's; ``run_validation`` on the mobile radio workload
                under ``random``, its report the reference's;
4. vision  — the deadline-aware serving path with DeiT-B, ResNet-50 and
             ViT-H/14 at full width, then the diffusion serve step and the
             language models:
             a. ``flash_attention`` against its plain version on a random
                sweep (causal / window / GQA, S in {1, 63, 65, 127, 129,
                578, 730, 1024}, D in {32, 64, 72, 80, 128}, f32 and bf16:
                every variant of the wrapper, ``tma_wgmma`` with and
                without split keys at D = 64, 72, 80 and 128, ``mma_sync``
                at D = 32 and ``f32_regtile``), held to
                ``ref.flash_attention_tolerance``, a tolerance scaled to
                each case; and causal GQA at (1, 1100, 24 / 8, 64) with
                the window a language model without a sliding window
                passes (``transformer.NO_WINDOW``, 1 << 30), f32 and bf16,
                and at Granite's (1, 32768, 24 / 8, 64) in bf16, equal bit
                for bit to no window;
             b. DeiT-B logits (seeded weights, two seeded images at 224
                and 384 px, f32 and bf16) against the JAX reference's in
                ``tests/data/torch_vit_golden.json``, with 0 kernel
                launches at 224 px (198 tokens take the naive path) and
                12 at 384 px (578 tokens, one per layer);
             c. the main path: ``DeadlineAwareEngine`` over three bf16
                DeiT-B replicas serving the 64-frame campus surveillance
                stream of ``examples/serve_surveillance.py`` (4K and FHD
                frames at 384 px, HD at 224 px) with the preferential
                queue and with FIFO, first stepping eagerly, then through
                the graphed step (``launch.graphs.GraphedStep``, one CUDA
                graph per (class, batch size), every batch size captured
                before the runs); each run's decisions equal to the
                golden's; the eager runs' kernel launches (the wrapper's
                count, set to 0 before each run) and the graphed runs'
                (captured launches x replays, the replays set to 0 before
                each run; the wrapper's count stays 0) equal to 12 x the
                run's 384-px batches; a profiled replay of the 384-px
                batch of 8 shows 12 kernels on the device; the kernel's
                inputs of each batch size served are kept from the eager
                runs (no wrapper runs in a replay) and held against the
                plain version, elementwise and by rms error against the
                plain version in f32 (within ``RMS_RATIO``); each check
                is shown to reject a kernel that drops the last key (the
                rms one on the served inputs, the elementwise one on
                random inputs of the served shape at B=8); the graphed
                logits equal the eager step's bit for bit at every
                (class, batch size) served;
             d. the kernel's time at each batch size served and at B=8
                (S=578, 12 heads, D=64, bf16), with its variant, beside the
                plain version's, ``scaled_dot_product_attention``'s (the
                yardstick; the port never calls it), their ratio and the
                bound; the f32 kernel at B=1 and B=8 beside its plain
                version, SDPA in f32, their ratio and its bound at the
                f32 peak outside the tensor cores; ``tma_wgmma`` at heads
                80 wide (ViT-H/14's 16 at B=8, S=578 and 730) and 72
                wide (DiT-XL/2's 16 at B=8, S=1024), and the ``mma_sync``
                variant on a view of (8, 578, 16, 80) one element off
                16-byte alignment, each checked, then timed beside SDPA
                and its bound;
                where the device time of one eager 384-px batch of 8
                goes; the engine's measured step times per class and
                batch size (graph replays); eager against graphed step
                times at each class and batch size 1 and 8 (wall in
                turns; device busy and idle share, profiled); each
                graph's capture time and memory;
             e. ResNet-50 logits (f32 with TF32 off, and bf16; the two
                images at 224 and 384 px) against the reference's in the
                golden file's ``resnet`` section, within
                ``RESNET_LOGIT_ATOL`` (by dtype and side), which is shown
                to reject a forward whose max pool pads (1, 1) where XLA's
                SAME pads (0, 1), and in f32 one with cuDNN's TF32 on;
                each class's frame alone against the golden's within
                ``RESNET_FRAME_ATOL``; three bf16 ResNet-50 replicas
                serving the stream eagerly and graphed, decisions equal to
                the golden's, each frame's class the golden's where its
                top-1 margin exceeds that tolerance;
                graphed against eager logits, step times and captures as
                for DeiT-B;
             f. ViT-H/14 (``configs/vit_h14.py``: 32 layers, d 1280, 16
                heads 80 wide; seeded weights, 632 M parameters): logits
                (f32 and bf16, the two images at 224 px, 257 tokens, no
                launch, and 384 px, 730 tokens, 32 launches) against the
                golden file's ``vit_h14`` section within
                ``VIT_H14_LOGIT_ATOL`` and ``VIT_H14_LOGIT_RMS`` (by dtype
                and side), shown to reject the planted faults that reach
                each side (in f32 and bf16: the last layer skipped, a
                kernel that drops the ragged last key tile; in f32 also a
                kernel that drops the last key, scores scaled by 128^-0.5,
                the padded width's scale, and the pos-embed resized with
                its grid transposed); each class's frame alone within
                ``VIT_H14_FRAME_ATOL``; three bf16 replicas serving the
                stream eagerly and graphed as DeiT-B's (decisions, 32
                launches a 384-px batch, a profiled replay of the batch of
                8 showing 32 ``tma_wgmma`` kernels of width 80, the kept
                inputs against the plain version, graphed = eager bit for
                bit), each frame's class the golden's where its top-1
                margin exceeds the frame tolerance; the kernel's time at
                each batch size served and at (8, 730, 16, 80); where the
                device time of a 384-px batch of 8 goes; step times and
                captures as for DeiT-B;
             g. the diffusion serve step: DiT-XL/2 (28 layers, d 1152,
                16 heads 72 wide, 675 M parameters) and the SD 1.5 UNet
                (785 M), built on the host from seeded numpy weights with
                every leaf random (the golden's ``constant_std``), held
                (f32 with TF32 off, and bf16; the UNet f32 alone) against
                the JAX reference's outputs in
                ``tests/data/torch_diffusion_golden.npz`` within
                ``DIT_ATOL`` / ``DIT_RMS`` and ``UNET_ATOL`` /
                ``UNET_RMS`` (DiT at 256 px, no launch, and 512 px, 28
                launches; the UNet at latent 64), each limit shown to
                reject the planted faults of ``dit_faults`` /
                ``unet_faults`` its dtype must; then DiT's main path: one
                bf16 step (``attn_impl="pallas"``) at each of
                ``DIFFUSION_SHAPES``' ``gen_fast`` (B=16, 512 px) and
                ``gen_1024`` (B=4, 1024 px) with the launch count from 0,
                28 a step, each held against the plain ``chunked`` step
                within ``DIT_STEP_REL_RMS``; each DiT step and the UNet's
                ``gen_fast`` step timed (CUDA events, best of 3) and
                profiled (device busy, idle share, device time by kind:
                matrix products, flash, other; 28 ``tma_wgmma`` kernels of
                width 72 on the device a DiT step), the UNet's
                ``gen_1024`` step run and checked, not timed; the kernel's
                inputs from each DiT shape
                against its plain version (elementwise and by rms error);
                the kernel at (16, 1024, 16, 72) and (4, 4096, 16, 72)
                beside its plain version, SDPA and the bound;
             h. the language models (their launch counts of ``rmsnorm``
                and ``moe_gemm`` checked 0 first, as in 5 below):
                Granite-3.0 MoE at full width with 2 of its 32 layers,
                seeded numpy weights with every leaf random, f32 (TF32
                off) and bf16, ``attn_impl="pallas"``: a prefill of two
                1,100-token prompts (one flash launch a layer, 2L + 1
                ``rmsnorm``, 3L ``moe_gemm``) and 4 decode steps (no flash),
                held against ``tests/data/torch_lm_golden.npz`` (the last
                logits, each step's logits, the aux loss, layer 0's K / V
                rows at 3 positions) within ``GRANITE_ATOL`` /
                ``GRANITE_RMS``, each limit shown to reject the planted
                faults of ``granite_faults``; the bf16 routing flips
                against the reference's; the four SMOKE LMs in f32 within
                ``LM_SMOKE_ATOL`` (gemma3-smoke's ring-buffer decode past
                its window included); then the main path, Granite at full
                width and depth (3.98 B parameters drawn on the card from
                a seeded ``torch.Generator``), bf16: a prefill of 32,768
                tokens (exactly 32 flash, 65 ``rmsnorm`` and 96
                ``moe_gemm`` launches, the counts from 0), 32 greedy decode
                steps on its cache and ``decode_32k``'s 8 steps at B=16 on
                a 32,768-slot cache at length 16,384 (65 and 96 launches a
                step, no flash); finite logits throughout; the kernel
                prefill at 4,096 tokens against the plain one routed alike
                within ``LM_PREFILL_REL_RMS``; the prefill and each decode
                step timed (CUDA events) and profiled (busy, idle, device
                time by kind: flash, ``moe_gemm``, ``rmsnorm``, other
                matrix products, other); flash on layers 0 and 31 at 32k
                (by blocks of query rows), ``rmsnorm`` on the prefill's
                and both decodes' rows and ``moe_gemm`` at C = 6,826, 1
                and 4, each on its main-path input, against the plain
                version, then timed beside it, SDPA (causal) /
                ``F.rms_norm`` / ``torch.bmm`` and the bound; flash's layer
                0 input also timed without the mask, the causal launch
                held within ``LM_CAUSAL_SHARE`` of it (the key band skips
                the tiles past the diagonal); then ``LM_FLASH_SHAPES``, the
                heads item 8d's models give the kernel at 32k on random
                inputs, StarCoder2-7B's causal (36 / 4, D = 128) and
                Gemma-3 27B's local layers (32 / 16, D = 128, window
                1,024), each against the plain version by blocks, timed
                beside SDPA (under the window the faster of its cuDNN and
                memory-efficient backends on a (S, S) bool mask) and the
                bound, the windowed
                launch held within ``LM_WINDOW_SHARE`` of the causal one;
                each flash row's key tiles walked and TFLOP/s on them
                printed as modelled from ``key_tile_band``;
             i. distribution, on an NCCL group of one rank made from an
                in-memory store (no network) and the 1 x 1 (data, model)
                mesh over it (``launch.mesh.make_host_mesh``), with
                ``install_rules`` (so each MoE layer of a
                ``moe_impl="shard_map"`` config runs
                ``moe.moe_ffn_sharded`` under ``local_map``:
                ``_local_dispatch_ffn``'s three ``moe_gemm`` launches, the
                FSDP all-gathers and one all-reduce over 'model'):
                Granite-3.0 MoE at 2 of its 32 layers, f32 (TF32 off) and
                bf16, against the golden's ``granite_mesh`` section (the
                reference's jitted prefill, logits at 3 positions and aux
                loss under its own one-device mesh) within
                ``GRANITE_ATOL`` / ``GRANITE_RMS``, the launches and the
                branch's calls counted, no copy routed to a padded expert
                (ids 40-47), the bf16 routing flips printed, and the
                unmeshed ``moe_ffn`` in the sharded path's place rejected
                in both dtypes; then phase 4h's weights at full width and
                depth and its 32,768-token prompt through the mesh branch
                (32 flash, 65 ``rmsnorm``, 96 ``moe_gemm`` launches, 32
                ``moe_ffn_sharded`` calls and all-reduces, the counts from
                0; no padded expert routed), layer 0's gate and down
                ``moe_gemm`` inputs at the mesh's capacity (8,192, from the
                40 real experts) kept and held against the plain version
                (``tma_wgmma`` required) and timed, the prefill timed with
                CUDA events beside 4h's unmeshed one, its last logits'
                distance from 4h's printed (they route differently by
                design), and the meshed kernel prefill at S = 4,096 held to
                the meshed plain one (plain ``rmsnorm`` and ``moe_gemm``,
                chunked attention, routed as the kernel one) within
                ``LM_PREFILL_REL_RMS``, as 4h holds the unmeshed; and a DeiT-B
                checkpoint (full width, ``training/checkpoint.py``)
                restored and placed on the mesh by
                ``training.elastic.replace_mesh``: equal bit for bit;
5. entry points — the kernels that ``repro_torch.kernels.ops`` exposes
             (their launch counts, set to 0 before phase 3, are 0 after
             phase 4g but for ``fleet_feasibility``'s, which must equal
             the heap router's decisions in phase 3f):
             a. ``fleet_feasibility`` and ``link_cost`` against their plain
                versions on random head-pointer fleets (K in {1, 5, 12, 32,
                256}, N in {8, 64, 1000, 1024, 20000}: rows off 16-byte
                alignment and rows longer than one staged chunk) with full
                and empty rows,
                deadlines on block edges and a priced network: bit for bit,
                ``load`` within ``ref.load_rtol`` where sizes are not
                dyadic, and always the kernels' association of the sum
                (``ref.lane_tree_sum``) bit for bit;
             b. on every ``event_select`` input kept in phase 3b, the
                selected event scored by ``link_cost`` from its node's
                network row equals ``event_select``'s feasible, arrive and
                load, and ``fleet_feasibility`` from max(arrive, busy) its
                feasible and load, bit for bit;
             c. ``rmsnorm`` at (4096, 5376) (Gemma-3 27B), (4096, 1536)
                (Granite-3.0 MoE) and (7, 7168) (Kimi-K2), f32 and bf16, and
                a misaligned view, held to ``ref.rmsnorm_tolerance``, which
                is shown to reject a row normalised without its last column;
             d. ``moe_gemm`` at the Granite-3.0 MoE gate/up (40, 1024, 1536)
                x (40, 1536, 512) and down (40, 1024, 512) x (40, 512, 1536)
                products, a ragged C = 1000, f = 504 one (``tma_wgmma``) and
                a ragged C = 1000, f = 500 one (``mma_sync``), bf16 and
                f32, each with the variant the wrapper chose, against the
                plain version with TF32 off, held to
                ``ref.moe_gemm_tolerance``, which is shown to reject an
                output without the last 16 of d;
             e. the entry points driven once at those full-width shapes with
                the four launch counts set to 0 (each must launch), their
                outputs held against the plain versions; then each kernel's
                time beside its plain version's, the one PyTorch call that
                computes the same function where there is one
                (``F.rms_norm``, ``torch.bmm``; timed only, never called by
                the port), the ratio of the two and the bound; the
                admission kernels also at each (K, cap) of the heap
                router's decisions, on one of its decisions, and each
                beside an empty kernel's launch at K blocks (the launch
                floor, in turns) and the share of the bound reached;
                ``rmsnorm``
                and ``F.rms_norm`` twice, warm (the same input every call,
                as L2 keeps it) and with L2 cold (each call on the next of
                as many input copies as exceed the 50 MB L2 twice over,
                rotated inside the graph), each pair timed in turns
                (kernel, library, library, kernel; the better of two each);
6. train    — training (``repro_torch.training``, ``launch.train``):
             a. the ``rmsnorm`` backward kernel (``rmsnorm_bwd``, one
                cooperative launch) against its plain version
                (``ref.rmsnorm_bwd_ref``) at (8192, 1536), (4096, 1536)
                (Granite's rows at B = 2 / 1), (7, 7168) and (1000, 1023),
                f32 and bf16, bit-equal over two launches, held to
                ``ref.rmsnorm_bwd_tolerance``, shown to reject a dscale
                without its last row and a dscale of 0; ``ops.moe_gemm``'s
                gradients (dx = moe_gemm(dy, w^T), dW = moe_gemm(x^T, dy)
                with C padded to a multiple of 8) against autograd of the
                plain version at Granite's expert products with C = 853 and
                1,706, bf16 and f32, each product's variant printed, the dW
                check shown to reject a dW without the last 8 rows of C;
                each timed beside its plain version, the library call
                (``F.rms_norm``'s autograd backward, ``torch.bmm``) and the
                bound; the embedding's backward (``common.row_order_sum``,
                the reference's row-order bf16 sum) at Granite's B = 2 x
                4,096 and the golden's 1,100 tokens on ``SyntheticSource``'s
                8 token ids, equal to the CPU's bit for bit, timed beside
                ``F.embedding``'s backward (f32 sums) and its distance;
             b. the diffusion losses' noise (``models.prng``: ``t`` and
                ``eps`` at DiT-XL/2's train_256 shapes) on the card equal
                to the CPU's bit for bit, timed; the golden train steps of
                ``tests/data/torch_train_golden.npz`` (Granite-3.0 MoE at
                full width, depth 2, 1,100 tokens, f32 and bf16; DeiT-B at
                full width, depth 2, B = 2; DiT-XL/2 at full width, depth
                2, B = 2 at 256 px, and the SD 1.5 UNet at full width with
                one ResBlock a level, B = 1 at latent 16, f32 and bf16; the
                smoke DeiT, ResNet, Granite, DiT and UNet over 3 steps)
                within ``tests/train_golden.py``'s limits (the bf16
                embedding gradient under the general one), with six planted
                faults (no dscale, a wrapper without autograd, the aux term
                dropped, no bias correction, a misordered loss remainder,
                an embedding backward that overwrites rows) each rejected,
                the last against the bf16 section too, and the six of
                ``train_golden.DIFFUSION_FAULTS`` (noise keys swapped,
                ``torch.randn`` noise, ``alphas[t + 1]``, DiT's loss on the
                sigma half, the UNet's context ignored, DiT without remat
                and a changed layer body) on their f32 sections; the
                embedding's share of its limit with ``F.embedding``'s f32
                sums beside the port's;
             c. the main paths through ``launch.train``'s ``run``:
                Granite-3.0 MoE at full width and depth (bf16 weights, f32
                moments, remat) on ``train_4k``'s 4,096-token sequences
                with the global batch cut 256 -> 2, one warm step, two
                timed (ms a step, tokens/s, peak memory), each kernel's
                launches a step as the counters saw them (set to 0 before
                the run), every leaf changed; DeiT-B ``cls_224`` at its
                full batch of 256, 2 steps against 1 step, a checkpoint,
                and a fresh run resumed to 2: equal bit for bit; DiT-XL/2
                ``train_256`` at full width, depth and batch (28 layers,
                B = 256 x 256 tokens, remat) and the SD 1.5 UNet at full
                width and depth at 256 px with the batch cut 256 ->
                ``UNET_TRAIN_BATCH``: a warm step, a profiled one (device
                busy, idle share, kernels a step, device time by kind:
                matrix products, softmax, other; DiT's attention timed
                alone), two timed (ms a step, images/s), the peak memory,
                every leaf reached by a gradient, no repo kernel launched;
                DiT-XL/2 at full width and batch with its depth cut to 2,
                2 steps against 1, a checkpoint and a fresh run resumed to
                2: equal bit for bit;
             d. the roofline of the card's own steps: one bf16 matmul at
                8192^3 and one 2 GiB copy beside the roofline's peaks
                (``launch.roofline.PEAK_FLOPS`` / ``HBM_BW``; above 1.05 of
                either fails); each run of ``ROOFLINE_RUNS`` (Granite's
                32k prefill at B=1, DiT-XL/2's gen_fast and gen_1024, the
                UNet's gen_fast, DiT-XL/2 and the UNet at train_256, Granite
                at train_4k), counted unmeshed on fake CUDA tensors by the
                dry run's cost model in a process of its own started
                before phase 4g at a lower priority (``--count-runs``), beside its measured time: the
                roofline share max(t_compute, t_memory) / measured (above
                1.05 fails: the count would be wrong) and the useful share
                model FLOPs / (PEAK_FLOPS x measured); ``python -m
                repro_torch.launch.dryrun --arch granite-moe-3b-a800m
                --shape prefill_32k --mesh both`` in another, held to
                ``tests/data/torch_dryrun_golden.json``'s model FLOPs and
                argument bytes; the host cost a ``torch.library``
                operator adds to a kernel call, with Granite's decode step
                at B=1 beside its time before the operators;
7. the ``{"kernels": [...]}`` line (one entry a kernel; ``flash_attention``
   one a variant: ``tma_wgmma`` at D = 64 (DeiT-B and Granite's prefill,
   phase 4h), 80 (ViT-H/14) and 72 (DiT-XL/2's steps, phase 4g), each
   with its main-path launches, and at D = 128 (phase 4h's StarCoder2-7B
   and Gemma-3 27B shapes), ``mma_sync`` and ``f32_regtile``, which no
   served path launches; ``fleet_feasibility`` with its path,
   the heap router, and that path's launches; ``rmsnorm`` and
   ``moe_gemm`` with theirs, the LM's (phase 4h and the meshed prefill of
   4i) and the train step's, their launches and their shapes' times; ``rmsnorm_backward`` with the train
   step's), then the ``{"ok": true, ...}`` line.

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
import gc
import hashlib
import itertools
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_fleetsim_golden.json")
VIT_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_vit_golden.json")
DIFFUSION_GOLDEN = os.path.join(ROOT, "tests", "data",
                                "torch_diffusion_golden.npz")
LM_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_lm_golden.npz")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import telemetry as tel  # noqa: E402
from repro_torch.core import torch_queue as tq  # noqa: E402
from repro_torch.configs import deit_b, resnet50, vit_h14  # noqa: E402
from repro_torch.configs import dit_xl2, unet_sd15  # noqa: E402
from repro_torch.configs import granite_moe_3b_a800m  # noqa: E402
from repro_torch.configs import get_smoke_config as get_lm_smoke  # noqa: E402
from repro_torch.configs.shapes import DIFFUSION_SHAPES  # noqa: E402
from repro_torch.configs.shapes import LM_SHAPES  # noqa: E402
from repro_torch.core.simulator import SimConfig, run_simulation  # noqa: E402
from repro_torch.fleetsim import core as fleet_core  # noqa: E402
from repro_torch.fleetsim import (NetParams, SimParams,  # noqa: E402
                                  simulate, simulate_fn, topology_arrays)
from repro_torch.fleetsim import validate  # noqa: E402
from repro_torch.kernels import admission as ad_mod  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import event_scan as scan_mod  # noqa: E402
from repro_torch.kernels import event_select as es_mod  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import moe_gemm as mg_mod  # noqa: E402
from repro_torch.kernels import rmsnorm as rn_mod  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import common as model_common  # noqa: E402
from repro_torch.models import diffusion, dit, resnet, unet, vit  # noqa: E402
from repro_torch.models import moe as lm_moe  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.core.scenarios import SCENARIOS  # noqa: E402
from repro_torch.orchestration import router as router_mod  # noqa: E402,E501
from repro_torch.netsim import (LinkModel, RadioModel,  # noqa: E402
                                RadioWorkload)
from repro_torch.orchestration import (DiurnalWorkload,  # noqa: E402
                                       PoissonWorkload, Topology,
                                       TraceWorkload, UniformWorkload,
                                       dump_trace, fleet_workload,
                                       get_workload)
from repro_torch.serving import measure_step_times  # noqa: E402

BIG = 1e30
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12           # H100 SXM dense bf16 tensor-core peak
F32_FLOP_PER_S = 67e12             # H100 SXM f32 outside the tensor cores
NAMES = ("take_fresh", "t", "node", "feasible", "arrive", "j", "cap", "load")
CSRC = "src/repro_torch/kernels/csrc/"
KERNELS = {           # name: (source, the TPU kernel it replaces)
    "event_scan": (CSRC + "event_scan.cu",
                   "src/repro/kernels/event_select.py:43"),
    "event_select": (CSRC + "event_select.cu",
                     "src/repro/kernels/event_select.py:43"),
    "flash_attention": (CSRC + "flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:32"),
    "fleet_feasibility": (CSRC + "admission.cu",
                          "src/repro/kernels/fleet_feasibility.py:39"),
    "link_cost": (CSRC + "admission.cu", "src/repro/kernels/link_cost.py:40"),
    "rmsnorm": (CSRC + "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:16"),
    "moe_gemm": (CSRC + "moe_gemm.cu", "src/repro/kernels/moe_gemm.py:18"),
    # the port's backward of the rmsnorm kernel (the reference has none)
    "rmsnorm_backward": (CSRC + "rmsnorm.cu",
                         "src/repro/kernels/rmsnorm.py:16"),
}
SOURCES = sorted({os.path.basename(src)[:-3] for src, _ in KERNELS.values()})
# On the served inputs attention is near uniform over 578 keys, so one key
# moves an output by less than a bf16 unit and no elementwise tolerance
# sees a dropped key there.  The rms error against the plain version in
# f32 does: the kernel's must stay within this multiple of the plain bf16
# version's (both are dominated by rounding the output to bf16; on an H100
# they agree to 4 digits), and the plain version without the last key
# must exceed it (17% above on an H100).
RMS_RATIO = 1.05
# DeiT-B logits against the JAX reference (|logit| <= 3.4 here).  f32
# with TF32 off: only the summation order differs (2.4e-6 on the CPU).
# bf16 keeps 8 significant bits and the card rounds at other places than
# XLA on the CPU (cuBLAS's GEMMs, the kernel's unnormalised p): the port
# on the CPU is 0.025 from the reference, and 0.1 leaves 4x that margin
LOGIT_ATOL = {"float32": 1e-4, "bfloat16": 0.1}
# ResNet-50 logits against the JAX reference (|logit| <= 3.8 here), by
# dtype and side.  The random-init network amplifies a rounding
# difference some 500-fold through its 16 blocks of BatchNorm on batch
# statistics.  f32 with TF32 off: 5.9e-5 / 3.7e-5 at 224 / 384 px on an
# H100 (6.5e-5 / 3.1e-5 for the port on the CPU), held at 3e-4.  bf16,
# where a conv output rounds to the other neighbour wherever its f32
# sum's order moves it across a rounding boundary: 0.342 / 0.217 on an
# H100 (0.365 / 0.205 on the CPU), held at 0.45 / 0.3.  Two planted
# faults must fail at every dtype and side where they apply: the max pool
# padded (1, 1) (0.625 / 0.427 in f32, 0.538 / 0.390 in bf16 on an H100)
# and, in f32, cuDNN's TF32.
RESNET_LOGIT_ATOL = {("float32", 224): 3e-4, ("float32", 384): 3e-4,
                     ("bfloat16", 224): 0.45, ("bfloat16", 384): 0.3}
# each surveillance class's frame alone, bf16, against the golden's:
# 0.187 / 0.117 at 224 / 384 px on an H100.  A class's served frames are
# held to its golden class where the golden's top-1 / top-2 margin (0.39
# / 0.30) exceeds this tolerance.
RESNET_FRAME_ATOL = 0.25
# ViT-H/14 logits against the JAX reference, by dtype and side (224 px: 257
# tokens, the naive path; 384 px: 730 tokens, the kernel in every layer),
# held by the largest error and by the rms error.  f32 with TF32 off: max
# 3.1e-6 / 4.3e-6, rms 9.3e-7 / 1.3e-6 on an H100, held at 1e-5 / 3e-6.
# bf16: max 0.0415 / 0.0409, rms 0.0131 / 0.0114 on an H100, held at 0.06
# and at rms 0.0145 / 0.0128.  The rms against the reference's bf16 logits
# is the sharper measure there: both round the same bf16 weights, so that
# share of the rounding cancels (against the reference's f32 logits the
# port's bf16 ones are rms 0.0126 / 0.0123 off, as the reference's own bf16
# ones are 0.0127 / 0.0125).  The limits must reject the planted faults of
# ``h14_faults`` that their dtype and side name (on an H100: in f32 the
# smallest, a pos-embed with its grid transposed, is max 2.0e-5, rms
# 4.4e-6; in bf16 the ragged last key tile dropped is rms 0.0143).
VIT_H14_LOGIT_ATOL = {("float32", 224): 1e-5, ("float32", 384): 1e-5,
                      ("bfloat16", 224): 0.06, ("bfloat16", 384): 0.06}
VIT_H14_LOGIT_RMS = {("float32", 224): 3e-6, ("float32", 384): 3e-6,
                     ("bfloat16", 224): 0.0145, ("bfloat16", 384): 0.0128}
# each surveillance class's frame alone, bf16, against the golden's:
# 0.0404 / 0.0487 at 224 / 384 px on an H100.  A class's served frames
# are held to its golden class where the golden's top-1 / top-2 margin
# (0.200 / 0.144) exceeds this tolerance.
VIT_H14_FRAME_ATOL = 0.07
# the eager loop's segment of each main-path run, how often it keeps an
# event_select input there, and how much of it is profiled (cut from 500,
# 150, 100 in PR 25 for the time budget: the profiler took ~0.1 s an event
# to digest, ~40 of phase 3b's 57 s; the kept inputs are as many)
SEGMENT_EVENTS, FLEET_CAPTURE_EVERY, PROFILED_EVENTS = 250, 75, 25
# the forwarding policies that draw from threefry (the golden file's runs
# that name one of them)
STOCHASTIC = ("random", "power_of_two")
# profiler windows that recorded no device entry, tried again (profiled)
PROFILE_TRIES = 3
# The diffusion serve step against the JAX reference's outputs in
# tests/data/torch_diffusion_golden.npz (full width and depth, batch 2,
# every weight leaf random: make_torch_diffusion_golden.CONSTANT_STD), by
# (dtype, side): DiT-XL/2 at 256 px (256 tokens, the naive path) and 512 px
# (1,024 tokens, the flash kernel in each layer), the UNet at its latent 64;
# outputs of rms ~0.70.  Held by the largest error and by the rms error.
# f32 with TF32 off: DiT max 1.0e-5 / 1.1e-5, rms 1.7e-6 at 256 / 512 px,
# the UNet max 1.8e-5, rms 3.5e-6 on an H100; held at 5e-5 / rms 5e-6 and
# 1e-4 / rms 1.5e-5.  bf16: DiT max 0.027 / 0.031, rms 0.0063, held at
# 0.08 / rms 0.015 (the UNet's bf16 golden is cut for the time budget).
# Every planted fault of dit_faults / unet_faults must fail f32 (on an
# H100 the smallest are DiT's transposed pos-embed, max 2.3e-3, rms
# 4.1e-4, and the UNet's GroupNorm eps, max 4.3e-3, rms 7.7e-4); bf16 must
# reject those that move the output past its own rounding (DiT's smallest
# there, the last layer skipped, is max 0.203 / 0.266, rms 0.037).  bf16
# cannot see DiT's transposed pos-embed (rms 0.0063, as sound): f32 holds
# it.
DIT_ATOL = {("float32", 256): 5e-5, ("float32", 512): 5e-5,
            ("bfloat16", 256): 0.08, ("bfloat16", 512): 0.08}
DIT_RMS = {("float32", 256): 5e-6, ("float32", 512): 5e-6,
           ("bfloat16", 256): 0.015, ("bfloat16", 512): 0.015}
UNET_ATOL, UNET_RMS = 1e-4, 1.5e-5          # f32 alone (the bf16 golden cut)
# DiT-XL/2's bf16 serve step through the flash kernel against the port's
# plain path (attn_impl "chunked") on the same inputs and weights, at
# gen_fast and gen_1024: the rms of the difference over the rms of the
# plain step's output (0.0063 / 0.0062 on an H100)
DIT_STEP_REL_RMS = 0.015


def fleet256(spec) -> bool:
    """A golden run of the 256-node fleet (phase 3h's)."""
    return spec["workload"].get("fleet") == 256


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


# The seeded numpy weight trees of phases 4 to 4i, drawn on a thread of
# their own while phase 3 runs: numpy's normal fill releases the GIL, so
# the draws (ViT-H/14 13.1 s, DiT-XL/2 and the UNet 29.0 s, the LM
# golden's Granite 7.7 s when each was drawn in its phase) leave the
# path.  Each tree has its own seeded stream: the values are the ones a
# draw in place gives.
TREE_DRAWS: dict = {}


def start_tree_draws(pool) -> None:
    """Submit the later phases' weight draws to ``pool``, in the order the
    phases take them (:func:`host_tree`)."""
    with open(VIT_GOLDEN) as f:
        vseed = json.load(f)["vit_h14"]["weight_seed"]
    with np.load(DIFFUSION_GOLDEN) as f:
        dmeta = json.loads(str(f["meta"]))
    with np.load(LM_GOLDEN) as f:
        lmeta = json.loads(str(f["meta"]))
    draws = [(vit.numpy_params, vit_h14.CONFIG, vseed)] + [
        (mod.numpy_params, cfg, dmeta["weight_seed"], dmeta["constant_std"])
        for mod, cfg in ((dit, dit_xl2.CONFIG), (unet, unet_sd15.CONFIG))] + [
        (golden_tree, granite_golden_config(lmeta["sections"]["granite"]),
         lmeta["weight_seed"], lmeta["constant_std"])]
    for fn, *args in draws:
        TREE_DRAWS[(fn, *args)] = pool.submit(fn, *args)


def host_tree(fn, *args):
    """``fn(*args)``, a seeded numpy weight tree: the one drawn by
    :func:`start_tree_draws` for the same call where there is one."""
    fut = TREE_DRAWS.pop((fn, *args), None)
    return fn(*args) if fut is None else fut.result()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def workload_of(spec):
    """The port's workload of a golden entry: a registered scenario, a
    fleet of ``fleet_workload``, or one the entry describes whole (a
    Poisson or diurnal process over a paper scenario's counts, a scenario
    through the radio model priced by a link profile)."""
    w = spec["workload"]
    if "registry" in w:
        return get_workload(w["registry"])
    if "fleet" in w:
        return fleet_workload(w["fleet"], w["div"])
    if w["kind"] == "poisson":
        return PoissonWorkload.from_counts(SCENARIOS[w["scenario"]],
                                           horizon=w["horizon"])
    if w["kind"] == "diurnal":
        return DiurnalWorkload(SCENARIOS[w["scenario"]], window=w["window"],
                               peaks=w["peaks"], amplitude=w["amplitude"])
    base = get_workload(w["base"])
    link = LinkModel.preset(Topology.full_mesh(base.n_nodes), w["link"])
    radio = RadioModel.from_link(link)
    if "mobility" in w:
        radio = radio.with_random_mobility(**w["mobility"])
    return RadioWorkload(base, radio, link=link)


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.cpu().numpy().astype(np.int32).tobytes()
                          ).hexdigest()


def timed_ms(fn, reps: int) -> float:
    """Device time per call: CUDA events around ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_ms(fn, reps: int) -> float:
    """Device time per call with the launch overhead taken out: ``reps``
    calls captured into one CUDA graph, replayed under CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                    # warm-up outside capture
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    g.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


L2_BYTES = 50e6                    # H100 SXM L2 cache


def cold_ms(fn, inputs) -> float:
    """Device time per call with L2 cold for the inputs: one call on each
    of as many copies of ``inputs`` as exceed twice the L2, captured in
    one CUDA graph in turn, replayed under CUDA events (each call finds
    its copy evicted by the others')."""
    nbytes = sum(t.numel() * t.element_size() for t in inputs)
    n = max(2, -(-int(2 * L2_BYTES) // nbytes))
    copies = [tuple(t.clone() for t in inputs) for _ in range(n)]
    order = itertools.cycle(copies)
    ms = graph_ms(lambda: fn(*next(order)), n)
    del copies
    return ms


def in_turns(time_a, time_b):
    """Two timings compared in turns, a, b, b, a, each the better of its
    two: the first timing after other work can find L2 and the clocks in
    another state, which at a few microseconds a call shows."""
    a1, b1, b2, a2 = time_a(), time_b(), time_b(), time_a()
    return min(a1, a2), min(b1, b2)


class Spy:
    """Wraps a function of ``module`` (a kernel entry point, a phase of a
    run) while a path runs, keeps clones of the arguments that
    ``keep(call_index, args)`` picks and sums the wall time of the calls
    (a device time only where the function reads its result back, as
    ``simulate`` reads the kernel's counts); the real function (and its
    launch counter) runs unchanged."""

    def __init__(self, module, name: str, keep=lambda i, args: False):
        self.module, self.name, self.keep = module, name, keep
        self.real = getattr(module, name)
        self.calls, self.kept, self.seconds = 0, [], 0.0
        self.last = None                       # the last call's result

    def __call__(self, *args, **kw):
        if self.keep(self.calls, args):
            self.kept.append((tuple(a.clone() if torch.is_tensor(a) else a
                                    for a in args), dict(kw)))
        self.calls += 1
        t0 = time.time()
        out = self.real(*args, **kw)
        self.seconds += time.time() - t0
        self.last = out
        return out

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


# ---------------------------------------------------------------------------
# phase 3: the fleet simulator and event_select
# ---------------------------------------------------------------------------
def random_args(rng, K, W, speeds, dev, tie=False):
    """A random head-pointer fleet window and two candidate events, as
    ``ops.event_select`` takes them.  Times sit on a 0.5 grid so that
    deadlines land exactly on block edges (the ``<`` ties)."""
    starts = np.full((K, W), BIG, np.float32)
    ends = np.full((K, W), BIG, np.float32)
    sizes = np.zeros((K, W), np.float32)
    head = np.zeros(K, np.int32)
    n = np.zeros(K, np.int32)
    edges = []
    for k in range(K):
        h = int(rng.integers(0, W // 4 + 1))
        nk = W - h if rng.random() < 0.15 else int(rng.integers(0, W - h + 1))
        head[k], n[k] = h, nk
        starts[k, :h] = ends[k, :h] = -BIG
        tcur = float(rng.integers(0, 400)) / 2
        for i in range(h, h + nk):
            gap = 0.0 if rng.random() < 0.6 else float(rng.integers(1, 100)) / 2
            size = np.float32(rng.choice([20.0, 44.0, 180.0]) / speeds[k])
            s = np.float32(tcur + gap)
            starts[k, i], ends[k, i], sizes[k, i] = s, s + size, size
            tcur = float(s + size)
            edges.append(float(starts[k, i]))
    busy = (rng.integers(0, 400, K) / 2).astype(np.float32)
    lat = rng.uniform(0, 120, (K, K)).astype(np.float32)
    ibw = rng.choice([0.0, 0.1, 0.8, 1.0], (K, K)).astype(np.float32)
    np.fill_diagonal(lat, 0.0)
    np.fill_diagonal(ibw, 0.0)

    def deadline():
        if edges and rng.random() < 0.5:
            return float(rng.choice(edges))          # a tie with a block
        return float(rng.integers(0, 20000)) / 2

    t_a = float(rng.integers(0, 800)) / 2
    t_b = t_a if tie else float(rng.integers(0, 800)) / 2
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    i = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)
    b = lambda x: torch.tensor(x, dtype=torch.bool, device=dev)
    pays = [0.9216, 2.7648, 6.2208, 24.8832]
    return (f(t_a), i(int(rng.integers(K))), f(deadline()), f(44.0),
            f(float(rng.choice(pays))), b(bool(rng.random() < 0.85)),
            f(t_b), i(int(rng.integers(K))), f(deadline()), f(20.0),
            f(float(rng.choice(pays))), b(bool(rng.random() < 0.85)),
            *(torch.from_numpy(a).to(dev) for a in
              (starts, ends, sizes, n, head)),
            torch.tensor(speeds, dtype=torch.float32, device=dev),
            *(torch.from_numpy(a).to(dev) for a in (busy, lat, ibw)))


OUTPUTS = {"event_select": NAMES,
           "fleet_feasibility": ("feasible", "load"),
           "link_cost": ("feasible", "arrive", "load")}


def check_exact(kernel, args, exact_load=True) -> float:
    """``ops.<kernel>`` (the kernel) vs ``ref.<kernel>_ref`` on one input;
    returns the max abs error over the float outputs.  Every output must
    match bit for bit, ``load`` too when the sizes are dyadic, else within
    ``ref.load_rtol``; ``load`` must also be the kernels' association of the
    sum (``ref.lane_tree_sum``) bit for bit."""
    got = getattr(ops, kernel)(*args)
    want = getattr(ref, kernel + "_ref")(*args)
    torch.cuda.synchronize()
    err = 0.0
    for name, g, w in zip(OUTPUTS[kernel], got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            fail(f"{kernel} {name}: {g.dtype}{tuple(g.shape)} vs "
                 f"{w.dtype}{tuple(w.shape)}")
        if g.dtype.is_floating_point:
            err = max(err, float((g - w).abs().max()))
        if name == "load" and kernel != "event_select" and not \
                torch.equal(g, ref.lane_tree_sum(args[2])):
            fail(f"{kernel} load is not the lane-tree sum of the sizes")
        if name == "load" and not exact_load:
            rtol = ref.load_rtol(args[12 if kernel == "event_select"
                                      else 0].shape[1])
            if not torch.allclose(g, w, rtol=rtol, atol=0.0):
                fail(f"{kernel} load outside rtol {rtol}")
        elif not torch.equal(g, w):
            fail(f"{kernel} {name} differs from the plain version: "
                 f"{g.flatten()[:8].tolist()} vs {w.flatten()[:8].tolist()}")
    return err


def packed_args(args):
    """``ops.event_select`` arguments as the kernel wrapper takes them: the
    twelve candidate scalars in one f32 and one int32 device buffer."""
    return (*ops.candidate_buffers(*args[:12]), *args[12:16],
            args[16].to(torch.int32), *args[17:])


def eager_segment(spec, golden, dev, keep):
    """The first events of a run through the eager per-event loop on the
    card (``fleetsim.core._simulate_eager``, the plain version of
    ``event_scan``): ``SEGMENT_EVENTS`` timed, with ``ops.event_select``'s
    inputs kept where ``keep`` picks them, then the first
    ``PROFILED_EVENTS`` under ``torch.profiler`` (its trace of ~190
    launches an event takes the profiler ~0.1 s an event to digest).
    Returns the wall time, the device busy time (the sum of the device's
    own entries), kernel launches per event, the host's time in
    device-to-host syncs, the costliest host ops and device kernels, and
    the kept inputs.  The profiler slows the host, so the idle share it
    shows is an upper bound for an unprofiled run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    reqs, topo, net = main_inputs(spec)
    kw = dict(policy=golden["policy"], max_forwards=golden["max_forwards"],
              capacity=spec["capacity"], depth=spec["depth"], net=net,
              device=dev)
    with Spy(ops, "event_select", keep) as spy:
        torch.cuda.synchronize()
        t0 = time.time()
        m = fleet_core._simulate_eager(reqs, topo, max_events=SEGMENT_EVENTS,
                                       **kw)
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        torch.cuda.synchronize()
        t0 = time.time()
        traced = fleet_core._simulate_eager(
            reqs, topo, max_events=PROFILED_EVENTS, **kw)
        torch.cuda.synchronize()
        traced_us = (time.time() - t0) * 1e6
    ka = prof.key_averages()
    dev_key = device_time_key(ka)
    # a CPU op also carries the time of the kernels it launched: count the
    # device's own entries (kernels, copies, fills) only
    on_dev = [e for e in ka if e.device_type == DeviceType.CUDA]
    busy_us = sum(getattr(e, dev_key) for e in on_dev)
    launches = sum(e.count for e in ka if e.key in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
        "cuLaunchKernelEx"))
    sync_us = sum(e.self_cpu_time_total for e in ka if e.key in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize",
        "cudaMemcpyAsync"))
    top = sorted(ka, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    top_dev = sorted(on_dev, key=lambda e: getattr(e, dev_key),
                     reverse=True)[:6]
    n = traced.events
    return dict(
        events=m.events, wall_us=wall_us, traced_events=n,
        traced_us_per_event=traced_us / n, busy_us_per_event=busy_us / n,
        idle_share=(1.0 - busy_us / traced_us) if busy_us > 0 else None,
        launches_per_event=launches / n,
        retire_iterations=m.retire_iterations,
        sync_us_per_event=sync_us / n,
        top_host_ops=[(e.key, e.count, round(e.self_cpu_time_total))
                      for e in top],
        top_device_ops=[(e.key[:60], e.count, round(getattr(e, dev_key)))
                        for e in top_dev],
        kept=[args for args, _ in spy.kept])


def device_time_key(ka) -> str:
    return ("self_device_time_total"
            if hasattr(ka[0], "self_device_time_total")
            else "self_cuda_time_total")


def event_select_bound_ms(K: int, W: int) -> float:
    """Least time for the work: each input read once, each output written
    once — three (K, W) f32 windows, four (K,) vectors, the selected (K,)
    latency and inverse-bandwidth rows, 48 bytes of candidate scalars;
    out 1 + 4 + 4 bytes of merge scalars and 17 bytes per node."""
    nbytes = 12 * K * W + 16 * K + 8 * K + 48 + 9 + 17 * K
    return nbytes / HBM_BYTES_PER_S * 1e3


def scan_bound_ms(K: int, events: int, scored: int) -> float:
    """Least time for a run's ``batched_feasible`` steps: each reads the
    live ledger blocks it scores (12 bytes a block; ``scored``, the
    kernel's count, sums them over the run), the per-node head, count,
    busy time, speed and load (20 K), the event node's latency and
    inverse-bandwidth (8 K) and adjacency (K) rows and the request's
    16-byte row, and writes the new block (16 bytes) and the request's
    record and completion (8).  The insert's shifted blocks are not
    counted (data-dependent and, at these loads, a few)."""
    nbytes = 12 * scored + events * (29 * K + 40)
    return nbytes / HBM_BYTES_PER_S * 1e3


def main_inputs(spec, reqs=None):
    """A golden entry's request arrays (``reqs``, or its workload's), its
    full mesh and its network: campus pricing unless the entry names
    another or none."""
    if reqs is None:
        reqs, _ = workload_of(spec).to_arrays(0)
    topo = Topology.full_mesh(spec["n_nodes"])
    net = spec.get("net", "campus")
    return (reqs, topology_arrays(topo),
            None if net is None else LinkModel.preset(topo, net).net_params())


def drive_golden(spec, golden, dev, reqs=None, label=None):
    """One golden entry through ``simulate`` on the card, the launch counts
    set to 0 just before and read just after: it must be one
    ``event_scan`` launch and no ``event_select`` launch, and equal the JAX
    reference's aggregates, digests and floats.  Returns the metrics, the
    wall time and the ``event_scan`` arguments it launched with."""
    reqs, topo, net = main_inputs(spec, reqs)
    policy = spec.get("policy", golden["policy"])
    torch.cuda.synchronize()
    scan_mod.event_scan.launches = 0
    es_mod.event_select.launches = 0
    with Spy(scan_mod, "event_scan", lambda i, args: True) as spy:
        t0 = time.time()
        m = simulate(reqs, topo, policy=policy,
                     max_forwards=golden["max_forwards"],
                     capacity=spec["capacity"], depth=spec["depth"],
                     net=net, max_events=spec["max_events"], device=dev)
        torch.cuda.synchronize()
        wall = time.time() - t0
    n_scan = scan_mod.event_scan.launches
    n_select = es_mod.event_select.launches
    R = int(m.total)
    print(f"main {label or spec['name']} ({policy}): {R} requests, "
          f"{m.events} events, {wall:.4f} s, {m.events / wall:.1f} "
          f"events/s, {R / wall:.1f} requests/s, "
          f"{wall / m.events * 1e6:.2f} us/event, {m.retire_iterations} "
          f"retire iterations, {n_scan} event_scan and {n_select} "
          f"event_select launches, {int(m.forwards)} forwards, "
          f"{int(m.met_deadline)} met", flush=True)
    check_golden(spec, m)
    if (n_scan, n_select) != (1, 0) or m.events == 0:
        fail(f"{spec['name']}: {n_scan} event_scan and {n_select} "
             f"event_select launches for {m.events} event steps")
    return m, wall, spy.kept[0]


def check_golden(spec, m):
    """A run's aggregates, per-request digests and floats against the JAX
    reference's in the golden file."""
    for k, want in spec["aggregates"].items():
        if int(getattr(m, k)) != want:
            fail(f"{spec['name']} {k}: {int(getattr(m, k))} != {want}")
    for k, want in spec["digests"].items():
        if digest(getattr(m, k)) != want:
            fail(f"{spec['name']} per-request {k} differs from the JAX "
                 "reference")
    for k, want in spec["floats"].items():
        got = float(getattr(m, k))
        if not np.isfinite(got) or abs(got - want) > 1e-5 * abs(want):
            fail(f"{spec['name']} {k}: {got} vs {want}")


PER_REQUEST = ("outcome", "served_by", "forwards_used", "completion",
               "transfer_used")
COUNTERS = ("overflow", "window_saturation", "event_overflow", "forwards",
            "met_deadline", "processed", "discarded", "events",
            "retire_iterations")


def fleet_diffs(got, want):
    """The per-request fields and counters on which two runs differ."""
    diffs = [f for f in PER_REQUEST if not torch.equal(
        getattr(got, f).cpu(), getattr(want, f).cpu())]
    return diffs + [f for f in COUNTERS
                    if int(getattr(got, f)) != int(getattr(want, f))]


def scan_vs_eager(dev) -> float:
    """Phase 3d: ``event_scan`` on the card against the eager loop on the
    CPU, on tests/test_fleetsim.py's hot 3-node fleet under the four
    deterministic policies and the two stochastic ones, with and without
    campus pricing, and under the stochastic ones on a 2-node mesh and a
    4-node star (``power_of_two`` at degree 1) and a 32-node mesh with
    four hot nodes (degree 31), priced; then the check's own test on two
    planted faults.  Returns the max abs error of the float fields
    (completion, transfer_used)."""
    hot = [{"S1": 30, "S4": 30, "S5": 25, "S6": 25}] * 3
    reqs, _ = UniformWorkload(hot, window=1200.0, name="hot").to_arrays(0)
    topo = Topology.full_mesh(3)
    ta = topology_arrays(topo)
    R, err, n_cases = reqs.arrival.shape[0], 0.0, 0
    fleets, traced = {"hot mesh3": (reqs, topo)}, None
    for name, counts, t in (
            ("mesh2", hot[:2], Topology.full_mesh(2)),
            ("star4", [{"S6": 4}] + hot, Topology.star(4)),
            ("mesh32", [hot[0]] * 4 + [{"S6": 2}] * 28,
             Topology.full_mesh(32))):
        fleets[name] = (UniformWorkload(counts, window=1200.0,
                                        name=name).to_arrays(0)[0], t)
    cases = [("hot mesh3", policy, net)
             for policy in ("batched_feasible", "round_robin",
                            "least_loaded", "trace", *STOCHASTIC)
             for net in (False, True)]
    cases += [(name, policy, True) for name in ("mesh2", "star4", "mesh32")
              for policy in STOCHASTIC]
    for fleet, policy, priced in cases:
        f_reqs, f_topo = fleets[fleet]
        targets = None if policy != "trace" else \
            np.random.default_rng(1).integers(-1, 3, (R, 2)).astype(np.int32)
        net = LinkModel.campus(f_topo).net_params() if priced else None
        kw = dict(policy=policy, capacity=512, depth=256, net=net,
                  targets=targets)
        f_ta = topology_arrays(f_topo)
        cpu = simulate(f_reqs, f_ta, device="cpu", **kw)
        scan_mod.event_scan.launches = 0
        es_mod.event_select.launches = 0
        gpu = simulate(f_reqs, f_ta, device=dev, **kw)
        torch.cuda.synchronize()
        launches = (scan_mod.event_scan.launches,
                    es_mod.event_select.launches)
        label = f"{fleet} {policy} {'campus' if priced else 'no net'}"
        if launches != (1, 0):
            fail(f"{label}: (event_scan, event_select) launches "
                 f"{launches}, not (1, 0)")
        diffs = fleet_diffs(gpu, cpu)
        if diffs:
            fail(f"{label}: event_scan differs from the eager loop on "
                 f"{diffs}")
        if int(cpu.forwards) == 0:
            fail(f"{label}: no forward to check")
        err = max(err, *(float((getattr(gpu, f).cpu() - getattr(
            cpu, f)).abs().max()) for f in ("completion", "transfer_used")))
        n_cases += 1
        if (fleet, policy, priced) == ("hot mesh3", "trace", True):
            traced = cpu, gpu, kw
    print(f"fleet scan: event_scan on the card equals the eager loop on "
          f"the CPU on every per-request field and counter in {n_cases} "
          f"runs: the hot fleet ({R} requests) under batched_feasible, "
          f"round_robin, least_loaded, trace, random and power_of_two, "
          f"priced and not; a 2-node mesh, a 4-node star and a 32-node "
          f"mesh under random and power_of_two, priced; max abs err {err}",
          flush=True)

    # the check's own test, on the hot fleet's priced trace run: a kernel
    # output with one request served elsewhere, and a kernel run with one
    # met request's deadline moved
    cpu, gpu, kw = traced
    i = int(torch.nonzero(cpu.outcome == 1)[0])
    bad = gpu._replace(served_by=gpu.served_by.clone())
    bad.served_by[i] = (bad.served_by[i] + 1) % 3
    moved = reqs.rel_deadline.copy()
    moved[i] = 1.0
    late = simulate(reqs._replace(rel_deadline=moved), ta, device=dev, **kw)
    faults = {"served_by changed": fleet_diffs(bad, cpu),
              "deadline moved": fleet_diffs(late, cpu)}
    if not all(faults.values()):
        fail(f"the event_scan check passes a planted fault: {faults}")
    print(f"fleet scan: the check rejects request {i} served elsewhere "
          f"(differs on {faults['served_by changed']}) and a run with its "
          f"deadline moved to 1 UT (differs on {faults['deadline moved']})",
          flush=True)
    return err


def fleet_phase(dev):
    """Phase 3; returns the ``event_select`` and ``event_scan`` entries of
    the kernels line and the ``event_select`` inputs kept from each
    main-path run's eager segment."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    rng = np.random.default_rng(0)
    max_err, n_checked = 0.0, 0
    for K in (3, 6, 32):
        for W in (64, 512):
            cases = [(np.ones(K), True, False), (np.ones(K), True, True),
                     (rng.choice([0.5, 1.0, 2.0], K), True, False),
                     (rng.choice([1.0, 3.0], K), False, False)]
            for speeds, exact, tie in cases:
                for _ in range(3):
                    args = random_args(rng, K, W, speeds, dev, tie=tie)
                    max_err = max(max_err,
                                  check_exact("event_select", args, exact))
                    n_checked += 1
    print(f"fleet kernel: {n_checked} random inputs match the plain "
          f"version, max abs err {max_err}", flush=True)
    t_sub = time.time()

    # b. the eager loop on the card over each main-path run's first events:
    # the before numbers, and event_select's inputs
    by_name = {r["name"]: r for r in golden["runs"]}
    runs = [by_name[n] for n in ("paper/scenario1", "paper/scenario2",
                                 "paper/scenario3", "fleet32_div4")]
    keep = lambda i, args: (i + 1) % FLEET_CAPTURE_EVERY == 0
    reqs, topo, net = main_inputs(runs[0])
    fleet_core._simulate_eager(reqs, topo, policy=golden["policy"],
                               capacity=runs[0]["capacity"],
                               depth=runs[0]["depth"], net=net,
                               max_events=50, device=dev)      # warm-up
    segments, captured = {}, {}
    for spec in runs:
        seg = segments[spec["name"]] = eager_segment(spec, golden, dev, keep)
        captured[spec["name"]] = seg.pop("kept")
        print(f"eager {spec['name']} first {seg['events']} events: "
              f"{seg['wall_us'] / seg['events']:.1f} us/event wall, "
              f"{seg['retire_iterations']} retire iterations; first "
              f"{seg['traced_events']} profiled: "
              f"{seg['traced_us_per_event']:.1f} us/event wall, device busy "
              f"{seg['busy_us_per_event']:.1f} us/event, idle share "
              f"{seg['idle_share']}, {seg['launches_per_event']:.1f} "
              f"launches/event, host in device-to-host syncs "
              f"{seg['sync_us_per_event']:.1f} us/event; top host ops (name, "
              f"calls, self us): {seg['top_host_ops']}; top device ops "
              f"(name, calls, self us): {seg['top_device_ops']}", flush=True)
    print(f"fleet phase b (eager segments): {time.time() - t_sub:.1f} s",
          flush=True)
    t_sub = time.time()

    # c. the main path, then the same fleets under the stochastic policies:
    # each run one event_scan launch, no event_select
    launches, scan_args, run_walls = {}, {}, {}
    drawn = [r for r in golden["runs"]
             if r.get("policy") in STOCHASTIC and not fleet256(r)]
    for spec in runs + drawn:
        m, wall, scan_args[spec["name"]] = drive_golden(spec, golden, dev)
        launches[spec["name"]] = (1, 0)
        run_walls[spec["name"]] = wall
        if spec in runs:
            segments[spec["name"]].update(
                R=int(m.total), K=spec["n_nodes"], W=spec["depth"],
                run_events=m.events, run_wall_s=wall)

    print(f"fleet phase c (main path): {time.time() - t_sub:.1f} s",
          flush=True)
    t_sub = time.time()

    # d. event_scan against the eager loop, and the check's own test
    scan_err = scan_vs_eager(dev)
    print(f"fleet phase d (event_scan against the eager loop): "
          f"{time.time() - t_sub:.1f} s", flush=True)

    # e. event_scan's time: each whole run in one launch, and the first
    # SEGMENT_EVENTS events of each run beside the eager loop's time there
    rows = []
    for spec in runs:
        seg = segments[spec["name"]]
        args, kw = scan_args[spec["name"]]
        K, W = seg["K"], seg["W"]
        seg_kw = dict(kw, max_events=SEGMENT_EVENTS)
        run_n, seg_n = (dict(zip(scan_mod.COUNTS, scan_mod.event_scan(
            *args, **k).counts[0].tolist())) for k in (kw, seg_kw))
        run_ms = timed_ms(lambda: scan_mod.event_scan(*args, **kw), 2)
        seg_ms = timed_ms(lambda: scan_mod.event_scan(*args, **seg_kw), 5)
        row = dict(run=spec["name"], K=K, W=W, events=run_n["events"],
                   ms=run_ms, us_per_event=run_ms * 1e3 / run_n["events"],
                   scored_per_event=run_n["scored"] / run_n["events"],
                   bound_ms=scan_bound_ms(K, run_n["events"],
                                          run_n["scored"]),
                   segment_events=seg_n["events"], segment_ms=seg_ms,
                   segment_plain_ms=seg["wall_us"] * 1e-3,
                   segment_bound_ms=scan_bound_ms(K, seg_n["events"],
                                                  seg_n["scored"]),
                   eager_us_per_event=seg["wall_us"] / seg["events"],
                   eager_busy_us_per_event=seg["busy_us_per_event"],
                   eager_idle_share=seg["idle_share"],
                   eager_launches_per_event=seg["launches_per_event"],
                   wall_s=seg["run_wall_s"])
        if (row["events"], row["segment_events"]) != (
                seg["run_events"], seg["events"]):
            fail(f"{spec['name']}: event_scan ran {row['events']} / "
                 f"{row['segment_events']} events, simulate "
                 f"{seg['run_events']} and the eager loop {seg['events']}")
        rows.append(row)
        seg_us = seg_ms * 1e3 / row["segment_events"]
        print(f"fleet scan time {spec['name']} (K={K}, W={W}): whole run "
              f"{row['events']} events in {run_ms:.3f} ms, "
              f"{row['us_per_event']:.3f} us/event, "
              f"{row['events'] / run_ms * 1e3:.0f} events/s (simulate wall "
              f"{row['wall_s']:.4f} s); first {row['segment_events']} "
              f"events {seg_ms:.3f} ms, {seg_us:.3f} us/event against the "
              f"eager loop's {row['eager_us_per_event']:.1f} us/event (x"
              f"{row['eager_us_per_event'] / seg_us:.0f}); bound "
              f"{row['bound_ms'] * 1e3 / row['events']:.4f} us/event by "
              f"bytes ({row['scored_per_event']:.1f} live blocks scored a "
              f"step, at 3.35 TB/s), beside the serial chain between "
              f"events (each step reads what the last wrote: its barriers "
              f"and dependent L2 round trips), which no bandwidth removes",
              flush=True)
    drawn_rows = []
    for spec in drawn:
        args, kw = scan_args[spec["name"]]
        n = dict(zip(scan_mod.COUNTS,
                     scan_mod.event_scan(*args, **kw).counts[0].tolist()))
        ms = timed_ms(lambda: scan_mod.event_scan(*args, **kw), 2)
        row = dict(run=spec["name"], policy=kw["policy"],
                   K=spec["n_nodes"], W=spec["depth"], events=n["events"],
                   ms=ms, us_per_event=ms * 1e3 / n["events"],
                   bound_ms=scan_bound_ms(spec["n_nodes"], n["events"],
                                          n["scored"]),
                   wall_s=run_walls[spec["name"]])
        drawn_rows.append(row)
        print(f"fleet scan time {spec['name']}: whole run {row['events']} "
              f"events in {ms:.3f} ms, {row['us_per_event']:.3f} us/event, "
              f"{row['events'] / ms * 1e3:.0f} events/s (simulate wall "
              f"{row['wall_s']:.4f} s); bound "
              f"{row['bound_ms'] * 1e3 / row['events']:.4f} us/event by "
              f"bytes", flush=True)
    top = rows[-1]                                   # fleet32_div4
    scan_entry = dict(
        launches=sum(n for n, _ in launches.values()),
        launches_by_run={k: n for k, (n, _) in launches.items()},
        also_replaces="src/repro/fleetsim/core.py:570",
        max_abs_err=scan_err, ms=top["segment_ms"],
        plain_ms=top["segment_plain_ms"], bound_ms=top["segment_bound_ms"],
        bound_by="bytes", library_ms=None,
        timed=f"{top['run']}, first {top['segment_events']} events, "
              f"{golden['policy']}",
        policies=[golden["policy"], *STOCHASTIC],
        runs=rows + drawn_rows)

    # event_select on the inputs kept from every main-path run's eager
    # segment, so each (K, W) the main path gives it is checked on its own
    # run's data; the last input of each shape is the one timed below
    shape_args, n_captured = {}, 0
    for name, kept in captured.items():
        if not kept:
            fail(f"no event_select inputs kept from {name}")
        for args in kept:
            max_err = max(max_err, check_exact("event_select", args))
        n_captured += len(kept)
        shape_args[tuple(kept[-1][12].shape)] = kept[-1]
    main_shapes = {(s["n_nodes"], s["depth"]) for s in runs}
    if set(shape_args) != main_shapes:
        fail(f"kept shapes {sorted(shape_args)} are not the main path's "
             f"{sorted(main_shapes)}")
    print(f"fleet kernel: {n_captured} inputs kept from the {len(runs)} "
          f"eager segments, shapes (K, W) {sorted(shape_args)}, match the "
          f"plain version; max abs err over all {n_checked + n_captured} "
          f"inputs {max_err}", flush=True)

    shapes = []
    for (K, W), args in sorted(shape_args.items()):
        packed = packed_args(args)
        kern = lambda: es_mod.event_select(*packed)
        plain = lambda: ref.event_select_ref(*args)
        row = dict(K=K, W=W, ms=graph_ms(kern, 1000),
                   ms_eager=timed_ms(kern, 1000),
                   plain_ms=graph_ms(plain, 200),
                   plain_ms_eager=timed_ms(plain, 200),
                   bound_ms=event_select_bound_ms(K, W))
        shapes.append(row)
        print(f"fleet kernel time K={K} W={W}: {row['ms'] * 1e3:.2f} us "
              f"(eager {row['ms_eager'] * 1e3:.2f} us), plain "
              f"{row['plain_ms'] * 1e3:.2f} us (eager "
              f"{row['plain_ms_eager'] * 1e3:.2f} us), bound "
              f"{row['bound_ms'] * 1e3:.4f} us", flush=True)
    fleet = next(r for r in shapes if (r["K"], r["W"]) == (32, 512))
    select_entry = dict(
        launches=sum(n for _, n in launches.values()),
        launches_by_run={k: n for k, (_, n) in launches.items()},
        max_abs_err=max_err, ms=fleet["ms"], plain_ms=fleet["plain_ms"],
        bound_ms=fleet["bound_ms"], bound_by="bytes", library_ms=None,
        ratio=None, shapes=shapes)
    return select_entry, scan_entry, captured


# ---------------------------------------------------------------------------
# phase 3f: the event heap (host Python) and the fleet's cross-validation
# ---------------------------------------------------------------------------
SIM_GOLDEN = os.path.join(ROOT, "tests", "golden_simulator.json")
SIM_INT_FIELDS = ("total_requests", "processed", "met_deadline", "forwards",
                  "discarded", "per_node_forwards")


def planted_trace(real):
    """``validate._host_run`` with one recorded forward target changed to
    another node than it and the request's origin."""
    def host_run(*args, **kw):
        out = real(*args, **kw)
        requests, targets = out[0], out[2]
        i, h = map(int, np.argwhere(targets >= 0)[0])
        bad = {int(targets[i, h]), requests[i].origin_node}
        targets[i, h] = min(set(range(3)) - bad)
        return out
    return host_run


# every this many batched_feasible decisions one is kept for the timed
# replays and the per-decision check against torch_queue.feasible_nodes
KEEP_DECISION = 16
# kept decisions profiled in one window, for each form of the scoring
PROFILED_DECISIONS = 20


class DecisionClock:
    """Stands in for ``router._score_feasible`` while the heap's
    ``batched_feasible`` cells run: counts the decisions, sums their wall
    time (host clock; each ends in the blocking read of its verdicts),
    keeps each decision's packed host buffer (what the kernel's input was
    copied from) and verdicts by (K, cap), and every ``KEEP_DECISION``th
    decision's ledger rows, read again after the timed call (scoring
    changes no queue).  ``extra`` is the time this bookkeeping adds to the
    run."""

    def __init__(self):
        self.real = router_mod._score_feasible
        self.rows = router_mod.ledger_rows
        self.calls, self.seconds, self.extra = 0, 0.0, 0.0
        self.packed = collections.defaultdict(list)
        self.kept = []
        self.shape = None

    def watch(self, staging):
        """Records each ``staging.pack``'s (K, cap) in ``self.shape``."""
        real = staging.pack

        def pack(*args):
            self.shape = real(*args)
            return self.shape
        staging.pack = pack
        staging.watched = True

    def __call__(self, nodes, cand_ids, ps, deadline, arrivals, staging):
        if not getattr(staging, "watched", False):
            self.watch(staging)
        t0 = time.perf_counter()
        out = self.real(nodes, cand_ids, ps, deadline, arrivals, staging)
        t1 = time.perf_counter()
        self.seconds += t1 - t0
        self.calls += 1
        K, cap = self.shape
        words = 3 * K * cap + 4 * K + 1
        self.packed[(K, cap)].append((staging.host[:words].clone(), out))
        if self.calls % KEEP_DECISION == 0:
            blocks, frees = self.rows(nodes, cand_ids, arrivals)
            self.kept.append((blocks, list(ps), deadline, frees, out))
        self.extra += time.perf_counter() - t1
        return out

    def __enter__(self):
        router_mod._score_feasible = self
        return self

    def __exit__(self, *exc):
        router_mod._score_feasible = self.real


def plain_verdicts(bufs, K, cap, dev):
    """The plain version's verdicts, on the card, of B packed decisions of
    one (K, cap) at once: their rows stacked into (B K, cap) ledgers, each
    row with its decision's deadline."""
    X = torch.stack(bufs).to(dev)
    B, L = X.shape[0], K * cap
    col = lambda a, b: X[:, a:b].contiguous()
    ledger = lambda i: col(i * L, (i + 1) * L).reshape(B * K, cap)
    vec = lambda i: col(3 * L + i * K, 3 * L + (i + 1) * K)
    feas, _ = ref.fleet_feasibility_ref(
        ledger(0), ledger(1), ledger(2),
        vec(0).view(torch.int32).reshape(B * K), vec(2).reshape(B * K),
        col(3 * L + 4 * K, 3 * L + 4 * K + 1).repeat_interleave(K, 0),
        vec(3).reshape(B * K), vec(1).view(torch.int32).reshape(B * K))
    return feas.reshape(B, K).tolist()


def pr21_score(blocks, ps, deadline, frees, dev, sync):
    """A decision scored as the router scored it until this slice (PR 21):
    three (K, cap) numpy ledgers filled element by element, each copied to
    the card, the scalars copied by ``torch.tensor``, then
    ``torch_queue.feasible_nodes`` and one read.  With ``sync``, returns
    the host time of each stage (build, copies, launches, read), each
    ending in a synchronise; else the verdicts."""
    t = [time.perf_counter()]
    cap, K = router_mod.ledger_cap(blocks), len(blocks)
    h_starts = np.full((K, cap), BIG, np.float32)
    h_ends = np.full((K, cap), BIG, np.float32)
    h_sizes = np.zeros((K, cap), np.float32)
    for k, blist in enumerate(blocks):
        for j, (s, e) in enumerate(blist):
            h_starts[k, j] = s
            h_ends[k, j] = e
            h_sizes[k, j] = e - s
    ns = [len(b) for b in blocks]
    t.append(time.perf_counter())
    f32 = dict(dtype=torch.float32, device=dev)
    leds = tq.Ledger(starts=torch.from_numpy(h_starts).to(dev),
                     ends=torch.from_numpy(h_ends).to(dev),
                     sizes=torch.from_numpy(h_sizes).to(dev),
                     n=torch.tensor(ns, dtype=torch.int32, device=dev))
    ps_t, d_t = torch.tensor(ps, **f32), torch.tensor(deadline, **f32)
    fr_t = torch.tensor(frees, **f32)
    if sync:
        torch.cuda.synchronize()
    t.append(time.perf_counter())
    ok = tq.feasible_nodes(leds, ps_t, d_t, fr_t)
    if sync:
        torch.cuda.synchronize()
    t.append(time.perf_counter())
    out = ok.tolist()
    t.append(time.perf_counter())
    return [b - a for a, b in zip(t, t[1:])] if sync else out


def routed_score(staging, blocks, ps, deadline, frees, sync):
    """A decision scored as the router scores it now: pack, one copy, one
    ``ops.fleet_feasibility`` call, one read.  With ``sync``, returns the
    host time of each stage (pack, copy, launch, read), each ending in a
    synchronise; else the verdicts."""
    t = [time.perf_counter()]
    K, cap = staging.pack(blocks, ps, frees, deadline)
    t.append(time.perf_counter())
    views = staging.to_device(K, cap)
    if sync:
        torch.cuda.synchronize()
    t.append(time.perf_counter())
    feas, _ = ops.fleet_feasibility(*views)
    if sync:
        torch.cuda.synchronize()
    t.append(time.perf_counter())
    out = feas.tolist()
    t.append(time.perf_counter())
    return [b - a for a, b in zip(t, t[1:])] if sync else out


def decision_split(clock, rows_s, dev) -> dict:
    """The heap's batched_feasible decisions after the run: every one's
    kernel verdicts against the plain version's on the card; the kept ones
    against ``torch_queue.feasible_nodes``; the kept ones replayed, in
    turns, through the router's path and through the PR 21 path, whole
    (no synchronise between stages) and stage by stage; one decision of
    each profiled (device kernels and copies)."""
    n = 0
    for (K, cap), rows in clock.packed.items():
        for i in range(0, len(rows), 2048):
            part = rows[i:i + 2048]
            got = [out for _, out in part]
            if plain_verdicts([b for b, _ in part], K, cap, dev) != got:
                fail(f"router decisions at (K, cap) {(K, cap)}: the "
                     f"kernel's verdicts differ from the plain version's")
            n += len(part)
    for blocks, ps, d, frees, out in clock.kept:
        if pr21_score(blocks, ps, d, frees, dev, False) != out:
            fail(f"a router decision (K={len(blocks)}): the kernel's "
                 f"verdicts differ from torch_queue.feasible_nodes'")
    staging = router_mod.FeasibilityStaging(dev)
    whole = {"routed": 0.0, "pr21": 0.0}
    stages = {"routed": np.zeros(4), "pr21": np.zeros(4)}
    for blocks, ps, d, frees, _ in clock.kept:
        for form in ("routed", "pr21", "pr21", "routed"):
            fn = (lambda sync: routed_score(staging, blocks, ps, d, frees,
                                            sync)) if form == "routed" \
                else (lambda sync: pr21_score(blocks, ps, d, frees, dev,
                                              sync))
            t0 = time.perf_counter()
            fn(False)
            whole[form] += (time.perf_counter() - t0) / 2
            stages[form] += np.asarray(fn(True)) / 2
    m = len(clock.kept)
    some = clock.kept[:PROFILED_DECISIONS]

    def window(form):
        """The device entries, by name, of ``PROFILED_DECISIONS`` kept
        decisions in one profiler window."""
        if form == "routed":
            run = lambda: [routed_score(staging, b, p, dd, f, False)
                           for b, p, dd, f, _ in some]
        else:
            run = lambda: [pr21_score(b, p, dd, f, dev, False)
                           for b, p, dd, f, _ in some]
        return profiled(run)["device_counts"]
    prof = {form: window(form) for form in ("routed", "pr21")}
    caps = collections.Counter()
    for (K, cap), rows in clock.packed.items():
        caps[f"K={K}, cap={cap}"] += len(rows)
    out = dict(decisions=clock.calls, checked_plain=n,
               checked_feasible_nodes=m,
               decision_ms=clock.seconds / clock.calls * 1e3,
               ledger_rows_ms=rows_s / clock.calls * 1e3,
               caps=dict(sorted(caps.items())))
    for form in whole:
        out[form] = dict(
            replay_ms=whole[form] / m * 1e3,
            stages_ms=dict(zip(("build", "copy", "launch", "read")
                               if form == "pr21" else
                               ("pack", "copy", "launch", "read"),
                               (stages[form] / m * 1e3).tolist())),
            device_entries=prof[form],
            device_kernels=sum(v for k, v in prof[form].items()
                               if not k.startswith("Memcpy")),
            device_copies=sum(v for k, v in prof[form].items()
                              if k.startswith("Memcpy")))
    print(f"heap router: {n} batched_feasible decisions, the kernel's "
          f"verdicts the plain version's on every one and "
          f"torch_queue.feasible_nodes' on {m} kept ones; caps "
          f"{out['caps']}", flush=True)
    print(f"heap router: a decision {out['decision_ms']:.4f} ms on the path "
          f"(of it ledger_rows {out['ledger_rows_ms']:.4f} ms); replayed "
          f"whole: routed {out['routed']['replay_ms']:.4f} ms, PR 21 form "
          f"{out['pr21']['replay_ms']:.4f} ms; by stage (each ending in a "
          f"synchronise) routed {out['routed']['stages_ms']}, PR 21 form "
          f"{out['pr21']['stages_ms']}", flush=True)
    print(f"heap router: {len(some)} decisions in one profiler window "
          f"(it can miss a window's first entries): routed "
          f"{out['routed']['device_kernels']} kernels and "
          f"{out['routed']['device_copies']} copies "
          f"({out['routed']['device_entries']}); PR 21 form "
          f"{out['pr21']['device_kernels']} kernels and "
          f"{out['pr21']['device_copies']} copies", flush=True)
    return out


def heap_phase(dev) -> dict:
    """Phase 3f: the port's ``run_simulation`` against all 18 entries of
    tests/golden_simulator.json (the router on the card), then
    ``run_validation`` on ``paper/scenario1..3`` under campus pricing with
    ``batched_feasible`` and ``round_robin`` replayed directly and
    ``random`` and ``power_of_two`` by trace, each with one ``event_scan``
    launch and no ``event_select`` launch and each report equal to the
    reference's in the golden file: exact where the reference's is (11 of
    12), the same mismatch counts where it is not (``paper/scenario2``
    under ``round_robin``: 16 requests served by another node than the
    heap's, f32 ledgers against f64, in the reference as in the port);
    then the check shown to reject a trace with one recorded forward
    target changed.  Returns the wall times."""
    with open(SIM_GOLDEN) as f:
        golden = json.load(f)
    t_grid = time.time()
    for key, want in golden.items():
        scenario, queue, seed = key.split("-")
        t0 = time.time()
        got = run_simulation(SimConfig(scenario=int(scenario), queue=queue,
                                       seed=int(seed)), device=dev)
        wall = time.time() - t0
        bad = [f for f in SIM_INT_FIELDS if getattr(got, f) != want[f]]
        ref_resp = want["mean_response_time"]
        if abs(got.mean_response_time - ref_resp) > 1e-9 * abs(ref_resp):
            bad.append("mean_response_time")
        if bad:
            fail(f"run_simulation {key} differs from "
                 f"tests/golden_simulator.json on {bad}")
        print(f"heap simulator {key}: met {got.met_deadline}/"
              f"{got.total_requests}, {got.forwards} forwards, mean "
              f"response {got.mean_response_time!r} UT, {wall:.3f} s",
              flush=True)
    grid_s = time.time() - t_grid
    print(f"heap simulator: all {len(golden)} runs equal "
          f"tests/golden_simulator.json, {grid_s:.1f} s", flush=True)

    with open(GOLDEN) as f:
        reference = json.load(f)["validation"]
    t_val, cells = time.time(), []
    clock, rows_s = DecisionClock(), 0.0
    for want in reference:
        sc, policy = want["scenario"], want["policy"]
        network = LinkModel.campus(Topology.full_mesh(
            get_workload(sc).n_nodes))
        scan_mod.event_scan.launches = 0
        es_mod.event_select.launches = 0
        decided, routed = clock.calls, ad_mod.fleet_feasibility.launches
        extra = clock.extra
        with Spy(validate, "_host_run") as host, \
                Spy(validate.fcore, "simulate") as fleet, \
                Spy(router_mod, "ledger_rows") as rows, \
                Spy(tq, "feasible_nodes") as old_scorer, clock:
            rep = validate.run_validation(sc, 0, policy=policy,
                                          network=network, device=dev)
        rows_s += rows.seconds
        extra = clock.extra - extra
        decided = clock.calls - decided
        routed = ad_mod.fleet_feasibility.launches - routed
        if routed != decided or old_scorer.calls or \
                (policy == "batched_feasible") != (decided > 0):
            fail(f"run_validation {sc} {policy}: {routed} fleet_feasibility "
                 f"launches for {decided} router decisions, "
                 f"{old_scorer.calls} torch_queue.feasible_nodes calls")
        launches = (scan_mod.event_scan.launches,
                    es_mod.event_select.launches)
        got = dict(exact=rep.exact,
                   outcome_mismatches=rep.outcome_mismatches,
                   node_mismatches=rep.node_mismatches,
                   capacity=rep.capacity,
                   host={k: int(rep.host[k]) for k in want["host"]},
                   fleet={k: int(rep.fleet[k]) for k in want["fleet"]})
        bad = [k for k, v in got.items() if v != want[k]]
        if launches != (1, 0) or bad:
            fail(f"run_validation {sc} {policy}: {rep.row()}, differs from "
                 f"the reference's report on {bad}; (event_scan, "
                 f"event_select) launches {launches}")
        cells.append(dict(scenario=sc, policy=policy, exact=rep.exact,
                          heap_s=host.seconds, fleet_s=fleet.seconds,
                          forwards=rep.host["forwards"], decisions=decided))
        print(f"heap validate {rep.row()}  heap {host.seconds:.3f} s, "
              f"fleet (event_scan) {fleet.seconds:.4f} s; the reference's "
              f"report; {decided} router decisions, as many "
              f"fleet_feasibility launches", flush=True)
        if decided:
            heap_s = host.seconds - extra
            cells[-1].update(heap_s=heap_s, bookkeeping_s=extra)
            print(f"heap validate {sc} batched_feasible: wall "
                  f"{heap_s + fleet.seconds:.3f} s ({decided} decisions, "
                  f"{heap_s / decided * 1e3:.4f} ms of heap a decision; "
                  f"{extra:.3f} s of this script's bookkeeping taken out)",
                  flush=True)
    validate_s = time.time() - t_val
    launched = ad_mod.fleet_feasibility.launches
    router = decision_split(clock, rows_s, dev)
    ad_mod.fleet_feasibility.launches = launched   # the replays' launches

    real = validate._host_run
    validate._host_run = planted_trace(real)
    try:
        rep = validate.run_validation(
            "paper/scenario3", 0, policy="random", device=dev,
            network=LinkModel.campus(Topology.full_mesh(6)))
    finally:
        validate._host_run = real
    if rep.exact:
        fail(f"run_validation passes a changed trace: {rep.row()}")
    print(f"heap validate: a trace with one forward target changed is "
          f"rejected ({rep.row()})", flush=True)
    return dict(grid_s=grid_s, validate_s=validate_s, cells=cells,
                router=router, router_inputs={
                    key: rows[0][0] for key, rows in clock.packed.items()})


# ---------------------------------------------------------------------------
# phase 3g: sweeps (one event_scan block a cell) and the telemetry plane
# ---------------------------------------------------------------------------
TRACE_DIR = os.path.join(ROOT, "build", "telemetry")
HOT_COUNTS = [{"S1": 30, "S4": 30, "S5": 25, "S6": 25}] * 3
FLEET_POLICIES = ("batched_feasible", "round_robin", "least_loaded", "trace",
                  *STOCHASTIC)


def counted(fn):
    """``fn()`` with the launch counts from 0, ending in a synchronise:
    returns its result, its wall time, the arguments of its last
    ``event_scan`` launch and the counts (``event_scan``, of those the
    telemetry instantiation, ``event_select``)."""
    torch.cuda.synchronize()
    scan_mod.event_scan.launches = 0
    scan_mod.event_scan.telemetry_launches = 0
    es_mod.event_select.launches = 0
    with Spy(scan_mod, "event_scan", lambda i, args: True) as spy:
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    return out, wall, spy.kept[-1] if spy.kept else None, (
        scan_mod.event_scan.launches, scan_mod.event_scan.telemetry_launches,
        es_mod.event_select.launches)


def golden_summary(cube) -> "tel.TelemetrySummary":
    """A cube of the golden file as a ``TelemetrySummary``."""
    counts = np.asarray(cube["counts"], np.int32)
    w = float(np.float32(cube["bucket_width"]))
    return tel.TelemetrySummary(
        counts=counts, queue_depth=np.asarray(cube["queue_depth"], np.float32),
        busy_time=np.asarray(cube["busy_time"], np.float32),
        occupancy_hwm=np.asarray(cube["occupancy_hwm"], np.int32),
        bucket_width=w, horizon=w * counts.shape[1])


def cube_diffs(want, got):
    """Where summary ``got`` breaks the telemetry contract against
    ``want``: counters and occupancy exactly, the integrals within
    ``DERIVED_ATOL``; with the agreement."""
    agr = tel.compare_summaries(want, got)
    bad = [name for name, wrong in (
        ("counts", agr.counts_mismatches),
        ("occupancy", agr.occupancy_mismatches),
        ("queue_depth", agr.depth_max_err > agr.depth_tol),
        ("busy_time", agr.busy_max_err_frac > agr.busy_tol_frac)) if wrong]
    return bad, agr


def single_cells(args, kw):
    """The arguments of each cell of a sweep's launch, launched alone."""
    cut = lambda t, c: t[c:c + 1] if torch.is_tensor(t) and t.dim() == 3 \
        and t.shape[0] > 1 else t
    return [(tuple(cut(a, c) for a in args), dict(kw, seed=[seed]))
            for c, seed in enumerate(kw["seed"])]


def sweep_times(args, kw):
    """One launch of all C cells against the C cells launched one after
    another, in turns (CUDA events)."""
    singles = single_cells(args, kw)

    def one_by_one():
        for a, k in singles:
            scan_mod.event_scan(*a, **k)
    return in_turns(
        lambda: timed_ms(lambda: scan_mod.event_scan(*args, **kw), 2),
        lambda: timed_ms(one_by_one, 1))


def paper_sweep(dev, g, telemetry=None):
    """examples/fleet_sweep.py's grid as one simulate_fn call."""
    wl = get_workload(g["scenario"])
    reqs, _ = wl.to_arrays(0)
    run = simulate_fn(policy=g["policy"], capacity=g["capacity"],
                      depth=g["depth"], telemetry=telemetry, device=dev)
    params = SimParams.make([c["seed"] for c in g["cells"]],
                            [c["sla_scale"] for c in g["cells"]])
    return counted(lambda: run(reqs, topology_arrays(
        Topology.full_mesh(wl.n_nodes)), params, None)), reqs


def sweep_phase(dev) -> dict:
    """Phase 3g: a. the 32-cell paper sweep as one launch of 32 blocks,
    each cell its golden entry, timed against its cells launched one by
    one; b. the 12-cell network grid; c. telemetry on the main path
    (``paper/scenario1..3``, ``batched_feasible``, campus): the JAX cube,
    every other output the telemetry-off run's and the golden digests,
    on against off per event; d. the paper sweep with telemetry, each
    cell's cube the JAX one; e. ``run_validation(telemetry=32)`` against
    the reference's reports, one Chrome trace written and validated;
    f. the eager loop against ``event_scan`` with telemetry on the hot
    fleets of phase 3d.  Returns the numbers for the kernels line, and
    ``launches``: the ``event_scan`` launches of each path of a-d, each
    counted from 0 by ``counted``."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    sweeps = golden["sweeps"]
    out = {"launches": {"sweep paper": 1, "sweep net_grid": 1,
                        "sweep paper telemetry": 1}}

    # a. the paper sweep, one launch of 32 blocks
    g = sweeps["paper"]
    (m, wall, (args, kw), n), reqs = paper_sweep(dev, g)
    C, R = len(g["cells"]), reqs.arrival.shape[0]
    if n != (1, 0, 0):
        fail(f"paper sweep: (event_scan, telemetry, event_select) launches "
             f"{n}, not (1, 0, 0)")
    for c, want in enumerate(g["cells"]):
        check_golden(dict(want, name=f"paper sweep cell {c}"), m.cell(c))
    ms, singles_ms = sweep_times(args, kw)
    events = m.events
    out["paper"] = dict(
        cells=C, requests=C * R, events=sum(events), launch_ms=ms,
        singles_ms=singles_ms, wall_s=wall, cells_per_s=C / ms * 1e3,
        requests_per_s=C * R / ms * 1e3,
        us_per_event_longest_cell=ms * 1e3 / max(events),
        us_per_event_singles=singles_ms * 1e3 / sum(events),
        speedup=singles_ms / ms)
    p = out["paper"]
    print(f"sweep paper: {C} cells ({g['scenario']}, {g['policy']}, seeds "
          f"{g['seeds'][0]}-{g['seeds'][-1]} x sla_scale {g['sla_scales']}; "
          f"{C * R} requests, {sum(events)} events) in one event_scan "
          f"launch of {C} blocks, each cell its golden entry: {ms:.3f} ms "
          f"({p['cells_per_s']:.1f} cells/s, {p['requests_per_s']:.0f} "
          f"requests/s, {p['us_per_event_longest_cell']:.3f} us per event "
          f"of the longest cell; simulate_fn wall {wall:.4f} s); the same "
          f"{C} cells launched one by one {singles_ms:.3f} ms "
          f"({p['us_per_event_singles']:.3f} us/event): x{p['speedup']:.1f}",
          flush=True)
    m_off = m

    # b. the network grid, one launch of 12 blocks
    g = sweeps["net_grid"]
    K = len(g["counts"])
    hot, _ = UniformWorkload(g["counts"], window=g["window"],
                             name="hot").to_arrays(0)
    nets = [NetParams.uniform(K, c["latency"], 0.0 if c["bandwidth"] == "inf"
                              else 1.0 / c["bandwidth"]) for c in g["cells"]]
    net = NetParams(np.stack([x.latency for x in nets]),
                    np.stack([x.inv_bw for x in nets]))
    run = simulate_fn(policy=g["policy"], capacity=g["capacity"],
                      depth=g["depth"], network=True, device=dev)
    m, wall, (args, kw), n = counted(lambda: run(
        hot, topology_arrays(Topology.full_mesh(K)), SimParams.make(0), None,
        net))
    if n != (1, 0, 0):
        fail(f"network grid: launches {n}, not (1, 0, 0)")
    for c, want in enumerate(g["cells"]):
        check_golden(dict(want, name=f"network grid cell {c}"), m.cell(c))
    ms = timed_ms(lambda: scan_mod.event_scan(*args, **kw), 5)
    out["net_grid"] = dict(cells=len(g["cells"]), launch_ms=ms, wall_s=wall)
    print(f"sweep network grid: {len(g['cells'])} cells (latency "
          f"{g['latency']} x bandwidth {g['bandwidth']}, {g['policy']}, "
          f"{hot.arrival.shape[0]} requests each) in one launch, each cell "
          f"its golden entry: {ms:.3f} ms; met "
          f"{m.met_deadline.tolist()}", flush=True)

    # c. telemetry on the main path: the JAX cube, nothing else moved
    by_name = {r["name"]: r for r in golden["runs"]}
    rows, planted = [], None
    for want in golden["telemetry"]:
        spec = by_name[want["name"]]
        reqs, topo, net = main_inputs(spec)
        kw = dict(policy=golden["policy"], max_forwards=golden["max_forwards"],
                  capacity=spec["capacity"], depth=spec["depth"], net=net,
                  max_events=spec["max_events"], device=dev)
        cfg = tel.TelemetryConfig(want["n_buckets"], want["horizon"])
        off, _, off_call, n_off = counted(lambda: simulate(reqs, topo, **kw))
        on, wall, on_call, n_on = counted(
            lambda: simulate(reqs, topo, telemetry=cfg, **kw))
        if (n_off, n_on) != ((1, 0, 0), (1, 1, 0)):
            fail(f"{spec['name']} telemetry: launches off {n_off}, on "
                 f"{n_on}, not (1, 0, 0) and (1, 1, 0)")
        check_golden(spec, on)
        moved = fleet_diffs(on, off)
        if moved:
            fail(f"{spec['name']}: telemetry moved {moved}")
        ref_sum = golden_summary(want)
        bad, agr = cube_diffs(ref_sum, tel.TelemetrySummary.from_frame(
            on.telemetry))
        if bad:
            fail(f"{spec['name']}: the telemetry cube differs from the JAX "
                 f"reference's on {bad}: {agr.row()}")
        if planted is None:
            # the check's own test: one counter moved, one bucket's busy
            # time moved by 5% of a bucket
            sums = [tel.TelemetrySummary.from_frame(on.telemetry)
                    for _ in range(2)]
            sums[0].counts[0, 0, tel.KIND_ARRIVAL] += 1
            sums[1].busy_time[0, 0] += 0.05 * sums[1].bucket_width
            planted = [cube_diffs(ref_sum, x)[0] for x in sums]
            if planted != [["counts"], ["busy_time"]]:
                fail(f"the cube check passes a planted fault: {planted}")
        t_off, t_on = in_turns(
            lambda: timed_ms(lambda: scan_mod.event_scan(
                *off_call[0], **off_call[1]), 2),
            lambda: timed_ms(lambda: scan_mod.event_scan(
                *on_call[0], **on_call[1]), 2))
        row = dict(run=spec["name"], events=on.events, off_ms=t_off,
                   on_ms=t_on, off_us_per_event=t_off * 1e3 / on.events,
                   on_us_per_event=t_on * 1e3 / on.events,
                   depth_err=agr.depth_max_err,
                   busy_err_frac=agr.busy_max_err_frac, wall_s=wall)
        rows.append(row)
        out["launches"][f"telemetry {spec['name']} (off, on)"] = 2
        print(f"telemetry {spec['name']}: {want['n_buckets']} buckets over "
              f"[0, {want['horizon']}): counters and occupancy equal the JAX "
              f"cube, depth err {agr.depth_max_err:.3g} (tol "
              f"{agr.depth_tol:.3g}), busy err {agr.busy_max_err_frac:.3g} "
              f"of a bucket (tol {agr.busy_tol_frac}); every other output "
              f"the telemetry-off run's and the golden digests; one launch "
              f"each; on {t_on:.3f} ms = {row['on_us_per_event']:.3f} "
              f"us/event against off {t_off:.3f} ms = "
              f"{row['off_us_per_event']:.3f} us/event, in turns", flush=True)
    print(f"telemetry: the cube check rejects a moved counter and a moved "
          f"busy time ({planted})", flush=True)
    out["telemetry"] = rows

    # d. the paper sweep with telemetry: each cell's cube the JAX one
    g = sweeps["paper_telemetry"]
    cfg = tel.TelemetryConfig(g["n_buckets"], g["horizon"])
    (m, wall, (args, kw), n), _ = paper_sweep(dev, g, cfg)
    if n != (1, 1, 0):
        fail(f"paper sweep with telemetry: launches {n}, not (1, 1, 0)")
    w = float(m.telemetry.bucket_width[0])
    for c, want in enumerate(g["cells"]):
        mc = m.cell(c)
        moved = fleet_diffs(mc, m_off.cell(c))
        if moved:
            fail(f"paper sweep cell {c}: telemetry moved {moved}")
        got = tel.TelemetrySummary.from_frame(mc.telemetry)
        wt = want["telemetry"]
        if "whole" in wt:
            bad, agr = cube_diffs(golden_summary(wt["whole"]), got)
            if bad:
                fail(f"paper sweep cell {c}: the cube differs from the JAX "
                     f"one on {bad}: {agr.row()}")
        ref = golden_summary(dict(
            counts=got.counts, occupancy_hwm=got.occupancy_hwm,
            queue_depth=wt["queue_depth"], busy_time=wt["busy_time"],
            bucket_width=w))
        bad = [k for k in ("counts", "occupancy_hwm")
               if digest(getattr(mc.telemetry, k)) != wt[k]]
        bad += cube_diffs(ref, got)[0]
        if bad:
            fail(f"paper sweep cell {c}: the cube differs from the JAX one "
                 f"on {bad}")
    t_off, t_on = in_turns(
        lambda: timed_ms(lambda: scan_mod.event_scan(
            *args, **dict(kw, telemetry=None)), 2),
        lambda: timed_ms(lambda: scan_mod.event_scan(*args, **kw), 2))
    out["paper_telemetry"] = dict(cells=len(g["cells"]), on_ms=t_on,
                                  off_ms=t_off, wall_s=wall)
    print(f"sweep paper with telemetry ({g['n_buckets']} buckets over [0, "
          f"{g['horizon']})): one launch of {len(g['cells'])} blocks, each "
          f"cell's counters and occupancy the JAX cube's digests, its "
          f"integrals within DERIVED_ATOL, cells {g['whole_cubes']} whole, "
          f"every other output the telemetry-off sweep's; {t_on:.3f} ms "
          f"against {t_off:.3f} ms without telemetry, in turns", flush=True)

    # e. the cross-validation with telemetry, and one Chrome trace
    cells = []
    for want in golden["validation_telemetry"]:
        sc = want["scenario"]
        topology = Topology.full_mesh(get_workload(sc).n_nodes)
        with Spy(validate, "_host_run") as host, \
                Spy(validate, "TraceRecorder") as recorder:
            rep, wall, _, n = counted(lambda: validate.run_validation(
                sc, 0, policy=want["policy"],
                network=LinkModel.campus(topology),
                telemetry=want["n_buckets"], device=dev))
        if n != (2, 1, 0):
            fail(f"run_validation {sc} telemetry: launches {n}, not (2, 1, "
                 "0)")
        got = dict(exact=rep.exact,
                   outcome_mismatches=rep.outcome_mismatches,
                   node_mismatches=rep.node_mismatches,
                   capacity=rep.capacity,
                   host={k: int(rep.host[k]) for k in want["host"]},
                   fleet={k: int(rep.fleet[k]) for k in want["fleet"]},
                   telemetry_ok=rep.telemetry.ok)
        agr, ref = rep.telemetry, want["telemetry"]
        bad = [k for k, v in got.items() if v != want[k]]
        bad += [k for k in ("counts_mismatches", "occupancy_mismatches",
                            "busy_tol_frac") if getattr(agr, k) != ref[k]]
        if not agr.ok or bad or abs(agr.depth_tol - ref["depth_tol"]) > \
                1e-6 * ref["depth_tol"]:
            fail(f"run_validation {sc} telemetry: {rep.row()}, differs "
                 f"from the reference's report on {bad}")
        cells.append(dict(scenario=sc, heap_s=host.seconds, wall_s=wall,
                          depth_err=agr.depth_max_err,
                          busy_err_frac=agr.busy_max_err_frac))
        print(f"telemetry validate {rep.row()}  heap {host.seconds:.3f} s, "
              f"all {wall:.3f} s; the reference's report", flush=True)
        if len(cells) == 1:
            os.makedirs(TRACE_DIR, exist_ok=True)
            path = os.path.join(TRACE_DIR, f"{sc.replace('/', '_')}.json")
            recorder.last.write(path, host.last[0], topology)
            with open(path) as f:
                n_ev = tel.validate_chrome_trace(json.load(f))
            print(f"telemetry trace: {n_ev} events of {sc}'s heap run "
                  f"written to {os.path.relpath(path, ROOT)} and valid",
                  flush=True)
    out["validation"] = cells

    # f. the eager loop against event_scan with telemetry on the hot fleet
    reqs, _ = UniformWorkload(HOT_COUNTS, window=1200.0,
                              name="hot").to_arrays(0)
    R, depth_err, busy_err = reqs.arrival.shape[0], 0.0, 0.0
    cfg = tel.TelemetryConfig(16, 3000.0)
    topo = Topology.full_mesh(3)
    for policy in FLEET_POLICIES:
        for priced in (False, True):
            targets = None if policy != "trace" else \
                np.random.default_rng(1).integers(-1, 3, (R, 2)).astype(
                    np.int32)
            kw = dict(policy=policy, capacity=512, depth=256, targets=targets,
                      telemetry=cfg,
                      net=LinkModel.campus(topo).net_params() if priced
                      else None)
            cpu = simulate(reqs, topology_arrays(topo), device="cpu", **kw)
            gpu, _, _, n = counted(lambda: simulate(
                reqs, topology_arrays(topo), device=dev, **kw))
            label = f"hot {policy} {'campus' if priced else 'no net'}"
            if n != (1, 1, 0):
                fail(f"{label} telemetry: launches {n}")
            diffs = fleet_diffs(gpu, cpu)
            bad, agr = cube_diffs(tel.TelemetrySummary.from_frame(
                cpu.telemetry), tel.TelemetrySummary.from_frame(gpu.telemetry))
            if diffs or bad:
                fail(f"{label}: event_scan with telemetry differs from the "
                     f"eager loop on {diffs + bad}")
            depth_err = max(depth_err, agr.depth_max_err)
            busy_err = max(busy_err, agr.busy_max_err_frac)
    print(f"telemetry scan: event_scan's telemetry instantiation equals the "
          f"eager loop on every per-request field, counter, event counter "
          f"and occupancy in {2 * len(FLEET_POLICIES)} hot-fleet runs (six "
          f"policies, priced and not), integrals within DERIVED_ATOL "
          f"(largest depth error {depth_err:.3g}, busy {busy_err:.3g} of a "
          f"bucket)", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 3h: the other arrival processes, the radio model, the 256-node fleet
# ---------------------------------------------------------------------------
TRACE_FILE = os.path.join(ROOT, "build", "traces", "paper_scenario1.jsonl")


def fleet256_times(spec, args, kw, wall) -> dict:
    """One 256-node run's kernel time: CUDA events around one launch of the
    whole run (after a launch that reads its counts), beside ``simulate``'s
    wall time, the bytes bound and the shared-memory ring path."""
    counts = scan_mod.event_scan(*args, **kw).counts[0].tolist()
    n = dict(zip(scan_mod.COUNTS, counts))
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    scan_mod.event_scan(*args, **kw)
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1)
    K, R = spec["n_nodes"], spec["aggregates"]["total"]
    ring = scan_mod.shared_bytes(K, kw["event_buf"], True) \
        <= scan_mod.SHARED_LIMIT
    row = dict(run=spec["name"], policy=kw["policy"], K=K,
               W=spec["depth"], R=R, events=n["events"], ms=ms,
               us_per_event=ms * 1e3 / n["events"], wall_s=wall,
               requests_per_s=R / wall,
               scored_per_event=n["scored"] / n["events"],
               bound_ms=scan_bound_ms(K, n["events"], n["scored"]),
               ring="shared" if ring else "global",
               shared_bytes=scan_mod.shared_bytes(K, kw["event_buf"], ring),
               event_buf=kw["event_buf"])
    print(f"fleet256 time {spec['name']}: whole run {n['events']} events "
          f"in one launch, {ms:.3f} ms, {row['us_per_event']:.3f} us/event "
          f"(CUDA events); simulate wall {wall:.4f} s, "
          f"{row['requests_per_s']:.0f} requests/s; bound "
          f"{row['bound_ms']:.4f} ms by bytes "
          f"({row['scored_per_event']:.1f} live blocks scored a step); ring "
          f"of {kw['event_buf']} events in {row['ring']} memory "
          f"({row['shared_bytes']} bytes of dynamic shared memory)",
          flush=True)
    return row


def workload_phase(dev) -> dict:
    """Phase 3h: (a) the golden file's eight ``workloads`` runs (Poisson,
    diurnal, static and mobile radio, under ``batched_feasible`` and
    ``random``); (b) ``paper/scenario1`` written by ``dump_trace`` and
    replayed by ``TraceWorkload``, held to the ``paper/scenario1`` entry;
    (c) the 256-node, 128,000-request fleet under ``random``,
    ``least_loaded`` and ``batched_feasible``, unpriced, each one launch
    held to the reference's digests, then timed; (d) the eager loop's
    first events of its ``batched_feasible`` run on the card beside the
    kernel's; (e) ``run_validation`` on the mobile radio workload under
    ``random`` against the reference's report.  Returns the numbers for
    the kernels line."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    launches = {}

    # a. the arrival processes and the radio model
    t_sub = time.time()
    for spec in golden["workloads"]:
        m, _, _ = drive_golden(spec, golden, dev)
        launches[spec["name"]] = 1
        if int(m.forwards) == 0:
            fail(f"{spec['name']}: no forward")
    print(f"workload phase a ({len(golden['workloads'])} runs): "
          f"{time.time() - t_sub:.1f} s", flush=True)

    # b. a trace written and replayed
    spec = next(r for r in golden["runs"] if r["name"] == "paper/scenario1")
    os.makedirs(os.path.dirname(TRACE_FILE), exist_ok=True)
    dump_trace(get_workload("paper/scenario1").generate(0), TRACE_FILE)
    replayed, _ = TraceWorkload(TRACE_FILE).to_arrays(0)
    drive_golden(spec, golden, dev, reqs=replayed,
                 label="paper/scenario1 replayed from its trace")
    launches["paper/scenario1@trace_replay"] = 1

    # c. the 256-node fleet
    t_sub = time.time()
    big = [r for r in golden["runs"] if fleet256(r)]
    reqs, _ = workload_of(big[0]).to_arrays(0)
    rows, kept = [], {}
    for spec in big:
        m, wall, (args, kw) = drive_golden(spec, golden, dev, reqs=reqs)
        launches[spec["name"]] = 1
        kept[spec["policy"]] = spec, args, kw
        rows.append(fleet256_times(spec, args, kw, wall))
    print(f"workload phase c (256-node fleet): {time.time() - t_sub:.1f} s",
          flush=True)

    # d. the first events of the batched_feasible run: eager loop against
    # the kernel
    spec, args, kw = kept["batched_feasible"]
    reqs256, topo, net = main_inputs(spec, reqs)
    eager_kw = dict(policy="batched_feasible",
                    max_forwards=golden["max_forwards"],
                    capacity=spec["capacity"], depth=spec["depth"], net=net,
                    device=dev)
    fleet_core._simulate_eager(reqs256, topo, max_events=20,
                               **eager_kw)                      # warm-up
    torch.cuda.synchronize()
    t0 = time.time()
    seg = fleet_core._simulate_eager(reqs256, topo,
                                     max_events=SEGMENT_EVENTS, **eager_kw)
    torch.cuda.synchronize()
    eager_ms = (time.time() - t0) * 1e3
    seg_kw = dict(kw, max_events=SEGMENT_EVENTS)
    n = dict(zip(scan_mod.COUNTS, scan_mod.event_scan(
        *args, **seg_kw).counts[0].tolist()))
    if n["events"] != seg.events:
        fail(f"fleet256: the kernel ran {n['events']} events where the "
             f"eager loop ran {seg.events}")
    seg_ms = timed_ms(lambda: scan_mod.event_scan(*args, **seg_kw), 5)
    segment = dict(run=spec["name"], events=seg.events, ms=seg_ms,
                   plain_ms=eager_ms,
                   bound_ms=scan_bound_ms(spec["n_nodes"], n["events"],
                                          n["scored"]))
    print(f"fleet256 {spec['name']} first {seg.events} events: event_scan "
          f"{seg_ms:.3f} ms ({seg_ms * 1e3 / seg.events:.3f} us/event), "
          f"eager loop on the card {eager_ms:.1f} ms "
          f"({eager_ms * 1e3 / seg.events:.1f} us/event, x"
          f"{eager_ms / seg_ms:.0f}), bound {segment['bound_ms']:.5f} ms",
          flush=True)

    # e. the cross-validation on the mobile radio workload
    [want] = golden["validation_radio"]
    wl = workload_of(dict(workload=want["workload"]))
    network = LinkModel.preset(Topology.full_mesh(wl.n_nodes),
                               want["workload"]["link"])
    scan_mod.event_scan.launches = 0
    es_mod.event_select.launches = 0
    with Spy(validate, "_host_run") as host, \
            Spy(validate.fcore, "simulate") as fleet:
        rep = validate.run_validation(wl, 0, policy=want["policy"],
                                      network=network, device=dev)
    n_launch = (scan_mod.event_scan.launches, es_mod.event_select.launches)
    got = dict(exact=rep.exact, outcome_mismatches=rep.outcome_mismatches,
               node_mismatches=rep.node_mismatches, capacity=rep.capacity,
               host={k: int(rep.host[k]) for k in want["host"]},
               fleet={k: int(rep.fleet[k]) for k in want["fleet"]})
    bad = [k for k, v in got.items() if v != want[k]]
    if n_launch != (1, 0) or bad:
        fail(f"run_validation {wl.name} {want['policy']}: {rep.row()}, "
             f"differs from the reference's report on {bad}; (event_scan, "
             f"event_select) launches {n_launch}")
    launches["validate radio_mobile@random"] = 1
    print(f"radio validate {rep.row()}  heap {host.seconds:.3f} s, fleet "
          f"(event_scan) {fleet.seconds:.4f} s; the reference's report",
          flush=True)
    return dict(launches=launches, fleet256=rows, fleet256_segment=segment)


# ---------------------------------------------------------------------------
# phase 4: the vision serving path and flash_attention
# ---------------------------------------------------------------------------
def tolerance_share(got, want, tol) -> float:
    """The largest error as a share of what ``tol`` allows there (an exact
    element counts 0, also where nothing is allowed)."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    share = err / (tol["atol"] + tol["rtol"] * w.abs())
    return float(torch.where(err == 0, 0.0, share).max())


def check_flash(q, k, v, causal, window):
    """Kernel vs plain version on one input, held to
    ``ref.flash_attention_tolerance``; returns the max abs error and the
    largest error as a share of what the tolerance allows there."""
    got = fa_mod.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    if got.dtype != want.dtype or got.shape != want.shape:
        fail(f"flash_attention: {got.dtype}{tuple(got.shape)} vs "
             f"{want.dtype}{tuple(want.shape)}")
    g, w = got.float(), want.float()
    tol = ref.flash_attention_tolerance(want, v)
    share = tolerance_share(g, w, tol)
    if not torch.isfinite(g).all() or not share <= 1.0:
        fail(f"flash_attention differs from the plain version at q "
             f"{tuple(q.shape)} kv heads {k.shape[2]} {q.dtype} causal "
             f"{causal} window {window}: max abs err "
             f"{float((g - w).abs().max())}, {share} of the tolerance "
             f"{tol}")
    return float((g - w).abs().max()), share


def flash_rejects_dropped_key(q, k, v) -> float:
    """The check's own test on one non-causal input: the plain version
    over all keys but the last (a kernel that drops the last key of the
    ragged tail tile) must fail the tolerance; returns its largest error
    as a share of the tolerance."""
    want = ref.flash_attention_ref(q, k, v, causal=False).float()
    bad = ref.flash_attention_ref(q, k[:, :-1], v[:, :-1], causal=False)
    share = tolerance_share(bad, want, ref.flash_attention_tolerance(want, v))
    if share <= 1.0:
        fail(f"the flash_attention check passes a kernel that drops the "
             f"last key at q {tuple(q.shape)}")
    return share


def flash_rms_errors(q, k, v):
    """Root-mean-square errors against the plain version in f32 on the
    same bf16 inputs: of the kernel, of the plain version in bf16, and of
    the plain version without the last key."""
    exact = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                    causal=False)
    rms = lambda x: float((x.float() - exact).pow(2).mean().sqrt())
    return (rms(fa_mod.flash_attention(q, k, v, causal=False)),
            rms(ref.flash_attention_ref(q, k, v, causal=False)),
            rms(ref.flash_attention_ref(q, k[:, :-1], v[:, :-1],
                                        causal=False)))


# the sweep's head widths: DeiT-B's 64, DiT-XL/2's 72, ViT-H/14's 80 and
# 128 on tma_wgmma in bf16, 32 on mma_sync
SWEEP_HEAD_DIMS = (32, 64, 72, 80, 128)


def flash_sweep(dev) -> float:
    gen = torch.Generator().manual_seed(0)
    variants = ((False, None, 12, 12), (True, None, 8, 2),
                (True, 100, 8, 1), (False, 64, 4, 4))
    err, share, n, paths = 0.0, {}, 0, {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for dt in (torch.float32, torch.bfloat16):
        for S in (1, 63, 65, 127, 129, 578, 730, 1024):
            for D in SWEEP_HEAD_DIMS:
                for causal, window, H, KV in variants:
                    q, k, v = (torch.randn(2, S, h, D, generator=gen).to(
                        device=dev, dtype=dt) for h in (H, KV, KV))
                    e, sh = check_flash(q, k, v, causal, window)
                    err, share[dt] = max(err, e), max(share.get(dt, 0.0), sh)
                    path = fa_mod.variant(q, k, v)
                    if path == "tma_wgmma":
                        path += " split" if fa_mod.split_keys(
                            2, S, H, sms) else " full"
                    key = f"{path} D={D}"
                    paths[key] = paths.get(key, 0) + 1
                    n += 1
    print(f"vision kernel: {n} random inputs (f32 and bf16, S in 1..1024, "
          f"D in {SWEEP_HEAD_DIMS}, causal, window, GQA) match the plain "
          f"version, max abs err {err}; largest error as a share of the "
          f"tolerance: f32 {share[torch.float32]}, bf16 "
          f"{share[torch.bfloat16]}; inputs per variant and head width "
          f"{paths}", flush=True)
    want = {f"{p} D={D}" for D in SWEEP_HEAD_DIMS
            for p in ("f32_regtile", "tma_wgmma split", "tma_wgmma full")
            if p == "f32_regtile" or D in fa_mod.WGMMA_HEAD_DIMS}
    want.add("mma_sync D=32")
    if set(paths) != want:
        fail(f"the flash sweep's variants and paths {sorted(paths)} are not "
             f"{sorted(want)}")
    # the window every layer of a language model without a sliding window
    # passes (transformer.NO_WINDOW, 1 << 30) on causal GQA as Granite's
    # prefill gives it: the output without a window, bit for bit
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(1, 1100, h, 64, generator=gen).to(
            device=dev, dtype=dt) for h in (24, 8, 8))
        e, _ = check_flash(q, k, v, True, transformer.NO_WINDOW)
        err = max(err, e)
        a = fa_mod.flash_attention(q, k, v, causal=True,
                                   window=transformer.NO_WINDOW)
        if not torch.equal(a, fa_mod.flash_attention(q, k, v, causal=True)):
            fail(f"flash_attention with window 1 << 30 differs from no "
                 f"window ({dt})")
    # and at Granite's 32k prefill, where the band is the causal triangle
    dgen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(1, 32768, h, 64, generator=dgen, device=dev,
                           dtype=torch.bfloat16) for h in (24, 8, 8))
    if not torch.equal(fa_mod.flash_attention(q, k, v, causal=True,
                                              window=transformer.NO_WINDOW),
                       fa_mod.flash_attention(q, k, v, causal=True)):
        fail("flash_attention with window 1 << 30 differs from no window at "
             "(1, 32768, 24 / 8, 64)")
    print("vision kernel: causal GQA (1, 1100, 24 / 8, 64) with window "
          "1 << 30 equals no window bit for bit, f32 and bf16; so does "
          "(1, 32768, 24 / 8, 64) in bf16", flush=True)
    return err


def golden_images():
    """The generator's images: per resolution, (2, res, res, 3) f32."""
    rng = np.random.default_rng(1)
    return {r: rng.random((2, r, r, 3), dtype=np.float32) for r in (224, 384)}


def serving_frames(spec, dev):
    """Each class's frame: the first golden image at its ``model_res``."""
    imgs = golden_images()
    return [torch.from_numpy(imgs[c["model_res"]][0]).to(dev)
            for c in spec["classes"]]


def warm_up(run_batch, frames, spec):
    """Every batch size the engine can form, at each class: an eager step
    chooses its algorithms, a graphed one captures its graph (the largest
    batch first, so the smaller graphs' captures reuse its blocks of the
    shared pool)."""
    for f in frames:
        for b in range(spec["max_batch"], 0, -1):
            run_batch("warmup", [f] * b)
    torch.cuda.synchronize()


def serving_run(label, spec, queue, run_batch, frames, cfg, dev):
    """One run of the golden stream through a fresh engine; its decisions
    held to the JAX engine's.  Returns the run's record and wall time."""
    t0 = time.time()
    got = serve.record_run(spec, queue, run_batch, frames, device=dev)
    torch.cuda.synchronize()
    wall = time.time() - t0
    want = spec["runs"][queue]
    for k in ("stats", "classes", "done_at", "forwards", "replica",
              "batches"):
        if got[k] != want[k]:
            fail(f"serving {label} {queue}: {k} differs from the JAX "
                 f"engine's")
    if any(not isinstance(r, int) or not 0 <= r < cfg.n_classes
           for r in got["results"]):
        fail(f"serving {label} {queue}: a frame got no class")
    print(f"serving {label} {queue}: {spec['requests']} frames, {wall:.3f} "
          f"s, {spec['requests'] / wall:.1f} frames/s, stats "
          f"{got['stats']}; decisions equal the JAX engine's", flush=True)
    return got, wall


def capture_rows(step):
    """Each captured graph: input shape, warm-up and capture time, the
    device memory the capture reserved, flash_attention launches in it."""
    return [dict(shape=list(shape), capture_s=g.capture_s,
                 reserved_bytes=g.reserved_bytes,
                 flash_attention=g.flash_launches)
            for (shape, _, _), g in step.graphs.items()]


def print_captures(name, step, dev):
    rows = capture_rows(step)
    for r in rows:
        print(f"vision {name} graph {tuple(r['shape'])}: warm-up and capture "
              f"{r['capture_s'] * 1e3:.1f} ms, reserved "
              f"{r['reserved_bytes'] / 2 ** 20:.1f} MiB, "
              f"{r['flash_attention']} flash_attention launches captured",
              flush=True)
    print(f"vision {name}: {len(rows)} graphs in one pool, captured in "
          f"{sum(r['capture_s'] for r in rows):.2f} s, reserving "
          f"{sum(r['reserved_bytes'] for r in rows) / 2 ** 20:.1f} MiB; "
          f"device memory reserved in all "
          f"{torch.cuda.memory_reserved(dev) / 2 ** 20:.1f} MiB", flush=True)


def graph_equals_eager(name, mod, params, cfg, step, spec, served, dev):
    """For every (class, batch size) served: the graph's logits equal the
    eager step's on the same (fresh, seeded) frames, bit for bit."""
    res = {c["name"]: c["model_res"] for c in spec["classes"]}
    gen = torch.Generator().manual_seed(7)
    worst = 0.0
    for cls, b in sorted(served):
        r = res[cls]
        x = torch.rand(b, r, r, 3, generator=gen).to(dev)
        want = mod.serve_step(params, x, cfg)
        got = step(x).clone()
        diff = float((got - want).abs().max())
        worst = max(worst, diff)
        if not torch.equal(got, want):
            fail(f"{name} {cls} batch {b}: graphed logits differ from the "
                 f"eager step's by up to {diff}")
    print(f"vision {name}: graphed logits equal the eager step's bit for bit "
          f"at every (class, batch size) served: {sorted(served)}",
          flush=True)


def profiled(fn, cpu: bool = True):
    """One call of ``fn`` under torch.profiler: its wall time, the device's
    busy time (its own entries: kernels, copies, fills), and each device
    entry's count and time by name.  Now and then the profiler records no
    device entry at all for a window (late in a long process); such a
    window is profiled again, up to ``PROFILE_TRIES`` times in all, and a
    window with any device entry is taken as it is.  ``cpu=False`` traces
    the device alone (a train step's ~10^5 host ops take the profiler
    tens of seconds to digest)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU] if cpu else []
    for tries in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=activities + [ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        ka = prof.key_averages()
        on_dev = [e for e in ka if e.device_type == DeviceType.CUDA]
        if on_dev:
            break
    key = device_time_key(ka) if ka else "self_device_time_total"
    return dict(wall_us=wall_us, tries=tries,
                busy_us=sum(getattr(e, key) for e in on_dev),
                device_counts={e.key: e.count for e in on_dev},
                device_us={e.key: getattr(e, key) for e in on_dev})


def profiled_replay(step, frame, b):
    x = torch.stack([frame] * b)
    step(x)
    return profiled(lambda: step(x))


def wall_ms(fn, reps=3) -> float:
    """The best of ``reps`` host-clock times of ``fn`` (which returns host
    values, so each call ends when the device's work does)."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def step_table(name, eager_rb, graphed_rb, spec, frames):
    """Eager against graphed step times at each class and batch size 1
    and 8 (2 and 4 cut for the time budget; PERF.md keeps their earlier
    rows): wall (in turns, eager, graphed, graphed, eager), then one call
    of each profiled: device busy and idle share (the profiler slows the
    host, so a profiled idle share is an upper bound)."""
    rows = []
    for c, frame in zip(spec["classes"], frames):
        for b in (1, 8):
            calls = {m: (lambda rb=rb: rb(c["name"], [frame] * b))
                     for m, rb in (("eager", eager_rb),
                                   ("graphed", graphed_rb))}
            row = dict(model=name, cls=c["name"], res=c["model_res"], b=b)
            row["eager_ms"], row["graphed_ms"] = in_turns(
                lambda: wall_ms(calls["eager"]),
                lambda: wall_ms(calls["graphed"]))
            for m, fn in calls.items():
                p = profiled(fn)
                row[m + "_busy_ms"] = p["busy_us"] / 1e3
                row[m + "_profiled_ms"] = p["wall_us"] / 1e3
                row[m + "_idle"] = 1.0 - p["busy_us"] / p["wall_us"]
                # the same busy time against the unprofiled wall
                row[m + "_idle_unprofiled"] = max(
                    0.0, 1.0 - row[m + "_busy_ms"] / row[m + "_ms"])
            rows.append(row)
            print(f"vision step {name} {c['name']} ({c['model_res']} px) "
                  f"batch {b}: wall eager {row['eager_ms']:.3f} ms, graphed "
                  f"{row['graphed_ms']:.3f} ms "
                  f"(x{row['eager_ms'] / row['graphed_ms']:.2f}); "
                  f"device busy eager {row['eager_busy_ms']:.3f} ms (idle "
                  f"{row['eager_idle']:.3f} of {row['eager_profiled_ms']:.3f}"
                  f" ms profiled), graphed {row['graphed_busy_ms']:.3f} ms "
                  f"(idle {row['graphed_idle']:.3f} of "
                  f"{row['graphed_profiled_ms']:.3f} ms); idle against the "
                  f"unprofiled wall: eager {row['eager_idle_unprofiled']:.3f},"
                  f" graphed {row['graphed_idle_unprofiled']:.3f}", flush=True)
    return rows


def logits_check(tree, vgold, dev):
    """DeiT-B at full width against the JAX reference's logits."""
    for dt in ("float32", "bfloat16"):
        cfg = dataclasses.replace(deit_b.CONFIG, attn_impl="pallas",
                                  param_dtype=dt)
        params = vit.params_from_numpy(tree, cfg, dev)
        for res, img in golden_images().items():
            want = np.asarray(vgold["logits"][str(res)][dt], np.float32)
            fa_mod.flash_attention.launches = 0
            got = vit.forward(params, torch.from_numpy(img).to(dev), cfg)
            n_launch = fa_mod.flash_attention.launches
            got = got.cpu().numpy()
            err = float(np.abs(got - want).max())
            S = cfg.n_tokens(res)
            expect = cfg.n_layers if S > cfg.attn_chunk else 0
            print(f"vision DeiT-B {dt} {res} px ({S} tokens): max abs err "
                  f"{err} against the JAX logits (atol {LOGIT_ATOL[dt]}), "
                  f"{n_launch} flash_attention launches", flush=True)
            if not np.isfinite(got).all() or got.shape != want.shape:
                fail(f"DeiT-B {dt} {res}: logits {got.shape} not finite "
                     f"or not {want.shape}")
            if err > LOGIT_ATOL[dt]:
                fail(f"DeiT-B {dt} {res}: logits {err} from the reference")
            if dt == "float32" and not np.array_equal(got.argmax(-1),
                                                      want.argmax(-1)):
                fail(f"DeiT-B {dt} {res}: argmax differs")
            if n_launch != expect:
                fail(f"DeiT-B {dt} {res}: {n_launch} flash_attention "
                     f"launches, expected {expect}")


def symmetric_pool(x):
    """The planted fault: the 3x3/2 max pool padded (1, 1) as PyTorch pads
    it, where XLA's SAME pads an even side (0, 1)."""
    return torch.nn.functional.max_pool2d(x, 3, 2, padding=1)


def resnet_forward(params, x, cfg, pool=None, tf32=False):
    """``resnet.forward``, with its max pool replaced by ``pool`` if given,
    and with cuDNN's TF32 on for an f32 forward if ``tf32``."""
    real_pool, real_exact = resnet._max_pool, resnet._exact_f32
    old = torch.backends.cudnn.allow_tf32
    resnet._max_pool = pool or real_pool
    if tf32:
        resnet._exact_f32 = lambda dtype: contextlib.nullcontext()
        torch.backends.cudnn.allow_tf32 = True
    try:
        return resnet.forward(params, x, cfg)
    finally:
        resnet._max_pool, resnet._exact_f32 = real_pool, real_exact
        torch.backends.cudnn.allow_tf32 = old


def resnet_logits_check(tree, rgold, dev) -> dict:
    """ResNet-50 at full width against the JAX reference's logits, f32
    (TF32 off) and bf16, at 224 and 384 px; each tolerance shown to reject
    the forward with the pool padded (1, 1) and, in f32, the forward with
    TF32 on."""
    out = {}
    for dt in ("float32", "bfloat16"):
        cfg = dataclasses.replace(resnet50.CONFIG, param_dtype=dt)
        params = resnet.params_from_numpy(tree, cfg, dev)
        for res, img in golden_images().items():
            tol = RESNET_LOGIT_ATOL[dt, res]
            want = np.asarray(rgold["logits"][str(res)][dt], np.float32)
            x = torch.from_numpy(img).to(dev)
            got = resnet_forward(params, x, cfg).cpu().numpy()
            faults = {"the pool padded (1, 1)": resnet_forward(
                params, x, cfg, symmetric_pool).cpu().numpy()}
            if dt == "float32":
                faults["TF32 on"] = resnet_forward(
                    params, x, cfg, tf32=True).cpu().numpy()
            err = float(np.abs(got - want).max())
            rms = float(np.sqrt(((got - want) ** 2).mean()))
            row = out[f"{dt} {res}"] = dict(max_abs_err=err, rms_err=rms,
                                            atol=tol)
            print(f"vision ResNet-50 {dt} {res} px: max abs err {err} (rms "
                  f"{rms}) against the JAX logits (atol {tol})", flush=True)
            if not np.isfinite(got).all() or got.shape != want.shape:
                fail(f"ResNet-50 {dt} {res}: logits {got.shape} not finite "
                     f"or not {want.shape}")
            if err > tol:
                fail(f"ResNet-50 {dt} {res}: logits {err} from the reference")
            if dt == "float32" and not np.array_equal(got.argmax(-1),
                                                      want.argmax(-1)):
                fail(f"ResNet-50 {dt} {res}: argmax differs")
            for fault, bad in faults.items():
                bad_err = float(np.abs(bad - want).max())
                bad_rms = float(np.sqrt(((bad - want) ** 2).mean()))
                row[fault] = dict(max_abs_err=bad_err, rms_err=bad_rms)
                print(f"vision ResNet-50 {dt} {res} px, {fault}: max abs err "
                      f"{bad_err} (rms {bad_rms}), "
                      f"{'rejected' if bad_err > tol else 'NOT rejected'}",
                      flush=True)
                if bad_err <= tol:
                    fail(f"ResNet-50 {dt} {res}: the tolerance {tol} passes "
                         f"a forward with {fault} ({bad_err})")
    return out


def resnet_phase(vgold, spec, frames, dev) -> dict:
    """ResNet-50 at full width: its logits against the JAX reference's, then
    three bf16 replicas serving the golden stream eagerly and through the
    graphed step, decisions and each frame's class held to the golden's;
    graphed against eager logits; step times; the graphs' capture cost."""
    rgold = vgold["resnet"]
    tree = resnet.numpy_params(resnet50.CONFIG, rgold["weight_seed"])
    out = dict(logits=resnet_logits_check(tree, rgold, dev))
    cfg = resnet50.CONFIG
    params = resnet.params_from_numpy(tree, cfg, dev)
    del tree
    # each class's frame alone (a batch of copies has its statistics)
    # against the golden's, and the class each served frame must get
    # where the golden's top-1 / top-2 margin exceeds the tolerance
    expect, out["classes"] = frame_classes(
        "ResNet-50", lambda f: resnet.forward(params, f[None], cfg)[0],
        rgold, spec, frames, RESNET_FRAME_ATOL)
    walls, served_shapes = {}, set()
    eager_rb = serve.make_run_batch(params, cfg, graphed=False)
    graphed_rb = serve.make_run_batch(params, cfg)
    step = graphed_rb.step
    warm_up(eager_rb, frames, spec)
    warm_up(graphed_rb, frames, spec)
    print_captures("ResNet-50", step, dev)
    for mode, rb in (("eager", eager_rb), ("graphed", graphed_rb)):
        for queue in ("preferential", "fifo"):
            step.reset_counts()
            got, walls[f"{mode} {queue}"] = serving_run(
                f"ResNet-50 {mode}", spec, queue, rb, frames, cfg, dev)
            served_class_check("ResNet-50", mode, queue, got, spec, expect)
            if mode == "graphed":
                served_shapes.update((c, b) for _, c, b in got["batches"])
                if step.launches() or not sum(
                        g.replays for g in step.graphs.values()):
                    fail("ResNet-50 graphed: no replay, or a flash_attention "
                         "launch")
    graph_equals_eager("ResNet-50", resnet, params, cfg, step, spec,
                       served_shapes, dev)
    out["serving_wall_s"] = walls
    out["steps"] = step_table("ResNet-50", eager_rb, graphed_rb, spec, frames)
    out["captures"] = capture_rows(step)
    return out


def bound(bytes_ms, ops_ms):
    """The least time, the larger of the two, and which one it is."""
    return max(bytes_ms, ops_ms), \
        "bytes" if bytes_ms >= ops_ms else "operations"


def flash_bound_ms(B, S, H, KV, D, itemsize):
    """Least time for one call: 4*B*H*S^2*D FLOPs at the dtype's peak (bf16
    on the tensor cores; f32 outside them, since TF32 would round the
    inputs), or q, k, v read once and out written once at the HBM rate,
    whichever is larger."""
    peak = BF16_FLOP_PER_S if itemsize == 2 else F32_FLOP_PER_S
    ops_ms = 4 * B * H * S * S * D / peak * 1e3
    bytes_ms = B * S * (2 * H + 2 * KV) * D * itemsize / HBM_BYTES_PER_S * 1e3
    return bound(bytes_ms, ops_ms)


def batch_breakdown(params, cfg, frame, b=8):
    """Device time of one eager forward of ``b`` frames by kind of kernel:
    flash_attention, matrix products (cuBLAS), the rest."""
    x = torch.stack([frame] * b)
    vit.forward(params, x, cfg)
    p = profiled(lambda: vit.forward(params, x, cfg))
    return p["wall_us"], device_kinds(p["device_us"])


def device_kinds(device_us) -> dict:
    """Device time by kind of kernel: the flash kernel, matrix products
    (cuBLAS GEMMs and cuDNN convolutions), and the rest (elementwise,
    norms, copies, a plain attention's softmax)."""
    kinds = {"flash_attention": 0.0, "matmul": 0.0, "other": 0.0}
    for name, us in device_us.items():
        name = name.lower()
        kind = ("flash_attention" if "flash_attention" in name else
                "matmul" if any(s in name for s in (
                    "gemm", "xmma", "cutlass", "nvjet", "matmul", "conv",
                    "fprop")) else "other")
        kinds[kind] += us
    return kinds


def flash_times(q, k, v, reps=100) -> dict:
    """Graph-replayed times of the kernel, its plain version and SDPA (the
    yardstick) on one non-causal input, with the bound."""
    B, S, H, D = q.shape
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    kind = fa_mod.variant(q, k, v)
    row = dict(B=B, S=S, H=H, D=D, dtype=str(q.dtype)[6:], variant=kind,
               split=fa_mod.split_keys(B, S, H, sms)
               if kind == "tma_wgmma" else None,
               ms=graph_ms(lambda: fa_mod.flash_attention(
                   q, k, v, causal=False), reps),
               plain_ms=graph_ms(lambda: ref.flash_attention_ref(
                   q, k, v, causal=False), reps // 2),
               library_ms=graph_ms(lambda: sdpa(qt, kt, vt), reps))
    row["ratio"] = row["ms"] / row["library_ms"]
    row["bound_ms"], row["bound_by"] = flash_bound_ms(
        B, S, H, k.shape[2], D, q.element_size())
    return row


def print_flash_row(label, row):
    print(f"vision kernel time {label} B={row['B']} S={row['S']} "
          f"H={row['H']} D={row['D']} {row['dtype']} ({row['variant']}, "
          f"split keys {row['split']}): {row['ms'] * 1e3:.2f} us, plain "
          f"{row['plain_ms'] * 1e3:.2f} us, SDPA "
          f"{row['library_ms'] * 1e3:.2f} us, kernel / SDPA "
          f"{row['ratio']:.3f}, bound {row['bound_ms'] * 1e3:.2f} us "
          f"({row['bound_by']})", flush=True)


def served_class_check(name, mode, queue, got, spec, expect):
    """Each served frame's class against ``expect`` (class name -> the
    golden's class, for the classes whose golden top-1 margin exceeds the
    frame tolerance)."""
    wrong = [i for i, (c, r) in enumerate(zip(got["classes"],
                                              got["results"]))
             if spec["classes"][c]["name"] in expect
             and r != expect[spec["classes"][c]["name"]]]
    held = sum(spec["classes"][c]["name"] in expect for c in got["classes"])
    given = sorted(collections.Counter(got["results"]).items())
    print(f"serving {name} {mode} {queue}: {held} frames held to their "
          f"class's JAX class, {len(wrong)} differ; classes given (class, "
          f"frames): {given}", flush=True)
    if wrong:
        fail(f"serving {name} {mode} {queue}: frames {wrong} got another "
             f"class than the JAX logits give")


def frame_classes(name, forward_one, gold, spec, frames, tol):
    """Each class's frame alone, bf16, against the golden's logits within
    ``tol``; returns the class each served frame must get where the
    golden's top-1 / top-2 margin exceeds ``tol``, and the readings."""
    expect, out = {}, {}
    for c, f in zip(spec["classes"], frames):
        want = np.asarray(gold["classes"][c["name"]]["logits"], np.float32)
        got = forward_one(f).cpu().numpy()
        top2 = np.sort(want)[-2:]
        margin = float(top2[1] - top2[0])
        err = float(np.abs(got - want).max())
        out[c["name"]] = dict(max_abs_err=err, margin=margin,
                              golden_class=int(want.argmax()),
                              class_=int(got.argmax()))
        if margin > tol:
            expect[c["name"]] = int(want.argmax())
        print(f"vision {name} {c['name']} frame ({c['model_res']} px, bf16, "
              f"alone): max abs err {err} against the JAX logits, class "
              f"{int(got.argmax())} (JAX {int(want.argmax())}, top-1 margin "
              f"{margin}: {'held' if margin > tol else 'not held'} to it at "
              f"atol {tol})", flush=True)
        if not np.isfinite(got).all() or err > tol:
            fail(f"{name} {c['name']} frame: logits {err} from the "
                 f"reference")
    return expect, out


def vit_serving(name, params, cfg, spec, frames, dev, expect=None) -> dict:
    """The serving path of one bf16 ViT at full width: three replicas behind
    the engine serve the golden stream with the preferential queue and with
    FIFO, first stepping eagerly (the wrapper's launches counted from 0,
    the kernel's input of each batch size served kept), then replaying one
    CUDA graph per (class, batch size) (captured launches x replays; the
    wrapper's count stays 0).  Each run's decisions are the golden's and
    its kernel launches n_layers x its 384-px batches; each frame's class
    is ``expect``'s where given.  Then graphed logits equal eager ones bit
    for bit, a profiled replay of the 384-px batch of 8 shows n_layers
    tma_wgmma kernels of the model's head width on the device, and the
    kept inputs match the plain version (elementwise, and by rms error
    against the f32 plain version within ``RMS_RATIO``)."""
    D = cfg.d_model // cfg.n_heads
    on_kernel = {c["name"] for c in spec["classes"]
                 if cfg.n_tokens(c["model_res"]) > cfg.attn_chunk}
    eager_rb = serve.make_run_batch(params, cfg, graphed=False)
    warm_up(eager_rb, frames, spec)
    seen = set()

    def keep(i, args):                 # one input per batch size served
        b = args[0].shape[0]
        if b in seen:
            return False
        seen.add(b)
        return True

    launches, kept, kernel_batches, walls = {}, [], {}, {}
    for queue in ("preferential", "fifo"):
        with Spy(ops, "flash_attention", keep) as spy:
            fa_mod.flash_attention.launches = 0
            got, walls["eager " + queue] = serving_run(
                f"{name} eager", spec, queue, eager_rb, frames, cfg, dev)
            n_launch = fa_mod.flash_attention.launches
        kept += spy.kept
        n_kb = sum(1 for _, c, _ in got["batches"] if c in on_kernel)
        launches["eager " + queue], kernel_batches[queue] = n_launch, n_kb
        print(f"serving {name} eager {queue}: {n_kb} batches at 384 px, "
              f"{n_launch} flash_attention launches", flush=True)
        if n_launch != cfg.n_layers * n_kb or n_launch == 0:
            fail(f"serving {name} {queue}: {n_launch} flash_attention "
                 f"launches for {n_kb} batches at 384 px of {cfg.n_layers} "
                 f"layers")
        if expect is not None:
            served_class_check(name, "eager", queue, got, spec, expect)

    graphed_rb = serve.make_run_batch(params, cfg)
    step = graphed_rb.step
    warm_up(graphed_rb, frames, spec)
    print_captures(name, step, dev)
    served_shapes = set()
    for queue in ("preferential", "fifo"):
        step.reset_counts()
        fa_mod.flash_attention.launches = 0
        got, walls[queue] = serving_run(f"{name} graphed", spec, queue,
                                        graphed_rb, frames, cfg, dev)
        n_launch, eager_launches = (step.launches(),
                                    fa_mod.flash_attention.launches)
        n_kb = sum(1 for _, c, _ in got["batches"] if c in on_kernel)
        launches[queue] = n_launch
        served_shapes.update((c, b) for _, c, b in got["batches"])
        print(f"serving {name} graphed {queue}: {n_kb} batches at 384 px, "
              f"{n_launch} flash_attention launches replayed (captured "
              f"launches x replays), {eager_launches} through the wrapper",
              flush=True)
        if n_launch != cfg.n_layers * n_kb or n_launch == 0 \
                or eager_launches:
            fail(f"serving {name} graphed {queue}: {n_launch} "
                 f"flash_attention launches replayed and {eager_launches} "
                 f"eager for {n_kb} batches at 384 px of {cfg.n_layers} "
                 f"layers")
        if expect is not None:
            served_class_check(name, "graphed", queue, got, spec, expect)
    graph_equals_eager(name, vit, params, cfg, step, spec, served_shapes,
                       dev)
    replay = profiled_replay(step, frames[0], spec["max_batch"])
    flash = {n: c for n, c in replay["device_counts"].items()
             if "flash_attention" in n.lower()}
    n_replayed = sum(flash.values())
    print(f"vision {name} graph replay at 384 px, batch of "
          f"{spec['max_batch']} (profiled): {replay['wall_us']:.0f} us "
          f"wall, device busy {replay['busy_us']:.0f} us, {n_replayed} "
          f"flash_attention kernels on the device {flash} (profiler "
          f"windows: {replay['tries']})", flush=True)
    if n_replayed != cfg.n_layers or not all(
            "flash_attention_wgmma_kernel" in n and f", {D}, false>" in n
            for n in flash):
        fail(f"a profiled {name} replay shows {flash}, expected "
             f"{cfg.n_layers} tma_wgmma kernels of width {D} without the "
             f"band")

    sizes = sorted(args[0].shape[0] for args, _ in kept)
    served = sorted({s for q in spec["runs"].values()
                     for _, c, s in q["batches"] if c in on_kernel})
    if sizes != served:
        fail(f"{name}: kept batch sizes {sizes} are not the served {served}")
    max_err, share = 0.0, 0.0
    for (q, k, v), kw in kept:
        if fa_mod.variant(q, k, v) != "tma_wgmma":
            fail(f"{name}: served q {tuple(q.shape)} takes "
                 f"{fa_mod.variant(q, k, v)}")
        e, sh = check_flash(q, k, v, kw.get("causal", True), kw.get("window"))
        max_err, share = max(max_err, e), max(share, sh)
        got, plain, dropped = flash_rms_errors(q, k, v)
        print(f"vision kernel: {name} served q {tuple(q.shape)}: largest "
              f"error {sh} of the tolerance; rms error against the f32 "
              f"plain version: kernel {got}, plain bf16 {plain}, plain bf16 "
              f"without the last key {dropped}", flush=True)
        if not got <= RMS_RATIO * plain:
            fail(f"flash_attention rms error {got} above {RMS_RATIO} x the "
                 f"plain bf16 version's {plain} at q {tuple(q.shape)}")
        if not dropped > RMS_RATIO * plain:
            fail(f"the rms check passes a kernel that drops the last key "
                 f"at q {tuple(q.shape)}")
    print(f"vision kernel: {name}'s inputs of every batch size served match "
          f"the plain version, largest error {share} of the tolerance; max "
          f"abs err {max_err}", flush=True)
    return dict(launches=launches["preferential"] + launches["fifo"],
                launches_by_run=launches, batches_at_384=kernel_batches,
                serving_wall_s=walls, replay_flash_kernels=n_replayed,
                max_abs_err=max_err, kept=kept, eager_rb=eager_rb,
                graphed_rb=graphed_rb)


def report_breakdown(name, wall_us, kinds):
    total = sum(kinds.values())
    print(f"vision {name} batch of 8 at 384 px (profiled): {wall_us:.0f} us "
          f"wall, device {total:.0f} us: " + ", ".join(
              f"{k} {v:.0f} us ({v / total:.3f})" for k, v in kinds.items()),
          flush=True)
    return dict(wall_us=wall_us, device_us=total, **{
        k + "_us": v for k, v in kinds.items()})


@contextlib.contextmanager
def patched(module, name, fn):
    """``module.name`` replaced by ``fn`` inside the block."""
    real = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, real)


def transposed_grid(resize):
    """``vit._interp_pos_embed`` with the resized grid's rows and columns
    swapped (a planted fault)."""
    def resized(pos, n_extra, grid_from, grid_to):
        out = resize(pos, n_extra, grid_from, grid_to)
        grid = out[n_extra:].reshape(grid_to, grid_to, -1).transpose(0, 1)
        return torch.cat([out[:n_extra], grid.reshape(out[n_extra:].shape)])
    return resized


def h14_faults(cfg):
    """The planted faults of the ViT-H/14 logits check: name -> (the sides
    (image px) it reaches, the dtypes whose limits must reject it, a
    context that plants it or None, the config to run).  f32 must reject
    every fault; bf16, whose logits sit ~0.04 from the reference's by
    rounding alone, the last layer skipped and the ragged last key tile
    dropped (by its rms error); the kernel-level checks hold a single
    dropped key in bf16."""
    D = cfg.d_model // cfg.n_heads
    real_attention, real_resize = attn_mod.attention, vit._interp_pos_embed

    def padded_scale(q, k, v, **kw):     # scores scaled by 128^-0.5
        return real_attention(q * (D / 128) ** 0.5, k, v, **kw)

    def dropped(keys):
        def attention(q, k, v, causal=True, window=None, **kw):
            n = keys(k.shape[1])
            return ref.flash_attention_ref(q, k[:, :n], v[:, :n],
                                           causal=causal, window=window)
        return attention

    short = dataclasses.replace(cfg, n_layers=cfg.n_layers - 1)
    both, f32 = ("float32", "bfloat16"), ("float32",)
    return {
        "the last layer skipped": ((224, 384), both, None, short),
        "the kernel drops the ragged last key tile": (
            (384,), both, lambda: patched(ops, "flash_attention", dropped(
                lambda S: S // 64 * 64)), cfg),
        "the kernel drops the last key": (
            (384,), f32, lambda: patched(ops, "flash_attention", dropped(
                lambda S: S - 1)), cfg),
        "scores scaled by 128^-0.5 (the padded width)": (
            (224, 384), f32,
            lambda: patched(attn_mod, "attention", padded_scale), cfg),
        "the pos-embed resized with rows and columns swapped": (
            (384,), f32,
            lambda: patched(vit, "_interp_pos_embed",
                            transposed_grid(real_resize)), cfg),
    }


def vit_h14_logits_check(tree, hgold, dev) -> dict:
    """ViT-H/14 at full width against the JAX reference's logits, f32 and
    bf16, at 224 px (257 tokens, the naive path, no launch) and 384 px (730
    tokens, 32 launches), within ``VIT_H14_LOGIT_ATOL`` and
    ``VIT_H14_LOGIT_RMS`` (by dtype and side); the limits shown to reject
    the planted faults that reach their side and that their dtype must
    reject (``h14_faults``).  bf16 rows also give the rms error against
    the reference's f32 logits."""
    out = {}
    for dt in ("float32", "bfloat16"):
        cfg = dataclasses.replace(vit_h14.CONFIG, attn_impl="pallas",
                                  param_dtype=dt)
        params = vit.params_from_numpy(tree, cfg, dev)
        faults = h14_faults(cfg)
        for res, img in golden_images().items():
            tol = VIT_H14_LOGIT_ATOL[dt, res]
            rms_tol = VIT_H14_LOGIT_RMS[dt, res]
            want = np.asarray(hgold["logits"][str(res)][dt], np.float32)
            truth = np.asarray(hgold["logits"][str(res)]["float32"],
                               np.float32)

            def errors(a):
                """max, rms against the reference; rms against its f32"""
                return (float(np.abs(a - want).max()),
                        float(np.sqrt(((a - want) ** 2).mean())),
                        float(np.sqrt(((a - truth) ** 2).mean())))

            x = torch.from_numpy(img).to(dev)
            fa_mod.flash_attention.launches = 0
            got = vit.forward(params, x, cfg)
            n_launch = fa_mod.flash_attention.launches
            got = got.cpu().numpy()
            err, rms, rms_f32 = errors(got)
            S = cfg.n_tokens(res)
            expect = cfg.n_layers if S > cfg.attn_chunk else 0
            row = out[f"{dt} {res}"] = dict(
                max_abs_err=err, rms_err=rms, rms_err_f32=rms_f32, atol=tol,
                rms_tol=rms_tol, launches=n_launch)
            print(f"vision ViT-H/14 {dt} {res} px ({S} tokens): max abs err "
                  f"{err}, rms {rms} against the JAX logits (atol {tol}, rms "
                  f"{rms_tol}); rms {rms_f32} against its f32 logits; "
                  f"{n_launch} flash_attention launches", flush=True)
            if not np.isfinite(got).all() or got.shape != want.shape:
                fail(f"ViT-H/14 {dt} {res}: logits {got.shape} not finite "
                     f"or not {want.shape}")
            if err > tol or rms > rms_tol:
                fail(f"ViT-H/14 {dt} {res}: logits {err} (rms {rms}) from "
                     f"the reference")
            if dt == "float32" and not np.array_equal(got.argmax(-1),
                                                      want.argmax(-1)):
                fail(f"ViT-H/14 {dt} {res}: argmax differs")
            if n_launch != expect:
                fail(f"ViT-H/14 {dt} {res}: {n_launch} flash_attention "
                     f"launches, expected {expect}")
            for fault, (sides, must, plant, fcfg) in faults.items():
                if res not in sides:
                    continue
                with plant() if plant else contextlib.nullcontext():
                    bad = vit.forward(params, x, fcfg).cpu().numpy()
                bad_err, bad_rms, bad_f32 = errors(bad)
                row[fault] = dict(max_abs_err=bad_err, rms_err=bad_rms,
                                  rms_err_f32=bad_f32)
                caught = bad_err > tol or bad_rms > rms_tol
                need = "" if dt in must else f" (not required in {dt})"
                print(f"vision ViT-H/14 {dt} {res} px, {fault}: max abs err "
                      f"{bad_err}, rms {bad_rms} (against f32 {bad_f32}), "
                      f"{'rejected' if caught else 'NOT rejected'}{need}",
                      flush=True)
                if not caught and dt in must:
                    fail(f"ViT-H/14 {dt} {res}: the limits {tol} / {rms_tol} "
                         f"pass a forward where {fault} ({bad_err} / "
                         f"{bad_rms})")
        del params
    return out


def vit_h14_phase(vgold, spec, frames, dev) -> dict:
    """ViT-H/14 at full width (32 layers, d 1280, 16 heads 80 wide): its
    logits against the JAX reference's, each class's frame alone, then
    three bf16 replicas serving the golden stream eagerly and graphed
    (``vit_serving``), the kernel's time at each batch size served and at
    (8, 730, 16, 80), where a 384-px batch of 8's device time goes, the
    step times and the graphs' capture cost."""
    t0 = time.time()
    hgold = vgold["vit_h14"]
    tree = host_tree(vit.numpy_params, vit_h14.CONFIG, hgold["weight_seed"])
    print(f"vision weights: ViT-H/14 seed {hgold['weight_seed']}, ready "
          f"in {time.time() - t0:.1f} s (drawn on the host beside phase 3)",
          flush=True)
    out = dict(logits=vit_h14_logits_check(tree, hgold, dev))
    cfg = dataclasses.replace(vit_h14.CONFIG, attn_impl="pallas")
    params = vit.params_from_numpy(tree, cfg, dev)
    del tree
    expect, out["classes"] = frame_classes(
        "ViT-H/14", lambda f: vit.forward(params, f[None], cfg)[0], hgold,
        spec, frames, VIT_H14_FRAME_ATOL)
    served = vit_serving("ViT-H/14", params, cfg, spec, frames, dev, expect)
    eager_rb, graphed_rb = served.pop("eager_rb"), served.pop("graphed_rb")
    rows = []
    for (q, k, v), _ in sorted(served.pop("kept"),
                               key=lambda a: a[0][0].shape[0]):
        rows.append(flash_times(q, k, v))
        print_flash_row("ViT-H/14 served bf16", rows[-1])
    B, S, H, D = 8, cfg.n_tokens(384), cfg.n_heads, cfg.d_model // cfg.n_heads
    gen = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(B, S, H, D, generator=gen).to(
        device=dev, dtype=torch.bfloat16) for _ in range(3))
    fault = flash_rejects_dropped_key(q, k, v)
    print(f"vision kernel: ViT-H/14 at B={B}, random inputs, a kernel that "
          f"drops the last key errs by {fault} of the tolerance and is "
          f"rejected", flush=True)
    headline = flash_times(q, k, v)
    rows.append(headline)
    print_flash_row("ViT-H/14 bf16", headline)
    del q, k, v
    out["breakdown"] = report_breakdown(
        "ViT-H/14", *batch_breakdown(params, cfg, frames[0]))
    share = out["breakdown"]["flash_attention_us"] / \
        out["breakdown"]["device_us"]
    for cls, frame in zip(serve.service_classes(spec), frames):
        measure_step_times(graphed_rb, cls, frame)
        print(f"vision ViT-H/14 step times {cls.name} ({frame.shape[0]} px), "
              f"graph replays, wall s per batch size: "
              f"{cls.batch_proc_time}", flush=True)
    out["steps"] = step_table("ViT-H/14", eager_rb, graphed_rb, spec, frames)
    out["captures"] = capture_rows(graphed_rb.step)
    out.update(served, headline=headline, shapes=rows,
               flash_share_of_batch=share)
    print(f"vision ViT-H/14: {time.time() - t0:.1f} s", flush=True)
    return out


def vision_phase(dev):
    """Phase 4; returns the ``flash_attention`` entry of the kernels line."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(VIT_GOLDEN) as f:
        vgold = json.load(f)
    max_err = flash_sweep(dev)

    t0 = time.time()
    tree = vit.numpy_params(deit_b.CONFIG, vgold["weight_seed"])
    print(f"vision weights: DeiT-B seed {vgold['weight_seed']}, "
          f"{time.time() - t0:.1f} s", flush=True)
    logits_check(tree, vgold, dev)

    # the main path: bf16 DeiT-B at full width behind the serving engine,
    # first stepping eagerly (the before numbers, and the kernel's served
    # inputs kept), then replaying one CUDA graph per (class, batch size)
    cfg = dataclasses.replace(deit_b.CONFIG, attn_impl="pallas")
    params = vit.params_from_numpy(tree, cfg, dev)
    del tree
    spec = vgold["serving"]
    frames = serving_frames(spec, dev)
    deit = vit_serving("DeiT-B", params, cfg, spec, frames, dev)
    max_err = max(max_err, deit["max_abs_err"])
    eager_rb, graphed_rb = deit.pop("eager_rb"), deit.pop("graphed_rb")

    # the kernel's time at each batch size served, on its kept input, and
    # at the engine's largest batch (max_batch 8) on random inputs
    rows = []
    for (q, k, v), _ in sorted(deit.pop("kept"),
                               key=lambda a: a[0][0].shape[0]):
        rows.append(flash_times(q, k, v))
        print_flash_row("served bf16", rows[-1])
    B, S, H, D = 8, cfg.n_tokens(384), cfg.n_heads, cfg.d_model // cfg.n_heads
    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(B, S, H, D, generator=gen).to(
        device=dev, dtype=torch.bfloat16) for _ in range(3))
    fault = flash_rejects_dropped_key(q, k, v)
    print(f"vision kernel: at B={B}, random inputs, a kernel that drops the "
          f"last key errs by {fault} of the tolerance and is rejected",
          flush=True)
    row = flash_times(q, k, v)
    row["ms_eager"] = timed_ms(lambda: fa_mod.flash_attention(
        q, k, v, causal=False), 100)
    rows.append(row)
    print_flash_row("bf16", row)
    print(f"vision kernel time B={B}: eager {row['ms_eager'] * 1e3:.2f} us",
          flush=True)
    # the f32 kernel (the f32 logits check's) at B=1 and at B=8
    for qf, kf, vf in ((x[:1].float() for x in (q, k, v)),
                       (x.float() for x in (q, k, v))):
        rows.append(flash_times(qf, kf, vf, reps=20))
        print_flash_row("f32", rows[-1])
    f32_row = rows[-1]
    # heads 80 wide (ViT-H/14's 16, configs/vit_h14.py) at DeiT-B's
    # sequence and at ViT-H/14's own 730 tokens, and 72 wide (DiT-XL/2's
    # 16 at 512 px, 1,024 tokens, at B=8; phase 4g times its own shapes):
    # tma_wgmma, checked, then timed
    for label, (S_, D_) in (("ViT-H/14 heads", (578, 80)),
                            ("ViT-H/14", (730, 80)),
                            ("DiT-XL/2 heads", (1024, 72))):
        q, k, v = (torch.randn(B, S_, 16, D_, generator=gen).to(
            device=dev, dtype=torch.bfloat16) for _ in range(3))
        if fa_mod.variant(q, k, v) != "tma_wgmma":
            fail(f"D={D_} bf16 takes {fa_mod.variant(q, k, v)}, not "
                 f"tma_wgmma")
        e, _ = check_flash(q, k, v, False, None)
        max_err = max(max_err, e)
        rows.append(flash_times(q, k, v))
        print_flash_row(f"bf16 {label}", rows[-1])
    # the mma_sync variant, on what it still takes: a view of ViT-H/14's
    # heads at (8, 578, 16, 80) one element off 16-byte alignment
    n = B * 578 * 16 * 80
    buf = torch.randn(3 * n + 1, generator=gen).to(dev, torch.bfloat16)
    q, k, v = (buf[1 + i * n:1 + (i + 1) * n].view(B, 578, 16, 80)
               for i in range(3))
    if fa_mod.variant(q, k, v) != "mma_sync":
        fail(f"a misaligned D=80 view takes {fa_mod.variant(q, k, v)}, not "
             f"mma_sync")
    e, _ = check_flash(q, k, v, False, None)
    max_err = max(max_err, e)
    mma_row = flash_times(q, k, v)
    rows.append(mma_row)
    print_flash_row("bf16 misaligned ViT-H/14 heads", mma_row)
    del q, k, v, buf

    wall_us, kinds = batch_breakdown(params, cfg, frames[0])
    report_breakdown("DeiT-B", wall_us, kinds)
    for cls, frame in zip(serve.service_classes(spec), frames):
        measure_step_times(graphed_rb, cls, frame)
        print(f"vision step times {cls.name} ({frame.shape[0]} px), graph "
              f"replays, wall s per batch size: {cls.batch_proc_time}",
              flush=True)
    steps = {"DeiT-B": step_table("DeiT-B", eager_rb, graphed_rb, spec,
                                  frames)}
    captures = {"DeiT-B": capture_rows(graphed_rb.step)}
    del eager_rb, graphed_rb, params
    resnet_out = resnet_phase(vgold, spec, frames, dev)
    steps["ResNet-50"] = resnet_out.pop("steps")
    captures["ResNet-50"] = resnet_out.pop("captures")
    h14 = vit_h14_phase(vgold, spec, frames, dev)
    steps["ViT-H/14"] = h14.pop("steps")
    captures["ViT-H/14"] = h14.pop("captures")
    max_err = max(max_err, h14["max_abs_err"])

    def entry(r, launches, **more):
        return dict(launches=launches, max_abs_err=max_err, ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"],
                    variant=r["variant"], D=r["D"], ratio=r["ratio"], **more)

    # one entry a variant: DeiT-B's D = 64 and ViT-H/14's D = 80 are on
    # the main path (graph replays); mma_sync and f32_regtile are on no
    # served path; D = 72 (DiT-XL/2) is phase 4g's
    return {
        "flash_attention": entry(
            row, deit["launches"], launches_by_run=deit["launches_by_run"],
            batches_at_384=deit["batches_at_384"],
            serving_wall_s=deit["serving_wall_s"],
            replay_flash_kernels=deit["replay_flash_kernels"], shapes=rows,
            step_times=steps, captures=captures, resnet=resnet_out),
        "flash_attention (tma_wgmma, D=80)": entry(
            h14["headline"], h14["launches"], vit_h14=h14),
        "flash_attention (mma_sync)": entry(mma_row, 0),
        "flash_attention (f32_regtile)": entry(f32_row, 0),
    }


# ---------------------------------------------------------------------------
# phase 4g: the diffusion serve step (DiT-XL/2 on the D=72 flash kernel, the
# SD 1.5 UNet)
# ---------------------------------------------------------------------------
def diffusion_golden():
    """The golden arrays by key, and the JSON meta entry."""
    with np.load(DIFFUSION_GOLDEN) as f:
        g = {k: f[k] for k in f.files}
    return g, json.loads(str(g.pop("meta")))


@contextlib.contextmanager
def gate_one(params, d):
    """Each layer's attention gate g1 replaced by 1: its adaLN columns 0 and
    their bias 1 (restored after)."""
    lay = params["layers"]
    cols = slice(2 * d, 3 * d)
    saved = lay["adaln"][..., cols].clone(), lay["adaln_b"][..., cols].clone()
    lay["adaln"][..., cols] = 0
    lay["adaln_b"][..., cols] = 1
    try:
        yield
    finally:
        lay["adaln"][..., cols], lay["adaln_b"][..., cols] = saved


def dit_faults(cfg, params):
    """The planted faults of the DiT-XL/2 golden check: name -> (the sides
    (image px) it reaches, the dtypes whose limits must reject it, a
    context that plants it or None, the config to run)."""
    real_temb, real_resize = (model_common.timestep_embedding,
                              vit._interp_pos_embed)
    real_modulate = dit._modulate

    def swapped_temb(t, dim, max_period=10_000.0):
        e = real_temb(t, dim, max_period)
        return torch.cat([e[:, dim // 2:], e[:, :dim // 2]], dim=-1)

    def no_transpose(out, gh, p):
        return out.reshape(out.shape[0], gh * p, gh * p, -1)

    short = dataclasses.replace(cfg, n_layers=cfg.n_layers - 1)
    both, f32 = ("float32", "bfloat16"), ("float32",)
    return {
        "the last layer skipped": ((256, 512), both, None, short),
        "gate g1 replaced by 1": (
            (256, 512), both, lambda: gate_one(params, cfg.d_model), cfg),
        "shift and scale swapped in _modulate": (
            (256, 512), both, lambda: patched(
                dit, "_modulate", lambda x, sh, sc: real_modulate(x, sc, sh)),
            cfg),
        "cos and sin swapped in timestep_embedding": (
            (256, 512), both,
            lambda: patched(model_common, "timestep_embedding", swapped_temb),
            cfg),
        "unpatchify without its transpose": (
            (256, 512), both, lambda: patched(dit, "_unpatchify",
                                              no_transpose), cfg),
        "the pos-embed resized with its grid transposed": (
            (512,), f32, lambda: patched(vit, "_interp_pos_embed",
                                         transposed_grid(real_resize)), cfg),
    }


def unet_faults(cfg):
    """The planted faults of the UNet golden check, as ``dit_faults``."""
    real_conv, real_pops = unet._conv, unet._pop_skips
    real_norm = model_common.group_norm

    def symmetric_downsample(x, w, stride=1):
        if stride == 1:
            return real_conv(x, w, stride)
        return torch.nn.functional.conv2d(
            x.permute(0, 3, 1, 2), w, stride=stride,
            padding=w.shape[-1] // 2).permute(0, 2, 3, 1)

    def swapped_pops(skips, n):
        out = real_pops(skips, n)
        return [out[1], out[0]] + out[2:]

    def eps_1e6(x, scale, bias, groups=32, eps=1e-5):
        return real_norm(x, scale, bias, groups, 1e-6)

    both = ("float32", "bfloat16")
    return {
        "the stride-2 downsample padded (1, 1)": (
            (64,), both, lambda: patched(unet, "_conv", symmetric_downsample),
            cfg),
        "the skip stack popped in the wrong order": (
            (64,), ("float32",),
            lambda: patched(unet, "_pop_skips", swapped_pops), cfg),
        "group_norm with eps 1e-6": (
            (64,), ("float32",),
            lambda: patched(model_common, "group_norm", eps_1e6), cfg),
    }


def golden_check(name, mod, params, cfg, g, section, side, dt, args, faults,
                 atol, rms_tol, dev, launches):
    """One golden output: the port's ``serve_step`` on the golden's inputs
    against the reference's within ``atol`` / ``rms_tol`` (with
    ``launches`` flash_attention launches), then each planted fault that
    reaches ``side`` (rejected where its dtype must).  Returns the row."""
    want = g[f"{section}/{side}/{dt}"]
    inputs = [torch.from_numpy(g[f"{section}/{side}/{a}"]).to(dev)
              for a in args]

    def errors(a):
        return (float(np.abs(a - want).max()),
                float(np.sqrt(((a - want) ** 2).mean())))

    fa_mod.flash_attention.launches = 0
    got = mod.serve_step(params, *inputs, cfg)
    n_launch = fa_mod.flash_attention.launches
    got = got.float().cpu().numpy()
    err, rms = errors(got)
    row = dict(max_abs_err=err, rms_err=rms, atol=atol, rms_tol=rms_tol,
               launches=n_launch, out_rms=float(np.sqrt((want ** 2).mean())))
    print(f"diffusion {name} {dt} {side}: max abs err {err}, rms {rms} "
          f"against the JAX output (atol {atol}, rms {rms_tol}; output rms "
          f"{row['out_rms']:.4f}); {n_launch} flash_attention launches",
          flush=True)
    if not np.isfinite(got).all() or got.shape != want.shape:
        fail(f"{name} {dt} {side}: output {got.shape} not finite or not "
             f"{want.shape}")
    if err > atol or rms > rms_tol:
        fail(f"{name} {dt} {side}: {err} (rms {rms}) from the reference")
    if n_launch != launches:
        fail(f"{name} {dt} {side}: {n_launch} flash_attention launches, "
             f"expected {launches}")
    for fault, (sides, must, plant, fcfg) in faults.items():
        if side not in sides:
            continue
        with plant() if plant else contextlib.nullcontext():
            bad = mod.serve_step(params, *inputs, fcfg).float().cpu().numpy()
        bad_err, bad_rms = errors(bad)
        row[fault] = dict(max_abs_err=bad_err, rms_err=bad_rms)
        caught = bad_err > atol or bad_rms > rms_tol
        need = "" if dt in must else f" (not required in {dt})"
        print(f"diffusion {name} {dt} {side}, {fault}: max abs err "
              f"{bad_err}, rms {bad_rms}, "
              f"{'rejected' if caught else 'NOT rejected'}{need}", flush=True)
        if not caught and dt in must:
            fail(f"{name} {dt} {side}: the limits {atol} / {rms_tol} pass a "
                 f"forward where {fault} ({bad_err} / {bad_rms})")
    return row


def dit_golden_check(tree, g, dev) -> dict:
    """DiT-XL/2 at full width against the golden outputs, f32 and bf16, at
    256 px (256 tokens, naive, no launch) and 512 px (1,024 tokens, one
    flash_attention launch a layer)."""
    out = {}
    for dt in ("float32", "bfloat16"):
        cfg = dataclasses.replace(dit_xl2.CONFIG, attn_impl="pallas",
                                  param_dtype=dt)
        params = dit.params_from_numpy(tree, cfg, dev)
        faults = dit_faults(cfg, params)
        for side in (256, 512):
            S = cfg.n_tokens(side)
            out[f"{dt} {side}"] = golden_check(
                "DiT-XL/2", dit, params, cfg, g, "dit", side, dt,
                ("latents", "t", "y"), faults, DIT_ATOL[dt, side],
                DIT_RMS[dt, side], dev,
                cfg.n_layers if S > cfg.attn_chunk else 0)
        del params, faults
    return out


def unet_golden_check(tree, g, dev) -> dict:
    """The SD 1.5 UNet at full width against the golden outputs, f32 (TF32
    off), at its latent 64.  (Its bf16 golden was cut for the time budget:
    bf16 must reject only the padded downsample, which f32 rejects too;
    ``tests/test_torch_gpu.py::test_unet_on_gpu_matches_cpu`` holds the
    bf16 UNet on the card against the CPU.)"""
    dt = "float32"
    cfg = dataclasses.replace(unet_sd15.CONFIG, param_dtype=dt)
    params = unet.params_from_numpy(tree, cfg, dev)
    side = cfg.latent_res
    return {f"{dt} {side}": golden_check(
        "UNet", unet, params, cfg, g, "unet", side, dt,
        ("latents", "t", "ctx"), unet_faults(cfg), UNET_ATOL, UNET_RMS,
        dev, 0)}


def step_inputs(family, cfg, shape, dev, seed):
    """Seeded inputs of one serve step at a DIFFUSION_SHAPES entry: latents
    (B, px/8, px/8, 4), timesteps, and DiT's labels (the last the
    class-dropout label) or the UNet's context stub."""
    gen = torch.Generator().manual_seed(seed)
    B, lat = shape.global_batch, shape.img_res // 8
    x = torch.randn(B, lat, lat, 4, generator=gen)
    t = torch.randint(0, 1000, (B,), generator=gen)
    if family == "dit":
        c = torch.randint(0, cfg.n_classes, (B,), generator=gen)
        c[-1] = cfg.n_classes
    else:
        c = torch.randn(B, cfg.ctx_len, cfg.ctx_dim, generator=gen)
    return [a.to(dev) for a in (x, t, c)]


def events_ms(fn, reps=3) -> float:
    """The best of ``reps`` calls' times between CUDA events recorded
    before and after each (an eager step: the device's span from its first
    kernel's enqueue to its last's end)."""
    best = float("inf")
    for _ in range(reps):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        best = min(best, t0.elapsed_time(t1))
    return best


def step_row(name, shape, fn):
    """One serve step timed (CUDA events, best of 3) and profiled once:
    wall, device busy and idle share, device time by kind."""
    ms = events_ms(fn)
    p = profiled(fn)
    kinds = device_kinds(p["device_us"])
    busy = p["busy_us"] / 1e3
    row = dict(model=name, shape=shape.name, B=shape.global_batch,
               px=shape.img_res, ms=ms, busy_ms=busy,
               profiled_ms=p["wall_us"] / 1e3,
               idle=max(0.0, 1.0 - busy / ms),
               idle_profiled=1.0 - p["busy_us"] / p["wall_us"],
               **{k + "_ms": v / 1e3 for k, v in kinds.items()},
               device_counts=p["device_counts"])
    top = sorted(p["device_us"].items(), key=lambda kv: -kv[1])[:4]
    row["top_kernels_ms"] = {k[:90]: v / 1e3 for k, v in top}
    total = sum(kinds.values())
    print(f"diffusion step {name} {shape.name} (B={shape.global_batch}, "
          f"{shape.img_res} px): {ms:.3f} ms a step (CUDA events, best of "
          f"3); device busy {busy:.3f} ms, idle {row['idle']:.3f} (profiled "
          f"{row['idle_profiled']:.3f} of {row['profiled_ms']:.3f} ms); "
          f"device time by kind: " + ", ".join(
              f"{k} {v / 1e3:.3f} ms ({v / total:.3f})"
              for k, v in kinds.items()) + "; the largest device entries: "
          + "; ".join(f"{k} {v:.3f} ms"
                      for k, v in row["top_kernels_ms"].items()), flush=True)
    return row


def dit_steps(tree, dev):
    """DiT-XL/2's bf16 serve step at gen_fast and gen_1024 through the
    flash kernel: the main path (launch count from 0, 28 a step, one kept
    input a shape), held against the plain path (``chunked``) on the same
    inputs, timed and profiled (28 tma_wgmma kernels of width 72 on the
    device); the kept inputs against the kernel's plain version."""
    cfg = dataclasses.replace(dit_xl2.CONFIG, attn_impl="pallas")
    plain_cfg = dataclasses.replace(cfg, attn_impl="chunked")
    params = dit.params_from_numpy(tree, cfg, dev)
    D = cfg.d_model // cfg.n_heads
    shapes = [DIFFUSION_SHAPES[n] for n in ("gen_fast", "gen_1024")]
    inputs = {s.name: step_inputs("dit", cfg, s, dev, i)
              for i, s in enumerate(shapes)}
    for s in shapes:                                   # warm-up, uncounted
        dit.serve_step(params, *inputs[s.name], cfg)
    torch.cuda.synchronize()

    # the main path: one step at each shape, the counts from 0
    by_run, outs = {}, {}
    with Spy(ops, "flash_attention",                   # each step's first
             lambda i, args: i % cfg.n_layers == 0) as spy:
        fa_mod.flash_attention.launches = 0
        for s in shapes:
            before = fa_mod.flash_attention.launches
            outs[s.name] = dit.serve_step(params, *inputs[s.name], cfg)
            torch.cuda.synchronize()
            by_run[s.name] = fa_mod.flash_attention.launches - before
    print(f"diffusion DiT-XL/2 main path (bf16, attn_impl 'pallas'): "
          f"flash_attention launches {by_run}", flush=True)
    if any(n != cfg.n_layers for n in by_run.values()):
        fail(f"DiT-XL/2 steps launched {by_run}, expected {cfg.n_layers} "
             f"a step")
    out = dict(launches=sum(by_run.values()), launches_by_run=by_run,
               steps=[], plain=[], kernel_inputs=[])
    for s in shapes:
        got = outs.pop(s.name).float()
        want = dit.serve_step(params, *inputs[s.name], plain_cfg).float()
        rel = float((got - want).pow(2).mean().sqrt()
                    / want.pow(2).mean().sqrt())
        err = float((got - want).abs().max())
        print(f"diffusion DiT-XL/2 {s.name}: the kernel step against the "
              f"plain step (chunked): max abs err {err}, rms {rel} of the "
              f"output's (limit {DIT_STEP_REL_RMS})", flush=True)
        if not torch.isfinite(got).all() or not rel <= DIT_STEP_REL_RMS:
            fail(f"DiT-XL/2 {s.name}: kernel step {rel} (rms, relative) "
                 f"from the plain step")
        out["plain"].append(dict(shape=s.name, max_abs_err=err, rel_rms=rel))
        del got, want
        row = step_row("DiT-XL/2", s, lambda s=s: dit.serve_step(
            params, *inputs[s.name], cfg))
        flash = {n: c for n, c in row["device_counts"].items()
                 if "flash_attention" in n.lower()}
        row["flash_kernels"] = flash
        if sum(flash.values()) != cfg.n_layers or not all(
                "flash_attention_wgmma_kernel" in n and f", {D}, false>" in n
                for n in flash):
            fail(f"a profiled DiT-XL/2 {s.name} step shows {flash}, expected "
                 f"{cfg.n_layers} tma_wgmma kernels of width {D} without the "
                 f"band")
        row["flash_share"] = row["flash_attention_ms"] / row["busy_ms"]
        # the plain step is no longer timed (cut in PR 25 for the time
        # budget; PR 23's times are in PERF.md), only checked above
        print(f"diffusion DiT-XL/2 {s.name}: {sum(flash.values())} "
              f"flash_attention kernels on the device {flash}; flash share of "
              f"the device time {row['flash_share']:.3f}", flush=True)
        del row["device_counts"]
        out["steps"].append(row)
    # the kernel on the inputs the model gave it, against its plain version
    max_err = 0.0
    for (q, k, v), kw in spy.kept:
        if fa_mod.variant(q, k, v) != "tma_wgmma":
            fail(f"DiT-XL/2: q {tuple(q.shape)} takes "
                 f"{fa_mod.variant(q, k, v)}")
        e, sh = check_flash(q, k, v, kw.get("causal", True), kw.get("window"))
        got, plain, dropped = flash_rms_errors(q, k, v)
        max_err = max(max_err, e)
        out["kernel_inputs"].append(dict(
            shape=list(q.shape), max_abs_err=e, tolerance_share=sh,
            rms=got, plain_rms=plain, dropped_key_rms=dropped))
        print(f"diffusion kernel: DiT-XL/2 q {tuple(q.shape)}: largest error "
              f"{sh} of the tolerance; rms error against the f32 plain "
              f"version: kernel {got}, plain bf16 {plain}, plain bf16 "
              f"without the last key {dropped}", flush=True)
        if not got <= RMS_RATIO * plain:
            fail(f"flash_attention rms error {got} above {RMS_RATIO} x the "
                 f"plain bf16 version's {plain} at q {tuple(q.shape)}")
        if not dropped > RMS_RATIO * plain:
            fail(f"the rms check passes a kernel that drops the last key "
                 f"at q {tuple(q.shape)}")
    if len(spy.kept) != len(shapes):
        fail(f"DiT-XL/2: {len(spy.kept)} kernel inputs kept, expected "
             f"{len(shapes)}")
    out["max_abs_err"] = max_err
    return out


def unet_steps(tree, dev):
    """The UNet's bf16 serve step at gen_fast and gen_1024 (no kernel on
    its path: the reference's chunked and naive attention), each checked;
    gen_fast timed and profiled (gen_1024 is not timed, for the time
    budget: PERF.md keeps its earlier time)."""
    cfg = unet_sd15.CONFIG
    params = unet.params_from_numpy(tree, cfg, dev)
    rows = []
    for i, name in enumerate(("gen_fast", "gen_1024")):
        s = DIFFUSION_SHAPES[name]
        args = step_inputs("unet", cfg, s, dev, 10 + i)
        fa_mod.flash_attention.launches = 0
        got = unet.serve_step(params, *args, cfg)
        if not torch.isfinite(got).all() or fa_mod.flash_attention.launches \
                or got.shape != args[0].shape:
            fail(f"UNet {name}: output {tuple(got.shape)} not finite or not "
                 f"the latents' shape, or a flash_attention launch")
        if name == "gen_1024":
            continue
        row = step_row("UNet", s, lambda: unet.serve_step(params, *args, cfg))
        del row["device_counts"]
        rows.append(row)
    return rows


def diffusion_phase(dev) -> dict:
    """Phase 4g; returns the ``flash_attention (tma_wgmma, D=72)`` entry of
    the kernels line."""
    t_phase = time.time()
    g, meta = diffusion_golden()
    t0 = time.time()
    dit_tree = host_tree(dit.numpy_params, dit_xl2.CONFIG,
                         meta["weight_seed"], meta["constant_std"])
    unet_tree = host_tree(unet.numpy_params, unet_sd15.CONFIG,
                          meta["weight_seed"], meta["constant_std"])
    n = {k: sum(int(np.prod(d.shape)) for d in mod.param_defs(c).values())
         for k, mod, c in (("dit", dit, dit_xl2.CONFIG),
                           ("unet", unet, unet_sd15.CONFIG))}
    print(f"diffusion weights: DiT-XL/2 {n['dit']:,} and UNet "
          f"{n['unet']:,} parameters, seed {meta['weight_seed']}, every leaf "
          f"random (constants' std {meta['constant_std']}), ready in "
          f"{time.time() - t0:.1f} s (drawn on the host beside phase 3)",
          flush=True)
    if n != {k: meta["sections"][k]["n_params"] for k in n}:
        fail(f"parameter counts {n} are not the golden's")
    out = dict(golden=dict(dit=dit_golden_check(dit_tree, g, dev),
                           unet=unet_golden_check(unet_tree, g, dev)))
    print(f"diffusion golden checks: {time.time() - t_phase:.1f} s",
          flush=True)
    steps = dit_steps(dit_tree, dev)
    del dit_tree
    steps["steps"] += unet_steps(unet_tree, dev)
    del unet_tree
    print(f"diffusion steps: {time.time() - t_phase:.1f} s", flush=True)

    # the kernel at DiT-XL/2's two serve shapes, random inputs
    rows = []
    gen = torch.Generator().manual_seed(3)
    for B, S in ((16, 1024), (4, 4096)):
        q, k, v = (torch.randn(B, S, 16, 72, generator=gen).to(
            device=dev, dtype=torch.bfloat16) for _ in range(3))
        e, _ = check_flash(q, k, v, False, None)
        steps["max_abs_err"] = max(steps["max_abs_err"], e)
        rows.append(flash_times(q, k, v, reps=20))
        print_flash_row("DiT-XL/2 bf16", rows[-1])
        del q, k, v
    top = rows[0]
    print(f"diffusion phase: {time.time() - t_phase:.1f} s", flush=True)
    return {"flash_attention (tma_wgmma, D=72)": dict(
        launches=steps.pop("launches"), max_abs_err=steps.pop("max_abs_err"),
        ms=top["ms"], plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
        bound_by=top["bound_by"], library_ms=top["library_ms"],
        variant=top["variant"], D=top["D"], ratio=top["ratio"], shapes=rows,
        dit_xl2=dict(out, **steps))}


# ---------------------------------------------------------------------------
# phase 4h: the language-model serve path (Granite-3.0 MoE: prefill and
# decode through flash_attention, rmsnorm and moe_gemm)
# ---------------------------------------------------------------------------
# Granite-3.0 MoE at full width, 2 of its 32 layers, against the JAX
# reference's outputs in tests/data/torch_lm_golden.npz (batch 2, 1,100-token
# prompts into a 1,104-slot cache, 4 decode steps; every weight leaf random;
# logits up to |4.7|, K / V rows ~1), by dtype: each output (the prefill's
# last logits, the steps' logits, the aux loss, the layer-0 K / V rows at 3
# positions) held by its largest error and its rms error.  f32 with TF32
# off: max 1.4e-5 on the logits and 6.2e-5 on the K rows (RoPE at
# positions up to 1,103: PyTorch's and XLA's f32 pow give frequencies an
# ulp apart, and the angle multiplies that; the port on the CPU is as far,
# 6.2e-5), rms 4.8e-6, on an H100; held at 1e-4 / rms 1e-5.  bf16: max
# 0.073, rms 0.0147 on the prefill's last logits (1,606 of 35,200 routed
# copies flip at near-ties against the reference's routing); held at 0.1 /
# rms 0.017.  Every planted fault of granite_faults must fail both: in f32
# the smallest is a flash kernel that drops the last key (rms 0.0128); in
# bf16 the same fault is rms 0.0194, 14% above the limit, the sound run
# 16% below it (on the CPU the port gives 0.0152 and 0.0200).
GRANITE_ATOL = {"float32": 1e-4, "bfloat16": 0.1}
GRANITE_RMS = {"float32": 1e-5, "bfloat16": 0.017}
# the four SMOKE configs in f32 (TF32 off) against their golden entries:
# 2.9e-6 at most on an H100; the CPU tests hold the port there within
# 1e-5 (observed 3.3e-6)
LM_SMOKE_ATOL = 1e-5
# Granite's bf16 prefill at B=1, S=4,096 through the three kernels against
# the plain path (attn_impl "chunked", the plain rmsnorm and moe_gemm),
# routed as the kernel path was (pinned_routing): the rms of the
# difference of the last logits over their rms, 0.0088 on an H100 (left
# to route itself, the plain path would flip 6% of the routed copies)
LM_PREFILL_REL_RMS = 0.015
LM_WEIGHT_SEED = 0
# decode steps on the main path: greedy after the 32k prefill; decode_32k
LM_GREEDY_STEPS, LM_DECODE32K_STEPS, LM_DECODE32K_BATCH = 32, 8, 16
LM_PLAIN_PREFILL = 4096
LM_COUNTERS = {"flash_attention": fa_mod.flash_attention,
               "rmsnorm": rn_mod.rmsnorm, "moe_gemm": mg_mod.moe_gemm}


def lm_golden():
    """The golden arrays by key, and the JSON meta entry."""
    with np.load(LM_GOLDEN) as f:
        g = {k: f[k] for k in f.files}
    return g, json.loads(str(g.pop("meta")))


def granite_golden_config(sec):
    """Granite at the golden section ``sec``'s depth, ``attn_impl="pallas"``
    (the 1,100-token prompts run the flash kernel once a layer)."""
    return dataclasses.replace(granite_moe_3b_a800m.CONFIG,
                               n_layers=sec["n_layers"], attn_impl="pallas")


@functools.lru_cache(maxsize=1)
def golden_tree(cfg, seed: int, constant_std: float):
    """The LM golden's seeded numpy weights (``transformer.numpy_params``),
    drawn once for phases 4h and 4i (390 M values at Granite's cut)."""
    return transformer.numpy_params(cfg, seed, constant_std)


def lm_counts(zero=False) -> dict:
    """The three kernels' launch counts (set to 0 first with ``zero``)."""
    if zero:
        for fn in LM_COUNTERS.values():
            fn.launches = 0
    return {name: fn.launches for name, fn in LM_COUNTERS.items()}


def lm_forward_counts(cfg, S: int) -> dict:
    """Launches of one forward of S tokens a row: flash once a layer past
    ``attn_chunk`` tokens under ``pallas``, rmsnorm twice a layer and once
    at the end, moe_gemm three times a layer."""
    L = cfg.n_layers
    flash = L if cfg.attn_impl == "pallas" and S > cfg.attn_chunk else 0
    return {"flash_attention": flash, "rmsnorm": 2 * L + 1,
            "moe_gemm": 3 * L}


@contextlib.contextmanager
def recorded_routing(n: int, host: bool = True):
    """The experts (T, K) of the first ``n`` ``route_topk`` calls of the
    port's MoE layer, kept on the host (or on the device)."""
    real, seen = lm_moe.route_topk, []

    def recording(logits, top_k, n_real=None):
        gates, experts = real(logits, top_k, n_real)
        if len(seen) < n:
            seen.append(experts.cpu().numpy() if host else experts)
        return gates, experts

    with patched(lm_moe, "route_topk", recording):
        yield seen


@contextlib.contextmanager
def pinned_routing(experts):
    """The port's MoE layer routed as another run was: ``route_topk``'s
    i-th call takes the experts (T, K) ``experts[i]``, with its own gates
    there (its softmax at those experts, normalised as ``route_topk``
    does); ``flips`` counts the routed copies where its own top-k differs.
    In bf16 a router logit that moves by rounding flips near-tied experts,
    and a flip into a full expert drops the last token routed there (the
    prompt's last, whose logits a prefill returns, first): two paths that
    differ only in rounding are compared with one routing.  ``largest``
    is the largest expert id of its own top-k."""
    real, calls = lm_moe.route_topk, dict(i=0, flips=0, largest=0)

    def pinned(logits, top_k, n_real=None):
        _, own = real(logits, top_k, n_real)
        e = experts[calls["i"]]
        calls["i"] += 1
        calls["flips"] += int((own != e).sum())
        calls["largest"] = max(calls["largest"], int(own.max()))
        gates = torch.softmax(logits.float(), dim=-1).gather(1, e.long())
        return gates / torch.clamp(gates.sum(-1, keepdim=True),
                                   min=1e-9), e

    with patched(lm_moe, "route_topk", pinned):
        yield calls


def granite_run(params, cfg, g, sec, dev, check_counts=False):
    """The golden's prefill, decode steps and hidden_states on the card
    (``sec``: the meta entry of the golden's granite section); returns
    each output as f32 numpy, and the routing of the prompts."""
    toks = torch.from_numpy(g["granite/tokens"]).long().to(dev)
    steps = torch.from_numpy(g["granite/decode_tokens"]).long().to(dev)
    S = toks.shape[1]
    with recorded_routing(cfg.n_layers) as routing:
        lm_counts(zero=True)
        last, cache = transformer.prefill(params, toks, cfg, sec["max_len"])
        prefill_counts = lm_counts()
    logits, step_counts = [], []
    for s in steps:
        lm_counts(zero=True)
        out, cache = transformer.decode_step(params, cache, s, cfg)
        step_counts.append(lm_counts())
        logits.append(out)
    _, aux = transformer.hidden_states(params, toks, cfg)
    rows = sec["cache_rows"]
    if check_counts:
        want = lm_forward_counts(cfg, S)
        want1 = dict(lm_forward_counts(cfg, 1), flash_attention=0)
        if prefill_counts != want or any(c != want1 for c in step_counts):
            fail(f"Granite golden run launched {prefill_counts} in its "
                 f"prefill and {step_counts} in its steps, expected {want} "
                 f"and {want1}")
    host = lambda t: t.float().cpu().numpy()
    return dict(prefill_logits=host(last), decode_logits=host(
        torch.stack(logits)), aux=host(aux), k_rows=host(
        cache["k"][0][:, rows]), v_rows=host(cache["v"][0][:, rows])), \
        np.stack(routing)


def granite_faults():
    """The planted faults of the Granite golden check: name -> (the dtypes
    whose limits must reject it, a context that plants it)."""
    real_input, real_layer = transformer._decode_input, \
        transformer._decode_layer
    real_route, real_norm = lm_moe.route_topk, ops.rmsnorm

    def rope_off(params, cache, tokens, cfg):
        pos, h, positions = real_input(params, cache, tokens, cfg)
        return pos, h, positions + 1

    def shifted(h, lp, cfg, positions, k_l, v_l, slot, n_valid, window):
        return real_layer(h, lp, cfg, positions, k_l, v_l,
                          min(slot + 1, k_l.shape[1] - 1), n_valid, window)

    def drop_last_key(q, k, v, *, causal=True, window=None, **kw):
        return ref.flash_attention_ref(q, k[:, :-1], v[:, :-1],
                                       causal=causal, window=window)

    both = ("float32", "bfloat16")
    return {
        "decode's RoPE position off by one": (
            both, lambda: patched(transformer, "_decode_input", rope_off)),
        "the cache written at pos + 1": (
            both, lambda: patched(transformer, "_decode_layer", shifted)),
        "the router masked to 40 experts (the reference's padding fixed)": (
            both, lambda: patched(lm_moe, "route_topk",
                                  lambda lg, k, n_real=None:
                                  real_route(lg, k, 40))),
        "the norm scaled by scale, not 1 + scale": (
            both, lambda: patched(ops, "rmsnorm",
                                  lambda x, s: real_norm(x, s - 1))),
        "a flash kernel that drops the last key": (
            both, lambda: patched(ops, "flash_attention", drop_last_key)),
    }


def lm_errors(got, g, prefix):
    """Largest and rms error of each output against the golden's."""
    out = {}
    for name, a in got.items():
        want = g[prefix + name]
        if a.shape != want.shape or not np.isfinite(a).all():
            fail(f"{prefix}{name}: {a.shape} not finite or not {want.shape}")
        d = a - want
        out[name] = (float(np.abs(d).max()), float(np.sqrt((d ** 2).mean())))
    return out


def granite_golden_check(g, meta, dev) -> dict:
    """Phase 4h a: Granite at full width, depth cut to the golden's layers,
    f32 (TF32 off) and bf16, attn_impl "pallas" (the 1,100-token prefill
    runs the flash kernel once a layer), against the reference's outputs;
    each planted fault rejected where its dtype must; the routing flips."""
    sec = meta["sections"]["granite"]
    base = granite_golden_config(sec)
    t0 = time.time()
    tree = host_tree(golden_tree, base, meta["weight_seed"],
                     meta["constant_std"])
    n = sum(int(np.prod(d.shape))
            for d in transformer.param_defs(base).values())
    print(f"lm golden: Granite-3.0 MoE, {sec['n_layers']} of 32 layers at "
          f"full width, {n:,} parameters (seed {meta['weight_seed']}, every "
          f"leaf random), ready in {time.time() - t0:.1f} s (drawn on the "
          f"host beside phase 3)", flush=True)
    if n != sec["n_params"]:
        fail(f"Granite golden: {n} parameters, the golden's {sec['n_params']}")
    out = {}
    for dt in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, param_dtype=dt)
        params = transformer.params_from_numpy(tree, cfg, dev)
        prefix = f"granite/{dt}/"
        atol, rms_tol = GRANITE_ATOL[dt], GRANITE_RMS[dt]
        got, routing = granite_run(params, cfg, g, sec, dev,
                                   check_counts=True)
        errs = lm_errors(got, g, prefix)
        ok = all(e <= atol and r <= rms_tol for e, r in errs.values())
        want_r = g[prefix + "experts"].astype(np.int64)
        flips = (routing != want_r)
        sets = sum(int((np.sort(a, 1) != np.sort(b, 1)).any(1).sum())
                   for a, b in zip(routing, want_r))
        row = dict(errors=errs, atol=atol, rms_tol=rms_tol,
                   routing_flips=int(flips.sum()),
                   routing_flips_by_layer=flips.sum((1, 2)).tolist(),
                   tokens_with_another_expert_set=sets,
                   routed_copies=int(want_r.size), faults={})
        print(f"lm golden Granite {dt}: " + "; ".join(
            f"{k} max {e:.3g} rms {r:.3g}" for k, (e, r) in errs.items())
            + f" (limits {atol} / rms {rms_tol}); routing flips against the "
            f"reference: {row['routing_flips']} of {want_r.size} routed "
            f"copies (by layer {row['routing_flips_by_layer']}), {sets} "
            f"token-layers with another expert set", flush=True)
        if not ok:
            fail(f"Granite {dt}: outputs {errs} beyond {atol} / {rms_tol}")
        for fault, (must, plant) in granite_faults().items():
            with plant():
                bad, _ = granite_run(params, cfg, g, sec, dev)
            berrs = lm_errors(bad, g, prefix)
            caught = any(e > atol or r > rms_tol for e, r in berrs.values())
            worst = max(berrs.items(), key=lambda kv: kv[1][1] / rms_tol)
            row["faults"][fault] = dict(errors=berrs, rejected=caught)
            need = "" if dt in must else f" (not required in {dt})"
            print(f"lm golden Granite {dt}, {fault}: worst output "
                  f"{worst[0]} max {worst[1][0]:.3g} rms {worst[1][1]:.3g}; "
                  f"{'rejected' if caught else 'NOT rejected'}{need}",
                  flush=True)
            if not caught and dt in must:
                fail(f"Granite {dt}: the limits pass a forward where {fault}")
        out[dt] = row
        del params
    return out


def lm_smoke_check(g, meta, dev) -> float:
    """Phase 4h a: the four SMOKE configs on the card in f32 against their
    golden entries: logits_fn, hidden_states and aux, prefill (last logits
    and the whole cache), the decode steps, and gemma3-smoke's
    decode_step_sliding past its window.  Returns the largest error."""
    sec = meta["sections"]["smoke"]
    worst = 0.0
    for arch in ("granite-moe-3b-a800m", "starcoder2-7b", "gemma3-27b",
                 "kimi-k2-1t-a32b"):
        cfg = dataclasses.replace(get_lm_smoke(arch), param_dtype="float32")
        entry = sec["archs"][cfg.name]
        params = transformer.params_from_numpy(transformer.numpy_params(
            cfg, entry["weight_seed"], meta["constant_std"]), cfg, dev)
        p = f"smoke/{cfg.name}/"
        tok = lambda a: torch.from_numpy(a).long().to(dev)
        got = {"logits": transformer.logits_fn(params, tok(g[p + "tokens"]),
                                                cfg)}
        got["hidden"], got["aux"] = transformer.hidden_states(
            params, tok(g[p + "tokens"]), cfg)
        got["prefill_logits"], cache = transformer.prefill(
            params, tok(g[p + "tokens"]), cfg, sec["max_len"])
        got["k"], got["v"] = cache["k"].clone(), cache["v"].clone()
        logits = []
        for s in g[p + "decode_tokens"]:
            out, cache = transformer.decode_step(params, cache, tok(s), cfg)
            logits.append(out)
        got["decode_logits"] = torch.stack(logits)
        if p + "sliding_tokens" in g:
            cache = transformer.init_sliding_cache(cfg, sec["batch"],
                                                   sec["max_len"], dev)
            logits = []
            for s in g[p + "sliding_tokens"]:
                out, cache = transformer.decode_step_sliding(params, cache,
                                                             tok(s), cfg)
                logits.append(out)
            got["sliding_logits"] = torch.stack(logits)
        errs = lm_errors({k: v.float().cpu().numpy() for k, v in got.items()},
                         g, p)
        err = max(e for e, _ in errs.values())
        worst = max(worst, err)
        print(f"lm golden {cfg.name} f32: largest error {err:.3g} over "
              f"{sorted(errs)} (limit {LM_SMOKE_ATOL})", flush=True)
        if err > LM_SMOKE_ATOL:
            fail(f"{cfg.name}: {errs} beyond {LM_SMOKE_ATOL}")
    return worst


def lm_flash_bound_ms(B, S, H, KV, D, window=None):
    """Causal bf16 attention: 4 B H D products for each (query, key) pair
    the masks keep, S (S + 1) / 2 (the lower triangle), or S W - W (W - 1)
    / 2 under a window W < S (the band), at the bf16 peak; or q, k, v
    read and out written once."""
    pairs = S * (S + 1) / 2 if not window or window >= S else \
        S * window - window * (window - 1) / 2
    ops_ms = 4 * B * H * D * pairs / BF16_FLOP_PER_S * 1e3
    bytes_ms = B * S * (2 * H + 2 * KV) * D * 2 / HBM_BYTES_PER_S * 1e3
    return bound(bytes_ms, ops_ms)


# phase 4h's flash shapes beside Granite's prefill, at its 32,768 tokens on
# random bf16 inputs (seed LM_FLASH_SEED), the ones item 8d's models give
# the kernel: StarCoder2-7B's causal attention (configs/starcoder2_7b.py:
# 36 query heads on 4 KV heads, 128 wide) and Gemma-3 27B's local layers
# (configs/gemma3_27b.py: 32 on 16, 128 wide, a sliding window of 1,024)
LM_FLASH_SHAPES = {"StarCoder2-7B": (36, 4, 128, None),
                   "Gemma-3 27B local": (32, 16, 128, 1024)}
LM_FLASH_SEED = 27
# the band's skip, held on the card: a causal launch within this share of
# the non-causal one on the same inputs (Granite's shape), a windowed one
# (window 1,024) within this share of the causal one (Gemma-3's shape)
LM_CAUSAL_SHARE, LM_WINDOW_SHARE = 0.6, 0.1


def flash_band_work(B, S, H, D, causal, window):
    """The key tiles the tma_wgmma kernel's warpgroups walk, modelled from
    the band (``fa_mod.key_tile_band``, the Python statement of the
    kernel's loop bounds, for each query tile over the B H heads; not
    counted on the card), and the operations of their two products, 4 x
    64 x 64 x D a tile."""
    tiles = B * H * sum(len(fa_mod.key_tile_band(i, fa_mod.ROWS, S, causal,
                                                 window))
                        for i in range(0, S, fa_mod.ROWS))
    return tiles, 4 * fa_mod.ROWS * 64 * D * tiles


def lm_flash_row(model, q, k, v, window) -> dict:
    """One causal flash shape of phase 4h timed: the kernel (CUDA events,
    3 launches), the plain version by blocks of 1,024 query rows, SDPA
    causal on the KV heads repeated, or under a window the faster of
    SDPA's cuDNN and memory-efficient backends with the window as a (S, S)
    bool mask built outside the timed call, and the bound.  The tiles
    walked and the rate on them are modelled from the band and printed,
    not returned."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    row = dict(model=model, B=B, S=S, H=H, KV=KV, D=D, causal=True,
               window=window, variant=fa_mod.variant(q, k, v),
               ms=timed_ms(lambda: fa_mod.flash_attention(
                   q, k, v, causal=True, window=window), 3),
               plain_ms=events_ms(lambda: ref.flash_attention_ref_by_blocks(
                   q, k, v, causal=True, window=window), 1),
               plain="ref.flash_attention_ref by blocks of 1,024 query rows")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (x.repeat_interleave(H // KV, dim=2).transpose(1, 2)
              .contiguous() for x in (k, v))
    if window is None or window >= S:
        row["library_ms"] = timed_ms(lambda: sdpa(qt, kt, vt,
                                                  is_causal=True), 3)
        row["library"] = "scaled_dot_product_attention, is_causal"
    else:
        # the backends that take a mask, each alone (none falls back to
        # the math backend's (B, H, S, S) f32 scores); the faster one is
        # the library call
        from torch.nn.attention import SDPBackend, sdpa_kernel
        mask = ref.flash_attention_mask(S, S, True, window, q.device)
        backends = {"cuDNN": SDPBackend.CUDNN_ATTENTION,
                    "memory-efficient": SDPBackend.EFFICIENT_ATTENTION}
        lib = {}
        for name, backend in backends.items():
            try:
                with sdpa_kernel(backend):
                    lib[name] = timed_ms(
                        lambda: sdpa(qt, kt, vt, attn_mask=mask), 3)
            except RuntimeError as err:
                print(f"lm kernel: SDPA's {name} backend takes no mask "
                      f"here: {err}", flush=True)
        best = min(lib, key=lib.get)
        with sdpa_kernel(backends[best]):
            lib_out = sdpa(qt, kt, vt, attn_mask=mask).transpose(1, 2)
        row["library_ms"] = lib[best]
        row["library_backends_ms"] = lib
        row["library"] = (f"scaled_dot_product_attention ({best} backend), "
                          f"the window as a (S, S) bool attn_mask")
        got = fa_mod.flash_attention(q, k, v, causal=True, window=window)
        print(f"lm kernel: flash_attention {model} window {window}: SDPA "
              f"with the mask " + ", ".join(
                  f"{n} {t:.3f} ms" for n, t in lib.items())
              + f"; {best}'s max abs difference from the kernel "
              f"{float((lib_out.float() - got.float()).abs().max())}",
              flush=True)
        del mask, lib_out, got
    del qt, kt, vt
    row["bound_ms"], row["bound_by"] = lm_flash_bound_ms(B, S, H, KV, D,
                                                         window)
    row["bound_share"] = row["bound_ms"] / row["ms"]
    tiles, flops = flash_band_work(B, S, H, D, True, window)
    print(f"lm kernel: flash_attention {model} (modelled from "
          f"key_tile_band, not counted on the card): {tiles:,} key tiles "
          f"walked, {flops / row['ms'] / 1e9:.1f} TFLOP/s on them",
          flush=True)
    return row


def lm_flash_check(label, q, k, v, window) -> tuple:
    """The kernel against the plain version by blocks of query rows on one
    causal input; returns the max abs error and the share of the
    tolerance."""
    got = fa_mod.flash_attention(q, k, v, causal=True, window=window)
    want = ref.flash_attention_ref_by_blocks(q, k, v, causal=True,
                                             window=window)
    share = tolerance_share(got, want, ref.flash_attention_tolerance(want, v))
    e = float((got.float() - want.float()).abs().max())
    print(f"lm kernel: flash_attention {label} q {tuple(q.shape)} kv heads "
          f"{k.shape[2]} causal window {window} "
          f"({fa_mod.variant(q, k, v)}): max abs err {e}, {share:.3f} of "
          f"the tolerance, by blocks of 1,024 query rows", flush=True)
    if fa_mod.variant(q, k, v) != "tma_wgmma" or not share <= 1.0 or \
            not torch.isfinite(got).all():
        fail(f"flash_attention {label}: {share} of the tolerance, variant "
             f"{fa_mod.variant(q, k, v)}")
    return e, share


def lm_kinds(device_us) -> dict:
    """Device time by kind: the three kernels of the path, other matrix
    products (cuBLAS), the rest."""
    kinds = dict.fromkeys(("flash_attention", "moe_gemm", "rmsnorm",
                           "matmul", "other"), 0.0)
    for name, us in device_us.items():
        n = name.lower()
        kind = next((k for k in ("moe_gemm", "rmsnorm", "flash_attention")
                     if k in n), None) or (
            "matmul" if any(s in n for s in ("gemm", "xmma", "cutlass",
                                             "nvjet", "matmul")) else "other")
        kinds[kind] += us
    return kinds


def lm_profile(name, fn, ms) -> dict:
    """One call of ``fn`` profiled: busy, idle share against ``ms`` (its
    CUDA-event time), device time by kind."""
    p = profiled(fn)
    kinds = lm_kinds(p["device_us"])
    busy = p["busy_us"] / 1e3
    top = sorted(p["device_us"].items(), key=lambda kv: -kv[1])[:6]
    row = dict(ms=ms, busy_ms=busy, idle=max(0.0, 1.0 - busy / ms),
               profiled_ms=p["wall_us"] / 1e3,
               **{k + "_ms": v / 1e3 for k, v in kinds.items()},
               top_kernels_ms={k[:90]: v / 1e3 for k, v in top})
    print(f"lm {name}: {ms:.3f} ms (CUDA events); device busy {busy:.3f} "
          f"ms, idle {row['idle']:.3f}; device time by kind: "
          + ", ".join(f"{k} {v / 1e3:.3f} ms ({v / max(1.0, p['busy_us']):.3f})"
                      for k, v in kinds.items()) + "; the largest device "
          "entries: " + "; ".join(f"{k} {v:.3f} ms" for k, v in
                                  row["top_kernels_ms"].items()), flush=True)
    return row


def moe_gemm_row(label, x, w) -> dict:
    """``moe_gemm`` on inputs kept from a path: against its plain version
    (the ``tma_wgmma`` variant required), then timed beside it, the
    library call and the bound."""
    E, C, d = x.shape
    f = w.shape[2]
    kind = mg_mod.variant(x, w)
    got = mg_mod.moe_gemm(x, w)
    want = ref.moe_gemm_ref(x, w)
    tol = ref.moe_gemm_tolerance(x, w)
    e = check_close(f"moe_gemm {label}", got, want, tol)
    print(f"lm kernel: moe_gemm {label} ({E}, {C}, {d}) x ({E}, {d}, {f}), "
          f"{kind}: max abs err {e}, "
          f"{tolerance_share(got, want, tol):.3f} of the tolerance",
          flush=True)
    del got, want
    if kind != "tma_wgmma":
        fail(f"moe_gemm {label} took {kind}")
    reps = 5 if C > 100 else 100
    row = dict(label=label, E=E, C=C, d=d, f=f, variant=kind,
               ms=graph_ms(lambda: mg_mod.moe_gemm(x, w), reps),
               plain_ms=graph_ms(lambda: ref.moe_gemm_ref(x, w),
                                 max(2, reps // 10)),
               library_ms=graph_ms(lambda: torch.bmm(x, w), reps),
               max_abs_err=e)
    row["bound_ms"], row["bound_by"] = moe_bound_ms(E, C, d, f, 2)
    return row


def kernel_row_lines(rows) -> None:
    """One line a timed kernel row: its time beside its plain version,
    the library call and the bound (``ratio`` set on each row)."""
    for name, rs in rows.items():
        for r in rs:
            lib = r["library_ms"]
            r["ratio"] = None if lib is None else r["ms"] / lib
            shape = ", ".join(f"{k}={v}" for k, v in r.items()
                              if not k.endswith(("ms", "_by", "ratio",
                                                 "err", "plain", "share",
                                                 "library")))
            more = (f", {r['bound_share']:.3f} of the bound"
                    if "bound_share" in r else "")
            print(f"lm kernel time {name} {shape}: {r['ms'] * 1e3:.2f} us, "
                  f"plain {r['plain_ms'] * 1e3:.2f} us, library "
                  + ("none" if lib is None else
                     f"{lib * 1e3:.2f} us, kernel / library "
                     f"{r['ratio']:.3f}")
                  + f", bound {r['bound_ms'] * 1e3:.2f} us "
                  f"({r['bound_by']}){more}", flush=True)


def lm_kernel_rows(kept, dev) -> dict:
    """Phase 4h c-d on the kernel inputs kept from the main path: each
    against its plain version, then timed beside it, the library call and
    the bound."""
    rows = {"flash_attention": [], "flash_attention_d128": [],
            "rmsnorm": [], "moe_gemm": []}
    errs = {}
    # flash, layers 0 and 31 of the 32k prefill
    for layer, ((q, k, v), kw) in zip(kept["layers"], kept["flash"]):
        window = kw.get("window")
        e, _ = lm_flash_check(f"layer {layer}", q, k, v, window)
        errs["flash_attention"] = max(errs.get("flash_attention", 0.0), e)
        if layer:
            continue
        row = lm_flash_row("Granite-3.0 MoE", q, k, v, window)
        # the same inputs without the mask: every key tile of every row
        row["non_causal_ms"] = timed_ms(lambda: fa_mod.flash_attention(
            q, k, v, causal=False), 3)
        row["causal_share"] = row["ms"] / row["non_causal_ms"]
        tiles = [flash_band_work(*q.shape[:3], q.shape[3], c, window)[0]
                 for c in (True, False)]
        print(f"lm kernel: flash_attention causal {row['ms']:.3f} ms "
              f"against {row['non_causal_ms']:.3f} ms non-causal: "
              f"{row['causal_share']:.3f} (limit {LM_CAUSAL_SHARE}); the "
              f"band modelled by key_tile_band: {tiles[0]:,} of "
              f"{tiles[1]:,} key tiles ({tiles[0] / tiles[1]:.3f})",
              flush=True)
        if not row["causal_share"] <= LM_CAUSAL_SHARE:
            fail(f"the causal flash launch takes {row['causal_share']} of "
                 f"the non-causal one")
        rows["flash_attention"].append(row)
    # StarCoder2-7B's and Gemma-3 27B's local attention at 32k (D = 128)
    gen = torch.Generator(device=dev).manual_seed(LM_FLASH_SEED)
    S = kept["flash"][0][0][0].shape[1]
    for model, (H, KV, D, window) in LM_FLASH_SHAPES.items():
        q, k, v = (torch.randn(1, S, h, D, generator=gen, device=dev,
                               dtype=torch.bfloat16) for h in (H, KV, KV))
        e, _ = lm_flash_check(model, q, k, v, window)
        errs["flash_attention_d128"] = max(
            errs.get("flash_attention_d128", 0.0), e)
        row = lm_flash_row(model, q, k, v, window)
        if window is not None:
            row["causal_ms"] = timed_ms(lambda: fa_mod.flash_attention(
                q, k, v, causal=True), 3)
            row["window_share"] = row["ms"] / row["causal_ms"]
            print(f"lm kernel: flash_attention {model} window {window} "
                  f"{row['ms']:.3f} ms against {row['causal_ms']:.3f} ms "
                  f"causal without it: {row['window_share']:.4f} (limit "
                  f"{LM_WINDOW_SHARE})", flush=True)
            if not row["window_share"] <= LM_WINDOW_SHARE:
                fail(f"the windowed flash launch takes "
                     f"{row['window_share']} of the causal one")
        rows["flash_attention_d128"].append(row)
        del q, k, v
    # rmsnorm: the prefill's first norm, decode rows at B = 1 and 16
    lib = torch.nn.functional.rms_norm
    for label, (x, s) in kept["rmsnorm"]:
        x2 = x.reshape(-1, x.shape[-1])
        R, d = x2.shape
        e = check_close(f"rmsnorm {label}", rn_mod.rmsnorm(x2, s),
                        ref.rmsnorm_ref(x2, s),
                        ref.rmsnorm_tolerance(x2.dtype))
        errs["rmsnorm"] = max(errs.get("rmsnorm", 0.0), e)
        weight = (1.0 + s.float()).to(x2.dtype)
        row = dict(label=label, R=R, d=d, dtype=str(x2.dtype)[6:],
                   ms=graph_ms(lambda: rn_mod.rmsnorm(x2, s), 50),
                   plain_ms=graph_ms(lambda: ref.rmsnorm_ref(x2, s), 10),
                   library_ms=graph_ms(lambda: lib(x2, (d,), weight=weight,
                                                   eps=rn_mod.EPS), 50),
                   max_abs_err=e)
        row["bound_ms"], row["bound_by"] = rmsnorm_bound_ms(R, d, 2)
        rows["rmsnorm"].append(row)
    # moe_gemm at the prefill's capacity (gate, down) and decode's C=1, 4
    for label, (x, w) in kept["moe_gemm"]:
        row = moe_gemm_row(label, x, w)
        errs["moe_gemm"] = max(errs.get("moe_gemm", 0.0), row["max_abs_err"])
        rows["moe_gemm"].append(row)
    kernel_row_lines(rows)
    return rows, errs


def lm_main_path(dev) -> dict:
    """Phase 4h b-d: Granite-3.0 MoE at full width and depth, bf16,
    attn_impl "pallas", weights drawn on the card: a 32k-token prefill, 32
    greedy decode steps on its cache, and decode_32k's 8 steps at B=16 on a
    half-full 32,768-slot cache, each run's launches counted from 0; then
    the kept kernel inputs checked and the kernels, the prefill and the
    steps timed."""
    cfg = dataclasses.replace(granite_moe_3b_a800m.CONFIG, attn_impl="pallas")
    L = cfg.n_layers
    t0 = time.time()
    gen = torch.Generator(device=dev).manual_seed(LM_WEIGHT_SEED)
    params = transformer.init_params(cfg, gen, dev)
    torch.cuda.synchronize()
    out = dict(init_s=time.time() - t0,
               n_params=model_common.count_params(params),
               weights_gb=sum(x.numel() * x.element_size() for x in
                              model_common.leaves(params)) / 1e9)
    print(f"lm main path: Granite-3.0 MoE at full width and depth, "
          f"{out['n_params']:,} parameters ({out['weights_gb']:.2f} GB), "
          f"drawn on the card in {out['init_s']:.3f} s", flush=True)
    want_fwd = lm_forward_counts(cfg, LM_SHAPES["prefill_32k"].seq_len)
    want_step = dict(lm_forward_counts(cfg, 1), flash_attention=0)
    finite, kept = [], dict(layers=(0, L - 1), rmsnorm=[], moe_gemm=[])

    # prefill: B = 1, S = 32,768 (prefill_32k's length)
    S = LM_SHAPES["prefill_32k"].seq_len
    max_len = S + LM_GREEDY_STEPS + PROFILE_TRIES   # + the profiled step
    tokens = torch.randint(0, cfg.vocab_size, (1, S), generator=gen,
                           device=dev)
    with Spy(ops, "flash_attention",
             lambda i, a: i in kept["layers"]) as fspy, \
            Spy(ops, "rmsnorm", lambda i, a: i == 0) as rspy, \
            Spy(ops, "moe_gemm", lambda i, a: i in (0, 2)) as mspy:
        t0 = time.time()
        lm_counts(zero=True)
        last, cache = transformer.prefill(params, tokens, cfg, max_len)
        torch.cuda.synchronize()
        counts = lm_counts()
        first_s = time.time() - t0
    finite.append(torch.isfinite(last).all())
    kept["flash"] = fspy.kept
    kept["rmsnorm"].append((f"prefill B=1 S={S}", rspy.kept[0][0]))
    C = mspy.kept[0][0][0].shape[1]
    kept["moe_gemm"] += [(f"gate C={C}", mspy.kept[0][0]),
                         (f"down C={C}", mspy.kept[1][0])]
    out["prefill_launches"] = counts
    print(f"lm main path: prefill B=1 S={S} (max_len {max_len}): launches "
          f"{counts} (expected {want_fwd}); first call {first_s:.2f} s; "
          f"cache {2 * cache['k'].numel() * 2 / 1e9:.2f} GB", flush=True)
    if counts != want_fwd:
        fail(f"the 32k prefill launched {counts}, expected {want_fwd}")

    # greedy decode on the prefill's cache, each step between CUDA events
    tok, steps, greedy, times = last.argmax(-1), [], [], []
    with Spy(ops, "rmsnorm", lambda i, a: i == 0) as rspy, \
            Spy(ops, "moe_gemm", lambda i, a: i == 0) as mspy:
        for _ in range(LM_GREEDY_STEPS):
            lm_counts(zero=True)
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            logits, cache = transformer.decode_step(params, cache, tok, cfg)
            e1.record()
            steps.append(lm_counts())
            finite.append(torch.isfinite(logits).all())
            tok = logits.argmax(-1)
            greedy.append(tok)
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
    kept["rmsnorm"].append(("decode B=1", rspy.kept[0][0]))
    kept["moe_gemm"].append((f"decode C={mspy.kept[0][0][0].shape[1]}",
                             mspy.kept[0][0]))
    out["greedy_tokens"] = torch.cat(greedy).tolist()
    out["decode_launches"] = steps[0]
    print(f"lm main path: {LM_GREEDY_STEPS} greedy decode steps at B=1, "
          f"launches a step {steps[0]} (expected {want_step}); tokens "
          f"{out['greedy_tokens'][:8]}...; CUDA-event times "
          f"{[round(t, 3) for t in times]}", flush=True)
    if any(s != want_step for s in steps):
        fail(f"greedy decode steps launched {steps}, expected {want_step}")

    # times at B = 1: a decode step (the best of the last 3), then the
    # prefill; each profiled once more
    step_fn = lambda: transformer.decode_step(params, cache, tok, cfg)
    out["decode_b1"] = lm_profile(f"decode step B=1 (cache {max_len})",
                                  step_fn, min(times[-3:]))
    out["decode_b1"]["tokens_per_s"] = 1e3 / out["decode_b1"]["ms"]
    del cache
    pre_fn = lambda: transformer.prefill(params, tokens, cfg, max_len)
    out["prefill"] = lm_profile(f"prefill B=1 S={S}", pre_fn,
                                events_ms(pre_fn))
    out["prefill"]["tokens_per_s"] = S / out["prefill"]["ms"] * 1e3

    # the kernel prefill against the plain one at B = 1, S = 4,096, the
    # plain one routed as the kernel one was
    short = tokens[:, :LM_PLAIN_PREFILL]
    with recorded_routing(L, host=False) as routing:
        got, got_cache = transformer.prefill(params, short, cfg)
    with patched(ops, "rmsnorm", ref.rmsnorm_ref), \
            patched(ops, "moe_gemm", ref.moe_gemm_ref), \
            pinned_routing(routing) as calls:
        lm_counts(zero=True)
        want, want_cache = transformer.prefill(
            params, short, dataclasses.replace(cfg, attn_impl="chunked"))
        if any(lm_counts().values()):
            fail(f"the plain prefill launched {lm_counts()}")
    rms = lambda x: float(x.float().pow(2).mean().sqrt())
    rel = rms(got - want) / rms(want)
    out["plain_prefill"] = dict(
        S=LM_PLAIN_PREFILL, rel_rms=rel,
        max_abs_err=float((got - want).abs().max()),
        cache_rel_rms=rms(got_cache["k"] - want_cache["k"])
        / rms(want_cache["k"]), routing_flips=calls["flips"],
        routed_copies=L * LM_PLAIN_PREFILL * cfg.top_k)
    print(f"lm main path: the kernel prefill at S={LM_PLAIN_PREFILL} "
          f"against the plain one (chunked attention, plain rmsnorm and "
          f"moe_gemm, routed as the kernel one): last logits rms {rel:.4g} "
          f"of theirs (limit {LM_PREFILL_REL_RMS}), max abs err "
          f"{out['plain_prefill']['max_abs_err']:.4g}; K cache rms "
          f"{out['plain_prefill']['cache_rel_rms']:.4g} of its own; its own "
          f"routing would differ in {calls['flips']} of "
          f"{out['plain_prefill']['routed_copies']} routed copies",
          flush=True)
    if not torch.isfinite(got).all() or not rel <= LM_PREFILL_REL_RMS:
        fail(f"the kernel prefill is {rel} (rms, relative) from the plain")
    del got, want, got_cache, want_cache, routing

    # decode_32k: B = 16 on a 32,768-slot cache at length 16,384
    shape = LM_SHAPES["decode_32k"]
    B = LM_DECODE32K_BATCH
    cache = transformer.init_cache(cfg, B, shape.seq_len, dev)
    cache["length"] = shape.seq_len // 2
    tok = torch.randint(0, cfg.vocab_size, (B,), generator=gen, device=dev)
    steps, times = [], []
    with Spy(ops, "rmsnorm", lambda i, a: i == 0) as rspy, \
            Spy(ops, "moe_gemm", lambda i, a: i == 0) as mspy:
        for _ in range(LM_DECODE32K_STEPS):
            lm_counts(zero=True)
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            logits, cache = transformer.decode_step(params, cache, tok, cfg)
            e1.record()
            steps.append(lm_counts())
            finite.append(torch.isfinite(logits).all())
            tok = logits.argmax(-1)
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
    kept["rmsnorm"].append((f"decode B={B}", rspy.kept[0][0]))
    kept["moe_gemm"].append((f"decode C={mspy.kept[0][0][0].shape[1]}",
                             mspy.kept[0][0]))
    out["decode_32k_launches"] = steps[0]
    print(f"lm main path: decode_32k, B={B} on a {shape.seq_len}-slot cache "
          f"({2 * cache['k'].numel() * 2 / 1e9:.2f} GB) from length "
          f"{shape.seq_len // 2}: {LM_DECODE32K_STEPS} steps, launches a "
          f"step {steps[0]}, CUDA-event times {[round(t, 3) for t in times]}",
          flush=True)
    if any(s != want_step for s in steps):
        fail(f"decode_32k steps launched {steps}, expected {want_step}")
    step_fn = lambda: transformer.decode_step(params, cache, tok, cfg)
    out["decode_b16"] = lm_profile(f"decode step B={B} (cache 32,768)",
                                   step_fn, min(times[-3:]))
    out["decode_b16"]["tokens_per_s"] = B * 1e3 / out["decode_b16"]["ms"]
    del cache
    if not bool(torch.stack(finite).all()):
        fail("non-finite logits on the LM main path")
    torch.cuda.empty_cache()
    out["kernels"], out["max_abs_err"] = lm_kernel_rows(kept, dev)
    out["launches"] = {name: out["prefill_launches"][name]
                       + LM_GREEDY_STEPS * out["decode_launches"][name]
                       + LM_DECODE32K_STEPS * out["decode_32k_launches"][name]
                       for name in LM_COUNTERS}
    return out, dict(params=params, cfg=cfg, tokens=tokens, last=last,
                     prefill_ms=out["prefill"]["ms"])


def lm_phase(dev):
    """Phase 4h; returns the LM's rows for the kernels line, and the main
    path's weights, prompt, last logits and prefill time for phase 4i."""
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.time()
    g, meta = lm_golden()
    out = dict(golden=granite_golden_check(g, meta, dev),
               smoke_max_abs_err=lm_smoke_check(g, meta, dev))
    print(f"lm golden checks: {time.time() - t_phase:.1f} s", flush=True)
    main, weights = lm_main_path(dev)
    out.update(main)
    print(f"lm phase: {time.time() - t_phase:.1f} s", flush=True)
    return out, weights


# ---------------------------------------------------------------------------
# phase 4i: distribution (Granite-3.0 MoE's prefill under a device mesh:
# moe_ffn_sharded -> _local_dispatch_ffn -> moe_gemm; elastic remesh)
# ---------------------------------------------------------------------------
# The meshed Granite golden (tests/data/torch_lm_golden.npz, section
# granite_mesh: the reference's jitted prefill, logits and aux loss under a
# one-device mesh with install_rules, the golden granite section's cut,
# weights and prompts) is held to GRANITE_ATOL / GRANITE_RMS, and must
# reject the unmeshed moe_ffn in place of the sharded path in both dtypes.
# bf16 runs routed as each of the reference's compiled calls was
# (pinned_routing on the golden's experts, logits_experts, aux_experts):
# left to route itself, the port on the CPU flips ~1,760 of 35,200 routed
# copies a forward at near-ties, and the flips that reach the prompts'
# last token move its logits by up to 1.13 (rms 0.19), where the rows
# before it stay within 0.056 (rms 0.012).  f32 routes itself (2 flips on
# the CPU, within the limits).
# Expert ids from this one up are Granite's padding (48 - 40): the mesh's
# dispatch routes no copy to them.
MESH_N_REAL = granite_moe_3b_a800m.CONFIG.n_experts
MESH_CKPT_DIR = os.path.join(ROOT, "build", "elastic_ckpt")


@contextlib.contextmanager
def one_rank_mesh():
    """An NCCL group of one rank from an in-memory store (no network) and
    the 1 x 1 (data, model) mesh over it on the card; the rules cleared and
    the group destroyed on the way out."""
    import torch.distributed as dist
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    dist.init_process_group(
        "nccl", store=dist.HashStore(), rank=0, world_size=1,
        device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        yield make_host_mesh()
    finally:
        shd.clear_rules()
        dist.destroy_process_group()


@contextlib.contextmanager
def mesh_calls():
    """Counts of the mesh branch's calls: ``moe_ffn_sharded`` (one a MoE
    layer), ``_local_dispatch_ffn`` (one a rank and layer) and the
    functional all-reduce and all-gathers inside it."""
    import torch.distributed._functional_collectives as funcol
    with Spy(lm_moe, "moe_ffn_sharded") as sharded, \
            Spy(lm_moe, "_local_dispatch_ffn") as local, \
            Spy(funcol, "all_reduce") as reduce, \
            Spy(funcol, "all_gather_tensor") as gathers:
        counts = {}
        yield counts
    counts.update(moe_ffn_sharded=sharded.calls,
                  _local_dispatch_ffn=local.calls, all_reduce=reduce.calls,
                  all_gather=gathers.calls)


def unmeshed_moe(x, router_w, w_gate, w_up, w_down, *, top_k,
                 capacity_factor, n_real=None, **mesh_args):
    """The planted fault: the unmeshed ``moe_ffn`` in the sharded path's
    place (padded experts routed, capacity from 48)."""
    return lm_moe.moe_ffn(x, router_w, w_gate, w_up, w_down, top_k=top_k,
                          capacity_factor=capacity_factor, n_real=n_real)


def granite_mesh_run(params, cfg, toks, rows):
    """The golden's outputs under the installed mesh: the prefill's last
    logits, ``logits_fn`` at ``rows`` and the aux loss, as f32 numpy."""
    host = lambda t: t.float().cpu().numpy()  # noqa: E731
    last, _ = transformer.prefill(params, toks, cfg)
    logits = transformer.logits_fn(params, toks, cfg)[:, rows]
    _, aux = transformer.hidden_states(params, toks, cfg)
    return dict(prefill_logits=host(last), logits_rows=host(logits),
                aux=host(aux))


def granite_mesh_check(g, meta, mesh, dev) -> dict:
    """Phase 4i a: Granite at full width, depth cut to the golden's, f32
    (TF32 off) and bf16, ``attn_impl="pallas"``, under the 1 x 1 mesh with
    ``install_rules`` (the golden's rules): each output within the Granite
    golden's limits, the launches and the mesh branch's calls counted, no
    copy routed to a padded expert, the routing flips against the
    reference's printed, and the unmeshed MoE rejected."""
    from repro_torch.launch.mesh import install_rules
    sec = meta["sections"]["granite_mesh"]
    base = granite_golden_config(sec)
    tree = golden_tree(base, meta["weight_seed"], meta["constant_std"])
    toks = torch.from_numpy(g["granite_mesh/tokens"]).long().to(dev)
    rows, L, S = sec["logits_rows"], sec["n_layers"], toks.shape[1]
    out = {}
    for dt in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, param_dtype=dt)
        params = transformer.params_from_numpy(tree, cfg, dev)
        rules = install_rules(mesh, cfg, sec["batch"], kind="prefill")
        if json.loads(json.dumps(rules)) != sec["rules"]:
            fail(f"granite mesh: rules {rules}, the golden's {sec['rules']}")
        prefix = f"granite_mesh/{dt}/"
        atol, rms_tol = GRANITE_ATOL[dt], GRANITE_RMS[dt]
        # the reference's routing of its three calls, in granite_mesh_run's
        # order
        want_r = np.concatenate([g[prefix + n] for n in (
            "experts", "logits_experts", "aux_experts")]).astype(np.int64)
        pin = [torch.from_numpy(e).to(dev) for e in want_r] \
            if dt == "bfloat16" else None
        routed = (lambda: pinned_routing(pin)) if pin else \
            (lambda: recorded_routing(3 * L))
        with routed() as seen, mesh_calls() as calls:
            lm_counts(zero=True)
            got = granite_mesh_run(params, cfg, toks, rows)
            counts = lm_counts()
        want_counts = {k: 3 * v for k, v in lm_forward_counts(cfg, S).items()}
        want_calls = dict(moe_ffn_sharded=3 * L, _local_dispatch_ffn=3 * L,
                          all_reduce=3 * L, all_gather=9 * L)
        if counts != want_counts or calls != want_calls:
            fail(f"granite mesh {dt}: launches {counts}, calls {calls}; "
                 f"expected {want_counts}, {want_calls}")
        if pin:
            flips, largest = seen["flips"], seen["largest"]
        else:
            own = np.stack(seen)
            flips, largest = int((own != want_r).sum()), int(own.max())
        if largest >= MESH_N_REAL:
            fail(f"granite mesh {dt}: a copy routed to padded expert "
                 f"{largest}")
        errs = lm_errors(got, g, prefix)
        row = dict(errors=errs, atol=atol, rms_tol=rms_tol, launches=counts,
                   calls=calls, pinned=bool(pin), routing_flips=flips,
                   routed_copies=int(want_r.size), largest_expert=largest)
        print(f"mesh golden Granite {dt} (rules {rules}; "
              f"{'routed as the reference' if pin else 'own routing'}): "
              + "; ".join(f"{k} max {e:.3g} rms {r:.3g}"
                          for k, (e, r) in errs.items())
              + f" (limits {atol} / rms {rms_tol}); launches {counts}; calls "
              f"{calls}; largest expert id {largest}; its own routing "
              f"differs from the reference's in {flips} of {want_r.size} "
              f"routed copies", flush=True)
        if not all(e <= atol and r <= rms_tol for e, r in errs.values()):
            fail(f"granite mesh {dt}: outputs {errs} beyond {atol} / "
                 f"{rms_tol}")
        with routed(), patched(lm_moe, "moe_ffn_sharded", unmeshed_moe):
            bad = granite_mesh_run(params, cfg, toks, rows)
        berrs = lm_errors(bad, g, prefix)
        caught = any(e > atol or r > rms_tol for e, r in berrs.values())
        row["fault"] = dict(errors=berrs, rejected=caught)
        print(f"mesh golden Granite {dt}, the unmeshed moe_ffn in place of "
              f"the sharded path: " + "; ".join(
                  f"{k} max {e:.3g} rms {r:.3g}" for k, (e, r) in
                  berrs.items())
              + f"; {'rejected' if caught else 'NOT rejected'}",
              flush=True)
        if not caught:
            fail(f"granite mesh {dt}: the limits pass the unmeshed MoE")
        out[dt] = row
        del params
    return out


def mesh_main_path(w, mesh, dev) -> dict:
    """Phase 4i b: phase 4h's Granite weights at full width and depth,
    bf16, its 32,768-token prompt at B = 1 through the mesh branch: the
    launches and the branch's calls counted from 0, no copy routed to a
    padded expert, layer 0's gate and down ``moe_gemm`` inputs kept and
    held against the plain version (their capacity is the mesh's, from
    the 40 real experts), the prefill timed (CUDA events, best of 3)
    beside 4h's unmeshed prefill and its last logits against 4h's (a
    report: the two route differently by design); then the meshed kernel
    prefill at S = 4,096 against the meshed plain one, routed as the
    kernel one was."""
    from repro_torch.launch.mesh import install_rules
    params, cfg, tokens = w["params"], w["cfg"], w["tokens"]
    L, S = cfg.n_layers, tokens.shape[1]
    rules = install_rules(mesh, cfg, 1, kind="prefill")
    with recorded_routing(L, host=False) as routing, mesh_calls() as calls, \
            Spy(ops, "moe_gemm", lambda i, a: i in (0, 2)) as mspy:
        lm_counts(zero=True)
        t0 = time.time()
        last, cache = transformer.prefill(params, tokens, cfg)
        torch.cuda.synchronize()
        first_s = time.time() - t0
        counts = lm_counts()
    want = lm_forward_counts(cfg, S)
    want_calls = dict(moe_ffn_sharded=L, _local_dispatch_ffn=L,
                      all_reduce=L, all_gather=3 * L)
    largest = int(torch.stack([r.max() for r in routing]).max())
    copies = sum(r.numel() for r in routing)
    del cache, routing
    diff = (last - w["last"]).abs()
    out = dict(rules=rules, launches=counts, calls=calls, first_s=first_s,
               largest_expert=largest, routed_copies=copies,
               finite=bool(torch.isfinite(last).all()),
               max_abs_diff_unmeshed=float(diff.max()),
               argmax_equal_unmeshed=bool(
                   (last.argmax(-1) == w["last"].argmax(-1)).all()),
               capacity=lm_moe.capacity(S, MESH_N_REAL, cfg.top_k,
                                        cfg.capacity_factor),
               unmeshed_capacity=lm_moe.capacity(S, cfg.n_experts_eff,
                                                 cfg.top_k,
                                                 cfg.capacity_factor))
    print(f"mesh main path: Granite-3.0 MoE at full width and depth, prefill "
          f"B=1 S={S} under the 1 x 1 mesh (rules {rules}): launches "
          f"{counts} (expected {want}); calls {calls} (expected "
          f"{want_calls}); largest expert id {largest} of {copies} routed "
          f"copies (padding from {MESH_N_REAL}); capacity {out['capacity']} "
          f"(unmeshed {out['unmeshed_capacity']}); first call {first_s:.2f} "
          f"s; last logits against 4h's unmeshed prefill: max |diff| "
          f"{out['max_abs_diff_unmeshed']:.4g}, argmax equal "
          f"{out['argmax_equal_unmeshed']} (a report, not a check)",
          flush=True)
    if counts != want or calls != want_calls:
        fail(f"the meshed prefill launched {counts} with calls {calls}, "
             f"expected {want} and {want_calls}")
    if largest >= MESH_N_REAL or not out["finite"]:
        fail(f"the meshed prefill routed to expert {largest} or is not "
             f"finite")
    # layer 0's expert products at the mesh's capacity, against the plain
    # version
    C = mspy.kept[0][0][0].shape[1]
    if C != out["capacity"]:
        fail(f"the meshed prefill's moe_gemm took capacity {C}, not "
             f"{out['capacity']}")
    out["kernels"] = [moe_gemm_row(f"meshed {part} C={C}", *args)
                      for part, (args, _) in zip(("gate", "down"),
                                                 mspy.kept)]
    out["max_abs_err"] = max(r["max_abs_err"] for r in out["kernels"])
    kernel_row_lines({"moe_gemm": out["kernels"]})
    del mspy
    pre_fn = lambda: transformer.prefill(params, tokens, cfg)  # noqa: E731
    out["ms"] = events_ms(pre_fn)
    out["tokens_per_s"] = S / out["ms"] * 1e3
    out["unmeshed_ms"] = w["prefill_ms"]
    out["ratio_to_unmeshed"] = out["ms"] / w["prefill_ms"]
    print(f"mesh main path: prefill {out['ms']:.3f} ms "
          f"({out['tokens_per_s']:.0f} tokens/s, CUDA events, best of 3) against phase 4h's unmeshed "
          f"{w['prefill_ms']:.3f} ms: {out['ratio_to_unmeshed']:.3f}",
          flush=True)

    # the meshed kernel prefill against the meshed plain one at B = 1,
    # S = 4,096, the plain one routed as the kernel one was (phase 4h's
    # check under the mesh)
    short = tokens[:, :LM_PLAIN_PREFILL]
    with recorded_routing(L, host=False) as routing, mesh_calls() as kcalls:
        got, _ = transformer.prefill(params, short, cfg)
    with patched(ops, "rmsnorm", ref.rmsnorm_ref), \
            patched(ops, "moe_gemm", ref.moe_gemm_ref), \
            pinned_routing(routing) as pinned, mesh_calls() as pcalls:
        lm_counts(zero=True)
        want_l, _ = transformer.prefill(
            params, short, dataclasses.replace(cfg, attn_impl="chunked"))
        if any(lm_counts().values()):
            fail(f"the meshed plain prefill launched {lm_counts()}")
    rms = lambda x: float(x.float().pow(2).mean().sqrt())  # noqa: E731
    rel = rms(got - want_l) / rms(want_l)
    out["plain_prefill"] = dict(
        S=LM_PLAIN_PREFILL, rel_rms=rel,
        max_abs_err=float((got - want_l).abs().max()),
        routing_flips=pinned["flips"], largest_expert=pinned["largest"],
        routed_copies=L * LM_PLAIN_PREFILL * cfg.top_k)
    print(f"mesh main path: the meshed kernel prefill at "
          f"S={LM_PLAIN_PREFILL} against the meshed plain one (chunked "
          f"attention, plain rmsnorm and moe_gemm, routed as the kernel "
          f"one): last logits rms {rel:.4g} of theirs (limit "
          f"{LM_PREFILL_REL_RMS}), max abs err "
          f"{out['plain_prefill']['max_abs_err']:.4g}; its own routing "
          f"would differ in {pinned['flips']} of "
          f"{out['plain_prefill']['routed_copies']} routed copies; "
          f"sharded calls {kcalls['moe_ffn_sharded']} / "
          f"{pcalls['moe_ffn_sharded']}", flush=True)
    if kcalls["moe_ffn_sharded"] != L or pcalls["moe_ffn_sharded"] != L:
        fail(f"the S={LM_PLAIN_PREFILL} prefills left the mesh branch: "
             f"{kcalls}, {pcalls}")
    if pinned["largest"] >= MESH_N_REAL:
        fail(f"the meshed plain prefill routed to expert "
             f"{pinned['largest']}")
    if not torch.isfinite(got).all() or not rel <= LM_PREFILL_REL_RMS:
        fail(f"the meshed kernel prefill is {rel} (rms, relative) from the "
             f"plain")
    return out


def elastic_check(mesh, dev) -> dict:
    """Phase 4i c: DeiT-B at full width (weights drawn on the card) written
    by ``training/checkpoint.py``, restored on the host and placed on the
    1 x 1 mesh by ``replace_mesh`` with the specs of its logical tree
    under ``install_rules``: every leaf equal bit for bit."""
    import shutil
    from repro_torch.launch import dryrun
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import install_rules
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.elastic import replace_mesh
    cfg = deit_b.CONFIG
    params = vit.init_params(cfg, torch.Generator(device=dev).manual_seed(7),
                             dev)
    t0 = time.time()
    shutil.rmtree(MESH_CKPT_DIR, ignore_errors=True)
    ckpt.save_checkpoint(MESH_CKPT_DIR, 1, params)
    template = model_common.tree_map(
        lambda x: torch.empty(x.shape, dtype=x.dtype), params)
    restored, _ = ckpt.restore_latest(MESH_CKPT_DIR, template)
    install_rules(mesh, cfg, 1, kind="serve")
    shardings = dryrun._to_shardings(
        mesh, S._nest_logical(vit.param_logical(cfg)), vit.param_specs(cfg))
    specs = model_common.tree_map(lambda s: s.spec, shardings)
    placed = replace_mesh(restored, specs, mesh)
    pairs = [(model_common.nested(params, path),
              model_common.nested(placed, path)) for path in
             vit.param_defs(cfg)]
    equal = all(torch.equal(a, b.to_local()) and b.device_mesh == mesh
                for a, b in pairs)
    out = dict(leaves=len(pairs), n_params=model_common.count_params(params),
               equal=equal, s=time.time() - t0)
    print(f"mesh elastic: DeiT-B ({out['n_params']:,} parameters, "
          f"{len(pairs)} leaves) checkpointed, restored and placed on the "
          f"1 x 1 mesh by replace_mesh: equal bit for bit {equal} "
          f"({out['s']:.1f} s)", flush=True)
    if not equal:
        fail("the DeiT-B checkpoint placed on the mesh differs")
    shutil.rmtree(MESH_CKPT_DIR, ignore_errors=True)
    return out


def mesh_phase(dev, weights) -> dict:
    """Phase 4i; returns the phase's rows (``moe_gemm``'s launches in
    ``launches``)."""
    t0 = time.time()
    g, meta = lm_golden()
    with one_rank_mesh() as mesh:
        out = dict(golden=granite_mesh_check(g, meta, mesh, dev))
        out["main"] = mesh_main_path(weights, mesh, dev)
        out["elastic"] = elastic_check(mesh, dev)
    out["launches"] = out["main"]["launches"]
    out["s"] = time.time() - t0
    print(f"mesh phase: {out['s']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 5: the entry-point kernels
# ---------------------------------------------------------------------------
ENTRY_POINTS = {"fleet_feasibility": ad_mod.fleet_feasibility,
                "link_cost": ad_mod.link_cost, "rmsnorm": rn_mod.rmsnorm,
                "moe_gemm": mg_mod.moe_gemm}
# (R, d): a 4,096-token prefill batch at the widths of
# src/repro/configs/gemma3_27b.py and granite_moe_3b_a800m.py; the
# Kimi-K2 width of tests/test_kernels.py
RMSNORM_SHAPES = ((4096, 5376), (4096, 1536), (7, 7168))
# (E, C, d, f): Granite-3.0 MoE (40 experts, top-8, d_model 1536, expert
# d_ff 512) at 4,096 tokens, capacity int(4096 * 8 * 1.25 / 40) = 1024
# a ragged C and f that a tensor map takes (f = 504), and one it does not
MOE_SHAPES = {"gate_up": (40, 1024, 1536, 512), "down": (40, 1024, 512, 1536),
              "ragged_tma": (40, 1000, 1536, 504),
              "ragged": (40, 1000, 1536, 500)}
FLEET_K, FLEET_N = (1, 5, 12, 32, 256), (8, 64, 1000, 1024, 20000)
# the shape each kernel's entry in the kernels line reports
HEADLINE = {"fleet_feasibility": dict(K=256, N=1024),
            "link_cost": dict(K=256, N=1024),
            "rmsnorm": dict(R=4096, d=5376, dtype="bfloat16"),
            "moe_gemm": dict(name="gate_up", dtype="bfloat16")}


def random_ledgers(rng, K, N, dyadic, dev):
    """Head-pointer ledgers as ``ops.fleet_feasibility`` takes them, with
    15% of the rows full, and row 0 full and row 1 empty for K > 2; times on
    a 0.5 grid (sizes 20 / 44 / 180 over speeds 0.5 / 1 / 2) or, not
    dyadic, sizes over speeds 1 / 3.  Returns the tensors, the per-node
    scores ``ps``, ``busy`` and network rows, and the block edges."""
    head = rng.integers(0, N // 4 + 1, K)
    n = rng.integers(0, N - head + 1)
    n = np.where(rng.random(K) < 0.15, N - head, n)
    if K > 2:
        n[0], n[1] = N - head[0], 0
    speeds = rng.choice([0.5, 1.0, 2.0] if dyadic else [1.0, 3.0], K)
    idx = np.arange(N)[None, :]
    live = (idx >= head[:, None]) & (idx < (head + n)[:, None])
    size = rng.choice([20.0, 44.0, 180.0], (K, N)) / speeds[:, None] * live
    gap = np.where(rng.random((K, N)) < 0.6, 0.0,
                   rng.integers(1, 100, (K, N)) / 2) * live
    ends = rng.integers(0, 400, K)[:, None] / 2 + np.cumsum(gap + size, 1)
    starts = ends - size
    retired = idx < head[:, None]
    starts = np.where(live, starts, np.where(retired, -BIG, BIG))
    ends = np.where(live, ends, np.where(retired, -BIG, BIG))
    f = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    i = lambda a: torch.tensor(np.asarray(a, np.int32), device=dev)
    ps = rng.choice([20.0, 44.0, 180.0], K) / speeds
    return dict(
        led=(f(starts), f(ends), f(size), i(n)), head=i(head), ps=f(ps),
        busy=f(rng.integers(0, 400, K) / 2),
        lat=f(rng.uniform(0, 120, K)),
        ibw=f(rng.choice([0.0, 0.1, 0.8, 1.0], K)),
        edges=np.asarray(starts, np.float32)[live])


def admission_args(L, kernel, d, t, payload, dev):
    """``ops.<kernel>`` arguments for ledgers ``L``, scalars on the card."""
    sc = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    if kernel == "fleet_feasibility":
        return (*L["led"], L["ps"], sc(d), L["busy"], L["head"])
    return (*L["led"], L["ps"], sc(d), L["busy"], L["head"], sc(t),
            L["lat"], L["ibw"], sc(payload))


def event_select_identity(args):
    """Scores one kept ``event_select`` input three ways and fails unless
    ``link_cost`` from the selected node's network row gives its feasible,
    arrive and load and ``fleet_feasibility`` from max(arrive, busy) its
    feasible and load, bit for bit (tests/test_netsim.py:570-593)."""
    take, t, node, feas, arrive, _, _, load = ops.event_select(*args)
    starts, ends, sizes, n, head, speeds, busy, lat, ibw = args[12:]
    K = starts.shape[0]
    pick = lambda a, b: torch.where(take, a, b).reshape(())
    d, ps = pick(args[2], args[8]), pick(args[3], args[9]) / speeds
    row = node.reshape(1).long()
    lc = ops.link_cost(starts, ends, sizes, n, ps, d, busy, head, t,
                       lat.index_select(0, row).reshape(K),
                       ibw.index_select(0, row).reshape(K),
                       pick(args[4], args[10]))
    ff = ops.fleet_feasibility(starts, ends, sizes, n, ps, d,
                               torch.maximum(arrive, busy), head)
    torch.cuda.synchronize()
    for what, g, w in (("link_cost feasible", lc[0], feas),
                       ("link_cost arrive", lc[1], arrive),
                       ("link_cost load", lc[2], load),
                       ("fleet_feasibility feasible", ff[0], feas),
                       ("fleet_feasibility load", ff[1], load)):
        if not torch.equal(g, w):
            fail(f"{what} differs from event_select's at K={K}")


def admission_bound_ms(K, N, link) -> float:
    """Each input read once, each output written once: three (K, N) f32
    ledgers, (K,) n, head, ps and cpu_free / busy, for link_cost the two
    (K,) network rows and three scalars, else one; out (K,) feasible and
    load, and arrive for link_cost."""
    nbytes = 12 * K * N + 16 * K + (8 * K + 12 if link else 4) \
        + 5 * K + (4 * K if link else 0)
    return nbytes / HBM_BYTES_PER_S * 1e3


def admission_checks(dev, kept):
    """Phase 5a and 5b; returns each kernel's largest error."""
    rng = np.random.default_rng(5)
    pays = [0.9216, 2.7648, 6.2208, 24.8832]
    errs, n_checked = {"fleet_feasibility": 0.0, "link_cost": 0.0}, 0
    for K in FLEET_K:
        for N in FLEET_N:
            for dyadic in (True, False):
                L = random_ledgers(rng, K, N, dyadic, dev)
                edges = L["edges"] if L["edges"].size else [500.0]
                for d in (float(rng.choice(edges)), float(rng.choice(edges)),
                          float(rng.integers(0, 40000)) / 2):
                    t = float(rng.integers(0, 800)) / 2
                    pay = float(rng.choice(pays))
                    for kernel in errs:
                        errs[kernel] = max(errs[kernel], check_exact(
                            kernel, admission_args(L, kernel, d, t, pay, dev),
                            dyadic))
                        n_checked += 1
    print(f"entry kernels: fleet_feasibility and link_cost match their "
          f"plain versions on {n_checked} random inputs (K in {FLEET_K}, N "
          f"in {FLEET_N}, full and empty head-pointer rows, deadlines on "
          f"block edges, a priced network); max abs err {errs}", flush=True)
    shapes = set()
    for args_list in kept.values():
        for args in args_list:
            event_select_identity(args)
            shapes.add(tuple(args[12].shape))
    print(f"entry kernels: on the {sum(map(len, kept.values()))} "
          f"event_select inputs kept from the fleet runs, shapes (K, W) "
          f"{sorted(shapes)}, link_cost and fleet_feasibility score the "
          f"selected event as event_select does, bit for bit", flush=True)
    return errs


def check_close(what, got, want, tol) -> float:
    """Fails unless ``got`` is finite and within ``tol`` of ``want``;
    returns the max abs error."""
    if got.dtype != want.dtype or got.shape != want.shape:
        fail(f"{what}: {got.dtype}{tuple(got.shape)} vs "
             f"{want.dtype}{tuple(want.shape)}")
    share = tolerance_share(got, want, tol)
    if not torch.isfinite(got).all() or not share <= 1.0:
        fail(f"{what} differs from the plain version: {share} of the "
             f"tolerance {tol}")
    return float((got.float() - want.float()).abs().max())


def randn(shape, seed, dev, dtype, scale=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)


def rmsnorm_inputs(R, d, dtype, dev):
    return (randn((R, d), R + d, dev, dtype),
            randn((d,), d, dev, dtype, 0.1))


def rmsnorm_checks(dev) -> float:
    """Phase 5c; returns the max abs error."""
    err = 0.0
    for R, d in RMSNORM_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            x, s = rmsnorm_inputs(R, d, dt, dev)
            err = max(err, check_close(f"rmsnorm ({R}, {d}) {dt}",
                                       rn_mod.rmsnorm(x, s),
                                       ref.rmsnorm_ref(x, s),
                                       ref.rmsnorm_tolerance(dt)))
    R, d = RMSNORM_SHAPES[0]
    for dt in (torch.float32, torch.bfloat16):
        x, s = rmsnorm_inputs(R, d, dt, dev)
        buf = torch.empty(R * d + 1, dtype=dt, device=dev)
        view = buf[1:].view(R, d)                # off 16-byte alignment
        view.copy_(x)
        err = max(err, check_close(f"rmsnorm misaligned ({R}, {d}) {dt}",
                                   rn_mod.rmsnorm(view, s),
                                   ref.rmsnorm_ref(x, s),
                                   ref.rmsnorm_tolerance(dt)))
    # the check's own test: a row normalised without its last column
    x, s = rmsnorm_inputs(R, d, torch.float32, dev)
    want = ref.rmsnorm_ref(x, s)
    var = x[:, :-1].square().sum(-1, keepdim=True) / d
    bad = x * torch.rsqrt(var + rn_mod.EPS) * (1.0 + s)
    f32_share = tolerance_share(bad, want, ref.rmsnorm_tolerance(x.dtype))
    bf16_share = tolerance_share(bad, want,
                                 ref.rmsnorm_tolerance(torch.bfloat16))
    if f32_share <= 1.0:
        fail("the f32 rmsnorm check passes a row without its last column")
    print(f"entry kernels: rmsnorm matches its plain version at (R, d) "
          f"{RMSNORM_SHAPES}, f32 and bf16, and on misaligned views; max abs "
          f"err {err}; a row normalised without its last column errs by "
          f"{f32_share} of the f32 tolerance (rejected) and {bf16_share} of "
          f"the bf16 one", flush=True)
    return err


def moe_inputs(E, C, d, f, dtype, dev):
    return (randn((E, C, d), C + d, dev, dtype, 0.1),
            randn((E, d, f), d + f, dev, dtype, 0.1))


def moe_checks(dev) -> float:
    """Phase 5d; returns the max abs error."""
    err = 0.0
    for name, (E, C, d, f) in MOE_SHAPES.items():
        for dt in (torch.bfloat16, torch.float32):
            x, w = moe_inputs(E, C, d, f, dt, dev)
            tol = ref.moe_gemm_tolerance(x, w)
            want = ref.moe_gemm_ref(x, w)
            got = mg_mod.moe_gemm(x, w)
            e = check_close(f"moe_gemm {name} {dt}", got, want, tol)
            err = max(err, e)
            print(f"entry kernels: moe_gemm {name} {(E, C, d, f)} {dt}: "
                  f"variant {mg_mod.variant(x, w)}, max abs err {e}",
                  flush=True)
            if name in ("gate_up", "ragged_tma"):
                bad = ref.moe_gemm_ref(x[..., :-16], w[:, :-16])
                share = tolerance_share(bad, want, tol)
                if share <= 1.0:
                    fail(f"the moe_gemm check passes an output without the "
                         f"last 16 of d ({dt})")
                print(f"entry kernels: moe_gemm {name} {dt}: max abs err "
                      f"{e}, {tolerance_share(got, want, tol)} of the "
                      f"tolerance {tol}; an output without the last 16 of d "
                      f"errs by {share} of it (rejected)", flush=True)
            del x, w, want, got
    print(f"entry kernels: moe_gemm matches its plain version at "
          f"{MOE_SHAPES}, bf16 and f32; max abs err {err}", flush=True)
    return err


def rmsnorm_bound_ms(R, d, itemsize):
    """x read and out written once, scale read once; ~5 f32 operations an
    element (square, add, two multiplies, 1 + scale) at the f32 peak."""
    bytes_ms = (2 * R * d * itemsize + 4 * d) / HBM_BYTES_PER_S * 1e3
    ops_ms = 5 * R * d / F32_FLOP_PER_S * 1e3
    return bound(bytes_ms, ops_ms)


def moe_bound_ms(E, C, d, f, itemsize):
    """2 E C d f operations at the bf16 tensor-core peak (f32: the f32
    units' peak), or x and w read once and out written once."""
    peak = BF16_FLOP_PER_S if itemsize == 2 else F32_FLOP_PER_S
    ops_ms = 2 * E * C * d * f / peak * 1e3
    bytes_ms = (E * C * d + E * d * f + E * C * f) * itemsize \
        / HBM_BYTES_PER_S * 1e3
    return bound(bytes_ms, ops_ms)


def drive_entry_points(dev, fleet):
    """This slice's path: each entry point once at its full-width shapes,
    with the four launch counts set to 0 before; every output is held
    against its plain version after (which launches none of them).
    Returns the launch counts."""
    calls = [("fleet_feasibility", admission_args(fleet, "fleet_feasibility",
                                                   9000.0, 0, 0, dev)),
             ("link_cost", admission_args(fleet, "link_cost", 9000.0, 120.5,
                                          24.8832, dev))]
    calls += [("rmsnorm", rmsnorm_inputs(R, d, torch.bfloat16, dev))
              for R, d in RMSNORM_SHAPES[:2]]
    calls += [("moe_gemm", moe_inputs(*MOE_SHAPES[k], torch.bfloat16, dev))
              for k in ("gate_up", "down")]
    for fn in ENTRY_POINTS.values():
        fn.launches = 0
    outs = [getattr(ops, name)(*args) for name, args in calls]
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in ENTRY_POINTS.items()}
    for (name, args), got in zip(calls, outs):
        want = getattr(ref, name + "_ref")(*args)
        if name == "rmsnorm":
            check_close("rmsnorm run", got, want, ref.rmsnorm_tolerance(
                args[0].dtype))
        elif name == "moe_gemm":
            check_close("moe_gemm run", got, want,
                        ref.moe_gemm_tolerance(*args))
        elif not all(torch.equal(g, w) for g, w in zip(got, want)):
            fail(f"{name} run differs from the plain version")
    if not all(launches.values()):
        fail(f"an entry point did not launch its kernel: {launches}")
    print(f"entry kernels: the entry points at full width launched "
          f"{launches}; outputs match the plain versions", flush=True)
    return launches


def one_call_kernels(fn) -> dict:
    """The device kernels of one call of ``fn`` (warm), by name: a window
    that records no device entry is profiled again, up to
    ``PROFILE_TRIES`` windows (``profiled``)."""
    fn()
    p = profiled(fn)
    return p["device_counts"]


def rmsnorm_device_kernels(dev) -> dict:
    """Phase 2b: the device kernels one ``rmsnorm`` call runs at each of
    ``RMSNORM_SHAPES``, f32 and bf16 with the scale in x's dtype, which
    must be one (the kernel reads the scale in its own dtype: no cast
    beside it), and one ``rmsnorm_bwd`` call at the train step's rows,
    also one (dx and dscale in one cooperative launch).  Profiled before
    anything else in the run is.  Returns the counts."""
    counts = {}
    for R, d in RMSNORM_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            x, s = rmsnorm_inputs(R, d, dt, dev)
            names = one_call_kernels(lambda: rn_mod.rmsnorm(x, s))
            if sum(names.values()) != 1:
                fail(f"rmsnorm ({R}, {d}) {dt} with a {s.dtype} scale ran "
                     f"device kernels {names}, not one")
            counts[(R, d, dt)] = 1
    for R, d in RMSNORM_BWD_SHAPES[:2]:
        for dt in (torch.bfloat16, torch.float32):
            x, s, dy = rmsnorm_bwd_inputs(R, d, dt, dev)
            names = one_call_kernels(lambda: rn_mod.rmsnorm_bwd(x, s, dy))
            if sum(names.values()) != 1:
                fail(f"rmsnorm_bwd ({R}, {d}) {dt} ran device kernels "
                     f"{names}, not one")
            counts[("bwd", R, d, dt)] = 1
    print(f"entry kernels: one rmsnorm call is one device kernel at (R, d) "
          f"{RMSNORM_SHAPES}, f32 and bf16, the scale in x's dtype, and one "
          f"rmsnorm_bwd call at {RMSNORM_BWD_SHAPES[:2]} (profiled)",
          flush=True)
    return counts


FLOOR_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(int blocks, int threads, int device,
                            cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  empty_kernel<<<blocks, threads, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}
"""
_floor = {}


def build_floor() -> float:
    """Builds an empty kernel with the kernels' flags (``build/kernels/
    floor``): the launch floor phase 5 times beside the admission kernels.
    Returns the build's seconds."""
    import ctypes
    t0 = time.time()
    out = build.build_dir() / "floor"
    out.mkdir(parents=True, exist_ok=True)
    (out / "empty.cu").write_text(FLOOR_SOURCE)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                    str(out / "libempty.so"), str(out / "empty.cu")],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(out / "libempty.so")).empty_launch
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _floor["launch"] = fn
    return time.time() - t0


def empty_launch(blocks: int, dev) -> None:
    """One launch of the empty kernel: ``blocks`` blocks of 256 threads (the
    admission kernels' largest block), on PyTorch's current stream."""
    build.raise_on("empty kernel", _floor["launch"](blocks, 256,
                                                    *build.stream_of(dev)))


def admission_row(kernel, K, N, args, dev) -> dict:
    """Graph-replayed times of one admission kernel, its plain version and
    the empty kernel at K blocks, in turns (kernel, floor, floor, kernel),
    with the bound and the share of it reached."""
    ms, floor_ms = in_turns(
        lambda: graph_ms(lambda: getattr(ops, kernel)(*args), 1000),
        lambda: graph_ms(lambda: empty_launch(K, dev), 1000))
    bound_ms = admission_bound_ms(K, N, kernel == "link_cost")
    return dict(K=K, N=N, ms=ms, floor_ms=floor_ms,
                plain_ms=graph_ms(lambda: getattr(ref, kernel + "_ref")(
                    *args), 200),
                library_ms=None, bound_ms=bound_ms, bound_by="bytes",
                bound_share=bound_ms / ms)


def entry_times(dev, kept, fleet, one_kernel, routed):
    """Phase 5e: graph-replayed times of each kernel, its plain version
    and the library call where one computes the same function, with the
    bound, at the checked shapes; the admission kernels also at the heap
    router's (K, cap) on one of its decisions each, beside the empty
    kernel's launch.  Returns rows per kernel."""
    rows = {name: [] for name in ENTRY_POINTS}
    inputs = {(256, 1024): fleet}
    for args_list in kept.values():                # the main path's shapes
        starts, ends, sizes, n, head, speeds, busy, lat, ibw = \
            args_list[-1][12:]
        K = starts.shape[0]
        inputs[tuple(starts.shape)] = dict(
            led=(starts, ends, sizes, n), head=head,
            ps=torch.full((K,), 44.0, device=dev) / speeds, busy=busy,
            lat=lat[0].contiguous(), ibw=ibw[0].contiguous())
    for (K, N), L in sorted(inputs.items()):
        for kernel in ("fleet_feasibility", "link_cost"):
            args = admission_args(L, kernel, 9000.0, 120.5, 24.8832, dev)
            rows[kernel].append(admission_row(kernel, K, N, args, dev))
    zero = lambda K: torch.zeros(K, device=dev)
    for (K, cap), buf in sorted(routed.items()):
        starts, ends, sizes, n, ps, d, free, head = router_mod.staged_views(
            buf.to(dev), K, cap)
        for kernel, args in (
                ("fleet_feasibility", (starts, ends, sizes, n, ps, d, free,
                                       head)),
                ("link_cost", (starts, ends, sizes, n, ps, d, free, head,
                               d, zero(K), zero(K), d))):
            row = admission_row(kernel, K, cap, args, dev)
            row["router"] = True
            rows[kernel].append(row)
    lib = torch.nn.functional.rms_norm
    for R, d in RMSNORM_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            x, s = rmsnorm_inputs(R, d, dt, dev)
            weight = (1.0 + s.float()).to(dt)
            ms, library_ms = in_turns(
                lambda: graph_ms(lambda: rn_mod.rmsnorm(x, s), 200),
                lambda: graph_ms(lambda: lib(x, (d,), weight=weight,
                                             eps=rn_mod.EPS), 200))
            ms_cold, library_ms_cold = in_turns(
                lambda: cold_ms(rn_mod.rmsnorm, (x, s)),
                lambda: cold_ms(lambda xc, wc: lib(
                    xc, (d,), weight=wc, eps=rn_mod.EPS), (x, weight)))
            row = dict(R=R, d=d, dtype=str(dt)[6:], ms=ms,
                       plain_ms=graph_ms(lambda: ref.rmsnorm_ref(x, s), 50),
                       library_ms=library_ms, ms_cold=ms_cold,
                       library_ms_cold=library_ms_cold,
                       device_kernels=one_kernel[(R, d, dt)])
            row["ratio_cold"] = row["ms_cold"] / row["library_ms_cold"]
            row["bound_ms"], row["bound_by"] = rmsnorm_bound_ms(
                R, d, x.element_size())
            rows["rmsnorm"].append(row)
    for name, (E, C, d, f) in MOE_SHAPES.items():
        for dt in (torch.bfloat16, torch.float32):
            if dt == torch.float32 and name != "gate_up":
                continue
            x, w = moe_inputs(E, C, d, f, dt, dev)
            reps = 20 if dt == torch.bfloat16 else 5
            row = dict(name=name, E=E, C=C, d=d, f=f, dtype=str(dt)[6:],
                       variant=mg_mod.variant(x, w),
                       ms=graph_ms(lambda: mg_mod.moe_gemm(x, w), reps),
                       plain_ms=graph_ms(lambda: ref.moe_gemm_ref(x, w), 5),
                       library_ms=graph_ms(lambda: torch.bmm(x, w), reps))
            row["bound_ms"], row["bound_by"] = moe_bound_ms(
                E, C, d, f, x.element_size())
            rows["moe_gemm"].append(row)
            del x, w
    for name, rs in rows.items():
        for r in rs:
            r["ratio"] = None if r["library_ms"] is None \
                else r["ms"] / r["library_ms"]
            shape = ", ".join(f"{k}={v}" for k, v in r.items()
                              if not k.endswith(("ms", "_by", "ratio",
                                                 "_cold", "_share")))
            lib = "none" if r["library_ms"] is None \
                else (f"{r['library_ms'] * 1e3:.2f} us, kernel / library "
                      f"{r['ratio']:.3f}")
            if "ms_cold" in r:
                lib += (f"; L2 cold: kernel {r['ms_cold'] * 1e3:.2f} us, "
                        f"library {r['library_ms_cold'] * 1e3:.2f} us, "
                        f"kernel / library {r['ratio_cold']:.3f}")
            floor = "" if "floor_ms" not in r else (
                f", empty-kernel launch {r['floor_ms'] * 1e3:.3f} us, share "
                f"of the bound {r['bound_share']:.4f}")
            print(f"entry kernel time {name} {shape}: {r['ms'] * 1e3:.3f} "
                  f"us, plain {r['plain_ms'] * 1e3:.2f} us, library {lib}, "
                  f"bound {r['bound_ms'] * 1e3:.4f} us ({r['bound_by']})"
                  f"{floor}", flush=True)
    return rows


def entry_point_phase(dev, kept, one_kernel, routed):
    """Phase 5; returns the kernels-line entries of the four kernels."""
    torch.backends.cuda.matmul.allow_tf32 = False
    errs = admission_checks(dev, kept)
    errs["rmsnorm"] = rmsnorm_checks(dev)
    errs["moe_gemm"] = moe_checks(dev)
    fleet = random_ledgers(np.random.default_rng(6), 256, 1024, True, dev)
    launches = drive_entry_points(dev, fleet)
    rows = entry_times(dev, kept, fleet, one_kernel, routed)
    out = {}
    for name in ENTRY_POINTS:
        top = next(r for r in rows[name]
                   if all(r[k] == v for k, v in HEADLINE[name].items()))
        out[name] = dict(launches=launches[name], max_abs_err=errs[name],
                         ms=top["ms"], plain_ms=top["plain_ms"],
                         bound_ms=top["bound_ms"], bound_by=top["bound_by"],
                         library_ms=top["library_ms"], ratio=top["ratio"],
                         shapes=rows[name])
        for key in ("variant", "floor_ms", "bound_share"):
            if key in top:
                out[name][key] = top[key]
    return out


# ---------------------------------------------------------------------------
# Phase 6: training
# ---------------------------------------------------------------------------
TRAIN_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_train_golden.npz")
TRAIN_CKPT_DIR = os.path.join(ROOT, "build", "train_ckpt")
# the rmsnorm backward kernel at the train step's rows ((B S, d) of
# Granite's norms at B = 2 and 1, S = 4,096), a wide row and an odd width
RMSNORM_BWD_SHAPES = ((8192, 1536), (4096, 1536), (7, 7168), (1000, 1023))
# moe_gemm's backward products at Granite's expert products, (E, C, d, f)
# of the forward x (E, C, d) w (E, d, f): C = 853 for one 4,096-token
# sequence, 1,706 for two (the main path's B = 2)
MOE_BWD_SHAPES = {"gate_up/853": (48, 853, 1536, 512),
                  "down/853": (48, 853, 512, 1536),
                  "gate_up/1706": (48, 1706, 1536, 512),
                  "down/1706": (48, 1706, 512, 1536)}
# the main path: Granite-3.0 MoE at full width and depth, train_4k's
# 4,096-token sequences with its global batch cut 256 -> TRAIN_BATCH;
# one warm step, TRAIN_TIMED timed
TRAIN_BATCH, TRAIN_WARM, TRAIN_TIMED = 2, 1, 2
# DeiT-B cls_224 at its full global batch: DEIT_STEPS steps, a checkpoint
# after DEIT_CKPT_AT, a fresh run resumed from it
DEIT_STEPS, DEIT_CKPT_AT = 2, 1
# the diffusion train steps at train_256 (256 px, latent 32): DiT-XL/2 at
# full width, depth and batch; the SD 1.5 UNet at full width and depth
# with its global batch cut 256 -> UNET_TRAIN_BATCH, its activations kept
# without remat as the reference keeps them: 0.698 GB a sample beside
# 10.06 GB of weights, gradients and moments on an NVIDIA H100 80GB HBM3
# at 700.00 W (``tools/train_batch_scan.py``), so B = 96 peaks at ~77 GB
# of the card's 85 (PERF.md section 4); a warm step each, one profiled,
# DIFF_TIMED timed.  UNET_PEAK_GB: the largest peak seen at B = 96 (in
# this script, on that card; 77.10 GB in a process of its own), which
# the card's free memory is held to before the run
UNET_TRAIN_BATCH, DIFF_TIMED, UNET_PEAK_GB = 96, 2, 78.18
# resumed = uninterrupted: DiT-XL/2 at full width and batch, depth cut
# 28 -> DIT_RESUME_LAYERS, DIT_RESUME_STEPS steps, a checkpoint after one
DIT_RESUME_LAYERS, DIT_RESUME_STEPS = 2, 2
# the embedding's backward at Granite's train step (B = 2 x 4,096 tokens
# onto the 8 ids SyntheticSource draws) and at the golden's 1,100 tokens
EMBED_BWD_TOKENS = ((2, 4096), (1, 1100))
TRAIN_COUNTERS = {"rmsnorm": rn_mod.rmsnorm,
                  "rmsnorm_backward": rn_mod.rmsnorm_bwd,
                  "moe_gemm": mg_mod.moe_gemm,
                  "flash_attention": fa_mod.flash_attention}


def train_golden_module():
    """``tests/train_golden.py``: the golden's record, limits and faults
    (numpy and torch only)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import train_golden
    return train_golden


def train_counts(zero=False) -> dict:
    if zero:
        for fn in TRAIN_COUNTERS.values():
            fn.launches = 0
    return {name: fn.launches for name, fn in TRAIN_COUNTERS.items()}


def rmsnorm_bwd_bound_ms(R, d, itemsize):
    """x and dy read and dx written once (the scale read and dscale
    written once); ~12 f32 operations an element at the f32 peak."""
    bytes_ms = (3 * R * d * itemsize + 8 * d) / HBM_BYTES_PER_S * 1e3
    ops_ms = 12 * R * d / F32_FLOP_PER_S * 1e3
    return bound(bytes_ms, ops_ms)


def rmsnorm_bwd_inputs(R, d, dtype, dev):
    x, s = rmsnorm_inputs(R, d, dtype, dev)
    return x, s, randn((R, d), R + d + 1, dev, dtype)


def rmsnorm_bwd_checks(dev) -> dict:
    """Phase 6a: the backward kernel against its plain version at
    ``RMSNORM_BWD_SHAPES``, f32 and bf16, deterministic; the dscale check
    shown to reject a dscale without its last row, and one of 0; times at
    the train shapes beside the plain version, the library's backward of
    ``F.rms_norm`` and the bound."""
    err, rows = 0.0, []
    for R, d in RMSNORM_BWD_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            x, s, dy = rmsnorm_bwd_inputs(R, d, dt, dev)
            dx, ds = rn_mod.rmsnorm_bwd(x, s, dy)
            want_dx, want_ds = ref.rmsnorm_bwd_ref(x, s, dy)
            tol = ref.rmsnorm_bwd_tolerance(x, s, dy)
            err = max(err, check_close(f"rmsnorm_bwd dx ({R}, {d}) {dt}", dx,
                                       want_dx, tol["dx"]),
                      check_close(f"rmsnorm_bwd dscale ({R}, {d}) {dt}", ds,
                                  want_ds, tol["dscale"]))
            dx2, ds2 = rn_mod.rmsnorm_bwd(x, s, dy)
            if not (torch.equal(dx, dx2) and torch.equal(ds, ds2)):
                fail(f"rmsnorm_bwd ({R}, {d}) {dt}: two launches differ")
    R, d = RMSNORM_BWD_SHAPES[0]
    x, s, dy = rmsnorm_bwd_inputs(R, d, torch.float32, dev)
    _, want_ds = ref.rmsnorm_bwd_ref(x, s, dy)
    tol = ref.rmsnorm_bwd_tolerance(x, s, dy)["dscale"]
    r = torch.rsqrt(x.square().mean(-1, keepdim=True) + rn_mod.EPS)
    no_last = want_ds - (dy * x * r)[-1]
    shares = (tolerance_share(no_last, want_ds, tol),
              tolerance_share(torch.zeros_like(want_ds), want_ds, tol))
    if not min(shares) > 1.0:
        fail(f"the rmsnorm_bwd dscale check passes a dropped dscale: {shares}")
    print(f"train kernels: rmsnorm_bwd matches its plain version at (R, d) "
          f"{RMSNORM_BWD_SHAPES}, f32 and bf16, bit-equal over two launches; "
          f"max abs err {err}; a dscale without its last row errs by "
          f"{shares[0]:.2f} of the tolerance, a dscale of 0 by "
          f"{shares[1]:.2f} (both rejected)", flush=True)
    for R, d in RMSNORM_BWD_SHAPES[:2]:
        for dt in (torch.bfloat16, torch.float32):
            x, s, dy = rmsnorm_bwd_inputs(R, d, dt, dev)
            xl = x.clone().requires_grad_()
            wl = (1.0 + s.float()).to(dt).requires_grad_()
            y = torch.nn.functional.rms_norm(xl, (d,), weight=wl,
                                             eps=rn_mod.EPS)
            ms = timed_ms(lambda: rn_mod.rmsnorm_bwd(x, s, dy), 50)
            plain_ms = timed_ms(lambda: ref.rmsnorm_bwd_ref(x, s, dy), 20)
            library_ms = timed_ms(lambda: torch.autograd.grad(
                y, (xl, wl), dy, retain_graph=True), 50)
            b_ms, b_by = rmsnorm_bwd_bound_ms(R, d, x.element_size())
            row = dict(shape=[R, d], dtype=str(dt), ms=ms, plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
                       ratio=ms / library_ms)
            rows.append(row)
            print(f"train kernels: rmsnorm_bwd ({R}, {d}) {dt}: {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, F.rms_norm's autograd backward "
                  f"{library_ms:.4f} ms (kernel / library {row['ratio']:.3f}),"
                  f" bound {b_ms:.4f} ms ({b_by})", flush=True)
            del y, xl, wl
    return dict(max_abs_err=err, rows=rows)


def embedding_bwd_rows(dev) -> dict:
    """Phase 6a: the embedding's backward, ``common.row_order_sum`` (each
    token id's rows added in row order in bf16, one ``index_add_`` a
    rank: the reference's scatter-add), at ``EMBED_BWD_TOKENS`` of
    Granite's table (bf16, d 1,536) on ``SyntheticSource``'s token ids:
    the card's sums equal the CPU's bit for bit (the same function;
    ``index_add_`` rounds each exact add once); their distance from
    ``F.embedding``'s backward (f32 sums); both timed (CUDA events) beside
    the bound (dy read once, the 8 rows written)."""
    from repro_torch.training.data import Spec, SyntheticSource
    cfg = granite_moe_3b_a800m.CONFIG
    V, d = cfg.vocab_size, cfg.d_model
    rows = []
    for B, S in EMBED_BWD_TOKENS:
        ids = SyntheticSource({"t": Spec((B, S), np.int32)}, 0).batch_at(
            0)["t"].reshape(-1)
        ids = torch.from_numpy(ids).long()
        dy = randn((B * S, d), B * S, "cpu", torch.bfloat16)
        want = model_common.row_order_sum(ids, dy, V)
        ids_d, dy_d = ids.to(dev), dy.to(dev)
        got = model_common.row_order_sum(ids_d, dy_d, V)
        if not torch.equal(got.cpu(), want):
            fail(f"embedding backward ({B} x {S}): the card's row-order sum "
                 f"differs from the CPU's in "
                 f"{int((got.cpu() != want).sum())} values")
        lib = torch.ops.aten.embedding_dense_backward(dy_d, ids_d, V, -1,
                                                      False)
        used = torch.unique(ids)
        gap = float((lib[used.to(dev)].float() - got[used.to(dev)].float())
                    .abs().max() / got[used.to(dev)].float().abs().max())
        ms = timed_ms(lambda: model_common.row_order_sum(ids_d, dy_d, V), 5)
        library_ms = timed_ms(lambda: torch.ops.aten.embedding_dense_backward(
            dy_d, ids_d, V, -1, False), 20)
        b_ms, b_by = bound((B * S * d * 2 + len(used) * d * 2)
                           / HBM_BYTES_PER_S * 1e3,
                           B * S * d / F32_FLOP_PER_S * 1e3)
        per_id = torch.bincount(ids).max().item()
        row = dict(tokens=[B, S], ids=int(len(used)), most_rows_an_id=per_id,
                   ms=ms, library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
                   f32_sum_gap=gap)
        rows.append(row)
        print(f"train embedding backward ({B} x {S} tokens onto "
              f"{len(used)} ids, at most {per_id} rows an id; V {V}, d {d}, "
              f"bf16): the card's row-order sum equals the CPU's bit for bit; "
              f"{ms:.3f} ms ({per_id} index_add_ launches), F.embedding's "
              f"backward (f32 sums) {library_ms:.3f} ms and "
              f"{gap:.4f} of the largest |g| away, bound {b_ms:.4f} ms "
              f"({b_by})", flush=True)
    return dict(rows=rows)


def prng_checks(dev) -> dict:
    """Phase 6b: the diffusion losses' noise on the card (``models.prng``:
    ``t`` (256,) and ``eps`` (256, 32, 32, 4) of DiT-XL/2's train_256 at
    steps 0 and 1) equal to the CPU's bit for bit (the CPU's equal JAX's:
    ``tests/test_torch_prng.py``), and its time a step."""
    x = torch.zeros(256, 32, 32, 4, device=dev)
    for step in (0, 1):
        t, eps = diffusion.diffusion_noise(step, x)
        t_c, eps_c = diffusion.diffusion_noise(step, x.cpu())
        if not (torch.equal(t.cpu(), t_c) and torch.equal(eps.cpu(), eps_c)):
            fail(f"diffusion noise at step {step}: the card's t / eps differ "
                 f"from the CPU's")
    ms = timed_ms(lambda: diffusion.diffusion_noise(2, x), 5)
    print(f"train noise: t (256,) and eps (256, 32, 32, 4) drawn on the card "
          f"equal the CPU's bit for bit at steps 0 and 1 (threefry, erf_inv "
          f"with fused multiply-adds in f64); {ms:.3f} ms a draw", flush=True)
    return dict(bit_equal=True, ms=ms)


def moe_bwd_products(x, w, dy):
    """The two backward products of y = x w as ``ops.MoEGemmFn`` forms
    them on the card: (dy, w^T) and (x^T, dy) with C padded to a multiple
    of 8."""
    wt = w.transpose(1, 2).contiguous()
    xt = ops._pad_rows(x.transpose(1, 2).contiguous(), 8, 2)
    return (dy, wt), (xt, ops._pad_rows(dy, 8, 1))


def moe_bwd_checks(dev) -> dict:
    """Phase 6a: ``ops.moe_gemm``'s gradients on the card (three launches:
    the forward and the two backward products) against autograd of the
    plain version at ``MOE_BWD_SHAPES``, bf16 and f32, each product with
    its variant; the dW check shown to reject a dW without the last 8 rows
    of C; times of each product beside the plain version, ``torch.bmm``
    and the bound."""
    err, rows = 0.0, []
    for name, (E, C, d, f) in MOE_BWD_SHAPES.items():
        for dt in (torch.bfloat16, torch.float32):
            x, w = moe_inputs(E, C, d, f, dt, dev)
            dy = randn((E, C, f), C + f + 2, dev, dt, 0.1)
            lx, lw = x.clone().requires_grad_(), w.clone().requires_grad_()
            n0 = mg_mod.moe_gemm.launches
            ops.moe_gemm(lx, lw).backward(dy)
            if mg_mod.moe_gemm.launches - n0 != 3:
                fail(f"moe_gemm backward {name} {dt}: "
                     f"{mg_mod.moe_gemm.launches - n0} launches, not 3")
            px, pw = x.clone().requires_grad_(), w.clone().requires_grad_()
            ref.moe_gemm_ref(px, pw).backward(dy)
            (a1, b1), (a2, b2) = moe_bwd_products(x, w, dy)
            tol_dx, tol_dw = (ref.moe_gemm_tolerance(a1, b1),
                              ref.moe_gemm_tolerance(a2, b2))
            e = max(check_close(f"moe_gemm dx {name} {dt}", lx.grad, px.grad,
                                tol_dx),
                    check_close(f"moe_gemm dw {name} {dt}", lw.grad, pw.grad,
                                tol_dw))
            err = max(err, e)
            variants = (mg_mod.variant(a1, b1), mg_mod.variant(a2, b2))
            share = None
            if dt == torch.bfloat16 and name == "gate_up/853":
                bad = ref.moe_gemm_ref(x.transpose(1, 2)[..., :-8]
                                       .contiguous(), dy[:, :-8])
                share = tolerance_share(bad, pw.grad, tol_dw)
                if share <= 1.0:
                    fail("the moe_gemm dW check passes a dW without the last "
                         "8 rows of C")
            print(f"train kernels: moe_gemm backward {name} {(E, C, d, f)} "
                  f"{dt}: dx ({tuple(a1.shape)} x {tuple(b1.shape)}) "
                  f"variant {variants[0]}, dW ({tuple(a2.shape)} x "
                  f"{tuple(b2.shape)}) variant {variants[1]}; max abs err {e}"
                  + ("" if share is None else f"; a dW without the last 8 "
                     f"rows of C errs by {share:.1f} of its tolerance "
                     f"(rejected)"), flush=True)
            if dt == torch.bfloat16:
                for what, (a, b) in (("dx", (a1, b1)), ("dW", (a2, b2))):
                    ms = timed_ms(lambda: mg_mod.moe_gemm(a, b), 20)
                    plain_ms = timed_ms(lambda: ref.moe_gemm_ref(a, b), 10)
                    lib_ms = timed_ms(lambda: torch.bmm(a, b), 20)
                    b_ms, b_by = moe_bound_ms(a.shape[0], a.shape[1],
                                              a.shape[2], b.shape[2], 2)
                    rows.append(dict(product=f"{name} {what}",
                                     shape=[*a.shape, b.shape[2]],
                                     variant=mg_mod.variant(a, b), ms=ms,
                                     plain_ms=plain_ms, library_ms=lib_ms,
                                     bound_ms=b_ms, bound_by=b_by,
                                     ratio=ms / lib_ms))
                    print(f"train kernels: moe_gemm {name} {what} "
                          f"{tuple(rows[-1]['shape'])} "
                          f"({rows[-1]['variant']}): {ms:.4f} ms, plain "
                          f"{plain_ms:.4f} ms, torch.bmm {lib_ms:.4f} ms "
                          f"(kernel / library {ms / lib_ms:.3f}), bound "
                          f"{b_ms:.4f} ms ({b_by})", flush=True)
            del x, w, dy, lx, lw, px, pw, a1, b1, a2, b2
    return dict(max_abs_err=err, rows=rows)


def train_golden_checks(dev) -> dict:
    """Phase 6b: the port's train steps on the card against the
    reference's in ``tests/data/torch_train_golden.npz`` (Granite at full
    width, 2 layers, f32 and bf16; DeiT-B at full width, 2 layers; the
    smoke configs over 3 steps), each within ``tests/train_golden.py``'s
    limits; the planted faults of ``train_golden.FAULTS`` each rejected
    on Granite's f32 section, and the embedding's on its bf16 one (under
    the general limit: the row-order bf16 sum); the diffusion
    sections (DiT-XL/2 at full width with 2 layers, the UNet at full width
    with one ResBlock a level, f32 and bf16; their smoke configs) and
    ``train_golden.DIFFUSION_FAULTS``, each on its family's f32
    section."""
    tg = train_golden_module()
    want = np.load(TRAIN_GOLDEN)
    cfgs = tg.port_configs()
    out = {}
    trees = {}          # the full-width sections' weights, f32 numpy

    def tree_of(name):
        group = name.split("/")[0]
        if group == "smoke":
            return None
        if group not in trees:
            trees[group] = tg.numpy_weights(cfgs[name])
        return trees[group]

    for name, cfg in cfgs.items():
        t0 = time.time()
        tree = tree_of(name)
        rec, losses = tg.port_record(name, cfg, want, device=dev, tree=tree)
        shares = tg.compare(rec, want, name, cfg.param_dtype)
        bad = tg.fails(shares)
        worst = max(shares, key=shares.get)
        if bad:
            fail(f"train golden {name}: {len(bad)} checks past their limits, "
                 f"e.g. {dict(list(bad.items())[:6])}")
        out[name] = dict(worst=worst, share=shares[worst], losses=losses,
                         s=time.time() - t0)
        embed = shares.get(f"{name}/embed/g")
        print(f"train golden {name}: every check within its limit (the "
              f"nearest: {worst} at {shares[worst]:.3f} of its limit"
              + ("" if embed is None else
                 f"; the embedding's gradient at {embed:.3f}")
              + f"); losses {losses} (reference "
              f"{list(want[name + '/losses'])}); {time.time() - t0:.1f} s",
              flush=True)
    faults = {}
    runs = [("granite/float32", f) for f in tg.FAULTS] + [
        ("granite/bfloat16", "embed_overwrite")] + [
        (f"{fam}/float32", f) for f, fam in tg.DIFFUSION_FAULTS.items()]
    for name, fault in runs:
        with tg.planted(fault):
            rec, _ = tg.port_record(name, cfgs[name], want, device=dev,
                                    tree=tree_of(name))
        bad = tg.fails(tg.compare(rec, want, name, cfgs[name].param_dtype))
        if not bad:
            fail(f"train golden: the planted fault {fault} passes {name}")
        faults[f"{name} {fault}"] = len(bad)
    print(f"train golden: each planted fault fails (checks past their "
          f"limits: {faults})", flush=True)
    out["faults"] = faults
    trees.clear()
    return out


def leaf_samples(params) -> list:
    """A strided sample of at most 2^20 values of each leaf (clones)."""
    out = []
    for p in model_common.leaves(params):
        flat = p.reshape(-1)
        out.append(flat[::max(1, flat.numel() >> 20)].clone())
    return out


def train_cell(arch, cfg, shape):
    from repro_torch.launch import steps as S
    return S.build_cell(arch, shape.name, cfg=cfg, shape=shape)


def granite_train(dev) -> dict:
    """Phase 6c: Granite-3.0 MoE at full width and depth through
    ``launch.train``'s ``run``: 4,096-token sequences at B =
    ``TRAIN_BATCH``, bf16 weights, f32 moments, remat; one warm step,
    ``TRAIN_TIMED`` timed (CUDA events around each); every leaf changed,
    finite loss and gradient norm, each kernel's launches a step as the
    counters saw them.  (The warm step is not profiled, for the time
    budget: PERF.md section 5 keeps its earlier device time by kind.)"""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.training.train_loop import TrainLoopConfig, run
    cfg = granite_moe_3b_a800m.CONFIG
    shape = ShapeSpec("chip_train", "train", seq_len=LM_SHAPES[
        "train_4k"].seq_len, global_batch=TRAIN_BATCH)
    cell = train_cell(cfg.name, cfg, shape)
    init, made = cell.make_args, {}

    def make_args(seed, device):
        """The run's own initial weights, sampled before its first step."""
        args = init(seed, device)
        made["before"] = leaf_samples(args[0])
        made["n_params"] = model_common.count_params(args[0])
        made["state_bytes"] = sum(t.numel() * t.element_size() for t in
                                  itertools.chain(*(model_common.leaves(x)
                                                    for x in (args[0],
                                                              args[1].m,
                                                              args[1].v))))
        made["t_init"] = time.time() - t_run
        return args

    cell.make_args = make_args
    steps, real = [], cell.step_fn

    def step_fn(params, opt_state, batch):
        c0 = train_counts()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        out = real(params, opt_state, batch)
        t1.record()
        torch.cuda.synchronize()
        c1 = train_counts()
        steps.append(dict(
            ms=t0.elapsed_time(t1),
            launches={n: c1[n] - c0[n] for n in c1},
            loss=float(out[2]["loss"]), grad_norm=float(out[2]["grad_norm"]),
            aux=float(out[2]["aux_loss"])))
        return out

    cell.step_fn = step_fn
    torch.cuda.reset_peak_memory_stats()
    train_counts(zero=True)
    t0 = t_run = time.time()
    res = run(cell, TrainLoopConfig(total_steps=TRAIN_WARM + TRAIN_TIMED,
                                    log_every=1, seed=0),
              log_fn=lambda m: print(f"granite train: {m}", flush=True),
              device=dev)
    wall = time.time() - t0
    counts = train_counts()
    peak = torch.cuda.max_memory_allocated()
    after = leaf_samples(res["params"])
    before, n_params = made["before"], made["n_params"]
    state_bytes = made["state_bytes"]
    unchanged = [i for i, (a, b) in enumerate(zip(before, after))
                 if torch.equal(a, b)]
    if unchanged:
        fail(f"granite train: {len(unchanged)} leaves unchanged after "
             f"{len(steps)} steps")
    if not all(np.isfinite([s["loss"], s["grad_norm"]]).all()
               for s in steps):
        fail(f"granite train: a loss or gradient norm is not finite: {steps}")
    L = cfg.n_layers
    want = {"rmsnorm": 2 * L + 1 + 2 * L, "rmsnorm_backward": 2 * L + 1,
            "moe_gemm": 4 * 3 * L, "flash_attention": 0}
    for i, s in enumerate(steps):
        if s["launches"] != want:
            fail(f"granite train step {i}: launches {s['launches']}, not "
                 f"{want} (rmsnorm 2L + 1 forward and 2L again under remat; "
                 f"its backward 2L + 1; moe_gemm 3L forward, 3L under remat "
                 f"and 6L backward)")
    timed = [s["ms"] for s in steps[TRAIN_WARM:TRAIN_WARM + TRAIN_TIMED]]
    ms = float(np.median(timed))
    tokens = TRAIN_BATCH * shape.seq_len
    row = dict(batch=TRAIN_BATCH, seq=shape.seq_len, n_params=n_params,
               state_gb=state_bytes / 1e9, step_ms=timed, ms=ms,
               tokens_per_s=tokens / (ms / 1e3), peak_gb=peak / 1e9,
               warm_ms=steps[0]["ms"], launches_per_step=want, wall_s=wall,
               init_s=made["t_init"],
               losses=[s["loss"] for s in steps],
               grad_norms=[s["grad_norm"] for s in steps], counts=counts)
    print(f"granite train (full width and depth, {n_params} parameters, "
          f"B={TRAIN_BATCH} x {shape.seq_len} tokens; parameters and AdamW "
          f"state {row['state_gb']:.2f} GB): step {ms:.1f} ms (median of "
          f"{[round(t, 1) for t in timed]}), {row['tokens_per_s']:.0f} "
          f"tokens/s, peak memory {row['peak_gb']:.2f} GB; the warm step "
          f"{row['warm_ms']:.1f} ms", flush=True)
    print(f"granite train: launches a step {want} on every step; losses "
          f"{row['losses']}, grad norms {row['grad_norms']}; every leaf "
          f"changed; run() {wall:.1f} s, of which the weights' and the "
          f"optimizer state's initialisation {made['t_init']:.1f} s",
          flush=True)
    return row


def deit_train(dev) -> dict:
    """Phase 6c: DeiT-B ``cls_224`` at its full global batch through
    ``run``: ``DEIT_STEPS`` steps uninterrupted, against ``DEIT_CKPT_AT``
    steps ending in a checkpoint, then a fresh run resumed from that
    checkpoint to ``DEIT_STEPS``: every parameter and moment equal bit for
    bit."""
    import shutil
    from repro_torch.configs.shapes import VISION_SHAPES
    from repro_torch.training.train_loop import TrainLoopConfig, run
    cfg = deit_b.CONFIG
    cell = train_cell(cfg.name, cfg, VISION_SHAPES["cls_224"])
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    logs = []
    quiet = dict(log_fn=logs.append, device=dev)
    # checkpoints only where the run ends (ckpt_every past the end)
    once = dict(ckpt_every=DEIT_STEPS + 1, log_every=1,
                ckpt_dir=TRAIN_CKPT_DIR)
    t0 = time.time()
    full = run(cell, TrainLoopConfig(total_steps=DEIT_STEPS, log_every=1),
               **quiet)
    t_full = time.time() - t0
    t0 = time.time()
    run(cell, TrainLoopConfig(total_steps=DEIT_CKPT_AT, **once), **quiet)
    resumed = run(cell, TrainLoopConfig(total_steps=DEIT_STEPS, **once),
                  **quiet)
    t_resumed = time.time() - t0
    if f"[train] resumed from step {DEIT_CKPT_AT}" not in logs:
        fail(f"deit train: the fresh run did not resume: {logs}")
    got, want = ([*model_common.leaves(r["params"]),
                  *model_common.leaves(r["opt_state"].m),
                  *model_common.leaves(r["opt_state"].v)]
                 for r in (resumed, full))
    differ = sum(not torch.equal(a, b) for a, b in zip(got, want))
    if differ or int(resumed["opt_state"].step) != DEIT_STEPS:
        fail(f"deit train: the resumed run differs from the uninterrupted "
             f"one in {differ} of {len(got)} leaves")
    losses = [l for _, l in full["losses"]]
    if not np.isfinite(losses).all():
        fail(f"deit train: losses {losses}")
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    print(f"deit train (cls_224, B=256, full width and depth): {DEIT_STEPS} "
          f"steps in {t_full:.1f} s, losses {losses}; a run to step "
          f"{DEIT_CKPT_AT} and its checkpoint, then a fresh run resumed from "
          f"it to {DEIT_STEPS} ({t_resumed:.1f} s with the two checkpoints' "
          f"writes and one read): equal to the uninterrupted run bit for bit "
          f"in all {len(got)} parameter and moment leaves", flush=True)
    return dict(steps=DEIT_STEPS, resumed_from=DEIT_CKPT_AT, losses=losses,
                wall_s=t_full, resumed_s=t_resumed, bit_equal=True)


def attention_ms(cfg, B, dev) -> float:
    """One layer's attention at the train step's shapes (``cfg``'s impl,
    bf16, B x n_tokens, heads of d / n_heads) as the step runs it: two
    forwards (the second remat's, where ``cfg.remat``) and one backward
    (CUDA events; the kernels are the step's matrix products and its
    softmax, which the profile cannot tell from the others')."""
    S, nh = cfg.n_tokens(), cfg.n_heads
    hd = cfg.d_model // nh
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn(B, S, nh, hd, generator=gen, device=dev,
                           dtype=torch.bfloat16).requires_grad_()
               for _ in range(3))
    dy = torch.randn(B, S, nh, hd, generator=gen, device=dev,
                     dtype=torch.bfloat16)

    def once():
        kw = dict(causal=False, impl=cfg.attn_impl, q_chunk=cfg.attn_chunk)
        if cfg.remat:
            with torch.no_grad():
                attn_mod.attention(q, k, v, **kw)
        torch.autograd.grad(attn_mod.attention(q, k, v, **kw), (q, k, v), dy)
    return timed_ms(once, 3)


def diffusion_train(arch, cfg, B, dev) -> dict:
    """Phase 6c: ``arch`` at full width and depth at train_256's 256 px
    (latent 32) and global batch ``B`` through ``launch.train``'s ``run``,
    bf16 weights, f32 moments: one warm step, one profiled (device time
    by kind, the device's busy share, kernels a step), ``DIFF_TIMED``
    timed (CUDA events around each); the peak memory; finite losses;
    every leaf's first moment nonzero (the gradient reached every leaf:
    the UNet's zero-initialised ``c2`` and ``conv_out`` hold it back for
    the first two steps) and the leaves that moved counted (a bf16 weight
    keeps its value under the warm-up's updates of ~lr = 3e-6 .. 1.2e-5
    unless it is near 0); no repo kernel launched (none is on these
    paths)."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.training.train_loop import TrainLoopConfig, run
    shape = ShapeSpec("chip_train", "train", img_res=256, global_batch=B)
    cell = train_cell(arch, cfg, shape)
    init, made, steps, real = cell.make_args, {}, [], cell.step_fn

    def make_args(seed, device):
        args = init(seed, device)
        made["before"] = leaf_samples(args[0])
        made["n_params"] = model_common.count_params(args[0])
        return args

    def step_fn(params, opt_state, batch):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        holder, prof = {}, None
        if len(steps) == 1:
            def once():            # a retried profiler window runs nothing
                if not holder:
                    holder["out"] = real(params, opt_state, batch)
            prof = profiled(once, cpu=False)
        else:
            t0.record()
            holder["out"] = real(params, opt_state, batch)
            t1.record()
        torch.cuda.synchronize()
        out = holder["out"]
        steps.append(dict(ms=None if prof else t0.elapsed_time(t1),
                          prof=prof, loss=float(out[2]["loss"]),
                          grad_norm=float(out[2]["grad_norm"])))
        return out

    cell.make_args, cell.step_fn = make_args, step_fn
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    train_counts(zero=True)
    t0 = time.time()
    res = run(cell, TrainLoopConfig(total_steps=2 + DIFF_TIMED, log_every=1,
                                    seed=0),
              log_fn=lambda m: print(f"{arch} train: {m}", flush=True),
              device=dev)
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = train_counts()
    after = leaf_samples(res["params"])
    moved = sum(not torch.equal(a, b) for a, b in zip(made["before"], after))
    no_grad = [i for i, m in enumerate(model_common.leaves(res["opt_state"].m))
               if not bool(m.ne(0).any())]
    del res, after
    if no_grad or not moved or any(counts.values()) or not np.isfinite(
            [[x["loss"], x["grad_norm"]] for x in steps]).all():
        fail(f"{arch} train: leaves {no_grad} never had a gradient, {moved} "
             f"moved, repo kernels launched {counts}, or losses {steps}")
    timed = [x["ms"] for x in steps[2:]]
    ms = float(np.median(timed))
    prof = steps[1]["prof"]
    kinds = dict.fromkeys(("matmul", "softmax", "other"), 0.0)
    for name, us in prof["device_us"].items():
        n = name.lower()
        kind = ("softmax" if "softmax" in n else "matmul" if any(
            k in n for k in ("gemm", "xmma", "cutlass", "nvjet", "matmul",
                             "conv", "fprop", "dgrad", "wgrad")) else "other")
        kinds[kind] += us / 1e3
    busy = prof["busy_us"] / 1e3
    att = attention_ms(cfg, B, dev) * cfg.n_layers \
        if cfg.family == "dit" else None
    top = sorted(prof["device_us"].items(), key=lambda kv: -kv[1])[:6]
    row = dict(batch=B, img_res=256, n_params=made["n_params"],
               leaves=len(made["before"]), leaves_moved=moved,
               warm_ms=steps[0]["ms"], step_ms=timed,
               ms=ms, images_per_s=B / (ms / 1e3), peak_gb=peak / 1e9,
               busy_ms=busy, profiled_ms=prof["wall_us"] / 1e3,
               idle=max(0.0, 1.0 - busy / (prof["wall_us"] / 1e3)),
               kinds_ms=kinds, kernels_per_step=sum(
                   prof["device_counts"].values()), wall_s=wall,
               losses=[x["loss"] for x in steps],
               grad_norms=[x["grad_norm"] for x in steps],
               top_kernels_ms={k[:90]: v / 1e3 for k, v in top})
    if cfg.family == "dit":
        row["attention_ms"] = att
    print(f"{arch} train (full width and depth, {made['n_params']} "
          f"parameters, B={B} at 256 px): step {ms:.1f} ms (median of "
          f"{[round(t, 1) for t in timed]}), {row['images_per_s']:.1f} "
          f"images/s, peak memory {row['peak_gb']:.2f} GB; the first step "
          f"{row['warm_ms']:.1f} ms; the second, profiled: "
          f"{row['profiled_ms']:.1f} ms, device busy {busy:.1f} ms "
          f"(idle {row['idle']:.3f}), {row['kernels_per_step']} device "
          f"kernels, by kind " + ", ".join(
              f"{k} {v:.1f} ms ({v / max(busy, 1e-9):.3f})"
              for k, v in kinds.items())
          + (f"; attention (L x two forwards and a backward, alone) "
             f"{att:.1f} ms ({att / max(busy, 1e-9):.3f})"
             if cfg.family == "dit" else "")
          + "; largest: " + "; ".join(f"{k} {v:.2f} ms" for k, v in
                                      row["top_kernels_ms"].items())
          + f"; losses {row['losses']}; every leaf had a gradient, "
          f"{moved} of {len(made['before'])} moved; run() {wall:.1f} s",
          flush=True)
    return row


def dit_resume(dev) -> dict:
    """Phase 6c: DiT-XL/2 at full width and batch, depth cut to
    ``DIT_RESUME_LAYERS``: ``DIT_RESUME_STEPS`` steps uninterrupted,
    against a run to step 1 ending in a checkpoint and a fresh run
    resumed from it: every parameter and moment equal bit for bit (step
    1's noise drawn from its step after the restart)."""
    import shutil
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.training.train_loop import TrainLoopConfig, run
    cfg = dataclasses.replace(dit_xl2.CONFIG, n_layers=DIT_RESUME_LAYERS)
    cell = train_cell(cfg.name, cfg, ShapeSpec("chip_resume", "train",
                                               img_res=256, global_batch=256))
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    logs = []
    quiet = dict(log_fn=logs.append, device=dev)
    once = dict(ckpt_every=DIT_RESUME_STEPS + 1, log_every=1,
                ckpt_dir=TRAIN_CKPT_DIR)
    t0 = time.time()
    full = run(cell, TrainLoopConfig(total_steps=DIT_RESUME_STEPS,
                                     log_every=1), **quiet)
    run(cell, TrainLoopConfig(total_steps=1, **once), **quiet)
    resumed = run(cell, TrainLoopConfig(total_steps=DIT_RESUME_STEPS,
                                        **once), **quiet)
    if "[train] resumed from step 1" not in logs:
        fail(f"dit train: the fresh run did not resume: {logs}")
    got, want = ([*model_common.leaves(r["params"]),
                  *model_common.leaves(r["opt_state"].m),
                  *model_common.leaves(r["opt_state"].v)]
                 for r in (resumed, full))
    differ = sum(not torch.equal(a, b) for a, b in zip(got, want))
    if differ:
        fail(f"dit train: the resumed run differs from the uninterrupted one "
             f"in {differ} of {len(got)} leaves")
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    losses = [l for _, l in full["losses"]]
    print(f"dit train: DiT-XL/2 at full width, B=256, depth cut to "
          f"{DIT_RESUME_LAYERS}: {DIT_RESUME_STEPS} steps uninterrupted "
          f"(losses {losses}) equal, bit for bit in all {len(got)} parameter "
          f"and moment leaves, a run to step 1 and a fresh run resumed from "
          f"its checkpoint ({time.time() - t0:.1f} s in all)", flush=True)
    return dict(n_layers=DIT_RESUME_LAYERS, steps=DIT_RESUME_STEPS,
                losses=losses, bit_equal=True, s=time.time() - t0)


def train_phase(dev) -> dict:
    """Phase 6: the kernel checks and the embedding's backward (a), the
    noise and the golden (b), the main paths (c)."""
    t0 = time.time()
    rb = rmsnorm_bwd_checks(dev)
    mb = moe_bwd_checks(dev)
    emb = embedding_bwd_rows(dev)
    noise = prng_checks(dev)
    golden = train_golden_checks(dev)
    print(f"train phase a-b: {time.time() - t0:.1f} s", flush=True)
    t1 = time.time()
    granite = granite_train(dev)
    torch.cuda.empty_cache()
    deit = deit_train(dev)
    torch.cuda.empty_cache()
    t2 = time.time()
    dit_row = diffusion_train("dit-xl2", dit_xl2.CONFIG, 256, dev)
    torch.cuda.empty_cache()
    resume = dit_resume(dev)
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"unet train: {free / 1e9:.2f} GB of the card's {total / 1e9:.2f} "
          f"free before B={UNET_TRAIN_BATCH}, whose largest peak seen is "
          f"{UNET_PEAK_GB} GB: a margin of {free / 1e9 - UNET_PEAK_GB:.2f} "
          f"GB", flush=True)
    if free / 1e9 < UNET_PEAK_GB:
        fail(f"unet train: {free / 1e9:.2f} GB free, under the "
             f"{UNET_PEAK_GB} GB that B={UNET_TRAIN_BATCH} has taken")
    unet_row = diffusion_train("unet-sd15", unet_sd15.CONFIG,
                               UNET_TRAIN_BATCH, dev)
    unet_row["free_gb_before"] = free / 1e9
    torch.cuda.empty_cache()
    print(f"train phase c: {time.time() - t1:.1f} s (diffusion "
          f"{time.time() - t2:.1f} s); train phase: {time.time() - t0:.1f} s",
          flush=True)
    return dict(rmsnorm_bwd=rb, moe_bwd=mb, embedding_bwd=emb, noise=noise,
                golden=golden, granite=granite, deit=deit,
                dit=dict(dit_row, resume=resume), unet=unet_row,
                s=time.time() - t0)


# ---------------------------------------------------------------------------
# Phase 6d: the roofline of the card's own steps
# ---------------------------------------------------------------------------
# (name, arch, kind, shape, config changes): the full-width runs whose time
# phases 4g, 4h and 6c measure, at the batch and attn_impl each ran (4h's
# prefill fills a cache of S + 35 slots, the counted one of S)
ROOFLINE_RUNS = (
    ("Granite-3.0 MoE prefill_32k B=1 (4h)", "granite-moe-3b-a800m",
     "prefill", dict(seq_len=32768, global_batch=1),
     dict(attn_impl="pallas")),
    ("DiT-XL/2 gen_fast B=16 (4g)", "dit-xl2", "serve",
     dict(img_res=512, global_batch=16), dict(attn_impl="pallas")),
    ("DiT-XL/2 gen_1024 B=4 (4g)", "dit-xl2", "serve",
     dict(img_res=1024, global_batch=4), dict(attn_impl="pallas")),
    ("UNet gen_fast B=16 (4g)", "unet-sd15", "serve",
     dict(img_res=512, global_batch=16), {}),
    ("DiT-XL/2 train_256 B=256 (6c)", "dit-xl2", "train",
     dict(img_res=256, global_batch=256), {}),
    ("UNet train_256 B=96 (6c)", "unet-sd15", "train",
     dict(img_res=256, global_batch=UNET_TRAIN_BATCH), {}),
    ("Granite-3.0 MoE train_4k B=2 (6c)", "granite-moe-3b-a800m", "train",
     dict(seq_len=4096, global_batch=TRAIN_BATCH), {}),
)
# a roofline share (the larger of the counted compute and memory times over
# the measured time) above this means the count is wrong: it is repaired,
# never this limit
ROOFLINE_LIMIT = 1.05
DRYRUN_OUT = os.path.join(ROOT, "build", "dryrun")
DRYRUN_GOLDEN = os.path.join(ROOT, "tests", "data",
                             "torch_dryrun_golden.json")
DRYRUN_ARCH, DRYRUN_SHAPE = "granite-moe-3b-a800m", "prefill_32k"
# Granite's decode step at B=1 before the kernels became torch.library
# operators (PERF.md section 5, run CI: host-bound, device idle 0.644)
DECODE_B1_BEFORE_MS = 138.517


def count_runs(path: str) -> int:
    """``chip_smoke.py --count-runs PATH``: each run of ``ROOFLINE_RUNS``
    counted unmeshed (one chip) on fake CUDA tensors by the dry run's cost
    model (``launch.dryrun.count_cell``: the kernels by their FLOP
    formulas, no launch), written to ``PATH`` as JSON.  Phase 6d starts it
    in its own process beside the other phases."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun, roofline, steps as S
    rows = {}
    for name, arch, kind, sk, ck in ROOFLINE_RUNS:
        t0 = time.time()
        cfg = dataclasses.replace(get_config(arch), **ck)
        shape = ShapeSpec("chip_" + kind, kind, **sk)
        cell = S.build_cell(arch, shape.name, cfg=cfg, shape=shape)
        c = dryrun.count_cell(cell, "cuda")
        rows[name] = dict(flops=c.costs.flops, bytes=c.costs.bytes,
                          depths=list(c.depths),
                          model_flops=roofline.model_flops_estimate(cfg,
                                                                    shape),
                          s=time.time() - t0)
    with open(path, "w") as f:
        json.dump(rows, f, indent=1)
    return 0


def start_counts() -> dict:
    """The dry run of ``DRYRUN_ARCH`` / ``DRYRUN_SHAPE`` on both production
    meshes (``python -m repro_torch.launch.dryrun``, a fake group of 512
    ranks, fake CUDA tensors) and ``--count-runs``, each in a process of
    its own, started before phase 4g (whose steps, and 4h's and 6's, keep
    the card busy while the host has room), at a lower priority than this
    process, and read by phase 6d; their output goes to ``build/dryrun/``."""
    os.makedirs(DRYRUN_OUT, exist_ok=True)
    # two host threads each, beside the main process's phases
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    cmds = {"dryrun": [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", DRYRUN_ARCH, "--shape", DRYRUN_SHAPE,
                       "--mesh", "both", "--out", DRYRUN_OUT],
            "runs": [sys.executable, os.path.abspath(__file__),
                     "--count-runs", os.path.join(DRYRUN_OUT, "runs.json")]}
    procs = {}
    for name, cmd in cmds.items():
        log = open(os.path.join(DRYRUN_OUT, f"{name}.log"), "w")
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT, env=env,
                                        cwd=ROOT,
                                        preexec_fn=lambda: os.nice(10)),
                       log)
    return procs


def stop_counts(procs) -> None:
    for proc, log in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def peak_rates(dev) -> dict:
    """One bf16 ``torch.matmul`` at 8192^3 and one 2 GiB device-to-device
    copy, CUDA events, the best of 5 after a warm call: each rate beside
    the roofline's peak (``PEAK_FLOPS``, ``HBM_BW``), and above 1.05 of it
    a failure (the peaks would not bound the card)."""
    from repro_torch.launch import roofline
    n = 8192
    a = torch.randn(n, n, device=dev, dtype=torch.bfloat16)
    b = torch.randn(n, n, device=dev, dtype=torch.bfloat16)
    src = torch.empty(1 << 30, device=dev, dtype=torch.bfloat16)
    dst = torch.empty_like(src)

    def best(fn):
        fn()
        times = []
        for _ in range(5):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1) / 1e3)
        return min(times)

    t_mm = best(lambda: torch.matmul(a, b))
    t_cp = best(lambda: dst.copy_(src))
    flops, moved = 2.0 * n ** 3, 2.0 * src.numel() * src.element_size()
    out = dict(matmul_s=t_mm, matmul_flops_per_s=flops / t_mm,
               matmul_share=flops / t_mm / roofline.PEAK_FLOPS,
               copy_s=t_cp, copy_bytes_per_s=moved / t_cp,
               copy_share=moved / t_cp / roofline.HBM_BW)
    print(f"roofline peaks ({card_line()}): bf16 matmul 8192^3 "
          f"{t_mm * 1e3:.3f} ms = {out['matmul_flops_per_s'] / 1e12:.1f} "
          f"TFLOP/s, {out['matmul_share']:.3f} of PEAK_FLOPS "
          f"{roofline.PEAK_FLOPS / 1e12:.0f} TFLOP/s; 2 GiB copy "
          f"{t_cp * 1e3:.3f} ms = {out['copy_bytes_per_s'] / 1e12:.3f} TB/s "
          f"(read + write), {out['copy_share']:.3f} of HBM_BW "
          f"{roofline.HBM_BW / 1e12:.2f} TB/s", flush=True)
    for what in ("matmul_share", "copy_share"):
        if out[what] > ROOFLINE_LIMIT:
            fail(f"roofline: the card's {what} {out[what]:.3f} is above "
                 f"{ROOFLINE_LIMIT} of the roofline's peak")
    del a, b, src, dst
    torch.cuda.empty_cache()
    return out


def dispatch_cost(dev, lm) -> dict:
    """The host time a ``torch.library`` operator adds to a kernel's call:
    ``rmsnorm`` at a decode row (1, 1536) bf16, called through the
    operator and through its wrapper directly, 2,000 calls each, the best
    of 3 (host clock, launches queued, one wait after each loop); with
    Granite's decode step at B=1 (phase 4h) beside its time before the
    operators."""
    from repro_torch.kernels import library
    x = torch.randn(1, 1536, device=dev, dtype=torch.bfloat16)
    s = torch.zeros(1536, device=dev, dtype=torch.bfloat16)
    calls = 2000

    def per_call(fn):
        best = float("inf")
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn(x, s)
            torch.cuda.synchronize()
            best = min(best, (time.perf_counter() - t0) / calls)
        return best

    op_us = per_call(library.ops.rmsnorm) * 1e6
    wrap_us = per_call(rn_mod.rmsnorm) * 1e6
    L = granite_moe_3b_a800m.CONFIG.n_layers
    per_step = 2 * L + 1 + 3 * L           # rmsnorm and moe_gemm calls a step
    decode = lm["decode_b1"]["ms"]
    out = dict(operator_us=op_us, wrapper_us=wrap_us,
               added_us=op_us - wrap_us, operator_calls_per_decode=per_step,
               decode_b1_ms=decode, decode_b1_before_ms=DECODE_B1_BEFORE_MS)
    print(f"operator dispatch: rmsnorm (1, 1536) bf16 {op_us:.2f} us a call "
          f"through torch.ops.repro_torch, {wrap_us:.2f} us through its "
          f"wrapper: {op_us - wrap_us:+.2f} us a call, x {per_step} kernel "
          f"calls a Granite decode step = "
          f"{(op_us - wrap_us) * per_step / 1e3:+.3f} ms; the decode step "
          f"at B=1 {decode:.3f} ms (phase 4h) against "
          f"{DECODE_B1_BEFORE_MS} ms before the operators ({card_line()})",
          flush=True)
    return out


def roofline_phase(dev, procs, measured, lm) -> dict:
    """Phase 6d: the peaks, each measured run's roofline and useful shares
    from its count (``--count-runs``), the dry run on the card against the
    reference's golden, and the operators' dispatch cost."""
    from repro_torch.launch import roofline
    t0 = time.time()
    out = dict(peaks=peak_rates(dev), dispatch=dispatch_cost(dev, lm))
    waits = {}
    for name, (proc, _) in procs.items():
        t1 = time.time()
        rc = proc.wait(timeout=900)
        waits[name] = time.time() - t1
        if rc != 0:
            with open(os.path.join(DRYRUN_OUT, f"{name}.log")) as f:
                tail = f.read()[-3000:]
            fail(f"roofline: the {name} process exited with {rc}: {tail}")
    out["waited_s"] = waits
    with open(os.path.join(DRYRUN_OUT, "runs.json")) as f:
        counts = json.load(f)
    card = card_line()
    rows = []
    for name, *_ in ROOFLINE_RUNS:
        c, ms = counts[name], measured[name]
        t_c, t_m = c["flops"] / roofline.PEAK_FLOPS, c["bytes"] / \
            roofline.HBM_BW
        share = max(t_c, t_m) / (ms / 1e3)
        useful = c["model_flops"] / (roofline.PEAK_FLOPS * ms / 1e3)
        rows.append(dict(run=name, ms=ms, t_compute_ms=t_c * 1e3,
                         t_memory_ms=t_m * 1e3, roofline_share=share,
                         useful_share=useful, **c))
        print(f"roofline {name}: t_compute {t_c * 1e3:.3f} ms, t_memory "
              f"{t_m * 1e3:.3f} ms, measured {ms:.3f} ms: roofline share "
              f"{share:.4f}, useful share {useful:.4f} (counted at depths "
              f"{c['depths']} in {c['s']:.1f} s, {c['flops']:.5g} FLOPs, "
              f"{c['bytes']:.5g} bytes, model FLOPs {c['model_flops']:.5g}; "
              f"{card})",
              flush=True)
        if share > ROOFLINE_LIMIT:
            fail(f"roofline {name}: share {share:.4f} above "
                 f"{ROOFLINE_LIMIT}: the count exceeds what the card did")
    out["runs"] = rows
    with open(DRYRUN_GOLDEN) as f:
        golden = json.load(f)["pairs"]
    dry = {}
    for mesh in ("single", "multi"):
        with open(os.path.join(DRYRUN_OUT, f"{DRYRUN_ARCH}__{DRYRUN_SHAPE}"
                                           f"__{mesh}.json")) as f:
            res = json.load(f)
        want = golden[f"{DRYRUN_ARCH}:{DRYRUN_SHAPE}:{mesh}"]
        got_b = res.get("memory", {}).get("argument_bytes")
        print(f"dry run {DRYRUN_ARCH}:{DRYRUN_SHAPE} on {res.get('mesh')} "
              f"({res.get('device')}, torch {torch.__version__}): "
              f"{res.get('status')}, model FLOPs {res.get('model_flops')} "
              f"(golden {want['model_flops']}), argument bytes {got_b} "
              f"(golden {want['memory']['argument_bytes']}), "
              f"{res.get('flops_per_chip', 0):.5g} FLOPs a chip (golden "
              f"{want['flops_per_chip']:.5g}), counted in "
              f"{res.get('compile_s')} s", flush=True)
        if res.get("status") != "ok" or res.get("device") != "cuda" or \
                res["model_flops"] != want["model_flops"] or \
                got_b != want["memory"]["argument_bytes"]:
            fail(f"dry run {mesh}: {res.get('status')}, not the golden's "
                 f"model FLOPs and argument bytes")
        dry[mesh] = {k: res[k] for k in (
            "flops_per_chip", "hbm_bytes_per_chip",
            "collective_bytes_per_chip", "collective_breakdown",
            "model_flops", "memory", "compile_s")}
    out["dryrun"] = dry
    out["s"] = time.time() - t0
    print(f"roofline phase: {out['s']:.1f} s (waited {waits} s for the "
          f"count processes)", flush=True)
    return out


def timed_build(name: str) -> float:
    t0 = time.time()
    build.load(name)
    return time.time() - t0


def process_seconds() -> float:
    """Wall seconds since this process started (the interpreter's start
    and the imports included), from ``/proc``."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--count-runs":
        if not torch.cuda.is_available():
            return 2
        return count_runs(sys.argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    t_start = time.time()

    # -- 1. card
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # -- 2. build, one nvcc per source, all started together (and the
    # empty kernel of phase 5's launch floor)
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES) + 1) as ex:
        floor = ex.submit(build_floor)
        secs = {n: ex.submit(timed_build, n) for n in SOURCES}
        for name, fut in secs.items():
            print(f"build: {name} {fut.result():.2f} s", flush=True)
            print(build.ptxas_report(name), end="", flush=True)
        print(f"build: empty kernel {floor.result():.2f} s", flush=True)
    draws = concurrent.futures.ThreadPoolExecutor(1)
    start_tree_draws(draws)
    counts = {}
    try:
        return run_phases(dev, t_start, card, draws, counts)
    finally:
        stop_counts(counts)


def run_phases(dev, t_start, card, draws, counts) -> int:
    """Phases 2b-7 (see the module's text); ``counts`` receives phase 6d's
    background processes."""

    # -- 2b. one rmsnorm call, one device kernel (the first profiled)
    one_kernel = rmsnorm_device_kernels(dev)

    # -- 3. the fleet simulator, 4. the vision serving path; of the
    # entry-point kernels only fleet_feasibility launches there, once a
    # decision of the heap's batched_feasible router (phase 3f)
    for fn in ENTRY_POINTS.values():
        fn.launches = 0
    t0 = time.time()
    entries = {}
    entries["event_select"], entries["event_scan"], kept = fleet_phase(dev)
    print(f"fleet phase: {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    entries["event_scan"]["heap"] = heap_phase(dev)
    print(f"heap phase: {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    sweeps = entries["event_scan"]["sweeps"] = sweep_phase(dev)
    entries["event_scan"]["launches_by_run"].update(sweeps["launches"])
    entries["event_scan"]["launches"] += sum(sweeps["launches"].values())
    print(f"sweep and telemetry phase: {time.time() - t0:.1f} s",
          flush=True)
    t0 = time.time()
    more = entries["event_scan"]["workloads"] = workload_phase(dev)
    entries["event_scan"]["launches_by_run"].update(more["launches"])
    entries["event_scan"]["launches"] += sum(more["launches"].values())
    print(f"workload, radio and 256-node phase: {time.time() - t0:.1f} s",
          flush=True)
    t0 = time.time()
    entries.update(vision_phase(dev))
    print(f"vision phase: {time.time() - t0:.1f} s", flush=True)
    # phase 6d's counts, each in a process of its own beside phases 4g-6
    counts.update(start_counts())
    entries.update(diffusion_phase(dev))
    on_paths = {name: fn.launches for name, fn in ENTRY_POINTS.items()}
    heap = entries["event_scan"]["heap"]
    want = dict.fromkeys(ENTRY_POINTS, 0)
    want["fleet_feasibility"] = heap["router"]["decisions"]
    if on_paths != want:
        fail(f"entry-point kernels launched {on_paths} on the fleet and "
             f"vision paths, not {want} (fleet_feasibility once a heap "
             f"router decision)")
    print(f"entry kernels on the fleet and vision paths: {on_paths} "
          f"(fleet_feasibility: one launch for each of the heap router's "
          f"{want['fleet_feasibility']} decisions)", flush=True)

    # -- 4h. the language-model serve path: rmsnorm's and moe_gemm's path
    lm, lm_weights = lm_phase(dev)
    # -- 4i. distribution: 4h's Granite prefill under a device mesh
    mesh = mesh_phase(dev, lm_weights)
    del lm_weights
    golden_tree.cache_clear()
    torch.cuda.empty_cache()

    # -- 5. the entry points
    t0 = time.time()
    routed = heap.pop("router_inputs")
    entries.update(entry_point_phase(dev, kept, one_kernel, routed))
    print(f"entry-point phase: {time.time() - t0:.1f} s", flush=True)
    for name in ENTRY_POINTS:
        entries[name]["launches_entry_point"] = entries[name]["launches"]
        entries[name]["launches"] = on_paths[name] or \
            entries[name]["launches"]
    entries["fleet_feasibility"]["path"] = (
        "the event heap's batched_feasible router (phase 3f: "
        "orchestration/router.py), one launch a decision")
    entries["fleet_feasibility"]["router"] = heap.pop("router")
    # rmsnorm and moe_gemm: their path is the LM's (phase 4h); the headline
    # numbers are the LM's own shapes, phase 5's rows stay under "shapes"
    for name in ("rmsnorm", "moe_gemm"):
        top = lm["kernels"][name][0]
        entries[name].update(
            launches=lm["launches"][name],
            max_abs_err=max(entries[name]["max_abs_err"],
                            lm["max_abs_err"][name]),
            path="the LM serve path (phase 4h: models/transformer.py, "
                 "models/moe.py; Granite-3.0 MoE prefill and decode)",
            lm_shapes=lm["kernels"][name],
            **{k: top[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "ratio")})
    # phase 4i's meshed prefill launches the same three kernels
    for name in ("rmsnorm", "moe_gemm"):
        entries[name]["launches"] += mesh["launches"][name]
        entries[name]["path"] += ("; the meshed prefill (phase 4i: "
                                  "models/moe.py::moe_ffn_sharded under a "
                                  "1 x 1 mesh)")
    entries["moe_gemm"]["max_abs_err"] = max(
        entries["moe_gemm"]["max_abs_err"], mesh["main"]["max_abs_err"])
    entries["moe_gemm"]["mesh"] = dict(
        launches=mesh["launches"]["moe_gemm"], prefill=mesh["main"],
        golden=mesh["golden"], elastic=mesh["elastic"])
    fl = entries["flash_attention"]
    fl["launches"] += lm["launches"]["flash_attention"] \
        + mesh["launches"]["flash_attention"]
    fl["max_abs_err"] = max(fl["max_abs_err"],
                            lm["max_abs_err"]["flash_attention"])
    fl["lm"] = dict(launches=lm["launches"]["flash_attention"],
                    shapes=lm["kernels"]["flash_attention"])
    # D = 128 (StarCoder2-7B's and Gemma-3 27B's heads): phase 4h's rows on
    # random inputs; no model of the main path has these heads yet
    d128 = lm["kernels"]["flash_attention_d128"]
    entries["flash_attention (tma_wgmma, D=128)"] = dict(
        launches=0, max_abs_err=lm["max_abs_err"]["flash_attention_d128"],
        **{k: d128[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "variant", "D", "ratio")},
        shapes=d128, path="none yet: StarCoder2-7B's causal and Gemma-3 "
        "27B's windowed attention at 32k on random inputs (phase 4h)")
    lm.pop("kernels")
    entries["flash_attention"]["lm"]["run"] = lm

    # -- 6. training (phase 6): the rmsnorm backward kernel, moe_gemm's
    # backward products, the golden train steps, Granite-3.0 MoE and DeiT-B
    # trained at full width through launch.train
    train = train_phase(dev)
    g = train["granite"]
    path = ("the train step (phase 6c: launch.train's run, Granite-3.0 MoE "
            "at full width and depth, B=2 x 4,096 tokens)")
    for name in ("rmsnorm", "moe_gemm"):
        e = entries[name]
        e["launches"] += g["counts"][name]
        e["path"] += "; " + path
        e["train"] = dict(launches=g["counts"][name],
                          launches_per_step=g["launches_per_step"][name])
    L = granite_moe_3b_a800m.CONFIG.n_layers
    mg = entries["moe_gemm"]
    mg["max_abs_err"] = max(mg["max_abs_err"], train["moe_bwd"]["max_abs_err"])
    mg["train"].update(forward_per_step=6 * L, backward_per_step=6 * L,
                       backward_products=train["moe_bwd"]["rows"])
    rb = train["rmsnorm_bwd"]
    top = rb["rows"][0]
    entries["rmsnorm_backward"] = dict(
        launches=g["counts"]["rmsnorm_backward"],
        max_abs_err=rb["max_abs_err"], path=path,
        note="the port's backward of the rmsnorm kernel: the reference "
             "differentiates its jnp rms_norm and has no backward kernel",
        launches_per_step=g["launches_per_step"]["rmsnorm_backward"],
        **{k: top[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "ratio", "shape", "dtype")},
        shapes=rb["rows"])
    entries["flash_attention"]["train"] = dict(
        launches=g["counts"]["flash_attention"],
        note="none: the train step takes the chunked attention (the "
             "published config), and the kernel raises under grad; none "
             "on the DiT-XL/2 and UNet train steps either (256 tokens take "
             "the plain path; the UNet's attention is plain)")

    # -- 6d. the roofline of the card's own steps
    steps_rows = {(r["model"], r["shape"]): r["ms"] for r in entries[
        "flash_attention (tma_wgmma, D=72)"]["dit_xl2"]["steps"]}
    measured = {
        ROOFLINE_RUNS[0][0]: lm["prefill"]["ms"],
        ROOFLINE_RUNS[1][0]: steps_rows[("DiT-XL/2", "gen_fast")],
        ROOFLINE_RUNS[2][0]: steps_rows[("DiT-XL/2", "gen_1024")],
        ROOFLINE_RUNS[3][0]: steps_rows[("UNet", "gen_fast")],
        ROOFLINE_RUNS[4][0]: train["dit"]["ms"],
        ROOFLINE_RUNS[5][0]: train["unet"]["ms"],
        ROOFLINE_RUNS[6][0]: train["granite"]["ms"]}
    roof = roofline_phase(dev, counts, measured, lm)
    print("roofline: " + json.dumps(roof), flush=True)

    # -- 7. the records
    print(f"card: {card}", flush=True)
    # an entry a kernel, and for flash_attention one a variant: "name
    # (variant, ...)" is the kernel "name"
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=KERNELS[name.split(" (")[0]][0],
             replaces=KERNELS[name.split(" (")[0]][1], **entry)
        for name, entry in entries.items()]}), flush=True)
    draws.shutdown()
    print(f"chip_smoke: {time.time() - t_start:.1f} s from the card's "
          f"first call, {process_seconds():.1f} s since the process "
          f"started", file=sys.stderr)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
