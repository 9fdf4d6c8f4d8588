"""On-card smoke run of the PyTorch/CUDA port (vptr_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, without the final result line):
1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel from csrc/ (one nvcc per source, in parallel)
   and print the build time and ptxas's register / spill report and any
   warning that it serialised wgmma products (C7520), and each
   instantiation of #2's and #4's bf16 kernels (attention_core_mma_kernel,
   attention_core_bwd_mma_kernel) by name with its registers and spills;
   count the HGMMA (wgmma) instructions in the SASS of the conv_ln_gelu,
   fused_ffn and window-attention libraries, forward and backward (#11,
   #12, #7, #8, and #1, #5, #3, #6) (cuobjdump), and fail if any has
   none;
3. hold each kernel against its plain PyTorch version on the card at the
   shapes the far_mnist paths give it, in bf16, f32 and f16 (f16 every
   call on the FMA routes, none on a bf16 tensor-core kernel; gates
   forward 2^-7 absolute beside bf16's 2^-4, backward 2^-8 relative
   beside bf16's 2^-5): the forwards at the far_rip shapes, a rectangular
   attention core, the residual/scale window variant and L 19 causal
   (dropout 0 and 0.1: the mask index over 24 tokens, bf16's 32); the
   forwards with dropout 0.1 at the far_rip and the
   training shapes, the window's with res and the DropPath scale at the
   training shape (dropout 0 and 0.1); the attention core (#2) also on
   q, k, v in the attention layer's strided layout (the (B, H, T, D) view
   of its projections' (B, T, H*D), the route kernel_route names, the
   output in q's layout) at far_rip's 640 x 8 x 20 causal, the FAR step's
   640 x 8 x 19 causal with dropout 0.1, and nar_mnist's 1024 x 8 x 10
   with dropout 0 and 0.1;
   both backward kernels at the training shapes (window 760 x 16 x 528,
   core 640 x 8 x 19 x 66), dropout 0 and 0.1, with a per-head bias for
   the bias gradients; the attention core's backward (#4) also on q, k,
   v and g in the layer's strided layout (the route backward_route names;
   dq, dk, dv in their inputs' layouts): the FAR step's 640 x 8 x 19
   causal with dropout 0.1, nar_mnist's 1024 x 8 x 10 with dropout 0 and
   0.1, and 640 x 8 x 19 with an 8-head bias and its gradient (two calls
   bit-equal, dbias included);
4. build far_mnist at full width from a seed (AE ngf 64 / feat 528 / 9 res
   blocks, FAR 12 layers / d 528 / 8 heads), run the far_rip predict entry
   point for 10 frames from 10 past frames at batch 10 with every launch
   counter set to 0 just before and read just after (each forward kernel
   must run 12 layers x 10 steps = 120 times), check the frames, and
   compare the teacher-forced "far" mode with kernels against
   kernels="plain";
5. train far_mnist at full width (the step make_far_train_step builds:
   batch 10, T = 19 teacher-forced, dropout / DropPath 0.1, clip -> AdamW
   with the preset's bf16 first moment): one step with every counter at 0
   just before and read just after (each of the four kernels must run 12
   times); one step with the kernels and one with kernels="plain" from one
   cloned state; 10 steps on one fixed batch, losses finite and falling;
6. time the far_rip predict call, the train step (median of 5 after 2
   warm-ups, and with kernels="plain") and each kernel beside its plain
   version, a PyTorch library yardstick and its bound (bytes or
   operations over the card's published peak); #1's to #4's yardsticks
   also replayed from CUDA graphs (a backward's as forward + backward less
   forward); #1-#4 again in f16 by the same code (the rows
   ``<name>_f16``: the same bytes, f16 products at 989 TFLOP/s, the
   yardstick in f16);
7. the NAR slice's kernels against their plain versions at the nar_mnist
   shapes (640 windows x 16 x 528), bf16, f32 and f16 (as phase 3),
   dropout 0 and 0.1:
   the two-stream kernels #5/#6 with an 8-head and a 1-head relative-
   position bias (forward, dx_qk, dx_v, every dW and db, dbias), and #1/#3
   with the 8-head bias, no position table and the bias gradient (#1 also
   with the 1-head bias);
8. build nar_mnist at full width from a seed (AE as far_mnist, NAR 4 + 8
   layers / d 528 / 8 heads, RPE) and run the "nar" predict entry point
   for 10 frames from 10 past frames at batch 16, every counter at 0 just
   before and read just after (#1 4, #5 8, #2 20 launches), check the
   frames and compare with kernels="plain";
9. train nar_mnist at full width (make_nar_train_step: batch 16, Tp = Tf
   = 10, dropout / DropPath 0.1, MSE + GDL + 0.1 BiPatchNCE, clip ->
   AdamW): one step with every counter at 0 (#1/#3 4, #5/#6 8, #2/#4 20
   launches); one step with the kernels and one with kernels="plain" from
   one cloned state; 10 steps on one batch, losses finite and falling;
10. time the nar predict call and the NAR train step (in turns with
   kernels="plain"), kernels #5/#6 beside their plain versions, library
   yardsticks (also replayed from CUDA graphs) and bounds, and #1/#3 at the
   NAR shape with the RPE bias; the kernels' readings again in f16;
11. the fused-FFN route's kernels (#7/#8 fused_ffn, #9/#10 fused_dw_chain)
   against their plain versions at the far_mnist shapes (FFN rows 12,800
   and 12,160 for the forward, 12,160 for the backward, C 528, hidden
   2112; dw chain 200 and 190 samples of 8 x 8 x 2112, #9 on the route
   its kernel_route names: persistent 16-block clusters in bf16, a cluster
   a sample in f32; #10 on the route its backward_route names: persistent
   16-block clusters in bf16, 8-block clusters over sample groups in f32;
   two calls of #9 and of #10 give the same bits), bf16 and f32, dropout
   0 and 0.1;
12. far_mnist with transformer.fused_ffn and fused_dw: the far_rip predict
   with every counter at 0 just before and read just after (#7, #9, #1
   and #2 120 launches each), the frames checked and compared with
   kernels="plain" and with the default route (same weights);
13. its train step: one step with every counter at 0 (#1-#4 and #7-#10 12
   launches each), kernels vs kernels="plain" from one cloned state, 10
   steps on one batch with a falling loss;
14. times: #7-#10 beside their plain versions, a library yardstick and the
   bound; #7's to #10's yardsticks also replayed from CUDA graphs (a
   backward's as forward + backward less forward); the far_rip predict and
   the train step on the fused route and the default route in turns, and
   each step's memory peak above what is held;
15. #11's bf16 product alone (the wgmma ring, 64 rows by 176, 352 and 528
   columns, K 528 and 2112) and #12's weight-gradient product alone (both
   operands MN-major, 1024 rows, both stages' Cin x Cout) against f32
   matmuls of the same operands;
   the conv-FFN route's kernels (#11/#12 conv_ln_gelu) against their
   plain versions at both stages of the far_mnist conv FFN (fc1 528 ->
   2112, fc2 2112 -> 528 over 8 x 8 latents; 200 samples forward, 190
   backward), and #1/#3 as the folded temporal sublayer calls them (the
   position table on q/k: 640 columns x 20 tokens causal, forward; 640 x
   19 causal and 1024 x 10, forward and backward; dropout 0 and 0.1), bf16
   and f32;
16. far_mnist with transformer.fused_conv_ffn and fused_full_temporal: the
   far_rip predict with every counter at 0 just before and read just after
   (#11 240 launches, #1 240: window and temporal, #2 0), the frames
   checked and compared with kernels="plain" and with the default route
   (same weights);
17. its train step (#11/#12 and #1/#3 24 launches each, #2/#4 0), kernels
   vs kernels="plain" from one cloned state, 10 steps on one batch with a
   falling loss;
18. times: the route's far_rip predict and FAR step against the default
   route in turns; the folded temporal sublayer (#1) against the default
   route's (LayerNorm, projections, #2); #11/#12 at both stages and #1/#3
   at the temporal shapes beside their plain versions, a library yardstick
   and the bound; #11's and #12's yardsticks, and #1's and #3's at the
   temporal shapes, also replayed from CUDA graphs (the backward's as
   forward + backward less forward);
19. nar_mnist with the same two flags: the nar predict (#11 32, #1 16, #5 8,
   #2 8 launches) and the train step (those and the backwards #12 32, #3
   16, #6 8, #4 8), each against kernels="plain";
20. build ae_mnist at full width from a seed (AE ngf 64 / feat 528 / 9 res
   blocks, PatchGAN ndf 64 / 3 layers, bf16, Adam(2e-4, 0.5, 0.999) for G
   and D, vanilla GAN at lam_gan 0.01) and take one stage-1 step on
   batch 32 x (10 + 10) frames of moving squares: every metric finite,
   Dtotal > 0, every parameter and every running statistic of the
   encoder, decoder and discriminator changed; 10 steps on one batch with
   AE_total falling; the eval step's frames shaped, finite, in [0, 1];
21. far_mnist's train step with lam_gan 0.01 and the discriminator on the
   default route: every counter at 0 just before and read just after
   (#1-#4 12 launches each), kernels vs kernels="plain" from one cloned
   state, Dtotal and T_gan finite and positive; then nar_mnist's once
   (phase 9's launches);
22. time the AE step (median of 5 after 2 warm-ups, training frames/s =
   640 / step time, the memory peak above what is held) and its eval
   step, and the far_mnist step with and without the GAN term in turns;
23. the commands users run, through vptr_tpu_torch.cli.main, on the
   synthetic loader (no dataset on disk), into a temporary directory
   removed after phase 58: `cli train` of ae_mnist at full width (8 steps and
   a validation pass; the metrics finite, ckpt/8/ written; its steps/s and
   training frames/s beside phase 22's bare AE step);
24. `cli train` of far_mnist at full width on phase 23's autoencoder
   (ae_ckpt), 12 steps and a validation pass, every counter at 0 just
   before and read just after (#1-#4 12 launches a train step, #1 and #2
   12 a validation batch); its steps/s, training frames/s and TFLOP/s
   beside phase 6's bare step; the train loader alone, on its native and
   its Python path, in batches/s, and the path the trainer took; a second
   `cli train` that logs "resumed from step 12" and writes ckpt/24/; the
   checkpoint's bytes and its save and restore times;
25. `cli eval --mode far_rip --max-batches 2` from that checkpoint: the
   curves finite, #1 and #2 120 launches a batch; evaluate's ms a batch
   and the metrics' share of it; one batch's PSNR / SSIM / MSE on the card
   (with cuDNN TF32 allowed: the metrics turn it off) against the same
   frames' on the CPU, 1e-5 relative;
26. `cli predict --mode far_rip --batches 1`: #1 and #2 120 launches; four
   GIFs and two clips written where PIL imports (else it says so);
27. TSLMA (transformer.tslma): #2 and #4 on their long route against the
   plain versions at nar_mnist's (64 windows, 8 heads, 160, 160, 66) and
   nar_bair's 160 x 32, bf16 (and f32 at 16 windows), contiguous and in
   the layer's layout, dropout 0 and 0.1, with and without a (8 | 1, Tq,
   Tk) bias and its gradient; both timed at 160 x 160 in the layer's
   layout (plain, kernel, kernel, plain; replayed from a CUDA graph),
   beside SDPA eager and graph-replayed (the backends that take the shape,
   the one dispatch picks) and the bound;
28. nar_mnist with transformer.tslma at full width: the nar predict with
   every counter at 0 just before and read just after (#1 4, #5 8, #2 20:
   12 on the mma route, 8 on the long route), the frames checked and
   compared with kernels="plain";
29. its train step (#3 4, #6 8, #4 20: 12 mma, 8 long), kernels vs
   kernels="plain" from one cloned state, 10 steps with a falling loss;
30. `cli predict --preset nar_mnist --set transformer.tslma=true --mode nar
   --batches 1`: 8 long-route launches of #2, its frames on the card and
   finite;
31. the TSLMA predict and train step against nar_mnist's full temporal
   enc-dec attention (same preset, tslma off), in turns: ms, frames/s;
32. data parallelism (vptr_tpu_torch.parallel) at far_bair_dp full width:
   NCCL up at W = the machine's cards (each rank a process of this file
   with --dp-worker, told its rank as torchrun tells it), an all-reduce of
   the far_bair_dp transformer's gradient bytes (its exact f32 parameter
   count) checked and, at W > 1 only, timed, with its algorithm and bus
   bandwidth (at W = 1 NCCL moves nothing: no time is read);
33. far_bair_dp (d_model 528, 12 layers, 8 heads, bf16) on the synthetic
   BAIR-shaped loader: the one-rank train step at the preset's global
   batch 64 (halved until it fits, with the memory peak said), every
   counter at 0 just before and read just after (#1-#4 12 launches each),
   its ms (median of 5 after 2 warm-ups), training frames/s (64 x 11
   teacher-forced frames a step) and memory peak; the DropPath / Dropout
   masks of one step (recorded, then drawn alone: what every rank draws
   at the global shape);
34. two ranks (two cards over NCCL where the machine has them, else two
   processes on the one card over gloo, labelled so): one far_bair_dp step
   at global batch 16 from the seeded init, every counter at 0 just
   before each rank's first step (#1-#4 12 launches each on each rank),
   against the one-rank step at 16: the averaged gradients within 2^-5 as
   one vector and 2^-2 leaf by leaf (L2), grad_norm within 5%, T_total
   within 2e-3, the parameters within lr/4 where the two gradients share a
   sign by a margin and 2 lr anywhere, bit-equal across the ranks; the
   step's ms and the gradient all-reduce's share of it; with more than two
   cards the same at W = the cards and the preset's batch 64;
35. `torchrun --standalone --nproc_per_node=<cards> -m vptr_tpu_torch.cli
   train --preset far_bair_dp` (2 steps and a validation pass) on the
   autoencoder of a 1-step `cli train --preset ae_bair`, then `cli eval
   --mode far_rip --num-pred 10 --max-batches 1` on that checkpoint: exit
   codes 0, rank 0's checkpoint, log and scalars, finite losses and
   curves, in a temporary directory removed at the end;
36. the reference's checkpoints: the torch re-derivations of the reference
   modules (tests/_torch_port_upstream.py, seeded, random BatchNorm
   statistics) at far_mnist's geometry (AE ngf 64 / feat 528 / 9 res blocks,
   FAR 12 layers / d 528 / 8 heads) and nar_mnist's (NAR 4 + 8, RPE) written
   as epoch_N.tar files in the whole save_ckpt envelope (module. prefixes,
   an unimportable Loss_tuple, an Adam state, the code bytes), read by
   import_reference_checkpoint and put into port states on the card by
   state_with_reference_weights, f32 and bf16: the transformer's latents
   and the teacher-forced "far" and the "nar" frames against the
   re-derivations' f32 forwards on the card; the far_rip predict (#1 and
   #2 120 launches) and the nar predict (#1 4, #5 8, #2 20) from those
   weights;
37. transformer.remat at far_mnist full width, on the default route and on
   the fused-FFN route: a train step with remat off and one with remat on
   (and the decoder checkpointed, as the Trainer sets it) from one seed,
   the forward kernels launched twice and the backward kernels once with
   remat; T_total, every gradient and parameter leaf (within 2^-8 of its
   largest, or 4x the floor the remat-off step run twice gives: the card's
   backward is not bit-reproducible), the generator's state after the
   step; ms (off, on, on, off) and each step's memory peak;
38. the same at nar_mnist, with and without transformer.tslma, the
   BatchNorm running statistics too;
39. far_bair_dp's one-rank step at the preset's batch 64 with remat, through
   the Trainer: #1/#2 24 and #3/#4 12 launches, its ms, training frames/s
   and memory peak, the peak below phase 33's without remat;
40. transformer.scan_layers at far_mnist and nar_mnist full width: the
   unrolled model's weights as a stacked JAX-layout tree (numpy) loaded by
   load_jax_variables into the scan_layers model, its predict frames equal
   to the unrolled model's and its train step's T_total and gradients
   against the unrolled step's (as phase 37), and the same with remat on;
41. kernels #1/#3, #5/#6 and #2/#4 on a head subset (tensor parallelism):
   heads 0-3, 4-7 (Cl 264) and 0-1 (Cl 132) of 8 at hd 66, the far_mnist
   and nar_mnist training shapes, dropout 0.1, bf16 and f32, each against
   its plain version on the subset (the route the wrapper names and the
   library's agreeing); #2/#4 also against the whole call's slice of those
   heads (bit equality reported) at 640 x 19 causal, with a per-head bias,
   and on the long route at 64 x 160; #1's and #5's two halves summed
   (bo added once) and their input gradients against the whole call;
42. far_mnist at full width on a (1, 2) mesh (mesh.model 2: 4 heads and
   1056 hidden channels a rank; two cards over NCCL, or two processes on
   the one card over gloo, labelled so): one train step from the seeds of
   phase 37 against the one-rank step (T_total, grad_norm, every gradient
   leaf whole through grads_against_floor, the parameters through
   params_on_firm_gradients), #1-#4 12 launches a rank; each rank's step
   ms, peak memory and the model group's collectives' share;
43. the same for nar_mnist with transformer.sequence_parallel (#1 4, #5 8,
   #2 20 and their backwards a rank);
44. `torchrun --nproc_per_node=2 -m vptr_tpu_torch.cli train --preset
   far_mnist --set mesh.model=2 --set transformer.sequence_parallel=true`
   on two routes side by side: the fused-FFN route's five flags
   (fused_attention, fused_full, fused_residual, fused_ffn, fused_dw) and
   the conv-FFN route's (fused_attention, fused_full, fused_residual,
   fused_ffn, fused_conv_ffn, fused_full_temporal) (1 step and a
   checkpoint each; on one card the ranks share it over gloo,
   VPTR_RANKS_SHARE_CARDS), each resumed by one process's cli train with
   mesh.model 1 for 1 more, against an unbroken one-process run of 2 on
   its route that runs beside the torchrun (each epoch's T_total, the
   transformer's relative L2);
45. kernels #9-#12 at nar_kth_128's 16 x 16 latent (80 decoder samples of
   256 positions; #9/#10 at the hidden 2112 on a 16-wide grid, #11/#12 at
   fc1 528 -> 2112 and fc2 2112 -> 528) against their plain versions on
   the routes the route functions name (the tiled routes), bf16 and f32,
   dropout 0 and 0.1, two calls bit-equal;
46. their times beside the plain versions, a library yardstick (eager and
   replayed from a CUDA graph) and the bound;
47-49. nar_kth_128 at full width (AE ngf 64 / feat 528 at 128 x 128 x 1, NAR
   4 + 8 blocks at d 528, RPE, batch 8, bf16, seeded random weights; one
   batch of the synthetic KTH-shaped loader) on the default route, the
   fused-FFN route (fused_ffn + fused_dw: #7, #9 16, and their backwards)
   and the conv-FFN route (fused_conv_ffn + fused_full_temporal: #11 32,
   #1 16, #5 8, #2 8 and their backwards): the nar predict 10 -> 10 with
   every counter at 0 just before and read just after (kth_launches: the
   counts of nar_mnist on the same route), its frames against
   kernels="plain"; 10 -> 40 (four NAR calls, four times the launches), 8 x
   40 frames finite and in [-1, 1]; the train step's launches, the step
   against kernels="plain" (on the fused routes at batch 2: the plain
   versions' autograd intermediates at batch 8 exceed the card), 10 steps
   on one batch with a falling loss; ms, frames/s and the step's memory
   peak;
50. `cli train --preset nar_kth_128` (3 steps and a validation pass), a
   resumed run, `cli eval --mode nar --max-batches 1` (10 -> 40) and `cli
   predict --mode nar --batches 1`, the launches of each checked;
51. kernels #7-#10 on a hidden-channel subset (tensor parallelism): #7/#8
   on hidden columns 0-1055 and 1056-2111 of 2112 at far_mnist's step
   (12,160 rows, C 528), bf16 and f32, dropout 0 and 0.1, against their
   plain versions on those columns and, the halves summed (b2 once),
   against the whole call; #9/#10 on the tiled route split at its
   statistics, two ranks' 1056-channel halves run in step in one process
   (the exchange a stack of their partials), at far_mnist's 190 x 64 and
   nar_kth_128's 80 x 256, dropout 0.1, against the plain version's slice
   and the whole tiled call's (bit equality reported); each on a rank's
   share beside its plain version, a library yardstick and its bound;
52. far_mnist at full width on a (1, 2) mesh on the fused-FFN route
   (fused_attention, fused_full, fused_residual, fused_ffn, fused_dw): one
   train step against the one-rank step as phase 42, each rank launching
   #1-#4 and #7-#10 12 times (#9/#10 all on the split tiled route); its
   torchrun cli train is phase 44's;
53. kernels #11/#12 as the conv FFN's column-parallel fc1 (each rank on
   its share of the 2112 hidden channels, norm1's per-row moments and
   LN's backward sums gathered over the ranks and merged) and row-parallel
   fc2 (the ranks' partial products summed in f32 in rank order before
   the moments), two and four ranks run in step in one process, at
   far_mnist's 190 x 64, bf16 and f32, against their plain versions on a
   rank's share and against the whole tiled call (its max |err|
   reported); a rank's times beside the plain versions, a library
   yardstick (eager and graph-replayed) and their bounds;
54. far_mnist at full width on a (1, 2) mesh on the conv-FFN route
   (fused_conv_ffn, fused_full_temporal): one train step against the
   one-rank step as phase 42, each rank launching #1/#3 and #11/#12 24
   times (12 `tiled_split` and 12 `tiled_rows` each); its torchrun cli
   train is phase 44's;
55. far_mnist's hidden over mesh.model 4 (528 channels a rank: 16 whole
   32-channel tiles and a partial one of 16): #7/#8 on each quarter of the
   hidden columns against their plain versions and, summed, the whole
   call; #9/#10's tiled route split at its statistics, four ranks run in
   step in one process (run_split), at the step's 190 samples of 8 x 8,
   bf16 and f32, dropout 0 and 0.1, each share against the plain
   version's slice (phase 51's gates), the four against the whole tiled
   call (max |err|: not the same bits, a whole-call tile straddles two
   ranks), two calls bit-equal; a rank's #9/#10 beside its plain version,
   the library yardstick (eager and graph-replayed) and the bound;
56. far_mnist at full width on a (1, 4) mesh on the fused-FFN route
   (TP_FFN_FLAGS: 2 heads, 528 hidden columns and channels a rank; four
   cards over NCCL, or four processes on the one card over gloo): one
   train step against the one-rank step as phase 42, each rank launching
   #1-#4 and #7-#10 12 times (#9/#10 all `tiled_split`);
57. the examples on the card, through their main(): test_vptr_torch.py
   --mode far_rip --max-batches 1 --gif-dir on phase 24's far_mnist
   checkpoint (#1/#2 240 launches: evaluate's batch and the GIF batch's
   predict; four GIFs where PIL imports), --mode nar on nar_mnist's
   seeded init saved as a step-0 checkpoint (#1 4, #5 8, #2 20; a 2-step
   `cli train` leaves NaN weights on the card, ROADMAP §3), and
   test_autoencoder_torch.py on phase 23's ae_mnist checkpoint (PSNR /
   SSIM finite, no kernel of the twelve launched, the strip written where
   PIL imports);
58. the float16 slice at full width (``dtype=float16``): far_mnist's
   far_rip predict (#1 and #2 120 launches) and nar_mnist's nar predict
   (#1 4, #5 8, #2 20) from phases 4's and 8's builds, against
   kernels="plain" in f16; each model's first f16 train step from those
   builds beside the f32 step on the same weights (f16 holds 2^-24 to
   65,504 and no loss is scaled: a gradient that underflows to 0 or
   overflows passes only where the f32 step shows why,
   f16_default_init_step); the far_mnist train step (#1-#4 12) on weights
   drawn anew (redraw: from the default initializers f16 keeps 2 of its
   482 gradient leaves) and the nar_mnist one (#1/#3 4, #5/#6 8, #2/#4 20)
   on phase 8/9's build, every launch on the FMA route, each against
   kernels="plain" in f16 (phases 5/9's gates: T_total within 2e-3, the
   gradient norm within 5%) and, with the plain version, against the f32
   step on the same weights (f16_step_gates: the kernels' gradient no
   farther from it than 1.5x the plain version's + 1e-3), 10 steps with a
   falling loss; nar_mnist's first step from the Trainer's seeded init in
   f16 (its non-finite gradient leaves reported, not gated: ROADMAP §3);
   an ae_mnist AE/GAN step from the default initializers beside the f32
   step on the same weights: every encoder and decoder parameter moved,
   every discriminator parameter with a non-zero f32 gradient, and each
   one moved in f16 or at an exactly-0 f16 gradient behind a point (its
   layer's output or a later one) where the f16 cotangent is 0 and the f32
   one below 2^-14 (underflow); none of the twelve kernels, 10 steps with a
   falling AE_total; `cli train --preset far_mnist --set dtype=float16`
   (2 steps on phase 23's autoencoder) and `cli predict --mode far_rip
   --batches 1` from it (#1/#2 120, the FMA route); then phases 23-26's
   directory is removed;
59. far_rip predict and the FAR and NAR train steps in f16, bf16 and f32
   (phase 58's weights in each dtype), in turns: ms and frames/s;
60. print {"kernels": [...]} (all twelve kernels and #1-#6's f16 rows,
   `<name>_f16`, their launches from phase 58; #1-#4 also with their
   launches in one far_bair_dp step, `far_bair_dp_launches`, in a far_mnist
   remat step, `far_remat_step_launches` (#7-#10 on the fused-FFN route),
   #1/#2 in the far_rip predict from a .tar, `upstream_far_rip_launches`;
   #1/#3 also at the
   temporal shapes and at the NAR shape; #9 and #10 with their bf16 routes
   and resident clusters; #2 and #4 timed in the layer's strided layout,
   their library yardsticks too, with the route, the contiguous-layout
   time (and #4's error there) and the NAR-shape time, each also replayed
   from a CUDA graph; #2's and #4's long route as rows of their own,
   attention_core_long and attention_core_bwd_long, at TSLMA's 160 x 160;
   #1-#6 with their head-subset readings, `head_subset` (with the subset's
   library yardstick and bound), and a rank's launches in phases 42 and
   43, `tp_step_launches_a_rank`; #9-#12 at nar_kth_128's shapes,
   `nar_kth_128`; #7-#10 with their hidden-subset readings,
   `hidden_subset`, and a rank's launches in phase 52; #11/#12 with
   their fc1 split and fc2 rows readings, `tensor_parallel`, and a rank's
   launches in phase 54; #7-#10 with their mesh.model 4 readings,
   `hidden_quarter`, and a rank's launches in phase 56),
   the run's wall time and, last, {"ok": true, "device": {...}}.

Imports nothing of JAX or of the JAX package. Exits non-zero when
torch.cuda.is_available() is false.
"""

from __future__ import annotations

import gc
import json
import logging
import math
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, dense): bytes/s and flop/s
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}

SEED = 0
ADAM_EPS = 1e-8               # train/optim.py::adam's eps, the presets' optimizers'
BATCH, PAST, FUTURE = 10, 10, 10
LAYERS = 12
TRAIN_STEPS = 10              # the loss-falling run
AE_CLI_STEPS, FAR_CLI_STEPS = 8, 12   # train steps of the cli train runs
TIMED_STEPS, WARMUP_STEPS = 5, 2

failures = []


_phase_start = [None]


def phase(name):
    """Starts a phase: its name, and the wall time the one before it took."""
    now = time.perf_counter()
    if _phase_start[0] is not None:
        print(f"  (the phase took {now - _phase_start[0]:.1f} s)", flush=True)
    _phase_start[0] = now
    print(f"\n=== {name}", flush=True)


def check(ok: bool, what: str):
    print(("  ok   " if ok else "  FAIL ") + what, flush=True)
    if not ok:
        failures.append(what)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        f"nvidia-smi failed: {out.stderr.strip()}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn) -> float:
    """Mean device time of one replay of fn captured in a CUDA graph (three
    warm-up calls on a side stream first), from CUDA events as cuda_ms:
    the launches replayed without the host between them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay)


def graph_bwd_ms(lib, ops, gout):
    """Device ms of the library yardstick's backward replayed from CUDA
    graphs: the graph of lib(*ops) with its gradients for gout (every
    operand's, as grads_of takes them) less the graph of lib(*ops) alone;
    None where autograd's backward cannot be captured."""
    ins = [t.clone().requires_grad_() for t in ops]
    try:
        both = graph_ms(lambda: torch.autograd.grad(lib(*ins), ins, gout))
        fwd = graph_ms(lambda: lib(*ops))
    except RuntimeError as e:
        print(f"  the backward yardstick could not be captured: {e}")
        return None
    print(f"  backward yardstick replayed from CUDA graphs: forward + backward {both:.4f} "
          f"ms, forward {fwd:.4f} ms: backward {both - fwd:.4f} ms")
    return both - fwd


def hgmma_count(library) -> int:
    """HGMMA (wgmma) instructions in the SASS of a built kernel library
    (cuobjdump beside nvcc)."""
    from pathlib import Path

    from vptr_tpu_torch.ops import _build

    cuobjdump = Path(_build.nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(cuobjdump), "-sass", str(library)], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        print(f"  cuobjdump failed: {out.stderr.strip()[:500]}")
    return sum("HGMMA" in line for line in out.stdout.splitlines())


def ptxas_report(log: str, fragment: str):
    """ptxas's stack / spill and register lines of every kernel whose
    (mangled) name holds ``fragment``, from a library's -Xptxas -v log."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        elif name and fragment in name and ("spill" in line or "registers" in line):
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return out


def compute_dtype(cfg) -> torch.dtype:
    """The preset's compute dtype through the trainer's map (float32,
    bfloat16 or float16; any other name raises), so that no preset is run
    in a dtype other than its own."""
    from vptr_tpu_torch.train.trainer import _dtype_of

    return _dtype_of(cfg.dtype)


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def rel_err(a, b) -> float:
    """max |a - b| over the larger of 1 and max |b|."""
    return max_err(a, b) / max(1.0, b.float().abs().max().item())


def normals(g):
    """randn(*shape, std=1.0): host normals drawn from generator g."""
    return lambda *shape, std=1.0: torch.randn(*shape, generator=g) * std


def host_ms(fn) -> float:
    """Host-clock ms of one synchronised call of fn."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def worst_rel(got, want, names):
    """(name, error) of the gradient with the largest rel_err; gradients the
    plain version does not return (None) are skipped."""
    worst = {n: rel_err(a, b) for n, a, b in zip(names, got, want) if b is not None}
    name = max(worst, key=worst.get)
    return name, worst[name]


def _wrappers():
    from vptr_tpu_torch.ops import conv_ln_gelu as tcl
    from vptr_tpu_torch.ops import fused_dw_chain as tdw
    from vptr_tpu_torch.ops import fused_ffn as tff
    from vptr_tpu_torch.ops import fused_window_attention as tfw
    from vptr_tpu_torch.ops.attention_core import attention_core

    return {"fused_attention_ln": tfw.fused_attention_ln,
            "fused_attention": tfw.fused_attention,
            "attention_core": attention_core, "fused_ffn": tff.fused_ffn,
            "fused_dw_chain": tdw.fused_dw_chain, "conv_ln_gelu": tcl.conv_ln_gelu}


def zero_counters():
    """Every kernel wrapper's launch counts to 0."""
    for w in _wrappers().values():
        w.launches = 0
        w.bwd_launches = 0
        for counts in (getattr(w, "launches_by_route", {}),
                       getattr(w, "bwd_launches_by_route", {})):
            for route in counts:
                counts[route] = 0


def launch_counts(*names):
    """{name: count}: "<wrapper>" reads its forward launches,
    "<wrapper>_bwd" its backward launches."""
    w = _wrappers()
    return {n: w[n[:-4]].bwd_launches if n.endswith("_bwd") else w[n].launches
            for n in names}


def check_counts(got, want, what):
    for name, n in got.items():
        check(n == want[name], f"{name} launches in {what}: {n} == {want[name]}")


def check_frames(pred, shape, what):
    check(tuple(pred.shape) == shape, f"{what} output shape {tuple(pred.shape)}")
    check(bool(torch.isfinite(pred.float()).all()), f"{what} output finite")
    lo, hi = pred.float().min().item(), pred.float().max().item()
    check(0.0 <= lo and hi <= 1.0, f"{what} output in [0, 1] ({lo:.4f}, {hi:.4f})")


def counted_predict(predict, args, want, shape, what):
    """One predict call with every counter at 0 just before and read just
    after: the launches of the `want` kernels and the frames checked.
    Returns (the frames, the launch counts)."""
    zero_counters()
    pred = predict(*args)
    torch.cuda.synchronize()
    got = launch_counts(*want)
    check_counts(got, want, f"the {what} run")
    check_frames(pred, shape, what)
    return pred, got


def predict_vs_plain(predict, args, tr, pred, what):
    """The frames `pred` against the same call with kernels="plain"."""
    from vptr_tpu_torch.models.layers import use_kernels

    use_kernels(tr, "plain")
    e = max_err(pred, predict(*args))
    use_kernels(tr, "cuda")
    check(e <= 5e-2, f"{what} kernels vs kernels='plain' max|err| {e:.3e} <= 5e-2 "
          f"(bf16 sigmoid frames after 12 layers)")


def counted_step(train_step, state, past, future, want, what):
    """One train step with every counter at 0 just before and read just
    after: the launches of the `want` kernels checked, the metrics finite.
    Returns (the new state, the launch counts)."""
    zero_counters()
    state, m = train_step(state, past, future)
    torch.cuda.synchronize()
    got = launch_counts(*want)
    check_counts(got, want, f"one {what}")
    check(all(bool(torch.isfinite(v)) for v in m.values()),
          f"first {what} metrics finite: { {k: round(float(v), 6) for k, v in m.items()} }")
    return state, got


def step_vs_plain(train_step, state, past, future, what):
    """One step with the kernels and one with kernels="plain" from one
    cloned state. bf16 through the layers and the decoder: the step's loss
    agrees to about 1e-3 of its value, the gradient norm to a few percent.
    Returns the two states after their step."""
    from vptr_tpu_torch.models.layers import use_kernels

    a, b = state.clone(), state.clone()
    use_kernels(b.transformer, "plain")
    a, ma = train_step(a, past, future)
    b, mb = train_step(b, past, future)
    d_total = abs(float(ma["T_total"]) - float(mb["T_total"]))
    d_norm = abs(float(ma["grad_norm"]) / float(mb["grad_norm"]) - 1)
    check(d_total <= 2e-3 * max(1.0, float(mb["T_total"])),
          f"{what} kernels vs kernels='plain' |dT_total| {d_total:.3e} "
          f"(T_total {float(ma['T_total']):.6f} vs {float(mb['T_total']):.6f})")
    check(d_norm <= 0.05, f"{what} kernels vs kernels='plain' grad norm rel diff "
          f"{d_norm:.3e} <= 0.05 ({float(ma['grad_norm']):.6e} vs "
          f"{float(mb['grad_norm']):.6e})")
    return a, b


def loss_falls(train_step, state, past, future, what):
    """TRAIN_STEPS steps on one batch from a clone of state: the losses
    finite and the last below the first."""
    fixed = state.clone()
    losses = []
    for _ in range(TRAIN_STEPS):
        fixed, m = train_step(fixed, past, future)
        losses.append(float(m["T_total"]))
    print(f"  {what} T_total over {TRAIN_STEPS} steps on one batch: "
          f"{[round(x, 6) for x in losses]}")
    check(all(x == x and abs(x) != float("inf") for x in losses),
          f"{what} train losses finite")
    check(losses[-1] < losses[0], f"{what} T_total falls over {TRAIN_STEPS} steps: "
          f"{losses[0]:.6f} -> {losses[-1]:.6f}")


def grads_of(lib, ops, gout):
    """A call of the library yardstick's backward: the gradients of
    lib(*ops) (ops cloned, the graph kept) for the output gradient gout."""
    ins = [t.clone().requires_grad_() for t in ops]
    out = lib(*ins)
    return lambda: torch.autograd.grad(out, ins, gout, retain_graph=True)


def bound(nbytes: float, flops: float, dtype=torch.bfloat16):
    """(least ms for the work on the card, "bytes" or "operations"): the
    larger of bytes over the memory rate and flops over the peak of their
    type (bf16 tensor-core products, or f32 arithmetic on the CUDA cores)."""
    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (tf, "operations") if tf >= tb else (tb, "bytes")


def timed_turns(fn, plain):
    """plain, kernel, kernel, plain (CUDA-event ms each): two versions
    compared within one call, in turns; returns (kernel ms, plain ms),
    the better reading of each."""
    p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(fn), cuda_ms(fn), cuda_ms(plain)
    return min(k1, k2), min(p1, p2)


def nar_phases(dev):
    """Phases 7-10: the nar_mnist NAR path. Returns (kernel rows of #5 and
    #6, a text line per extra reading, the summary numbers)."""
    import torch.nn.functional as F

    from vptr_tpu_torch.config import get_preset
    from vptr_tpu_torch.eval.harness import make_predict_fn
    from vptr_tpu_torch.models.autoencoder import build_autoencoder
    from vptr_tpu_torch.models.layers import relative_position_index, use_kernels
    from vptr_tpu_torch.models.transformer import build_transformer
    from vptr_tpu_torch.ops import fused_window_attention as tfw
    from vptr_tpu_torch.train.optim import build_optimizer
    from vptr_tpu_torch.train.state import create_nar_train_state
    from vptr_tpu_torch.train.steps import make_nar_train_step

    cfg = get_preset("nar_mnist")
    tc = cfg.transformer
    c, heads = tc.d_model, tc.n_heads
    hd = c // heads
    batch, n_past, n_fut = cfg.data.batch_size, tc.num_past_frames, tc.num_future_frames
    tokens = tc.window_size ** 2
    per_frame = (tc.enc_h // tc.window_size) * (tc.enc_w // tc.window_size)
    windows = batch * n_fut * per_frame       # 640: the decoder's (and encoder's)
    rows = windows * tokens
    rate = tc.dropout
    randn = normals(torch.Generator().manual_seed(SEED + 20))
    kseed = torch.tensor([SEED + 54321], dtype=torch.int32, device=dev)
    bf, f16 = torch.bfloat16, torch.float16
    tol = {torch.float32: 1e-3, bf: 6.25e-2, f16: F16_TOL}            # as phase 3
    bwd_tol = {torch.float32: 1e-4, bf: 2 ** -5, f16: F16_BWD_TOL}
    idx = torch.from_numpy(relative_position_index(tc.window_size).reshape(-1))

    def rpe_bias(nb):
        table = randn((2 * tc.window_size - 1) ** 2, nb, std=0.5)
        return table[idx].reshape(tokens, tokens, nb).permute(2, 0, 1).contiguous().to(dev)

    def weights(dtype):
        w = [randn(c, c, std=c ** -0.5).to(dev, dtype) for _ in range(4)]
        b = [randn(c, std=0.02).to(dev) for _ in range(4)]
        return (w[0], b[0], w[1], b[1], w[2], b[2], w[3], b[3])

    def two_stream(dtype):
        x_v = randn(windows, tokens, c)
        x_qk = x_v + randn(windows, tokens, c, std=0.5)
        return (x_qk.to(dev, dtype), x_v.to(dev, dtype)) + weights(dtype)

    def ln_operands(dtype):
        return ((randn(windows, tokens, c).to(dev, dtype),) + weights(dtype)
                + ((1 + randn(c, std=0.1)).to(dev), randn(c, std=0.1).to(dev), None))

    two_names = ("dx_qk", "dx_v", "dwq", "dbq", "dwk", "dbk", "dwv", "dbv",
                 "dwo", "dbo", "dbias")
    ln_names = ("dx", "dwq", "dbq", "dwk", "dbk", "dwv", "dbv", "dwo", "dbo",
                "dls", "dlb", "dbias")
    rpe8, rpe1 = rpe_bias(heads), rpe_bias(1)
    errs = {}

    phase("7. NAR kernels against their plain versions (card)")
    for dtype in (bf, torch.float32, f16):
        name = str(dtype).replace("torch.", "")
        zero_counters()
        ops = two_stream(dtype)
        gout = randn(windows, tokens, c).to(dev, dtype)
        for bias, what in ((rpe8, "8-head RPE bias"), (rpe1, "1-head bias")):
            for r in (0.0, rate):
                e = max_err(tfw.fused_attention(*ops, bias, kseed, heads, r),
                            tfw.fused_attention_plain(*ops, bias, kseed, heads, r))
                check(e <= tol[dtype], f"fused_attention {name} {what} dropout {r} "
                      f"{tuple(ops[0].shape)} ({tfw.kernel_route(tokens, c, dtype)})"
                      f" max|err| {e:.3e} <= {tol[dtype]}")
                got = tfw.fused_attention_backward(*ops, bias, kseed, gout, heads, r)
                want = tfw.fused_attention_backward_plain(*ops, bias, kseed, gout,
                                                          heads, r)
                n_worst, worst = worst_rel(got, want, two_names)
                check(worst <= bwd_tol[dtype], f"fused_attention backward {name} "
                      f"{what} dropout {r} ({tfw.backward_route(tokens, c, dtype, False)} "
                      f"route) worst {n_worst} rel err {worst:.2e} <= {bwd_tol[dtype]:.2e}")
                if r > 0 and bias is rpe8:
                    errs[("two", dtype)] = e
                    errs[("two_bwd", dtype)] = max(max_err(a, b) for a, b in zip(got, want))
        lops = ln_operands(dtype)
        for r in (0.0, rate):
            for bias, what in ((rpe8, "8-head RPE bias"), (rpe1, "1-head bias")):
                e = max_err(tfw.fused_attention_ln(*lops, bias, kseed, heads, r),
                            tfw.fused_attention_ln_plain(*lops, bias, kseed, heads, r))
                check(e <= tol[dtype], f"fused_attention_ln {name} {what}, no pos, "
                      f"dropout {r} ({tfw.kernel_route(tokens, c, dtype)}) max|err| "
                      f"{e:.3e} <= {tol[dtype]}")
            got = tfw.fused_attention_ln_backward(*lops, rpe8, kseed, gout, heads, r)
            want = tfw.fused_attention_ln_backward_plain(*lops, rpe8, kseed, gout,
                                                         heads, r)
            check(got[-1] is not None and tuple(got[-1].shape) == (heads, tokens, tokens),
                  f"fused_attention_ln backward {name} returns the 8-head dbias")
            n_worst, worst = worst_rel(got, want, ln_names)
            check(worst <= bwd_tol[dtype], f"fused_attention_ln backward {name} "
                  f"8-head RPE bias dropout {r} ({tfw.backward_route(tokens, c, dtype)} "
                  f"route) worst {n_worst} rel err {worst:.2e} <= {bwd_tol[dtype]:.2e}")
        if dtype == f16:
            torch.cuda.synchronize()
            _routes_only_fma("phase 7's f16 calls")
    torch.cuda.synchronize()

    phase("8. nar_mnist full width, nar predict")
    dtype = compute_dtype(cfg)
    enc, dec = build_autoencoder(cfg.ae, dtype, dev, torch.Generator().manual_seed(SEED))
    tr = build_transformer(tc, dtype, dev, torch.Generator().manual_seed(SEED + 1))
    n_params = sum(p.numel() for m in (enc, dec, tr) for p in m.parameters())
    print(f"  params {n_params} (enc+dec+NAR {tc.num_encoder_layers}+"
          f"{tc.num_decoder_layers} layers, rpe {tc.rpe}), dtype {dtype}")
    frames = torch.rand(batch, n_past + n_fut, 64, 64, 1,
                        generator=torch.Generator().manual_seed(SEED + 2))
    past, future = frames[:, :n_past].to(dev), frames[:, n_past:].to(dev)
    predict = make_predict_fn(cfg, enc, dec, tr, "nar", n_fut, dev)
    enc_l, dec_l = tc.num_encoder_layers, tc.num_decoder_layers
    want = {"fused_attention_ln": enc_l, "fused_attention": dec_l,
            "attention_core": enc_l + 2 * dec_l}
    pred, pred_launches = counted_predict(predict, (past,), want,
                                          (batch, n_fut, 64, 64, 1), "nar predict")
    predict_vs_plain(predict, (past,), tr, pred, "nar predict")

    phase("9. nar_mnist full width, train step")
    opt = build_optimizer(cfg.optim, c)
    print(f"  optimizer {cfg.optim.optimizer} lr {cfg.optim.lr} clip "
          f"{cfg.optim.max_grad_norm}; dropout {tc.dropout} drop_path "
          f"{tc.drop_path}; lam_nce {cfg.loss.lam_nce} at temperature "
          f"{cfg.loss.nce_temperature}")
    state = create_nar_train_state(enc, dec, tr, opt, seed=SEED + 3)
    train_step = make_nar_train_step(enc, dec, tr, opt, cfg.loss)
    want = {"fused_attention_ln": enc_l, "fused_attention_ln_bwd": enc_l,
            "fused_attention": dec_l, "fused_attention_bwd": dec_l,
            "attention_core": enc_l + 2 * dec_l,
            "attention_core_bwd": enc_l + 2 * dec_l}
    state, step_launches = counted_step(train_step, state, past, future, want,
                                        "NAR train step")
    step_vs_plain(train_step, state, past, future, "NAR step")
    loss_falls(train_step, state, past, future, "NAR")

    phase("10. NAR timing")
    torch.cuda.reset_peak_memory_stats()
    times = [host_ms(lambda: predict(past)) for _ in range(6)][1:]  # the first warms up
    pred_ms = statistics.median(times)
    pred_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    use_kernels(tr, "plain")
    plain_pred_ms = statistics.median(
        [cuda_ms(lambda: predict(past), iters=1, warmup=0) for _ in range(3)])
    use_kernels(tr, "cuda")
    print(f"  nar predict (batch {batch}, {n_past} -> {n_fut} frames): median "
          f"{pred_ms:.3f} ms of {len(times)} ({[round(t, 3) for t in times]}), "
          f"{batch * n_fut / pred_ms * 1e3:.1f} frames/s, peak {pred_peak:.3f} "
          f"GiB (with the train state held); kernels='plain' {plain_pred_ms:.3f} ms")

    kstate, pstate = state.clone(), state.clone()
    use_kernels(pstate.transformer, "plain")
    del state
    step_times, plain_times = [], []
    for i in range(WARMUP_STEPS + TIMED_STEPS):
        order = ((kstate, step_times), (pstate, plain_times))
        for which, out in (order if i % 2 == 0 else order[::-1]):
            ms = host_ms(lambda: train_step(which, past, future))
            if i >= WARMUP_STEPS:
                out.append(ms)
    del pstate
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    host_ms(lambda: train_step(kstate, past, future))
    step_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del kstate
    step_ms, plain_step_ms = statistics.median(step_times), statistics.median(plain_times)
    train_fps = batch * n_fut / step_ms * 1e3
    print(f"  NAR train step (batch {batch}, {n_past} -> {n_fut}): median "
          f"{step_ms:.3f} ms of {len(step_times)} ({[round(t, 3) for t in step_times]}),"
          f" {train_fps:.1f} training frames/s; kernels='plain' median "
          f"{plain_step_ms:.3f} ms ({[round(t, 3) for t in plain_times]}); peak "
          f"{step_peak:.3f} GiB with one state")

    def nar_rows(dt, launches=None, step_launches=None):
        """#5's and #6's rows of the kernels line in ``dt`` (bf16; f16 on the
        FMA routes, named ``<name>_f16``) at the NAR shapes (the training
        dropout, the RPE bias), and #1/#3 there: each timed beside its plain
        version in turns, the library yardstick in ``dt`` (#5/#6's also
        replayed from CUDA graphs) and the bound. ``launches`` /
        ``step_launches``: the nar predict's and the train step's counts in
        ``dt`` (None: filled in by the caller). Returns (the rows, #1/#3's
        readings at the NAR shape by name)."""
        ops = two_stream(dt)
        x_qk, x_v, wq, bq, wk, bk, wv, bv, wo, bo = ops
        gwin = randn(windows, tokens, c).to(dev, dt)
        mask = rpe8.to(dt)[None]

        def split(z):
            return z.view(windows, tokens, heads, hd).transpose(1, 2)

        def two_library(x_qk=x_qk, x_v=x_v, wq=wq, wk=wk, wv=wv, wo=wo):
            o = F.scaled_dot_product_attention(
                split(F.linear(x_qk, wq.t(), bq.to(dt))),
                split(F.linear(x_qk, wk.t(), bk.to(dt))),
                split(F.linear(x_v, wv.t(), bv.to(dt))), attn_mask=mask)
            return F.linear(o.transpose(1, 2).reshape(windows, tokens, c), wo.t(),
                            bo.to(dt))

        lops = ln_operands(dt)
        x, ls, lb = lops[0], lops[9], lops[10]

        def ln_library(x=x, wq=wq, wk=wk, wv=wv, wo=wo):
            xn = F.layer_norm(x, (c,), ls.to(dt), lb.to(dt))
            return two_library(xn, xn, wq, wk, wv, wo)

        s = dt.itemsize
        vec = 4 * c * 4 + heads * tokens * tokens * 4
        fwd_flops = 8 * rows * c * c + 4 * rows * tokens * c
        bwd_flops = 22 * rows * c * c + 12 * rows * tokens * c
        cases = (
            # name, fn, plain, library, bytes, flops
            ("fused_attention",
             lambda: tfw.fused_attention(*ops, rpe8, kseed, heads, rate),
             lambda: tfw.fused_attention_plain(*ops, rpe8, kseed, heads, rate),
             two_library, 3 * rows * c * s + 4 * c * c * s + vec, fwd_flops),
            ("fused_attention_bwd",
             lambda: tfw.fused_attention_backward(*ops, rpe8, kseed, gwin, heads, rate),
             lambda: tfw.fused_attention_backward_plain(*ops, rpe8, kseed, gwin, heads,
                                                        rate),
             grads_of(two_library, (x_qk, x_v, wq, wk, wv, wo), gwin),
             5 * rows * c * s + 8 * c * c * s + 2 * vec, bwd_flops),
            ("fused_attention_ln (NAR shape, RPE bias)",
             lambda: tfw.fused_attention_ln(*lops, rpe8, kseed, heads, rate),
             lambda: tfw.fused_attention_ln_plain(*lops, rpe8, kseed, heads, rate),
             ln_library, 2 * rows * c * s + 4 * c * c * s + vec + 2 * c * 4,
             fwd_flops),
            ("fused_attention_ln_bwd (NAR shape, RPE bias)",
             lambda: tfw.fused_attention_ln_backward(*lops, rpe8, kseed, gwin, heads,
                                                     rate),
             lambda: tfw.fused_attention_ln_backward_plain(*lops, rpe8, kseed, gwin,
                                                           heads, rate),
             grads_of(ln_library, (x, wq, wk, wv, wo), gwin),
             3 * rows * c * s + 8 * c * c * s + 2 * vec + 4 * c * 4, bwd_flops),
        )
        readings = {}
        for name, fn, plain, lib, nbytes, flops in cases:
            k_ms, p_ms = timed_turns(fn, plain)
            lib_ms = cuda_ms(lib)
            b_ms, b_by = bound(nbytes, flops, dt)
            readings[name] = dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                                  bound_ms=b_ms, bound_by=b_by)
            print(f"  {name} {dt}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, library "
                  f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.2f} "
                  f"MB, {flops / 1e9:.2f} GFLOP)")
        # #5's and #6's yardsticks again, replayed from CUDA graphs (no host
        # between launches); the backward's as forward + backward less forward
        readings["fused_attention"]["library_graph_ms"] = fwd = graph_ms(two_library)
        print(f"  fused_attention library yardstick ({dt}) replayed from a CUDA graph: "
              f"{fwd:.4f} ms; the backward's:")
        readings["fused_attention_bwd"]["library_graph_ms"] = graph_bwd_ms(
            two_library, (x_qk, x_v, wq, wk, wv, wo), gwin)
        suffix = "_f16" if dt == f16 else ""
        out = []
        for name, src, replaces, counts in (
                ("fused_attention", "vptr_tpu_torch/csrc/fused_window_attention.cu",
                 "vptr_tpu/ops/fused_window_attention.py:239", launches),
                ("fused_attention_bwd",
                 "vptr_tpu_torch/csrc/fused_window_attention_bwd.cu",
                 "vptr_tpu/ops/fused_window_attention.py:386", step_launches)):
            out.append({"name": name + suffix, "route": "cuda", "source": src,
                        "replaces": replaces, "dtype": str(dt).replace("torch.", ""),
                        "launches": counts[name] if counts else None,
                        "max_abs_err": errs[(name.replace("fused_attention", "two"), dt)],
                        **readings[name],
                        "train_step_launches": step_launches[name] if step_launches
                        else None})
        ln = {k.replace(" (", f"{suffix} (", 1): v for k, v in readings.items()
              if k.startswith("fused_attention_ln")}
        return out, ln

    rows_out, ln_readings = nar_rows(bf, pred_launches, step_launches)
    f16_rows, f16_ln = nar_rows(f16)
    rows_out += f16_rows
    ln_readings.update(f16_ln)
    summary = (f"nar_predict_ms {pred_ms:.3f} nar_plain_predict_ms "
               f"{plain_pred_ms:.3f} nar_train_step_ms {step_ms:.3f} "
               f"nar_plain_train_step_ms {plain_step_ms:.3f} "
               f"nar_train_frames_per_s {train_fps:.1f} nar_train_peak_gib "
               f"{step_peak:.3f}")
    extra = {"nar_predict_launches": pred_launches,
             "nar_step_launches": step_launches,
             "nar_shape_ln_kernels": ln_readings}
    return rows_out, extra, summary


def route_phases(dev, flags, label, first, want_pred, want_step):
    """Phases first .. first + 2: far_mnist at full width on a kernel route
    (the transformer `flags`) beside the default route with the same
    weights. The far_rip predict with every counter at 0 just before and
    read just after (`want_pred` launches), its frames checked and compared
    with kernels="plain" and with the default route; one train step's
    launches (`want_step`), kernels vs kernels="plain" from one cloned
    state, 10 steps on one batch with a falling loss; the predict and the
    step timed against the default route in turns, with each step's memory
    peak above what is held. Returns (the predict's launches, the step's
    launches, {"predict_ms" | "step_ms" | "step_peak_gib": {route: value}})."""
    from vptr_tpu_torch.config import get_preset
    from vptr_tpu_torch.eval.harness import make_predict_fn
    from vptr_tpu_torch.models.autoencoder import build_autoencoder
    from vptr_tpu_torch.models.transformer import build_transformer
    from vptr_tpu_torch.train.optim import build_optimizer
    from vptr_tpu_torch.train.state import create_far_train_state
    from vptr_tpu_torch.train.steps import make_far_train_step

    base = get_preset("far_mnist")
    cfg = base.override({"transformer": flags})
    tc = cfg.transformer
    ctx = tc.num_past_frames + tc.num_future_frames

    phase(f"{first}. far_mnist {label} ({' + '.join(flags)}), far_rip predict")
    dtype = compute_dtype(cfg)
    enc, dec = build_autoencoder(cfg.ae, dtype, dev, torch.Generator().manual_seed(SEED))
    tr = build_transformer(tc, dtype, dev, torch.Generator().manual_seed(SEED + 1))
    # the default route with the same weights (the parameter trees agree)
    tr_default = build_transformer(base.transformer, dtype, dev,
                                   torch.Generator().manual_seed(SEED + 1))
    frames = torch.rand(BATCH, PAST + FUTURE, 64, 64, 1,
                        generator=torch.Generator().manual_seed(SEED + 2))
    past, future = frames[:, :PAST].to(dev), frames[:, PAST:].to(dev)
    predict = make_predict_fn(cfg, enc, dec, tr, "far_rip", FUTURE, dev)
    predict_default = make_predict_fn(base, enc, dec, tr_default, "far_rip", FUTURE, dev)
    pred, pred_launches = counted_predict(predict, (past,), want_pred,
                                          (BATCH, FUTURE, 64, 64, 1), f"{label} far_rip")
    predict_vs_plain(predict, (past,), tr, pred, f"{label} far_rip")
    e_default = max_err(pred, predict_default(past))
    check(e_default <= 5e-2, f"{label} far_rip vs the default route max|err| "
          f"{e_default:.3e} <= 5e-2 (the GELU's form and the rounding points differ)")

    phase(f"{first + 1}. far_mnist {label}, train step")
    opt = build_optimizer(cfg.optim, tc.d_model)
    state = create_far_train_state(enc, dec, tr, opt, seed=SEED + 3)
    train_step = make_far_train_step(enc, dec, tr, opt, cfg.loss)
    state, step_launches = counted_step(train_step, state, past, future, want_step,
                                        f"{label} FAR train step")
    step_vs_plain(train_step, state, past, future, f"{label} FAR step")
    loss_falls(train_step, state, past, future, label)

    phase(f"{first + 2}. {label} timing (against the default route, in turns)")
    predict(past)
    predict_default(past)
    predicts = {"route": predict, "default": predict_default}
    pred_times = {"route": [], "default": []}
    for i in range(6):                 # default, route, route, default, ...
        for name in (("default", "route") if i % 2 == 0 else ("route", "default")):
            pred_times[name].append(host_ms(lambda: predicts[name](past)))
    pred_ms = {k: statistics.median(v) for k, v in pred_times.items()}
    print(f"  far_rip predict (batch {BATCH}, {FUTURE} frames): {label} median "
          f"{pred_ms['route']:.3f} ms ({[round(t, 3) for t in pred_times['route']]}), "
          f"default route {pred_ms['default']:.3f} ms "
          f"({[round(t, 3) for t in pred_times['default']]})")

    dstate = create_far_train_state(enc, dec, tr_default, opt, seed=SEED + 3)
    default_step = make_far_train_step(enc, dec, tr_default, opt, base.loss)
    steps = {"route": (train_step, state), "default": (default_step, dstate)}
    del state, dstate
    step_times = {"route": [], "default": []}
    act_peak = {}
    for i in range(WARMUP_STEPS + TIMED_STEPS):
        for name in (("default", "route") if i % 2 == 0 else ("route", "default")):
            fn, st = steps[name]
            if i == WARMUP_STEPS - 1:   # the activation peak above what is held
                torch.cuda.synchronize()
                held = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            ms = host_ms(lambda: fn(st, past, future))
            if i == WARMUP_STEPS - 1:
                act_peak[name] = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
            if i >= WARMUP_STEPS:
                step_times[name].append(ms)
    step_ms = {k: statistics.median(v) for k, v in step_times.items()}
    print(f"  FAR train step (batch {BATCH}, T {ctx - 1}): {label} median "
          f"{step_ms['route']:.3f} ms ({[round(t, 3) for t in step_times['route']]}), "
          f"default route {step_ms['default']:.3f} ms "
          f"({[round(t, 3) for t in step_times['default']]}); peak above the held "
          f"memory: {label} {act_peak['route']:.3f} GiB, default "
          f"{act_peak['default']:.3f} GiB")
    del steps, train_step, default_step, enc, dec, tr, tr_default, predict, predict_default
    del predicts
    torch.cuda.empty_cache()
    return pred_launches, step_launches, {"predict_ms": pred_ms, "step_ms": step_ms,
                                          "step_peak_gib": act_peak}


def ffn_phases(dev):
    """Phases 11-14: the far_mnist fused-FFN route (transformer.fused_ffn
    and fused_dw). Returns (kernel rows of #7-#10, extra readings, the
    summary line)."""
    import torch.nn.functional as F

    from vptr_tpu_torch.config import get_preset
    from vptr_tpu_torch.ops import fused_dw_chain as tdw
    from vptr_tpu_torch.ops import fused_ffn as tff

    tc = get_preset("far_mnist").transformer
    c, hid, hw, w = tc.d_model, tc.spatial_ffn_hidden_ratio * tc.d_model, \
        tc.enc_h * tc.enc_w, tc.enc_w
    ctx = tc.num_past_frames + tc.num_future_frames
    s_pred, s_step = BATCH * ctx * hw, BATCH * (ctx - 1) * hw     # FFN rows
    n_pred, n_step = BATCH * ctx, BATCH * (ctx - 1)               # dw samples
    rate = tc.dropout
    bf = torch.bfloat16
    kseed = torch.tensor([SEED + 777], dtype=torch.int32, device=dev)
    randn = normals(torch.Generator().manual_seed(SEED + 30))
    tol = {torch.float32: 1e-3, bf: 6.25e-2}            # as phase 3
    bwd_tol = {torch.float32: 1e-4, bf: 2 ** -5}

    def ffn_ops(rows, dtype):
        return (randn(rows, c).to(dev, dtype), randn(c, hid, std=c ** -0.5).to(dev, dtype),
                randn(hid, std=0.1).to(dev), randn(hid, c, std=hid ** -0.5).to(dev, dtype),
                randn(c, std=0.1).to(dev), (1 + randn(c, std=0.1)).to(dev),
                randn(c, std=0.1).to(dev))

    def dw_ops(n, dtype):
        return (randn(n, hw, hid).to(dev, dtype), randn(9, hid, std=0.3).to(dev),
                randn(hid, std=0.1).to(dev), (1 + randn(hw, hid, std=0.1)).to(dev),
                randn(hw, hid, std=0.1).to(dev), (1 + randn(hw, hid, std=0.1)).to(dev),
                randn(hw, hid, std=0.1).to(dev))

    ffn_names = ("dx", "dw1", "db1", "dw2", "db2", "dls", "dlb")
    dw_names = ("dx", "dtaps", "ddwb", "ds1", "db1", "ds2", "db2")
    errs = {}

    phase("11. fused-FFN route kernels (#7-#10) against their plain versions (card)")
    for dtype in (bf, torch.float32):
        name = str(dtype).replace("torch.", "")
        fops, fops_t = ffn_ops(s_pred, dtype), ffn_ops(s_step, dtype)
        dops, dops_t = dw_ops(n_pred, dtype), dw_ops(n_step, dtype)
        gffn = randn(s_step, c).to(dev, dtype)
        gdw = randn(n_step, hw, hid).to(dev, dtype)
        gdw_pred = randn(n_pred, hw, hid).to(dev, dtype)
        for r in (0.0, rate):
            # #7 at the predict's rows (the value kept) and the step's
            for ops in (fops_t, fops):
                e = max_err(tff.fused_ffn(*ops, kseed, r), tff.fused_ffn_plain(*ops, kseed, r))
                check(e <= tol[dtype], f"fused_ffn {name} dropout {r} {tuple(ops[0].shape)} "
                      f"({tff.kernel_route(c, hid, dtype)}) max|err| {e:.3e} <= {tol[dtype]}")
            got = tff.fused_ffn_backward(*fops_t, kseed, gffn, r)
            want = tff.fused_ffn_backward_plain(*fops_t, kseed, gffn, r)
            n_worst, worst = worst_rel(got, want, ffn_names)
            check(worst <= bwd_tol[dtype], f"fused_ffn backward {name} dropout {r} "
                  f"{tuple(fops_t[0].shape)} worst {n_worst} rel err {worst:.2e} <= "
                  f"{bwd_tol[dtype]:.2e}")
            if dtype == bf and r > 0:
                errs["ffn"] = e
                errs["ffn_bwd"] = max(max_err(a, b) for a, b in zip(got, want))
            # #9 at the step's samples and the predict's (the value kept);
            # two calls of a route give the same bits
            route = tdw.kernel_route(hw, hid, dtype, w)
            for ops in (dops_t, dops):
                got = tdw.fused_dw_chain(*ops, kseed, w, r)
                e = max_err(got, tdw.fused_dw_chain_plain(*ops, kseed, w, r))
                check(e <= tol[dtype], f"fused_dw_chain {name} dropout {r} "
                      f"{tuple(ops[0].shape)} ({route}) max|err| {e:.3e} <= {tol[dtype]}")
                check(torch.equal(got, tdw.fused_dw_chain(*ops, kseed, w, r)),
                      f"fused_dw_chain {name} dropout {r} {tuple(ops[0].shape)} ({route}) "
                      f"two calls give the same bits")
                del got
            # #10 at the step's samples (the value kept) and the predict's,
            # on the route backward_route names; two calls give the same bits
            broute = tdw.backward_route(hw, hid, dtype, w)
            for ops, gd in ((dops, gdw_pred), (dops_t, gdw)):
                got = tdw.fused_dw_chain_backward(*ops, kseed, gd, w, r)
                want = tdw.fused_dw_chain_backward_plain(*ops, kseed, gd, w, r)
                n_worst, worst = worst_rel(got, want, dw_names)
                check(worst <= bwd_tol[dtype], f"fused_dw_chain backward {name} dropout {r} "
                      f"{tuple(ops[0].shape)} ({broute}) worst {n_worst} rel err "
                      f"{worst:.2e} <= {bwd_tol[dtype]:.2e}")
                again = tdw.fused_dw_chain_backward(*ops, kseed, gd, w, r)
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"fused_dw_chain backward {name} dropout {r} {tuple(ops[0].shape)} "
                      f"({broute}) two calls give the same bits")
                del again
            if dtype == bf and r > 0:
                errs["dw"] = e
                errs["dw_bwd"] = max(max_err(a, b) for a, b in zip(got, want))
        del fops, fops_t, dops, dops_t, gffn, gdw, gdw_pred, got, want
    torch.cuda.synchronize()

    n = LAYERS * FUTURE
    pred_launches, step_launches, times = route_phases(
        dev, {"fused_ffn": True, "fused_dw": True}, "fused-FFN route", 12,
        {"fused_ffn": n, "fused_dw_chain": n, "fused_attention_ln": n, "attention_core": n},
        {k: LAYERS for k in ("fused_ffn", "fused_ffn_bwd", "fused_dw_chain",
                             "fused_dw_chain_bwd", "fused_attention_ln",
                             "fused_attention_ln_bwd", "attention_core",
                             "attention_core_bwd")})

    # the kernels beside their plain versions, a library yardstick and the
    # bound: #7/#9 at the far_rip shapes (dropout 0), #8/#10 at the step's
    # (dropout 0.1), bf16
    fops, fops_t, gffn = ffn_ops(s_pred, bf), ffn_ops(s_step, bf), randn(s_step, c).to(dev, bf)
    dops, dops_t = dw_ops(n_pred, bf), dw_ops(n_step, bf)
    gdw = randn(n_step, hw, hid).to(dev, bf)

    def ffn_library(x, w1, b1, w2, b2, ls, lb):
        xn = F.layer_norm(x, (c,), ls.to(bf), lb.to(bf))
        return F.linear(F.gelu(F.linear(xn, w1.t(), b1.to(bf))), w2.t(), b2.to(bf))

    def dw_library(x, taps, dwb, s1, b1, s2, b2):
        n = x.shape[0]
        img = x.view(n, tc.enc_h, w, hid).permute(0, 3, 1, 2)
        aff = lambda p: p.t().reshape(hid, tc.enc_h, w).to(bf)
        z = F.gelu(F.layer_norm(img, img.shape[1:], aff(s1), aff(b1)))
        z = F.conv2d(z, taps.t().reshape(hid, 1, 3, 3).to(bf), dwb.to(bf), padding=1,
                     groups=hid)
        return F.gelu(F.layer_norm(z, z.shape[1:], aff(s2), aff(b2)))

    e_pred, e_step = s_pred * c, s_step * c
    d_pred, d_step = n_pred * hw * hid, n_step * hw * hid
    s2b = 2   # bytes per bf16 element
    # f32 arithmetic per element of the dw chain on the CUDA cores (two
    # LayerNorms, two A&S GELUs, the nine-tap conv, the dropout: ~80; the
    # backward recomputes them and adds two GELU derivatives, two LayerNorm
    # backwards, the transposed conv, the tap and affine sums: ~210)
    cases = (
        # name, fn, plain, library, bytes, flops, flop dtype
        ("fused_ffn", lambda: tff.fused_ffn(*fops, kseed, 0.0),
         lambda: tff.fused_ffn_plain(*fops, kseed, 0.0),
         lambda: ffn_library(*fops),
         2 * e_pred * s2b + 2 * c * hid * s2b + (hid + 3 * c) * 4,
         4 * s_pred * c * hid, bf),
        ("fused_ffn_bwd", lambda: tff.fused_ffn_backward(*fops_t, kseed, gffn, rate),
         lambda: tff.fused_ffn_backward_plain(*fops_t, kseed, gffn, rate),
         grads_of(ffn_library, fops_t, gffn),
         3 * e_step * s2b + 4 * c * hid * s2b + 2 * hid * 4 + 6 * c * 4,
         10 * s_step * c * hid, bf),
        ("fused_dw_chain", lambda: tdw.fused_dw_chain(*dops, kseed, w, 0.0),
         lambda: tdw.fused_dw_chain_plain(*dops, kseed, w, 0.0),
         lambda: dw_library(*dops),
         2 * d_pred * s2b + (10 * hid + 4 * hw * hid) * 4, 80 * d_pred, torch.float32),
        ("fused_dw_chain_bwd",
         lambda: tdw.fused_dw_chain_backward(*dops_t, kseed, gdw, w, rate),
         lambda: tdw.fused_dw_chain_backward_plain(*dops_t, kseed, gdw, w, rate),
         # the conv yardstick's output is NCHW
         grads_of(dw_library, dops_t, gdw.view(n_step, tc.enc_h, w, hid).permute(0, 3, 1, 2)),
         3 * d_step * s2b + (20 * hid + 8 * hw * hid) * 4, 210 * d_step, torch.float32),
    )
    per_sample, bwd_clusters = tdw.resident_clusters(hw, hid)
    clusters = {"fused_dw_chain per_sample (8 blocks)": per_sample,
                "fused_dw_chain persistent (16 blocks)": tdw.persistent_clusters(hw, hid, w),
                "fused_dw_chain_bwd groups (8 blocks)": bwd_clusters,
                "fused_dw_chain_bwd persistent (16 blocks)": tdw.backward_clusters(hw, hid, w)}
    print(f"  clusters resident at once: {clusters}; in bf16 #9 takes the "
          f"{tdw.kernel_route(hw, hid, bf, w)} route, #10 the "
          f"{tdw.backward_route(hw, hid, bf, w)} route")
    readings = {}
    for name, fn, plain, lib, nbytes, flops, fdt in cases:
        k_ms, p_ms = timed_turns(fn, plain)
        lib_ms = cuda_ms(lib)
        b_ms, b_by = bound(nbytes, flops, fdt)
        readings[name] = dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, bound_ms=b_ms,
                              bound_by=b_by)
        print(f"  {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, library "
              f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.2f} MB, "
              f"{flops / 1e9:.2f} GFLOP {str(fdt).replace('torch.', '')})")
    # #7's and #8's yardsticks again, replayed from CUDA graphs (no host
    # between launches); the backward's as the graph of forward + backward
    # less the graph of the forward on the step's rows
    fwd = graph_ms(lambda: ffn_library(*fops))
    readings["fused_ffn"]["library_graph_ms"] = fwd
    print(f"  fused_ffn library yardstick replayed from a CUDA graph: forward {fwd:.4f} ms "
          f"({s_pred} rows); the backward's on {s_step} rows:")
    readings["fused_ffn_bwd"]["library_graph_ms"] = graph_bwd_ms(ffn_library, fops_t, gffn)
    fwd = graph_ms(lambda: dw_library(*dops))
    readings["fused_dw_chain"]["library_graph_ms"] = fwd
    print(f"  fused_dw_chain library yardstick replayed from a CUDA graph: forward {fwd:.4f} "
          f"ms ({n_pred} samples); the backward's on {n_step}:")
    readings["fused_dw_chain_bwd"]["library_graph_ms"] = graph_bwd_ms(
        dw_library, dops_t, gdw.view(n_step, tc.enc_h, w, hid).permute(0, 3, 1, 2))
    rows_out = []
    for name, src, replaces, err, launches in (
            ("fused_ffn", "vptr_tpu_torch/csrc/fused_ffn.cu",
             "vptr_tpu/ops/fused_ffn.py:188", errs["ffn"], pred_launches["fused_ffn"]),
            ("fused_ffn_bwd", "vptr_tpu_torch/csrc/fused_ffn_bwd.cu",
             "vptr_tpu/ops/fused_ffn.py:214", errs["ffn_bwd"],
             step_launches["fused_ffn_bwd"]),
            ("fused_dw_chain", "vptr_tpu_torch/csrc/fused_dw_chain.cu",
             "vptr_tpu/ops/fused_dw_chain.py:294", errs["dw"],
             pred_launches["fused_dw_chain"]),
            ("fused_dw_chain_bwd", "vptr_tpu_torch/csrc/fused_dw_chain_bwd.cu",
             "vptr_tpu/ops/fused_dw_chain.py:318", errs["dw_bwd"],
             step_launches["fused_dw_chain_bwd"])):
        rows_out.append({"name": name, "route": "cuda", "source": src,
                         "replaces": replaces, "launches": launches,
                         "max_abs_err": err, **readings[name],
                         "train_step_launches": step_launches[name]})
        if name.startswith("fused_dw_chain"):   # #9's / #10's route in bf16, its clusters
            route = (tdw.kernel_route if name == "fused_dw_chain" else tdw.backward_route)(
                hw, hid, bf, w)
            rows_out[-1].update(kernel_route=route, resident_clusters=clusters[
                f"{name} {route} ({16 if route == 'persistent' else 8} blocks)"])
    pm, sm, pk = times["predict_ms"], times["step_ms"], times["step_peak_gib"]
    summary = (f"ffn_route_predict_ms {pm['route']:.3f} default_predict_ms "
               f"{pm['default']:.3f} ffn_route_train_step_ms {sm['route']:.3f} "
               f"default_train_step_ms {sm['default']:.3f} ffn_route_step_peak_gib "
               f"{pk['route']:.3f} default_step_peak_gib {pk['default']:.3f}")
    extra = {"ffn_route_predict_launches": pred_launches,
             "ffn_route_step_launches": step_launches,
             "dw_chain_resident_clusters": clusters}
    return rows_out, extra, summary


def conv_phases(dev):
    """Phases 15-19: the conv-FFN kernel route with the folded temporal
    sublayer (transformer.fused_conv_ffn and fused_full_temporal) on
    far_mnist and nar_mnist. Returns (kernel rows of #11 and #12, the #1/#3
    readings at the temporal shapes by kernel name, extra readings, the
    summary line)."""
    import torch.nn.functional as F

    from vptr_tpu_torch.config import get_preset
    from vptr_tpu_torch.eval.harness import make_predict_fn
    from vptr_tpu_torch.models.autoencoder import build_autoencoder
    from vptr_tpu_torch.models.layers import LayerNorm, TemporalAttention
    from vptr_tpu_torch.models.transformer import build_transformer
    from vptr_tpu_torch.ops import conv_ln_gelu as tcl
    from vptr_tpu_torch.ops import fused_window_attention as tfw
    from vptr_tpu_torch.train.optim import build_optimizer
    from vptr_tpu_torch.train.state import create_nar_train_state
    from vptr_tpu_torch.train.steps import make_nar_train_step

    flags = {"fused_conv_ffn": True, "fused_full_temporal": True}
    tc = get_preset("far_mnist").transformer
    ncfg = get_preset("nar_mnist").override({"transformer": flags})
    ntc = ncfg.transformer
    c, hid, hw = tc.d_model, tc.spatial_ffn_hidden_ratio * tc.d_model, tc.enc_h * tc.enc_w
    heads, hd = tc.n_heads, tc.d_model // tc.n_heads
    ctx = tc.num_past_frames + tc.num_future_frames
    n_pred, n_step = BATCH * ctx, BATCH * (ctx - 1)               # conv-FFN samples
    stages = {"fc1": (c, hid), "fc2": (hid, c)}
    nb = ncfg.data.batch_size
    # the folded temporal sublayer's #1/#3 calls: (columns, T, causal, dropout
    # rates) -- far_rip predict, the FAR step, the NAR encoder and decoder
    attn_rate = lambda t: t.dropout if t.attention_dropout is None else t.attention_dropout
    temporal = {"far_rip": (BATCH * hw, ctx, True, (0.0, attn_rate(tc))),
                "far_step": (BATCH * hw, ctx - 1, True, (0.0, attn_rate(tc))),
                "nar": (nb * hw, ntc.num_past_frames, False, (0.0, attn_rate(ntc)))}
    bf = torch.bfloat16
    randn = normals(torch.Generator().manual_seed(SEED + 40))
    kseed = torch.tensor([SEED + 4321], dtype=torch.int32, device=dev)
    tol = {torch.float32: 1e-3, bf: 6.25e-2}            # as phase 3
    bwd_tol = {torch.float32: 1e-4, bf: 2 ** -5}
    names = ("dx", "dw", "db", "dscale", "dbias2")
    ln_names = ("dx", "dwq", "dbq", "dwk", "dbk", "dwv", "dbv", "dwo", "dbo", "dls",
                "dlb", "dbias")

    def conv_ops(n, cin, cout, dtype):
        return (randn(n, hw, cin).to(dev, dtype), randn(cin, cout, std=cin ** -0.5).to(dev, dtype),
                randn(cout, std=0.1).to(dev), (1 + randn(hw, cout, std=0.1)).to(dev),
                randn(hw, cout, std=0.1).to(dev))

    def temporal_ops(cols, t, causal, dtype):
        """#1/#3's operands as the folded temporal sublayer passes them: the
        raw columns, (C, C) weights, the LayerNorm affine, the (T, C)
        position table on q/k and the -1e30 causal (1, T, T) bias (FAR)."""
        w = [randn(c, c, std=c ** -0.5).to(dev, dtype) for _ in range(4)]
        b = [randn(c, std=0.02).to(dev) for _ in range(4)]
        bias = torch.full((t, t), -1e30).triu(1)[None].to(dev) if causal else None
        return (randn(cols, t, c).to(dev, dtype), w[0], b[0], w[1], b[1], w[2], b[2],
                w[3], b[3], (1 + randn(c, std=0.1)).to(dev), randn(c, std=0.1).to(dev),
                randn(t, c, std=0.5).to(dev), bias)

    errs = {}
    phase("15. conv-FFN route kernels (#11/#12, and #1/#3 at the temporal shapes) "
          "against their plain versions (card)")
    print(f"  clusters: fc1 {tcl.cluster_split(hid)} blocks a sample, fc2 "
          f"{tcl.cluster_split(c)}")
    # #11's bf16 product alone (csrc/wgmma.cuh): 64 rows by 176 columns (one
    # warpgroup), 352 (two: fc1's slab) and 528 (three), K of both stages;
    # against an f32 matmul of the same bf16 operands (summation order only)
    prand = normals(torch.Generator().manual_seed(SEED + 41))
    for cols, k in ((176, c), (176, hid), (352, c), (528, hid)):
        a, bt = prand(64, k).to(dev, bf), prand(cols, k).to(dev, bf)
        e = rel_err(tcl.wgmma_product(a, bt), torch.matmul(a.float(), bt.float().t()))
        check(e <= 1e-5, f"wgmma product 64 x {cols} x {k} vs f32 matmul rel err "
              f"{e:.2e} <= 1e-5")
    # #12's weight-gradient product alone (both operands MN-major, as x and
    # du lie in memory: the transpose flags), at one K chunk of the step's
    # split (1024 rows) and both stages' (Cin, Cout)
    for m, n in ((c, hid), (hid, c)):
        a, b = prand(1024, m).to(dev, bf), prand(1024, n).to(dev, bf)
        e = rel_err(tcl.wgmma_product_mn(a, b), torch.matmul(a.float().t(), b.float()))
        check(e <= 1e-5, f"wgmma MN-major product 1024 x {m} x {n} vs f32 matmul rel err "
              f"{e:.2e} <= 1e-5")
    for dtype in (bf, torch.float32):
        name = str(dtype).replace("torch.", "")
        for stage, (cin, cout) in stages.items():
            ops, ops_t = conv_ops(n_pred, cin, cout, dtype), conv_ops(n_step, cin, cout, dtype)
            e = max_err(tcl.conv_ln_gelu(*ops), tcl.conv_ln_gelu_plain(*ops))
            check(e <= tol[dtype], f"conv_ln_gelu {name} {stage} {tuple(ops[0].shape)} -> "
                  f"{cout} max|err| {e:.3e} <= {tol[dtype]}")
            gout = randn(n_step, hw, cout).to(dev, dtype)
            got = tcl.conv_ln_gelu_backward(*ops_t, gout)
            want = tcl.conv_ln_gelu_backward_plain(*ops_t, gout)
            n_worst, worst = worst_rel(got, want, names)
            check(worst <= bwd_tol[dtype], f"conv_ln_gelu backward {name} {stage} "
                  f"{tuple(ops_t[0].shape)} worst {n_worst} rel err {worst:.2e} <= "
                  f"{bwd_tol[dtype]:.2e}")
            if dtype == bf and stage == "fc1":
                errs["fwd"] = e
                errs["bwd"] = max(max_err(a, b) for a, b in zip(got, want))
            del ops, ops_t, gout, got, want
        for where, (cols, t, causal, rates) in temporal.items():
            ops = temporal_ops(cols, t, causal, dtype)
            what = (f"{name} {where} {tuple(ops[0].shape)}"
                    f"{' causal' if causal else ''} + positions "
                    f"({tfw.kernel_route(t, c, dtype)})")
            gout = randn(cols, t, c).to(dev, dtype)
            for r in rates:
                e = max_err(tfw.fused_attention_ln(*ops, kseed, heads, r),
                            tfw.fused_attention_ln_plain(*ops, kseed, heads, r))
                check(e <= tol[dtype], f"fused_attention_ln {what} dropout {r} "
                      f"max|err| {e:.3e} <= {tol[dtype]}")
                if dtype == bf and r == 0:
                    errs[("ln", where)] = e
                if where == "far_rip":        # the predict runs no backward
                    continue
                # the path's call: no gradient for the constant causal bias
                got = tfw.fused_attention_ln_backward(*ops, kseed, gout, heads, r,
                                                      need_dbias=False)
                want = tfw.fused_attention_ln_backward_plain(*ops, kseed, gout, heads, r,
                                                             need_dbias=False)
                n_worst, worst = worst_rel(got, want, ln_names)
                check(worst <= bwd_tol[dtype], f"fused_attention_ln backward {what} "
                      f"dropout {r} ({tfw.backward_route(t, c, dtype)} route) worst "
                      f"{n_worst} rel err {worst:.2e} <= {bwd_tol[dtype]:.2e}")
                if dtype == bf and r > 0:
                    errs[("ln_bwd", where)] = max(max_err(a, b) for a, b in zip(got, want)
                                                  if b is not None)
            del ops, gout
    torch.cuda.synchronize()

    n = LAYERS * FUTURE
    pred_launches, step_launches, times = route_phases(
        dev, flags, "conv-FFN route", 16,
        {"conv_ln_gelu": 2 * n, "fused_attention_ln": 2 * n, "attention_core": 0},
        {"conv_ln_gelu": 2 * LAYERS, "conv_ln_gelu_bwd": 2 * LAYERS,
         "fused_attention_ln": 2 * LAYERS, "fused_attention_ln_bwd": 2 * LAYERS,
         "attention_core": 0, "attention_core_bwd": 0})

    # #1 at the temporal shape (640 columns x 20 tokens, causal, the position
    # table) inside the module, against the default route's temporal
    # sublayer: f32 LayerNorm, q/k/v projections, #2, the output projection;
    # the same weights
    xt = randn(BATCH, ctx, tc.enc_h, tc.enc_w, c).to(dev, bf)
    pos_t = (0.5 * randn(ctx, c)).to(dev)
    folded = TemporalAttention(c, heads, True, True, bf, fused_full=True).to(dev).eval()
    unfolded = TemporalAttention(c, heads, True, True, bf).to(dev).eval()
    unfolded.load_state_dict(folded.state_dict())
    norm = LayerNorm(c, dtype=bf).to(dev)
    ln = (norm.weight, norm.bias)
    with torch.no_grad():
        e_t = max_err(folded(xt, pos_t, ln=ln), unfolded(norm(xt), pos_t))
        t_fold, t_unfold = timed_turns(lambda: folded(xt, pos_t, ln=ln),
                                       lambda: unfolded(norm(xt), pos_t))
    check(e_t <= tol[bf], f"temporal sublayer folded (#1) vs LayerNorm + projections + "
          f"#2 max|err| {e_t:.3e} <= {tol[bf]}")
    print(f"  temporal sublayer (640 x 20 x 528, causal): folded #1 {t_fold:.4f} ms, "
          f"LayerNorm + projections + #2 {t_unfold:.4f} ms (module calls, CUDA events)")
    del xt, folded, unfolded, norm

    def library(x, w, b, scale, bias2):
        u = F.linear(x, w.t(), b.to(bf))
        return F.gelu(F.layer_norm(u, u.shape[1:], scale.to(bf), bias2.to(bf)))

    s2b = 2   # bytes per bf16 element
    readings = {}

    def timed(key, fn, plain, lib, nbytes, flops):
        k_ms, p_ms = timed_turns(fn, plain)
        lib_ms = cuda_ms(lib)
        b_ms, b_by = bound(nbytes, flops)
        readings[key] = dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, bound_ms=b_ms,
                             bound_by=b_by)
        print(f"  {' '.join(key)}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, library "
              f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.2f} MB, "
              f"{flops / 1e9:.2f} GFLOP)")

    for stage, (cin, cout) in stages.items():
        ops, ops_t = conv_ops(n_pred, cin, cout, bf), conv_ops(n_step, cin, cout, bf)
        gout = randn(n_step, hw, cout).to(dev, bf)
        s_pred, s_step = n_pred * hw, n_step * hw
        vecs = cout * 4 + 2 * hw * cout * 4
        timed(("conv_ln_gelu", stage), lambda: tcl.conv_ln_gelu(*ops),
              lambda: tcl.conv_ln_gelu_plain(*ops), lambda: library(*ops),
              s_pred * (cin + cout) * s2b + cin * cout * s2b + vecs,
              2 * s_pred * cin * cout)
        timed(("conv_ln_gelu_bwd", stage), lambda: tcl.conv_ln_gelu_backward(*ops_t, gout),
              lambda: tcl.conv_ln_gelu_backward_plain(*ops_t, gout),
              grads_of(library, ops_t, gout),
              s_step * (2 * cin + cout) * s2b + 2 * cin * cout * s2b + 2 * vecs + cout * 4,
              6 * s_step * cin * cout)
        # the yardsticks again, replayed from CUDA graphs (no host between
        # launches): the forward on the 200 samples, the backward on the 190
        fwd = graph_ms(lambda: library(*ops))
        readings[("conv_ln_gelu", stage)]["library_graph_ms"] = fwd
        print(f"  library yardstick replayed from a CUDA graph, {stage}: forward {fwd:.4f} "
              f"ms (200 samples)")
        readings[("conv_ln_gelu_bwd", stage)]["library_graph_ms"] = graph_bwd_ms(
            library, ops_t, gout)
        del ops, ops_t, gout

    # #1 / #3 at the temporal shapes (bf16): #1 as far_rip and the NAR
    # predict call it (dropout 0), #3 as the FAR and NAR steps do (dropout
    # 0.1); the yardstick is LayerNorm, F.linear x4 and SDPA with the mask
    for where, key_f, key_b in (("far_rip", "far_rip 640x20", None),
                                ("far_step", None, "far_step 640x19"),
                                ("nar", "nar 1024x10", "nar 1024x10")):
        cols, t, causal, rates = temporal[where]
        ops = temporal_ops(cols, t, causal, bf)
        x, wq, bq, wk, bk, wv, bv, wo, bo, ls, lb, pos, bias = ops
        gout = randn(cols, t, c).to(dev, bf)
        mask = None if bias is None else bias.to(bf)

        def t_library(x, wq, wk, wv, wo, t=t, cols=cols, ls=ls, lb=lb, pos=pos, mask=mask,
                      bq=bq, bk=bk, bv=bv, bo=bo):
            xn = F.layer_norm(x, (c,), ls.to(bf), lb.to(bf))
            xqk = xn + pos.to(bf)
            split = lambda z: z.view(cols, t, heads, hd).transpose(1, 2)
            o = F.scaled_dot_product_attention(
                split(F.linear(xqk, wq.t(), bq.to(bf))),
                split(F.linear(xqk, wk.t(), bk.to(bf))),
                split(F.linear(xn, wv.t(), bv.to(bf))), attn_mask=mask)
            return F.linear(o.transpose(1, 2).reshape(cols, t, c), wo.t(), bo.to(bf))

        rows = cols * t
        vec = (6 * c + t * c) * 4 + (t * t * 4 if causal else 0)
        if key_f:
            timed(("fused_attention_ln", key_f),
                  lambda: tfw.fused_attention_ln(*ops, kseed, heads, 0.0),
                  lambda: tfw.fused_attention_ln_plain(*ops, kseed, heads, 0.0),
                  lambda: t_library(x, wq, wk, wv, wo),
                  2 * rows * c * s2b + 4 * c * c * s2b + vec,
                  8 * rows * c * c + 4 * rows * t * c)
            fwd = graph_ms(lambda: t_library(x, wq, wk, wv, wo))
            readings[("fused_attention_ln", key_f)]["library_graph_ms"] = fwd
            print(f"  library yardstick replayed from a CUDA graph, {key_f}: {fwd:.4f} ms")
        if key_b:
            r = rates[-1]
            timed(("fused_attention_ln_bwd", key_b),
                  lambda: tfw.fused_attention_ln_backward(*ops, kseed, gout, heads, r,
                                                          need_dbias=False),
                  lambda: tfw.fused_attention_ln_backward_plain(*ops, kseed, gout, heads, r,
                                                                need_dbias=False),
                  grads_of(t_library, (x, wq, wk, wv, wo), gout),
                  3 * rows * c * s2b + 8 * c * c * s2b + vec + 8 * c * 4,
                  22 * rows * c * c + 12 * rows * t * c)
            readings[("fused_attention_ln_bwd", key_b)]["library_graph_ms"] = graph_bwd_ms(
                t_library, (x, wq, wk, wv, wo), gout)
        del ops, gout

    rows_out = []
    for name, src, replaces, err, n_launch in (
            ("conv_ln_gelu", "vptr_tpu_torch/csrc/conv_ln_gelu.cu",
             "vptr_tpu/ops/fused_conv_ln.py:174", errs["fwd"], pred_launches["conv_ln_gelu"]),
            ("conv_ln_gelu_bwd", "vptr_tpu_torch/csrc/conv_ln_gelu_bwd.cu",
             "vptr_tpu/ops/fused_conv_ln.py:196", errs["bwd"],
             step_launches["conv_ln_gelu_bwd"])):
        rows_out.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                         "launches": n_launch, "max_abs_err": err,
                         **readings[(name, "fc1")], "fc2_stage": readings[(name, "fc2")],
                         "train_step_launches": step_launches[name]})
    # the #1 / #3 rows' readings at the temporal shapes, by kernel name
    temporal_rows = {"fused_attention_ln": {}, "fused_attention_ln_bwd": {}}
    for (name, shape), reading in readings.items():
        if name in temporal_rows:
            where = shape.split()[0]
            err = errs[("ln" if name == "fused_attention_ln" else "ln_bwd", where)]
            temporal_rows[name][shape] = {"max_abs_err": err, **reading}

    phase("19. nar_mnist conv-FFN route (fused_conv_ffn + fused_full_temporal)")
    dtype = compute_dtype(ncfg)
    n_past, n_fut = ntc.num_past_frames, ntc.num_future_frames
    enc_l, dec_l = ntc.num_encoder_layers, ntc.num_decoder_layers
    nenc, ndec = build_autoencoder(ncfg.ae, dtype, dev, torch.Generator().manual_seed(SEED))
    ntr = build_transformer(ntc, dtype, dev, torch.Generator().manual_seed(SEED + 1))
    nframes = torch.rand(nb, n_past + n_fut, 64, 64, 1,
                         generator=torch.Generator().manual_seed(SEED + 2))
    npast, nfuture = nframes[:, :n_past].to(dev), nframes[:, n_past:].to(dev)
    npredict = make_predict_fn(ncfg, nenc, ndec, ntr, "nar", n_fut, dev)
    want_nar = {"conv_ln_gelu": 4 * dec_l, "fused_attention_ln": 2 * enc_l + dec_l,
                "fused_attention": dec_l, "attention_core": dec_l}
    npred, nar_pred_launches = counted_predict(npredict, (npast,), want_nar,
                                               (nb, n_fut, 64, 64, 1), "conv-route nar")
    predict_vs_plain(npredict, (npast,), ntr, npred, "conv-route nar predict")
    nopt = build_optimizer(ncfg.optim, c)
    nstate = create_nar_train_state(nenc, ndec, ntr, nopt, seed=SEED + 3)
    nar_step = make_nar_train_step(nenc, ndec, ntr, nopt, ncfg.loss)
    nstate, _ = nar_step(nstate, npast, nfuture)    # the first step's norm is ~1e10
    want_nar_step = {**want_nar, "conv_ln_gelu_bwd": 4 * dec_l,
                     "fused_attention_ln_bwd": 2 * enc_l + dec_l,
                     "fused_attention_bwd": dec_l, "attention_core_bwd": dec_l}
    nstate, nar_step_launches = counted_step(nar_step, nstate, npast, nfuture,
                                             want_nar_step, "conv-route NAR train step")
    step_vs_plain(nar_step, nstate, npast, nfuture, "conv-route NAR step")
    del nenc, ndec, ntr, nstate, nar_step, npredict
    torch.cuda.empty_cache()

    pm, sm = times["predict_ms"], times["step_ms"]
    summary = (f"conv_route_predict_ms {pm['route']:.3f} default_predict_ms "
               f"{pm['default']:.3f} conv_route_train_step_ms {sm['route']:.3f} "
               f"default_train_step_ms {sm['default']:.3f} conv_route_step_peak_gib "
               f"{times['step_peak_gib']['route']:.3f} temporal_folded_ms {t_fold:.4f} "
               f"temporal_unfolded_ms {t_unfold:.4f}")
    extra = {"conv_route_predict_launches": pred_launches,
             "conv_route_step_launches": step_launches,
             "conv_route_nar_predict_launches": nar_pred_launches,
             "conv_route_nar_step_launches": nar_step_launches}
    return rows_out, temporal_rows, extra, summary


def moving_squares(n: int, t: int, size: int, g: torch.Generator) -> torch.Tensor:
    """(n, t, size, size, 1) frames in [0, 1]: two bright 12 x 12 squares a
    clip on black, each moving at its own constant speed and bouncing off
    the borders (the layout of Moving MNIST, without digits)."""
    frames = torch.zeros(n, t, size, size, 1)
    side = 12
    span = size - side
    pos = torch.rand(n, 2, 2, generator=g) * span
    vel = (torch.rand(n, 2, 2, generator=g) - 0.5) * 6
    for step in range(t):
        p = torch.remainder(pos + vel * step, 2 * span)   # reflected into [0, span]
        p = torch.where(p > span, 2 * span - p, p).long()
        for i in range(n):
            for k in range(2):
                y, x = p[i, k].tolist()
                frames[i, step, y:y + side, x:x + side] = 1.0
    return frames


def ae_gan_phases(dev):
    """Phases 20-22: the stage-1 AE/GAN step of ae_mnist at full width,
    lam_gan on the far_mnist and nar_mnist steps, and their times. Returns
    (the summary line, extra readings)."""
    from vptr_tpu_torch.config import get_preset
    from vptr_tpu_torch.models.autoencoder import build_autoencoder
    from vptr_tpu_torch.models.discriminator import build_discriminator
    from vptr_tpu_torch.models.transformer import build_transformer
    from vptr_tpu_torch.train.optim import build_optimizer
    from vptr_tpu_torch.train.state import create_ae_train_state, create_far_train_state
    from vptr_tpu_torch.train.steps import (
        make_ae_eval_step,
        make_ae_train_step,
        make_far_train_step,
        make_nar_train_step,
    )

    bf = torch.bfloat16
    phase("20. ae_mnist full width, AE/GAN train step")
    cfg = get_preset("ae_mnist")
    dtype = compute_dtype(cfg)
    batch, n_past, n_fut = (cfg.data.batch_size, cfg.data.num_past_frames,
                            cfg.data.num_future_frames)
    enc, dec = build_autoencoder(cfg.ae, dtype, dev, torch.Generator().manual_seed(SEED + 30))
    disc = build_discriminator(cfg.disc, dtype, dev, torch.Generator().manual_seed(SEED + 31))
    g_opt, d_opt = build_optimizer(cfg.optim), build_optimizer(cfg.optim_d)
    state = create_ae_train_state(enc, dec, disc, g_opt, d_opt, seed=SEED + 32)
    train_step = make_ae_train_step(enc, dec, disc, g_opt, d_opt, cfg.loss)
    eval_step = make_ae_eval_step(enc, dec, disc, cfg.loss)
    counts = {n: sum(p.numel() for p in m.parameters())
              for n, m in (("enc", enc), ("dec", dec), ("disc", disc))}
    print(f"  params {counts}, dtype {dtype}; AE ngf {cfg.ae.ngf} feat {cfg.ae.feat_dim} "
          f"res blocks {cfg.ae.n_res_blocks} norm {cfg.ae.norm}; D ndf {cfg.disc.ndf} "
          f"n_layers {cfg.disc.n_layers}; G {cfg.optim.optimizer} lr {cfg.optim.lr} "
          f"b1 {cfg.optim.b1}, D {cfg.optim_d.optimizer} lr {cfg.optim_d.lr} b1 "
          f"{cfg.optim_d.b1}, mu_dtype {cfg.optim.mu_dtype}; {cfg.loss.gan_mode} GAN at "
          f"lam_gan {cfg.loss.lam_gan}; batch {batch}, {n_past} + {n_fut} frames")
    frames = moving_squares(batch, n_past + n_fut, 64, torch.Generator().manual_seed(SEED + 33))
    past, future = frames[:, :n_past].to(dev), frames[:, n_past:].to(dev)
    before = {n: {k: v.clone() for k, v in m.state_dict().items()}
              for n, m in (("enc", enc), ("dec", dec), ("disc", disc))}
    state, m = train_step(state, past, future)
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(v)) for v in m.values()),
          f"first AE step metrics finite: { {k: round(float(v), 6) for k, v in m.items()} }")
    check(float(m["Dtotal"]) > 0, f"Dtotal {float(m['Dtotal']):.6f} > 0")
    for name, module in (("enc", state.enc), ("dec", state.dec), ("disc", state.disc)):
        params = dict(module.named_parameters())
        stats = {k: v for k, v in module.state_dict().items() if k not in params}
        same_p = [k for k, p in params.items() if torch.equal(p, before[name][k])]
        same_s = [k for k, v in stats.items() if torch.equal(v, before[name][k])]
        check(not same_p, f"{name}: all {len(params)} parameters changed by the step "
              f"(unchanged: {same_p})")
        check(len(stats) > 0 and not same_s, f"{name}: all {len(stats)} running "
              f"statistics changed by the step (unchanged: {same_s})")
    del before
    fixed = state.clone()
    losses = []
    for _ in range(TRAIN_STEPS):
        fixed, mm = train_step(fixed, past, future)
        losses.append(float(mm["AE_total"]))
    del fixed
    print(f"  AE_total over {TRAIN_STEPS} steps on one batch: {[round(x, 6) for x in losses]}")
    check(all(x == x and abs(x) != float("inf") for x in losses), "AE train losses finite")
    check(losses[-1] < losses[0], f"AE_total falls over {TRAIN_STEPS} steps: "
          f"{losses[0]:.6f} -> {losses[-1]:.6f}")
    em, rec = eval_step(state, past, future)
    check(all(bool(torch.isfinite(v)) for v in em.values()),
          f"AE eval metrics finite: { {k: round(float(v), 6) for k, v in em.items()} }")
    check_frames(rec, (batch, n_past + n_fut, 64, 64, 1), "AE eval step")
    del rec

    phase("21. far_mnist and nar_mnist train steps with lam_gan 0.01 (default route)")
    fcfg = get_preset("far_mnist").override({"loss": {"lam_gan": 0.01}})
    ftc = fcfg.transformer
    fenc, fdec = build_autoencoder(fcfg.ae, dtype, dev, torch.Generator().manual_seed(SEED))
    ftr = build_transformer(ftc, dtype, dev, torch.Generator().manual_seed(SEED + 1))
    fdisc = build_discriminator(fcfg.disc, dtype, dev, torch.Generator().manual_seed(SEED + 31))
    opt, fd_opt = build_optimizer(fcfg.optim, ftc.d_model), build_optimizer(fcfg.optim_d)
    frames = torch.rand(BATCH, PAST + FUTURE, 64, 64, 1,
                        generator=torch.Generator().manual_seed(SEED + 2))
    fpast, ffuture = frames[:, :PAST].to(dev), frames[:, PAST:].to(dev)
    plain_state = create_far_train_state(fenc, fdec, ftr, opt, seed=SEED + 3).clone()
    gan_state = create_far_train_state(fenc, fdec, ftr, opt, seed=SEED + 3, disc=fdisc,
                                       d_optimizer=fd_opt)
    gan_step = make_far_train_step(fenc, fdec, ftr, opt, fcfg.loss, disc=fdisc,
                                   d_optimizer=fd_opt)
    plain_step = make_far_train_step(fenc, fdec, ftr, opt, get_preset("far_mnist").loss)
    gan_state, far_launches = counted_step(
        gan_step, gan_state, fpast, ffuture,
        {k: LAYERS for k in ("fused_attention_ln", "attention_core",
                             "fused_attention_ln_bwd", "attention_core_bwd")},
        "FAR train step with the GAN term")
    step_vs_plain(gan_step, gan_state, fpast, ffuture, "FAR GAN step")
    _, m = gan_step(gan_state.clone(), fpast, ffuture)
    check(float(m["Dtotal"]) > 0 and float(m["T_gan"]) > 0,
          f"FAR GAN step Dtotal {float(m['Dtotal']):.6f}, T_gan {float(m['T_gan']):.6f} "
          f"finite and > 0")

    ncfg = get_preset("nar_mnist").override({"loss": {"lam_gan": 0.01}})
    ntc = ncfg.transformer
    nb, nn_past, nn_fut = ncfg.data.batch_size, ntc.num_past_frames, ntc.num_future_frames
    enc_l, dec_l = ntc.num_encoder_layers, ntc.num_decoder_layers
    nenc, ndec = build_autoencoder(ncfg.ae, dtype, dev, torch.Generator().manual_seed(SEED))
    ntr = build_transformer(ntc, dtype, dev, torch.Generator().manual_seed(SEED + 1))
    ndisc = build_discriminator(ncfg.disc, dtype, dev, torch.Generator().manual_seed(SEED + 31))
    nopt, nd_opt = build_optimizer(ncfg.optim, ntc.d_model), build_optimizer(ncfg.optim_d)
    nframes = torch.rand(nb, nn_past + nn_fut, 64, 64, 1,
                         generator=torch.Generator().manual_seed(SEED + 2))
    npast, nfuture = nframes[:, :nn_past].to(dev), nframes[:, nn_past:].to(dev)
    nstate = create_far_train_state(nenc, ndec, ntr, nopt, seed=SEED + 3, disc=ndisc,
                                    d_optimizer=nd_opt)
    nar_step = make_nar_train_step(nenc, ndec, ntr, nopt, ncfg.loss, disc=ndisc,
                                   d_optimizer=nd_opt)
    want = {"fused_attention_ln": enc_l, "fused_attention_ln_bwd": enc_l,
            "fused_attention": dec_l, "fused_attention_bwd": dec_l,
            "attention_core": enc_l + 2 * dec_l, "attention_core_bwd": enc_l + 2 * dec_l}
    nstate, nar_launches = counted_step(nar_step, nstate, npast, nfuture, want,
                                        "NAR train step with the GAN term")
    _, m = nar_step(nstate.clone(), npast, nfuture)
    check(float(m["Dtotal"]) > 0 and float(m["T_gan"]) > 0,
          f"NAR GAN step Dtotal {float(m['Dtotal']):.6f}, T_gan {float(m['T_gan']):.6f} "
          f"finite and > 0")
    del nstate, nar_step, nenc, ndec, ntr, ndisc
    torch.cuda.empty_cache()

    phase("22. timing: the AE step and its eval step; the FAR step with and without "
          "the GAN term, in turns")
    frames_per_step = batch * (n_past + n_fut)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = [host_ms(lambda: train_step(state, past, future))
             for _ in range(WARMUP_STEPS + TIMED_STEPS)][WARMUP_STEPS:]
    ae_peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    ae_ms = statistics.median(times)
    eval_times = [host_ms(lambda: eval_step(state, past, future))
                  for _ in range(WARMUP_STEPS + TIMED_STEPS)][WARMUP_STEPS:]
    eval_ms = statistics.median(eval_times)
    print(f"  AE/GAN train step (batch {batch}, {n_past + n_fut} frames): median "
          f"{ae_ms:.3f} ms of {len(times)} ({[round(x, 3) for x in times]}), "
          f"{frames_per_step / ae_ms * 1e3:.1f} training frames/s; peak {ae_peak:.3f} "
          f"GiB above the {held / 2 ** 30:.3f} GiB held (the AE and FAR modules and "
          f"states); eval step median {eval_ms:.3f} ms "
          f"({[round(x, 3) for x in eval_times]}), "
          f"{frames_per_step / eval_ms * 1e3:.1f} frames/s")
    del state, enc, dec, disc, train_step, eval_step, past, future
    torch.cuda.empty_cache()

    steps = {"gan": (gan_step, gan_state), "plain": (plain_step, plain_state)}
    step_times = {"gan": [], "plain": []}
    for i in range(WARMUP_STEPS + TIMED_STEPS):   # plain, gan, gan, plain, ...
        for name in (("plain", "gan") if i % 2 == 0 else ("gan", "plain")):
            fn, st = steps[name]
            ms = host_ms(lambda: fn(st, fpast, ffuture))
            if i >= WARMUP_STEPS:
                step_times[name].append(ms)
    far_ms = {k: statistics.median(v) for k, v in step_times.items()}
    print(f"  FAR train step (batch {BATCH}, T {PAST + FUTURE - 1}): with the GAN term "
          f"median {far_ms['gan']:.3f} ms ({[round(x, 3) for x in step_times['gan']]}), "
          f"without {far_ms['plain']:.3f} ms "
          f"({[round(x, 3) for x in step_times['plain']]}): the GAN term costs "
          f"{far_ms['gan'] - far_ms['plain']:.3f} ms")
    del steps, gan_state, plain_state, gan_step, plain_step, fenc, fdec, ftr, fdisc
    torch.cuda.empty_cache()
    summary = (f"ae_train_step_ms {ae_ms:.3f} ae_train_frames_per_s "
               f"{frames_per_step / ae_ms * 1e3:.1f} ae_train_peak_gib {ae_peak:.3f} "
               f"ae_eval_step_ms {eval_ms:.3f} far_gan_step_ms {far_ms['gan']:.3f} "
               f"far_plain_step_ms {far_ms['plain']:.3f}")
    extra = {"far_gan_step_launches": far_launches, "nar_gan_step_launches": nar_launches,
             "ae_train_step_ms": ae_ms}
    return summary, extra


class _Records(logging.Handler):
    """The messages logged while it is attached."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _history(ckpt_dir):
    """{"train": {key: last value}, "val": {...}} of a run's history.json."""
    hist = json.loads((ckpt_dir / "ckpt" / "history.json").read_text())
    return {split: {k: v[-1][1] for k, v in hist.get(split, {}).items()}
            for split in ("train", "val")}


def _finite(values) -> bool:
    return all(v == v and abs(v) != float("inf") for v in values)


def loader_batches_per_s(loader, n: int) -> float:
    """Batches/s of a loader alone over n batches after its first (the
    thread pool running)."""
    from contextlib import closing

    with closing(iter(loader)) as it:
        next(it)
        t0 = time.perf_counter()
        for _ in range(n):
            next(it)
        return n / (time.perf_counter() - t0)


class _PerClip:
    """A dataset without its native batch path: the loader builds each
    clip with ``get`` (the Python generator)."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def get(self, index, rng=None):
        return self.ds.get(index, rng)


def entry_point_phases(dev, bare_step_ms, bare_ae_ms, root):
    """Phases 23-26: the commands users run, ``python -m vptr_tpu_torch.cli
    train / eval / predict``, through ``cli.main`` at full width on the
    synthetic loader (no dataset on disk), into the directory ``root``
    (the caller's: phase 57 runs the examples on its ae_mnist and far_mnist
    checkpoints, ``root / "ae"`` and ``root / "far"``, then removes it).
    Returns (the summary line, extra readings)."""
    import contextlib
    import importlib.util
    import io

    from vptr_tpu_torch import cli
    from vptr_tpu_torch.config import get_preset
    from vptr_tpu_torch.data import native
    from vptr_tpu_torch.data.loader import ClipLoader, build_loader
    from vptr_tpu_torch.eval.harness import evaluate, make_predict_fn
    from vptr_tpu_torch.eval.metrics import METRIC_FNS
    from vptr_tpu_torch.train.checkpoint import CheckpointManager
    from vptr_tpu_torch.train.trainer import Trainer

    records = _Records()
    logging.getLogger("vptr_tpu_torch").addHandler(records)
    try:
        phase(f"23. cli train: ae_mnist at full width, {AE_CLI_STEPS} steps and a "
              f"validation pass")
        ae_dir = root / "ae"
        acfg = get_preset("ae_mnist")
        t0 = time.perf_counter()
        cli.main(["train", "--preset", "ae_mnist", "--ckpt-dir", str(ae_dir),
                  "--set", "epochs=1", "--set", f"steps_per_epoch={AE_CLI_STEPS}",
                  "--set", "val_per_epochs=1"])
        ae_wall = time.perf_counter() - t0
        ah = _history(ae_dir)
        ae_frames = acfg.data.batch_size * (acfg.data.num_past_frames
                                            + acfg.data.num_future_frames)
        ae_sps = ah["train"]["steps_per_sec"]
        print(f"  train {ah['train']}\n  val {ah['val']}")
        check(_finite(ah["train"].values()) and _finite(ah["val"].values())
              and "AE_total" in ah["val"], "ae_mnist cli train: train and val metrics finite")
        check((ae_dir / "ckpt" / str(AE_CLI_STEPS) / "state.pt").is_file(),
              f"ae_mnist cli train wrote ckpt/{AE_CLI_STEPS}/")
        print(f"  ae_mnist trainer: {ae_sps:.3f} steps/s ({1e3 / ae_sps:.1f} ms a step), "
              f"{ae_sps * ae_frames:.1f} training frames/s ({ae_frames} a step); the bare "
              f"AE step (phase 22) {bare_ae_ms:.3f} ms = {ae_frames / bare_ae_ms * 1e3:.1f} "
              f"frames/s; the command's wall {ae_wall:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()

        phase(f"24. cli train: far_mnist at full width on phase 23's autoencoder, "
              f"{FAR_CLI_STEPS} steps and a validation pass; the loader alone; a resumed run")
        far_dir = root / "far"
        sets = ["--set", f"ae_ckpt={ae_dir / 'ckpt'}", "--set", "epochs=1", "--set",
                f"steps_per_epoch={FAR_CLI_STEPS}", "--set", "val_per_epochs=1"]
        far_args = ["--preset", "far_mnist", "--ckpt-dir", str(far_dir), *sets]
        cfg = get_preset("far_mnist").override({"ae_ckpt": str(ae_dir / "ckpt"),
                                                "ckpt_dir": str(far_dir)})
        val_batches = len(build_loader(cfg.data, split="val", seed=cfg.seed))
        frames_per_step = cfg.data.batch_size * (cfg.data.num_past_frames
                                                 + cfg.data.num_future_frames - 1)
        zero_counters()
        t0 = time.perf_counter()
        cli.main(["train", *far_args])
        torch.cuda.synchronize()
        far_wall = time.perf_counter() - t0
        fwd = LAYERS * (FAR_CLI_STEPS + val_batches)
        far_launches = launch_counts("fused_attention_ln", "attention_core",
                                     "fused_attention_ln_bwd", "attention_core_bwd")
        check_counts(far_launches, {"fused_attention_ln": fwd, "attention_core": fwd,
                                    "fused_attention_ln_bwd": LAYERS * FAR_CLI_STEPS,
                                    "attention_core_bwd": LAYERS * FAR_CLI_STEPS},
                     f"cli train far_mnist ({FAR_CLI_STEPS} steps x 12, {val_batches} "
                     f"validation batches x 12 forward)")
        fh = _history(far_dir)
        print(f"  train {fh['train']}\n  val {fh['val']}")
        check(_finite(fh["train"].values()) and _finite(fh["val"].values()),
              "far_mnist cli train: train and val metrics finite")
        check((far_dir / "ckpt" / str(FAR_CLI_STEPS) / "state.pt").is_file(),
              f"far_mnist cli train wrote ckpt/{FAR_CLI_STEPS}/")
        sps = fh["train"]["steps_per_sec"]
        print(f"  far_mnist trainer: {sps:.3f} steps/s ({1e3 / sps:.1f} ms a step), "
              f"{sps * frames_per_step:.1f} training frames/s ({frames_per_step} a step), "
              f"{fh['train']['transformer_tflops_per_sec']:.2f} transformer TFLOP/s; the "
              f"bare step (phase 6) {bare_step_ms:.3f} ms = {1e3 / bare_step_ms:.3f} "
              f"steps/s: the trainer's step costs {1e3 / sps / bare_step_ms:.3f}x the bare "
              f"step's; the command's wall {far_wall:.1f} s")

        loader = build_loader(cfg.data, split="train", seed=cfg.seed)
        route = ("native (native/libclipgen.so)" if native.native_available()
                 and loader.dataset.get_batch(np.arange(1)) is not None else "Python")
        native_bps = loader_batches_per_s(loader, 30)
        py_loader = ClipLoader(_PerClip(loader.dataset), loader.batch_size, seed=cfg.seed,
                               prefetch=cfg.data.prefetch, num_workers=cfg.data.num_workers)
        python_bps = loader_batches_per_s(py_loader, 6)
        print(f"  loader alone (batch {cfg.data.batch_size} x {cfg.total_frames} frames of "
              f"{cfg.data.synthetic_digits}-digit {cfg.data.synthetic_motion} synthetic "
              f"Moving MNIST, {cfg.data.num_workers} threads, prefetch "
              f"{cfg.data.prefetch}): the path the trainer took: {route}; native "
              f"{native_bps:.1f} batches/s, Python {python_bps:.2f} batches/s, against the "
              f"trainer's {sps:.3f} steps/s")

        records.messages.clear()
        cli.main(["train", *far_args])
        resumed = [m for m in records.messages if m.startswith("resumed from step")]
        check(resumed == [f"resumed from step {FAR_CLI_STEPS} (epoch 1)"],
              f"the second cli train logs {resumed}")
        check((far_dir / "ckpt" / str(2 * FAR_CLI_STEPS) / "state.pt").is_file(),
              f"the resumed run continued to ckpt/{2 * FAR_CLI_STEPS}/")
        fh2 = _history(far_dir)
        sps2 = fh2["train"]["steps_per_sec"]
        print(f"  resumed run: {sps2:.3f} steps/s; T_total {fh2['train']['T_total']:.6f}")
        gc.collect()
        torch.cuda.empty_cache()

        trainer = Trainer(cfg, device=dev)
        state = trainer.init_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = trainer.ckpt.restore(state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        ckpt_bytes = (far_dir / "ckpt" / str(2 * FAR_CLI_STEPS) / "state.pt").stat().st_size
        check(state.step == 2 * FAR_CLI_STEPS, f"restored step {state.step}")
        t0 = time.perf_counter()
        CheckpointManager(str(root / "save_probe")).save(state.step, state)
        save_s = time.perf_counter() - t0
        print(f"  far_mnist checkpoint: {ckpt_bytes} bytes; save {save_s:.3f} s, restore "
              f"onto the card {restore_s:.3f} s")

        phase("25. cli eval --mode far_rip --max-batches 2 from that checkpoint")
        eval_args = ["--preset", "far_mnist", "--ckpt-dir", str(far_dir), *sets]
        zero_counters()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["eval", *eval_args, "--mode", "far_rip", "--max-batches", "2"])
        torch.cuda.synchronize()
        curves = json.loads(buf.getvalue())
        print(f"  {json.dumps(curves)}")
        want = LAYERS * FUTURE * 2
        eval_launches = launch_counts("fused_attention_ln", "attention_core")
        check_counts(eval_launches, {"fused_attention_ln": want, "attention_core": want},
                     "cli eval far_rip (2 batches of 10 x 12 layers)")
        check(all(len(curves[m]) == FUTURE and _finite(curves[m])
                  for m in ("psnr", "ssim", "mse")), "cli eval curves finite, 10 long")

        test = build_loader(cfg.data, split="test", seed=cfg.seed)
        batches = list(zip(range(3), test))
        batches = [b for _, b in batches]
        evaluate(trainer, state, batches[:1], mode="far_rip")          # warm-up
        eval_ms = host_ms(lambda: evaluate(trainer, state, batches, mode="far_rip")) / 3
        predict = make_predict_fn(cfg, state.enc, state.dec, state.transformer,
                                  "far_rip", FUTURE, dev)
        pred_ms = host_ms(lambda: [predict(*trainer.put_batch(p, f)) for p, f in batches]) / 3
        past_d, future_d = trainer.put_batch(*batches[0])
        pred = predict(past_d, future_d)
        pr = torch.clamp(trainer.renorm(pred.float()), 0.0, 1.0)
        tg = torch.clamp(trainer.renorm(future_d.float()), 0.0, 1.0)

        def curves_of(a, b):
            return {m: torch.stack([fn(a[:, t], b[:, t]) for t in range(FUTURE)])
                    for m, fn in METRIC_FNS.items()}

        metrics_ms = host_ms(lambda: curves_of(pr, tg))
        print(f"  evaluate far_rip: {eval_ms:.3f} ms a batch of {BATCH} (3 batches), of "
              f"which the rollout and staging {pred_ms:.3f} ms; the metrics alone "
              f"{metrics_ms:.3f} ms a batch ({metrics_ms / eval_ms:.3f} of it)")
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True      # the metrics turn it off themselves
        card = curves_of(pr, tg)
        torch.backends.cudnn.allow_tf32 = prev
        host = curves_of(pr.cpu(), tg.cpu())
        for m in METRIC_FNS:
            rel = ((card[m].cpu() - host[m]).abs() / host[m].abs().clamp_min(1e-12)).max().item()
            check(rel <= 1e-5, f"{m} of one batch on the card (cuDNN TF32 allowed) vs the "
                  f"CPU: max rel err {rel:.3e} <= 1e-5")
        del trainer, state, predict, pred, pr, tg, past_d, future_d
        gc.collect()
        torch.cuda.empty_cache()

        phase("26. cli predict --mode far_rip --batches 1")
        out_dir = root / "predictions"
        zero_counters()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["predict", *eval_args, "--out", str(out_dir), "--batches", "1"])
        torch.cuda.synchronize()
        print("  " + buf.getvalue().strip().replace("\n", "\n  "))
        want = LAYERS * FUTURE
        check_counts(launch_counts("fused_attention_ln", "attention_core"),
                     {"fused_attention_ln": want, "attention_core": want},
                     "cli predict far_rip (1 batch)")
        if importlib.util.find_spec("PIL") is not None:
            gifs = sorted(p.name for p in out_dir.rglob("*.gif"))
            clips = sorted(p.name for p in out_dir.rglob("*.avi")) + sorted(
                p.name for p in out_dir.rglob("*.mp4"))
            check(len(gifs) == min(4, cfg.data.batch_size) and len(clips) == 2,
                  f"cli predict wrote {gifs} and {clips}")
        else:
            print("  PIL does not import here: cli predict wrote no GIF or clip")
            check("PIL does not import" in buf.getvalue(), "cli predict said so")
    finally:
        logging.getLogger("vptr_tpu_torch").removeHandler(records)
    summary = (f"ae_trainer_steps_per_s {ae_sps:.4f} ae_trainer_frames_per_s "
               f"{ae_sps * ae_frames:.1f} far_trainer_steps_per_s {sps:.4f} "
               f"far_trainer_frames_per_s {sps * frames_per_step:.1f} "
               f"far_resumed_steps_per_s {sps2:.4f} far_bare_step_ms {bare_step_ms:.3f} "
               f"loader_native_batches_per_s {native_bps:.2f} loader_python_batches_per_s "
               f"{python_bps:.3f} eval_far_rip_ms_per_batch {eval_ms:.3f} "
               f"eval_predict_ms_per_batch {pred_ms:.3f} eval_metrics_ms_per_batch "
               f"{metrics_ms:.3f} ckpt_bytes {ckpt_bytes} ckpt_save_s {save_s:.3f} "
               f"ckpt_restore_s {restore_s:.3f}")
    extra = {"cli_train_far_launches": far_launches, "cli_eval_launches": eval_launches,
             "loader_path": route}
    return summary, extra


def sdpa_backends(q, k, v):
    """(the SDPA backends that take these operands alone, the one PyTorch's
    dispatch picks for them or None where it does not say): the flash
    backend refuses a head width of 66."""
    import warnings

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    names = {}
    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "MATH"):
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue
        names[int(backend)] = name
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                with sdpa_kernel([backend]):
                    F.scaled_dot_product_attention(q, k, v)
            except RuntimeError:
                names[int(backend)] = None
    takes = [n for n in names.values() if n]
    choice = getattr(torch, "_fused_sdp_choice", None)
    picked = names.get(int(choice(q, k, v))) if choice else None
    return takes, picked


def tslma_phases(dev):
    """Phases 27-31: TSLMA (transformer.tslma), nar_mnist's enc-dec attention
    over space-time windows, on the attention core's long route. Returns
    (the kernel rows of #2's and #4's long route, extra readings, the
    summary line)."""
    import contextlib
    import io
    import shutil
    import tempfile
    from pathlib import Path

    import torch.nn.functional as F

    from vptr_tpu_torch import cli
    from vptr_tpu_torch.config import get_preset
    from vptr_tpu_torch.eval import harness
    from vptr_tpu_torch.models.autoencoder import build_autoencoder
    from vptr_tpu_torch.models.transformer import build_transformer
    from vptr_tpu_torch.ops import attention_core as tac
    from vptr_tpu_torch.train.optim import build_optimizer
    from vptr_tpu_torch.train.state import create_nar_train_state
    from vptr_tpu_torch.train.steps import make_nar_train_step

    base = get_preset("nar_mnist")
    cfg = base.override({"transformer": {"tslma": True}})
    tc = cfg.transformer
    c, heads = tc.d_model, tc.n_heads
    hd = c // heads
    batch, n_past, n_fut = cfg.data.batch_size, tc.num_past_frames, tc.num_future_frames
    win2 = tc.window_size ** 2
    windows = batch * (tc.enc_h // tc.window_size) * (tc.enc_w // tc.window_size)
    tq = n_fut * win2                          # 160 queries a window
    bair_tk = 2 * win2                         # nar_bair's 2 past frames: 32 keys
    bf, f32 = torch.bfloat16, torch.float32
    randn = normals(torch.Generator().manual_seed(SEED + 90))
    kseed = torch.tensor([SEED + 97531], dtype=torch.int32, device=dev)
    rate = tc.dropout
    tol = {f32: 1e-3, bf: 2 ** -4}             # as phase 3
    bwd_tol = {f32: 1e-4, bf: 2 ** -5}
    names = ("dq", "dk", "dv", "dbias")

    def operands(dtype, b, tk, strided):
        """q, k, v, g: contiguous (B, H, T, D), or (strided) the (B, H, T, D)
        views of (B, T, H*D) tensors, as TSLMA's layer hands them over."""
        def one(t):
            if strided:
                return randn(b, t, c).to(dev, dtype).view(b, t, heads, hd).transpose(1, 2)
            return randn(b, heads, t, hd).to(dev, dtype)
        return one(tq), one(tk), one(tk), one(tq)

    phase("27. TSLMA: #2 and #4 on the long route against their plain versions (card)")
    errs = {}
    for dtype, b in ((bf, windows), (f32, 16)):
        name = str(dtype).replace("torch.", "")
        for tk in (tq, bair_tk):
            check(tac.kernel_route(dtype, heads, tq, tk, hd) == "long"
                  and tac.backward_route(dtype, heads, tq, tk, hd) == "long",
                  f"{name} ({b}, {heads}, {tq}, {tk}, {hd}) takes the long route both ways")
            for strided in (True, False):
                q, k, v, g = operands(dtype, b, tk, strided)
                for r in (0.0, rate):
                    for nb in (0, heads if tk == tq else 1):
                        bias = randn(nb, tq, tk).to(dev) if nb else None
                        what = (f"{name} ({b}, {heads}, {tq}, {tk}, {hd}) "
                                f"{'layer layout' if strided else 'contiguous'} dropout {r} "
                                f"bias {'(%d, %d, %d)' % (nb, tq, tk) if nb else 'none'}")
                        out = tac.attention_core(q, k, v, bias, kseed, r)
                        e = max_err(out, tac.attention_core_plain(q, k, v, bias, kseed, r))
                        check(e <= tol[dtype] and out.stride() == q.stride(),
                              f"attention_core long {what}: max|err| {e:.3e} <= {tol[dtype]}")
                        got = tac.attention_core_backward(q, k, v, bias, kseed, g, r,
                                                          need_dbias=nb > 0)
                        want = tac.attention_core_backward_plain(q, k, v, bias, kseed, g, r,
                                                                 nb > 0)
                        n_worst, worst = worst_rel(got, want, names)
                        check(worst <= bwd_tol[dtype], f"attention_core backward long {what}: "
                              f"worst {n_worst} rel err {worst:.2e} <= {bwd_tol[dtype]:.2e}")
                        if dtype == bf and strided and tk == tq and not nb:
                            errs[("fwd", r)] = e
                            errs[("bwd", r)] = max(max_err(x, y) for x, y in
                                                   zip(got[:3], want[:3]))
    torch.cuda.synchronize()

    # times at nar_mnist's 160 x 160, bf16, the layer's layout: the forward
    # as predict calls it (no dropout), the backward as the step does (0.1)
    q, k, v, g = operands(bf, windows, tq, True)
    fwd = lambda: tac.attention_core(q, k, v)
    bwd = lambda: tac.attention_core_backward(q, k, v, None, kseed, g, rate, need_dbias=False)
    sdpa = lambda q, k, v: F.scaled_dot_product_attention(q, k, v)
    takes, picked = sdpa_backends(q, k, v)
    print(f"  SDPA at ({windows}, {heads}, {tq}, {tq}, {hd}) bf16: backends that take it "
          f"{takes}, dispatch picks {picked}")
    elems = windows * heads * tq * hd
    readings = {}
    for key, fn, plain, lib, lib_graph, nbytes, flops in (
            ("fwd", fwd, lambda: tac.attention_core_plain(q, k, v), lambda: sdpa(q, k, v),
             lambda: graph_ms(lambda: sdpa(q, k, v)), 4 * elems * 2,
             4 * windows * heads * tq * tq * hd),
            ("bwd", bwd, lambda: tac.attention_core_backward_plain(q, k, v, None, kseed, g,
                                                                   rate, False),
             grads_of(sdpa, (q, k, v), g), lambda: graph_bwd_ms(sdpa, (q, k, v), g),
             7 * elems * 2, 10 * windows * heads * tq * tq * hd)):
        k_ms, p_ms = timed_turns(fn, plain)
        b_ms, b_by = bound(nbytes, flops)
        readings[key] = dict(ms=k_ms, graph_ms=graph_ms(fn), plain_ms=p_ms,
                             library_ms=cuda_ms(lib), library_graph_ms=lib_graph(),
                             bound_ms=b_ms, bound_by=b_by)
        print(f"  attention_core{'_bwd' if key == 'bwd' else ''} long route "
              f"({windows}, {heads}, {tq}, {tq}, {hd}): {readings[key]} ({nbytes / 1e6:.2f} MB, "
              f"{flops / 1e9:.2f} GFLOP)")
    del q, k, v, g
    torch.cuda.empty_cache()

    phase("28. nar_mnist + transformer.tslma at full width, nar predict")
    dtype = compute_dtype(cfg)
    enc, dec = build_autoencoder(cfg.ae, dtype, dev, torch.Generator().manual_seed(SEED))
    tr = build_transformer(tc, dtype, dev, torch.Generator().manual_seed(SEED + 1))
    print(f"  NAR {tc.num_encoder_layers}+{tc.num_decoder_layers} layers, d {c}, {heads} "
          f"heads, TSLMA in every decoder block: {windows} windows x {tq} queries over "
          f"{n_past * win2} keys")
    frames = torch.rand(batch, n_past + n_fut, 64, 64, 1,
                        generator=torch.Generator().manual_seed(SEED + 2))
    past, future = frames[:, :n_past].to(dev), frames[:, n_past:].to(dev)
    predict = harness.make_predict_fn(cfg, enc, dec, tr, "nar", n_fut, dev)
    enc_l, dec_l = tc.num_encoder_layers, tc.num_decoder_layers
    routes = lambda n_long: {"long": n_long, "mma": enc_l + dec_l, "fma": 0}
    want = {"fused_attention_ln": enc_l, "fused_attention": dec_l,
            "attention_core": enc_l + 2 * dec_l}
    pred, pred_launches = counted_predict(predict, (past,), want, (batch, n_fut, 64, 64, 1),
                                          "TSLMA nar predict")
    pred_routes = dict(tac.attention_core.launches_by_route)
    check(pred_routes == routes(dec_l), f"attention_core launches by route in the TSLMA "
          f"nar predict: {pred_routes} == {routes(dec_l)}")
    predict_vs_plain(predict, (past,), tr, pred, "TSLMA nar predict")

    phase("29. nar_mnist + transformer.tslma at full width, train step")
    opt = build_optimizer(cfg.optim, c)
    state = create_nar_train_state(enc, dec, tr, opt, seed=SEED + 3)
    train_step = make_nar_train_step(enc, dec, tr, opt, cfg.loss)
    want = {"fused_attention_ln": enc_l, "fused_attention_ln_bwd": enc_l,
            "fused_attention": dec_l, "fused_attention_bwd": dec_l,
            "attention_core": enc_l + 2 * dec_l, "attention_core_bwd": enc_l + 2 * dec_l}
    state, step_launches = counted_step(train_step, state, past, future, want,
                                        "TSLMA NAR train step")
    step_routes = {"forward": dict(tac.attention_core.launches_by_route),
                   "backward": dict(tac.attention_core.bwd_launches_by_route)}
    for way, got in step_routes.items():
        check(got == routes(dec_l), f"attention_core {way} launches by route in one TSLMA "
              f"NAR train step: {got} == {routes(dec_l)}")
    step_vs_plain(train_step, state, past, future, "TSLMA NAR step")
    loss_falls(train_step, state, past, future, "TSLMA NAR")

    phase("30. cli predict --preset nar_mnist --set transformer.tslma=true --mode nar "
          "--batches 1")
    root = Path(tempfile.mkdtemp(prefix="vptr_smoke_tslma_"))
    outputs, make = [], harness.make_predict_fn

    def recording(*args, **kwargs):          # the predictions the command makes
        fn = make(*args, **kwargs)

        def run(*batch_args):
            out = fn(*batch_args)
            outputs.append(out)
            return out
        return run

    harness.make_predict_fn = recording
    try:
        zero_counters()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["predict", "--preset", "nar_mnist", "--ckpt-dir", str(root / "run"),
                      "--set", "transformer.tslma=true", "--mode", "nar", "--batches", "1",
                      "--out", str(root / "predictions")])
        torch.cuda.synchronize()
        print("  " + buf.getvalue().strip().replace("\n", "\n  "))
        cli_routes = dict(tac.attention_core.launches_by_route)
        check(cli_routes == routes(dec_l), f"attention_core launches by route in cli "
              f"predict: {cli_routes} == {routes(dec_l)}")
        check(len(outputs) == 1 and outputs[0].is_cuda
              and bool(torch.isfinite(outputs[0].float()).all()),
              f"cli predict ran on the card, its frames finite "
              f"({[(tuple(o.shape), str(o.device)) for o in outputs]})")
    finally:
        harness.make_predict_fn = make
        shutil.rmtree(root, ignore_errors=True)
    del outputs
    gc.collect()
    torch.cuda.empty_cache()

    phase("31. TSLMA timing: predict and train step against nar_mnist's full temporal "
          "enc-dec attention, in turns")
    tr0 = build_transformer(base.transformer, dtype, dev, torch.Generator().manual_seed(SEED + 1))
    predict0 = harness.make_predict_fn(base, enc, dec, tr0, "nar", n_fut, dev)
    opt0 = build_optimizer(base.optim, c)
    state0 = create_nar_train_state(enc, dec, tr0, opt0, seed=SEED + 3)
    step0 = make_nar_train_step(enc, dec, tr0, opt0, base.loss)
    state0, _ = step0(state0, past, future)    # one step past the seeded init, as state
    pairs = {"tslma": (predict, train_step, state), "full": (predict0, step0, state0)}
    pred_times = {key: [] for key in pairs}
    for i in range(6):
        for key in (("tslma", "full") if i % 2 == 0 else ("full", "tslma")):
            ms = host_ms(lambda: pairs[key][0](past))
            if i:                                # the first warms up
                pred_times[key].append(ms)
    step_times = {key: [] for key in pairs}
    for i in range(WARMUP_STEPS + TIMED_STEPS):
        for key in (("tslma", "full") if i % 2 == 0 else ("full", "tslma")):
            _, step, st = pairs[key]
            ms = host_ms(lambda: step(st, past, future))
            if i >= WARMUP_STEPS:
                step_times[key].append(ms)
    med = {f"{what}_{key}": statistics.median(times[key]) for what, times in
           (("predict_ms", pred_times), ("train_step_ms", step_times)) for key in pairs}
    for key in pairs:
        print(f"  {key}: predict median {med['predict_ms_' + key]:.3f} ms "
              f"({[round(x, 3) for x in pred_times[key]]}), "
              f"{batch * n_fut / med['predict_ms_' + key] * 1e3:.1f} frames/s; train step "
              f"median {med['train_step_ms_' + key]:.3f} ms "
              f"({[round(x, 3) for x in step_times[key]]}), "
              f"{batch * n_fut / med['train_step_ms_' + key] * 1e3:.1f} training frames/s")
    del pairs, state, state0, tr, tr0, enc, dec, predict, predict0
    gc.collect()
    torch.cuda.empty_cache()

    rows = []
    for key, replaces, launches in (
            ("fwd", "vptr_tpu/ops/attention_core.py:188", pred_routes["long"]),
            ("bwd", "vptr_tpu/ops/attention_core.py:317", step_routes["backward"]["long"])):
        rows.append({"name": "attention_core_long" if key == "fwd" else "attention_core_bwd_long",
                     "route": "cuda", "source": "vptr_tpu_torch/csrc/attention_core.cu",
                     "replaces": replaces, "launches": launches,
                     "max_abs_err": errs[(key, 0.0 if key == "fwd" else rate)],
                     **readings[key], "kernel_route": "long",
                     "shape": [windows, heads, tq, tq, hd],
                     "train_step_launches": step_routes["forward" if key == "fwd"
                                                        else "backward"]["long"],
                     "sdpa_backends": takes, "sdpa_dispatch": picked})
    summary = (f"tslma_predict_ms {med['predict_ms_tslma']:.3f} full_enc_dec_predict_ms "
               f"{med['predict_ms_full']:.3f} tslma_train_step_ms "
               f"{med['train_step_ms_tslma']:.3f} full_enc_dec_train_step_ms "
               f"{med['train_step_ms_full']:.3f} tslma_train_frames_per_s "
               f"{batch * n_fut / med['train_step_ms_tslma'] * 1e3:.1f}")
    extra = {"tslma_predict_launches": pred_launches, "tslma_predict_routes": pred_routes,
             "tslma_step_launches": step_launches, "tslma_step_routes": step_routes,
             "tslma_cli_predict_routes": cli_routes,
             "attention_core_long_errs": {f"{k[0]} dropout {k[1]}": v for k, v in errs.items()}}
    return rows, extra, summary


# ---------------------------------------------------------------- data parallel

DP_PRESET = "far_bair_dp"
DP_STEP_BATCH = 16            # phase 34's global batch
DP_CLI_STEPS = 2              # phase 35's cli train steps
AE_BAIR_STEPS = 1             # phase 35's ae_bair checkpoint


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_ranks(job: str, world: int, backend: str, out_dir, one_card: bool,
                 timeout: float = 600):
    """``world`` processes of ``python3 chip_smoke.py --dp-worker <job>``
    (this file), each told its rank as torchrun would tell it; on
    ``one_card`` every rank's LOCAL_RANK is card 0. Waits for all (killing
    any left at the time limit) and returns [(exit code, output tail,
    result dict or None)] by rank."""
    import os
    from pathlib import Path

    root = str(Path(__file__).resolve().parent)
    for r in range(world):       # no result of an earlier launch is read as this one's
        (out_dir / f"{job}.rank{r}.json").unlink(missing_ok=True)
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()),
           "WORLD_SIZE": str(world),
           "PYTHONPATH": os.pathsep.join([root] + ([os.environ["PYTHONPATH"]]
                                                   if os.environ.get("PYTHONPATH") else []))}
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--dp-worker", job, backend,
         str(out_dir)], env={**env, "RANK": str(r), "LOCAL_RANK": "0" if one_card else str(r)},
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=timeout)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0] + "\n[killed at the time limit]")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        path = out_dir / f"{job}.rank{r}.json"
        results.append((p.returncode, out[-3000:],
                        json.loads(path.read_text()) if path.is_file() else None))
    return results


def _ranks_ok(results, what) -> bool:
    ok = all(rc == 0 and res is not None for rc, _, res in results)
    check(ok, f"{what}: every rank exited 0 with a result")
    if not ok:
        for r, (rc, out, _) in enumerate(results):
            print(f"  rank {r} exit {rc}:\n{out}")
    return ok


def _worker_allreduce(out_dir):
    """Phase 32 on each rank: an NCCL all-reduce of the FAR transformer's
    gradient bytes (f32), the sum checked; timed with CUDA events at W > 1
    only (at W = 1 NCCL moves nothing, so there is no time to read)."""
    import torch.distributed as dist

    from vptr_tpu_torch.parallel import host_id, num_hosts

    n = json.loads((out_dir / "args.json").read_text())["n_params"]
    w, r = num_hosts(), host_id()
    buf = torch.full((n,), float(r + 1), device="cuda")
    dist.all_reduce(buf)
    torch.cuda.synchronize()
    want = w * (w + 1) / 2
    correct = bool((buf == want).all())
    ms = cuda_ms(lambda: dist.all_reduce(buf), iters=10, warmup=3) if w > 1 else None
    return {"backend": dist.get_backend(), "world": w, "n": n, "sum_correct": correct,
            "ms": ms, "card": torch.cuda.get_device_name()}


# A key projection's bias has a zero gradient in exact arithmetic: it adds
# q·b to every logit of a query's row, which the softmax does not see. What
# either run computes there is rounding noise, so the leaf-by-leaf check
# leaves these leaves out (the whole-vector check keeps them).
ZERO_GRAD_LEAF = "k_proj.bias"


def _against_one_rank(named, ref, lr):
    """Rank 0's step against the one-rank step at the same global batch
    (``ref``: its parameters and gradients by name): the averaged gradients
    as one vector and leaf by leaf, |g_W - g_1| / |g_1|; the parameters,
    the largest gap anywhere, and where |g_1| > 2 |g_W - g_1| (there the two
    gradients have one sign, so two first AdamW steps, lr·g / (|g| + eps),
    are less than 0.18 lr apart)."""
    rels, p_err, p_err_firm, firm_leaf = {}, 0.0, 0.0, ""
    d2 = n2 = 0.0
    for name, p in named.items():
        g1 = ref["grads"][name].to(p.device)
        diff = p.grad.float() - g1
        dn, gn = float(diff.square().sum()), float(g1.square().sum())
        d2, n2 = d2 + dn, n2 + gn
        gap = (p.detach().float() - ref["params"][name].to(p.device)).abs()
        p_err = max(p_err, float(gap.max()))
        firm = g1.abs() > 2 * diff.abs()
        if bool(firm.any()) and float(gap[firm].max()) > p_err_firm:
            p_err_firm, firm_leaf = float(gap[firm].max()), name
        if not name.endswith(ZERO_GRAD_LEAF):
            rels[name] = (dn / gn) ** 0.5 if gn > 0 else (0.0 if dn == 0 else float("inf"))
    worst = sorted(rels, key=rels.get, reverse=True)[:3]
    return {"grad_rel_err": rels[worst[0]], "grad_worst_leaves": {n: rels[n] for n in worst},
            "grad_vector_rel_err": (d2 / n2) ** 0.5, "lr": lr,
            "max_abs_err_vs_one_rank": p_err, "firm_param_err": p_err_firm,
            "firm_param_leaf": firm_leaf}


def _worker_step(out_dir):
    """Phase 34 on each rank: far_bair_dp's Trainer at the global batch
    DP_STEP_BATCH, one train step on the rank's rows of the saved batch
    with every launch counter at 0 just before it, its parameters against
    rank 0's (broadcast) and, on rank 0, its averaged gradients and
    parameters against the one-rank step's; then the step's and the
    gradient all-reduce's times."""
    import torch.distributed as dist

    from vptr_tpu_torch.config import get_preset
    from vptr_tpu_torch.parallel import all_reduce_grads, host_id, num_hosts
    from vptr_tpu_torch.train.trainer import Trainer

    args = json.loads((out_dir / "args.json").read_text())
    cfg = get_preset(DP_PRESET).override({"data": {"batch_size": args["batch"]}})
    tr = Trainer(cfg, write_outputs=False)
    state = tr.init_state()
    batch = torch.load(out_dir / "batch.pt")
    w, r = num_hosts(), host_id()
    rows = slice(r * args["batch"] // w, (r + 1) * args["batch"] // w)
    past, future = tr.put_batch(batch["past"][rows].numpy(), batch["future"][rows].numpy())
    zero_counters()
    state, m = tr.train_step(state, past, future)
    torch.cuda.synchronize()
    launches = launch_counts("fused_attention_ln", "attention_core",
                             "fused_attention_ln_bwd", "attention_core_bwd")
    named = dict(state.transformer.named_parameters())
    flat = torch.cat([p.detach().float().reshape(-1) for p in named.values()])
    theirs = flat.clone()
    dist.broadcast(theirs, src=0)
    same = torch.tensor([float(torch.equal(flat, theirs))], device=flat.device)
    dist.all_reduce(same, op=dist.ReduceOp.MIN)
    out = {"backend": dist.get_backend(), "world": w, "local_rows": past.shape[0],
           "metrics": {k: float(v) for k, v in m.items()}, "launches": launches,
           "bit_equal_across_ranks": bool(same.item() == 1.0)}
    del flat, theirs
    if r == 0:
        out.update(_against_one_rank(named, torch.load(out_dir / "ref.pt"), cfg.optim.lr))
    for _ in range(WARMUP_STEPS):
        state, _ = tr.train_step(state, past, future)
    step_ms = statistics.median(
        [host_ms(lambda: tr.train_step(state, past, future)) for _ in range(TIMED_STEPS)])
    params = state.params()
    ar_ms = statistics.median([host_ms(lambda: all_reduce_grads(params))
                               for _ in range(TIMED_STEPS)])
    out.update(step_ms=step_ms, all_reduce_ms=ar_ms,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    return out


def dp_worker(argv) -> int:
    """``python3 chip_smoke.py --dp-worker <job> <backend> <dir>``: one rank
    of phase 32 or 34, launched by :func:`launch_ranks`; writes
    ``<dir>/<job>.rank<r>.json``."""
    from pathlib import Path

    from vptr_tpu_torch.parallel import destroy_distributed, host_id, init_distributed

    job, backend, out_dir = argv[0], argv[1], Path(argv[2])
    if not init_distributed("cuda", backend=backend):
        print("dp worker: no process group in the environment", file=sys.stderr)
        return 1
    try:
        result = {"allreduce": _worker_allreduce, "step": _worker_step,
                  "tp_step": _worker_tp_step}[job](out_dir)
        (out_dir / f"{job}.rank{host_id()}.json").write_text(json.dumps(result))
    finally:
        destroy_distributed()
    return 0


def dp_phases(dev, card):
    """Phases 32-35: data parallelism (vptr_tpu_torch.parallel) and
    far_bair_dp at full width. Returns (the summary line, extra readings,
    far_bair_dp's launches of #1-#4 in one train step)."""
    import os
    import shutil
    import tempfile
    from contextlib import closing
    from pathlib import Path

    from vptr_tpu_torch.config import get_preset
    from vptr_tpu_torch.data.loader import build_loader
    from vptr_tpu_torch.models import layers
    from vptr_tpu_torch.models.transformer import build_transformer
    from vptr_tpu_torch.train.trainer import Trainer

    cards = torch.cuda.device_count()
    cfg = get_preset(DP_PRESET)
    tc, dc = cfg.transformer, cfg.data
    extra = {"cards": cards, "card": card}
    root = Path(tempfile.mkdtemp(prefix="vptr_smoke_dp_"))
    try:
        phase(f"32. NCCL at W = {cards} (the machine's cards): an all-reduce of the "
              f"{DP_PRESET} transformer's gradient bytes")
        n_params = sum(p.numel() for p in build_transformer(tc, torch.bfloat16, "cpu")
                       .parameters())
        (root / "args.json").write_text(json.dumps({"n_params": n_params}))
        res = launch_ranks("allreduce", cards, "nccl", root, one_card=False)
        if _ranks_ok(res, f"NCCL all-reduce at W = {cards}"):
            a = res[0][2]
            nbytes = 4 * n_params
            check(all(x[2]["sum_correct"] for x in res),
                  f"all-reduce of {n_params} f32 values sums the {cards} ranks")
            check(a["backend"] == "nccl", f"backend {a['backend']} == nccl")
            extra.update(allreduce_params=n_params)
            if cards == 1:
                print(f"  {card}: NCCL up at W = 1, {n_params} f32 parameters "
                      f"({nbytes / 2 ** 20:.1f} MiB) summed right; no time or bandwidth "
                      f"measured (NCCL moves nothing at W = 1)")
            else:
                alg = nbytes / a["ms"] / 1e6                  # GB/s
                bus = alg * 2 * (cards - 1) / cards
                print(f"  {card}: {n_params} f32 parameters ({nbytes / 2 ** 20:.1f} MiB), "
                      f"all-reduce {a['ms']:.3f} ms at W = {cards}: algorithm bandwidth "
                      f"{alg:.1f} GB/s, bus bandwidth {bus:.1f} GB/s (2 (W-1)/W of it)")
                extra.update(allreduce_ms=a["ms"], allreduce_algbw_gbs=alg,
                             allreduce_busbw_gbs=bus)

        phase(f"33. {DP_PRESET} at full width (d_model {tc.d_model}, "
              f"{tc.num_encoder_layers} layers, {tc.n_heads} heads, {cfg.dtype}) on the "
              f"synthetic BAIR-shaped loader: the one-rank train step")
        loader = build_loader(dc, split="train", seed=cfg.seed)
        with closing(iter(loader)) as it:
            past_np, future_np = next(it)
        t_tf = dc.num_past_frames + dc.num_future_frames - 1
        want = {k: tc.num_encoder_layers for k in (
            "fused_attention_ln", "attention_core", "fused_attention_ln_bwd",
            "attention_core_bwd")}
        launches, batch = None, dc.batch_size
        while batch >= 8:
            trainer = state = None
            try:
                trainer = Trainer(cfg.override({"data": {"batch_size": batch}}),
                                  write_outputs=False)
                state = trainer.init_state()
                past, future = trainer.put_batch(past_np[:batch], future_np[:batch])
                torch.cuda.reset_peak_memory_stats()
                state, launches = counted_step(trainer.train_step, state, past, future,
                                               want, f"{DP_PRESET} train step")
                for _ in range(WARMUP_STEPS):
                    state, _ = trainer.train_step(state, past, future)
                times = [host_ms(lambda: trainer.train_step(state, past, future))
                         for _ in range(TIMED_STEPS)]
                break
            except torch.cuda.OutOfMemoryError:
                print(f"  batch {batch} does not fit one card: "
                      f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB allocated "
                      f"at the peak; halving it")
                del trainer, state
                gc.collect()
                torch.cuda.empty_cache()
                batch //= 2
        check(launches is not None, f"{DP_PRESET} train step fits one card at batch >= 8")
        if launches is None:
            return "", extra, None
        step_ms = statistics.median(times)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        frames = batch * t_tf
        print(f"  {card}: batch {batch} (the preset's {dc.batch_size}) x {t_tf} "
              f"teacher-forced frames of {dc.img_size}x{dc.img_size}x{dc.img_channels}: "
              f"median {step_ms:.3f} ms of {len(times)} ({[round(t, 3) for t in times]}), "
              f"{frames / step_ms * 1e3:.1f} training frames/s, peak {peak:.3f} GiB; "
              f"#1-#4 launches a step {launches}")
        extra.update(one_rank_batch=batch, one_rank_step_ms=step_ms,
                     one_rank_frames_per_s=frames / step_ms * 1e3, one_rank_peak_gib=peak)
        # the DropPath / Dropout masks of one step (drawn at the global
        # shape on every rank): their shapes, then those draws alone
        shapes = []
        draw = layers.bernoulli_keep

        def recording(shape, keep, generator, device, split=None):
            out = draw(shape, keep, generator, device, split)
            shapes.append((tuple(out.shape), keep))
            return out
        layers.bernoulli_keep = recording
        try:
            trainer.train_step(state, past, future)
        finally:
            layers.bernoulli_keep = draw
        gen = torch.Generator(device=dev).manual_seed(SEED)
        mask_ms = cuda_ms(lambda: [torch.rand(sh, generator=gen, device=dev) < keep
                                   for sh, keep in shapes], iters=3, warmup=1)
        n_drawn = sum(int(np.prod(sh)) for sh, _ in shapes)
        print(f"  the step's torch.rand masks: {len(shapes)} draws, {n_drawn} elements at "
              f"the global batch, {mask_ms:.3f} ms alone ({mask_ms / step_ms:.1%} of the "
              f"step); under W ranks every rank draws them all (its own rows: 1/W)")
        extra.update(mask_draws=len(shapes), mask_elements=n_drawn, mask_ms=mask_ms)
        del trainer, state, past, future
        gc.collect()
        torch.cuda.empty_cache()

        def ranks_step(world, batch, two_cards):
            """One far_bair_dp step at global batch ``batch`` on ``world``
            ranks against the one-rank step at ``batch``, then the ranks'
            step and all-reduce times; returns rank 0's result or None."""
            backend = "nccl" if two_cards else "gloo"
            label = (f"{world} cards over NCCL" if two_cards else
                     f"{world} processes on the one card over gloo (the all-reduce "
                     f"staged through the host)")
            one = Trainer(cfg.override({"data": {"batch_size": batch}}), write_outputs=False)
            s1 = one.init_state()
            s1, m1 = one.train_step(s1, *one.put_batch(past_np[:batch], future_np[:batch]))
            named = list(s1.transformer.named_parameters())
            torch.save({"params": {n: p.detach().float().cpu() for n, p in named},
                        "grads": {n: p.grad.detach().float().cpu() for n, p in named}},
                       root / "ref.pt")
            one_total, one_norm = float(m1["T_total"]), float(m1["grad_norm"])
            del one, s1, m1, named
            gc.collect()
            torch.cuda.empty_cache()
            torch.save({"past": torch.from_numpy(past_np[:batch]),
                        "future": torch.from_numpy(future_np[:batch])}, root / "batch.pt")
            (root / "args.json").write_text(json.dumps({"batch": batch}))
            res = launch_ranks("step", world, backend, root, one_card=not two_cards)
            if not _ranks_ok(res, f"{world}-rank {DP_PRESET} step ({label})"):
                return None
            r0 = res[0][2]
            err, lr = r0["max_abs_err_vs_one_rank"], r0["lr"]
            d_total = abs(r0["metrics"]["T_total"] - one_total)
            d_norm = abs(r0["metrics"]["grad_norm"] / one_norm - 1)
            for x in res:
                check_counts(x[2]["launches"], want, f"a rank's step of the {world}-rank run")
            check(r0["backend"] == backend and r0["world"] == world
                  and r0["local_rows"] == batch // world,
                  f"backend {r0['backend']}, world {r0['world']}, {r0['local_rows']} rows "
                  f"a rank")
            check(all(x[2]["bit_equal_across_ranks"] for x in res),
                  f"parameters bit-equal across the {world} ranks after the step")
            check(r0["grad_vector_rel_err"] <= 2 ** -5,
                  f"averaged gradients against the one-rank step's as one vector: "
                  f"|g_W - g_1| / |g_1| {r0['grad_vector_rel_err']:.3e} <= 2^-5")
            # bf16 weight gradients of the attention's q / k leaves cancel
            # over the batch; a leaf left unaveraged reads 0.5 or more
            check(r0["grad_rel_err"] <= 2 ** -2,
                  f"averaged gradients against the one-rank step's, leaf by leaf but the "
                  f"{ZERO_GRAD_LEAF} leaves: |g_W - g_1| / |g_1| "
                  f"{r0['grad_rel_err']:.3e} <= 2^-2 (the worst "
                  f"{ {n: f'{v:.3e}' for n, v in r0['grad_worst_leaves'].items()} })")
            check(d_norm <= 0.05, f"grad_norm {r0['metrics']['grad_norm']:.6e} against the "
                  f"one-rank {one_norm:.6e}: rel diff {d_norm:.3e} <= 0.05")
            check(r0["firm_param_err"] <= lr / 4,
                  f"parameters against the one-rank step where |g_1| > 2 |g_W - g_1|: "
                  f"max|err| {r0['firm_param_err']:.3e} <= lr/4 = {lr / 4:.3e} "
                  f"({r0['firm_param_leaf']})")
            check(err <= 2 * lr + 1e-6,
                  f"parameters against the one-rank step anywhere: max|err| {err:.3e} <= "
                  f"2 lr (two first AdamW steps of opposite sign)")
            check(d_total <= 2e-3 * max(1.0, one_total),
                  f"T_total {r0['metrics']['T_total']:.6f} against the one-rank "
                  f"{one_total:.6f}: |d| {d_total:.3e}")
            share = r0["all_reduce_ms"] / r0["step_ms"]
            print(f"  {card}: {world}-rank step at global batch {batch} median "
                  f"{r0['step_ms']:.3f} ms (the slowest rank "
                  f"{max(x[2]['step_ms'] for x in res):.3f}), {batch // world} rows a rank, "
                  f"{batch * t_tf / r0['step_ms'] * 1e3:.1f} training frames/s; the gradient "
                  f"all-reduce alone {r0['all_reduce_ms']:.3f} ms = {share:.1%} of the step "
                  f"({label}); peak {r0['peak_gib']:.3f} GiB a rank")
            return {"backend": backend, "step_ms": r0["step_ms"],
                    "all_reduce_ms": r0["all_reduce_ms"], "all_reduce_share": share,
                    "param_err": err, "firm_param_err": r0["firm_param_err"],
                    "grad_rel_err": r0["grad_rel_err"],
                    "grad_vector_rel_err": r0["grad_vector_rel_err"],
                    "grad_norm_rel_diff": d_norm,
                    "launches": r0["launches"]}

        two_cards = cards >= 2
        how = ("two cards over NCCL" if two_cards else
               "two processes on the one card over gloo")
        more = f"; then {cards} ranks at the preset's batch {dc.batch_size}"
        phase(f"34. two ranks ({how}): one {DP_PRESET} step at global batch "
              f"{DP_STEP_BATCH} against the one-rank step at {DP_STEP_BATCH}"
              + (more if cards > 2 else ""))
        two = ranks_step(2, DP_STEP_BATCH, two_cards)
        if two:
            extra.update({f"two_rank_{k}": v for k, v in two.items()})
        if cards > 2:
            every = ranks_step(cards, dc.batch_size, True)
            if every:
                extra.update({f"{cards}_rank_{k}": v for k, v in every.items()})

        phase(f"35. torchrun --nproc_per_node={cards} -m vptr_tpu_torch.cli train --preset "
              f"{DP_PRESET} ({DP_CLI_STEPS} steps and a validation pass) on a "
              f"{AE_BAIR_STEPS}-step ae_bair checkpoint, then cli eval")
        here = str(Path(__file__).resolve().parent)
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            [here] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else []))}
        cli = [sys.executable, "-m", "vptr_tpu_torch.cli"]
        run = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc_per_node={cards}", "-m", "vptr_tpu_torch.cli"]
        ae_dir, far_dir = root / "ae", root / "far"

        def command(args, what, timeout=600):
            t0 = time.perf_counter()
            p = subprocess.run(args, cwd=here, env=env, capture_output=True, text=True,
                               timeout=timeout)
            wall = time.perf_counter() - t0
            check(p.returncode == 0, f"{what}: exit {p.returncode} ({wall:.1f} s)")
            if p.returncode != 0:
                print((p.stdout + p.stderr)[-3000:])
            return p, wall

        command(cli + ["train", "--preset", "ae_bair", "--ckpt-dir", str(ae_dir), "--set",
                       "epochs=1", "--set", f"steps_per_epoch={AE_BAIR_STEPS}", "--set",
                       "val_per_epochs=2"], f"cli train --preset ae_bair ({AE_BAIR_STEPS} "
                f"steps)")
        _, far_wall = command(run + [
            "train", "--preset", DP_PRESET, "--ckpt-dir", str(far_dir), "--set",
            f"ae_ckpt={ae_dir / 'ckpt'}", "--set", "epochs=1", "--set",
            f"steps_per_epoch={DP_CLI_STEPS}", "--set", "val_per_epochs=1"],
            f"torchrun {cards} x cli train --preset {DP_PRESET}")
        files = sorted(str(p.relative_to(far_dir)) for p in far_dir.rglob("*") if p.is_file())
        print(f"  the run directory holds {files}")
        check((far_dir / "ckpt" / str(DP_CLI_STEPS) / "state.pt").is_file()
              and (far_dir / "train_log.log").is_file()
              and (far_dir / "tb" / "scalars.jsonl").is_file(),
              f"rank 0 wrote ckpt/{DP_CLI_STEPS}/, train_log.log and tb/scalars.jsonl")
        if (far_dir / "ckpt" / "history.json").is_file():
            fh = _history(far_dir)
            print(f"  train {fh['train']}\n  val {fh['val']}")
            check(_finite(fh["train"].values()) and _finite(fh["val"].values())
                  and "T_total" in fh["val"], f"{DP_PRESET} cli train: losses finite")
            extra.update(cli_train_steps_per_s=fh["train"]["steps_per_sec"],
                         cli_train_wall_s=far_wall)
        # the test split is 2 -> 28 frames: the autoregressive rollout, 10 of them
        ev, _ = command(run + ["eval", "--preset", DP_PRESET, "--ckpt-dir", str(far_dir),
                               "--mode", "far_rip", "--num-pred", "10", "--max-batches",
                               "1", "--no-lpips"],
                        f"torchrun {cards} x cli eval --preset {DP_PRESET} --mode far_rip")
        try:
            curves = json.loads(ev.stdout[ev.stdout.index("{"):ev.stdout.rindex("}") + 1])
            check(_finite(curves["mean"].values()), f"cli eval curves finite: "
                  f"{curves['mean']}")
        except ValueError:
            check(False, f"cli eval printed its curves: {ev.stdout[-500:]}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    summary = " ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                       for k, v in extra.items())
    return summary, extra, launches


# ----------------------------------------------------------------------------
# phases 36-40: the upstream .tar loader, transformer.remat, scan_layers

def _upstream():
    """tests/_torch_port_upstream.py beside this file (the reference modules
    re-derived in torch and the save_ckpt envelope; torch and numpy only),
    loaded by its path: another package named ``tests`` may be installed."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent / "tests" / "_torch_port_upstream.py"
    spec = importlib.util.spec_from_file_location("_torch_port_upstream", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _leaf_diffs(a, b):
    """{name: |a - b|_2 over |a|_2} for two {name: tensor} of one shape
    each."""
    return {n: (a[n].float() - b[n].float()).norm().item()
            / max(a[n].float().norm().item(), 1e-30) for n in a}


def grads_against_floor(what, ref, again, got):
    """Each gradient leaf of ``got`` against ``ref`` ({name: tensor}) by its
    relative L2 distance, beside the floor the same step run twice gives
    (``again`` against ``ref``): the card's backward is not bit-
    reproducible (reductions whose order varies from run to run), and a
    leaf whose exact gradient is 0 -- a key projection's bias, which the
    softmax cancels; a bias that a BatchNorm removes -- holds only that
    noise (distance ~1 from run to run). A leaf passes within 2^-8 or 4x
    its floor; a step that drew other masks or recomputed other values
    moves the leaves with real gradients by far more than either. Returns
    (bit-equal, the remat-off step reproducible bit for bit, the worst
    leaf by its margin over the allowance, its distance, its floor)."""
    diff, floor = _leaf_diffs(ref, got), _leaf_diffs(ref, again)
    margin = {n: diff[n] / max(2 ** -8, 4 * floor[n]) for n in diff}
    worst = max(margin, key=margin.get)
    check(margin[worst] <= 1.0, f"{what}: every leaf within 2^-8 (relative L2) or 4x the "
          f"same step's run-to-run floor (the worst {worst}: {diff[worst]:.3e}, floor "
          f"{floor[worst]:.3e})")
    return (all(torch.equal(ref[n], got[n]) for n in ref),
            all(torch.equal(ref[n], again[n]) for n in ref), worst, diff[worst], floor[worst])


def params_on_firm_gradients(what, start, ref, got, g_ref, g_again, clip_scale):
    """Each parameter leaf after the step, ``got`` against ``ref``, where the
    gradient is firm: AdamW's first step moves an element by lr g / (|g| +
    eps), about lr times the sign of g, so where the gradient is run-to-run
    noise the two steps may move it 2 lr apart, and where |g| is near eps
    the move follows |g| itself (g after the clip: ``clip_scale`` times the
    raw gradient). Leaves whose gradient is noise as a whole (their L2
    floor above 2^-4) are left out; in the others an element counts where
    its gradient is above 2^-6 of its leaf's largest, its clipped gradient
    above 64 eps, and its gradient above 8x its own run-to-run difference.
    Held at a sixteenth of the leaf's largest move; returns the worst
    (leaf, error over that move, elements compared)."""
    floor = _leaf_diffs(g_ref, g_again)
    worst, worst_rel, n_firm = None, 0.0, 0
    for n, p in ref.items():
        g, d = g_ref[n].float().abs(), (g_ref[n].float() - g_again[n].float()).abs()
        firm = (g > 2 ** -6 * g.max()) & (clip_scale * g > 64 * ADAM_EPS) & (g > 8 * d)
        step = (p.float() - start[n].float()).abs().max().item()
        if floor[n] > 2 ** -4 or not bool(firm.any()) or step == 0.0:
            continue
        n_firm += int(firm.sum())
        rel = (got[n].float() - p.float()).abs()[firm].max().item() / step
        if rel >= worst_rel:
            worst, worst_rel = n, rel
    check(n_firm > 0 and worst_rel <= 2 ** -4, f"{what}: the parameters where the "
          f"gradient is firm ({n_firm} elements) within 1/16 of their leaf's largest move "
          f"(the worst {worst}: {worst_rel:.3e})")
    return worst, worst_rel, n_firm


def upstream_phases(dev):
    """Phase 36: reference-format epoch_N.tar files of far_mnist's and
    nar_mnist's geometry loaded into port states on the card. Returns
    (extra readings, far_rip launches)."""
    import shutil
    import tempfile
    from pathlib import Path

    from vptr_tpu_torch.config import get_preset
    from vptr_tpu_torch.eval.harness import make_predict_fn
    from vptr_tpu_torch.models.autoencoder import build_autoencoder
    from vptr_tpu_torch.models.position import position_embedding_1d, position_embedding_2d
    from vptr_tpu_torch.models.transformer import build_transformer
    from vptr_tpu_torch.train.optim import build_optimizer
    from vptr_tpu_torch.train.state import create_far_train_state
    from vptr_tpu_torch.utils import torch_import

    up = _upstream()
    far_cfg, nar_cfg = get_preset("far_mnist"), get_preset("nar_mnist")
    ae, ftc, ntc = far_cfg.ae, far_cfg.transformer, nar_cfg.transformer
    c, heads, win = ftc.d_model, ftc.n_heads, ftc.window_size
    extra = {}

    def seeded(cls, seed, *args, **kw):
        torch.manual_seed(seed)
        m = cls(*args, **kw).eval()
        up.randomize_bn(m, torch.Generator().manual_seed(seed))
        return m

    phase(f"36. upstream epoch_N.tar at full width: the reference's far_mnist (AE ngf "
          f"{ae.ngf} / feat {ae.feat_dim} / {ae.n_res_blocks} res blocks, FAR "
          f"{ftc.num_encoder_layers} layers at {c} / {heads} heads) and nar_mnist (NAR "
          f"{ntc.num_encoder_layers} + {ntc.num_decoder_layers}, RPE) modules, loaded "
          f"through import_reference_checkpoint + state_with_reference_weights")
    tenc = seeded(up.TorchVPTREnc, SEED + 200, ae.img_channels, ae.ngf, ae.feat_dim,
                  ae.n_downsampling, ae.n_res_blocks)
    tdec = seeded(up.TorchVPTRDec, SEED + 201, ae.img_channels, ae.ngf, ae.feat_dim,
                  ae.n_downsampling)
    tfar = seeded(up.TorchFAR, SEED + 202, ftc.num_encoder_layers, c, heads, win,
                  ftc.enc_h, ftc.enc_w)
    tnar = seeded(up.TorchNAR, SEED + 203, ntc.num_encoder_layers, ntc.num_decoder_layers,
                  c, heads, win, ntc.enc_h, ntc.enc_w, ntc.num_future_frames)
    root = Path(tempfile.mkdtemp(prefix="vptr_smoke_tar_"))
    try:
        t0 = time.perf_counter()
        up.write_reference_tar(root / "epoch_40.tar", {"VPTR_Enc": tenc, "VPTR_Dec": tdec,
                                                       "VPTR_Transformer": tfar}, epoch=40)
        up.write_reference_tar(root / "epoch_50.tar", {"VPTR_Transformer": tnar}, epoch=50)
        t1 = time.perf_counter()
        far_conv = torch_import.import_reference_checkpoint(str(root / "epoch_40.tar"))
        nar_conv = torch_import.import_reference_checkpoint(str(root / "epoch_50.tar"))
        t2 = time.perf_counter()
        sizes = {p.name: p.stat().st_size for p in root.iterdir()}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"  files {sizes} bytes (module. prefixes, an unimportable Loss_tuple, an Adam "
          f"state, the code bytes): written in {t1 - t0:.2f} s, read and converted in "
          f"{t2 - t1:.2f} s")
    check(set(far_conv) == {"VPTR_Enc", "VPTR_Dec", "VPTR_Transformer"}
          and set(nar_conv) == {"VPTR_Transformer"},
          f"modules recognised: {sorted(far_conv)}, {sorted(nar_conv)}")
    extra.update(tar_bytes=sizes, tar_read_s=t2 - t1)

    frames = torch.rand(BATCH, PAST + FUTURE, 64, 64, 1,
                        generator=torch.Generator().manual_seed(SEED + 204)).to(dev)
    past, future = frames[:, :PAST], frames[:, PAST:]
    nb = nar_cfg.data.batch_size
    nar_past = torch.rand(nb, ntc.num_past_frames, 64, 64, 1,
                          generator=torch.Generator().manual_seed(SEED + 205)).to(dev)
    lw = position_embedding_2d(win, win, c).to(dev)
    tpos = position_embedding_1d(ftc.num_past_frames + ftc.num_future_frames, c).to(dev)

    # the re-derivations' f32 forwards on the card (TF32 off)
    with torch.inference_mode():
        for m in (tenc, tdec, tfar, tnar):
            m.to(dev)
        x = torch.cat([past, future[:, :-1]], dim=1)
        far_lat = tfar(up.encode_clips(tenc, x), lw, tpos[:x.shape[1]])
        want_far = up.decode_clips(tdec, far_lat)[:, -FUTURE:]
        nar_lat = tnar(up.encode_clips(tenc, nar_past), lw, tpos)
        want_nar = up.decode_clips(tdec, nar_lat)
        for m in (tenc, tdec, tfar, tnar):
            m.cpu()
    torch.cuda.empty_cache()

    def loaded(cfg, conv, dtype):
        enc, dec = build_autoencoder(cfg.ae, dtype, dev, torch.Generator().manual_seed(SEED))
        tr = build_transformer(cfg.transformer, dtype, dev,
                               torch.Generator().manual_seed(SEED + 1))
        state = create_far_train_state(enc, dec, tr, build_optimizer(cfg.optim, c),
                                       seed=SEED + 3)
        new = torch_import.state_with_reference_weights(state, conv)
        check(all(next(getattr(new, f).parameters()).device.type == "cuda"
                  for f in ("enc", "dec", "transformer")),
              f"{cfg.transformer.variant} state {dtype}: the loaded modules are on the card")
        return new

    def latents(s, frames, want, what, dtype):
        """The loaded transformer's output on the loaded encoder's latents
        against the re-derivation's: max |err| over max(1, max |want|);
        held in f32 (2e-3, the CPU parity tests' bound at this depth),
        printed in bf16."""
        with torch.inference_mode():
            e = rel_err(s.transformer.eval()(s.enc.eval()(frames)), want)
        if dtype == torch.float32:
            check(e <= 2e-3, f"{what} from the .tar, the transformer's latents, port f32 vs "
                  f"the re-derivation's: rel err {e:.3e} <= 2e-3")
        else:
            print(f"  {what} from the .tar, the transformer's latents, port bf16 vs the "
                  f"re-derivation's f32: rel err {e:.3e}")
        return e

    both = {"VPTR_Enc": far_conv["VPTR_Enc"], "VPTR_Dec": far_conv["VPTR_Dec"], **nar_conv}
    # frames: f32 as the latents; bf16 as phase 3's bf16 kernels (2^-4)
    tol = {torch.float32: 2e-3, torch.bfloat16: 2 ** -4}
    far_launches = None
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        s = loaded(far_cfg, far_conv, dtype)
        far = make_predict_fn(far_cfg, s.enc, s.dec, s.transformer, "far", FUTURE, dev)
        e = max_err(far(past, future), want_far)
        check(e <= tol[dtype], f"far_mnist from the .tar, teacher-forced 'far' frames, port "
              f"{name} vs the re-derivation's f32 forward: max|err| {e:.3e} <= {tol[dtype]}")
        extra[f"far_{name}_max_abs_err"] = e
        extra[f"far_{name}_latent_rel_err"] = latents(s, x, far_lat, "far_mnist", dtype)
        if dtype == torch.bfloat16:
            rip = make_predict_fn(far_cfg, s.enc, s.dec, s.transformer, "far_rip", FUTURE,
                                  dev)
            want = LAYERS * FUTURE
            _, far_launches = counted_predict(
                rip, (past,), {"fused_attention_ln": want, "attention_core": want},
                (BATCH, FUTURE, 64, 64, 1), "far_rip from the .tar")
        del s, far
        torch.cuda.empty_cache()
        s = loaded(nar_cfg, both, dtype)
        nar = make_predict_fn(nar_cfg, s.enc, s.dec, s.transformer, "nar",
                              ntc.num_future_frames, dev)
        enc_l, dec_l = ntc.num_encoder_layers, ntc.num_decoder_layers
        got, _ = counted_predict(nar, (nar_past,), {
            "fused_attention_ln": enc_l, "fused_attention": dec_l,
            "attention_core": enc_l + 2 * dec_l}, (nb, ntc.num_future_frames, 64, 64, 1),
            f"nar predict from the .tar ({name})")
        e = max_err(got, want_nar)
        check(e <= tol[dtype], f"nar_mnist from the .tar, nar frames, port {name} vs the "
              f"re-derivation's f32 forward: max|err| {e:.3e} <= {tol[dtype]}")
        extra[f"nar_{name}_max_abs_err"] = e
        extra[f"nar_{name}_latent_rel_err"] = latents(s, nar_past, nar_lat, "nar_mnist", dtype)
        del s, nar, got
        torch.cuda.empty_cache()
    return extra, far_launches


def remat_pair(dev, preset, flags, label, want_fwd, want_bwd):
    """Two train steps at full width from one seed, ``transformer.remat``
    off and on (the decoder checkpointed with it, as the Trainer sets it),
    on the route ``flags``: the metrics, every gradient, the parameters
    after the step, the generator's state and the BatchNorm statistics
    compared (bit-equal expected; a leaf past 2^-8 of its largest fails);
    the launches around each step (forwards twice with remat, backwards
    once); then each step's ms (off, on, on, off) and memory peak above
    what the state holds. Returns the readings."""
    from vptr_tpu_torch.config import get_preset
    from vptr_tpu_torch.models.autoencoder import build_autoencoder
    from vptr_tpu_torch.models.transformer import build_transformer
    from vptr_tpu_torch.train.optim import build_optimizer
    from vptr_tpu_torch.train.state import create_far_train_state
    from vptr_tpu_torch.train.steps import make_far_train_step, make_nar_train_step

    cfg = get_preset(preset).override({"transformer": flags})
    tc = cfg.transformer
    nar = tc.variant == "nar"
    batch = cfg.data.batch_size if nar else BATCH
    frames = torch.rand(batch, tc.num_past_frames + tc.num_future_frames, 64, 64, 1,
                        generator=torch.Generator().manual_seed(SEED + 210)).to(dev)
    past, future = frames[:, :tc.num_past_frames], frames[:, tc.num_past_frames:]
    enc, dec = build_autoencoder(cfg.ae, torch.bfloat16, dev,
                                 torch.Generator().manual_seed(SEED))
    make = make_nar_train_step if nar else make_far_train_step
    runs = {}
    for remat in (False, True):
        rc = cfg.override({"transformer": {"remat": remat}})
        tr = build_transformer(rc.transformer, torch.bfloat16, dev,
                               torch.Generator().manual_seed(SEED + 1))
        opt = build_optimizer(rc.optim, tc.d_model)
        state = create_far_train_state(enc, dec, tr, opt, seed=SEED + 3)
        step = make(enc, dec, tr, opt, rc.loss, remat_decoder=remat)
        zero_counters()
        after, m = step(state.clone(), past, future)
        torch.cuda.synchronize()
        launches = launch_counts(*want_fwd, *want_bwd)
        want = {k: (2 * n if remat else n) for k, n in want_fwd.items()}
        check_counts(launches, {**want, **want_bwd},
                     f"one {label} step with remat {'on' if remat else 'off'}")
        runs[remat] = dict(state=state, step=step, launches=launches, after=after,
                           metrics={k: float(v) for k, v in m.items()})
    # the remat-off step once more from the same state: the card's floor
    again, _ = runs[False]["step"](runs[False]["state"].clone(), past, future)
    a, b = runs[False]["after"], runs[True]["after"]
    ma, mb = runs[False]["metrics"], runs[True]["metrics"]
    check(all(v == v and abs(v) != float("inf") for v in mb.values()),
          f"{label}: remat step metrics finite")
    check(abs(ma["T_total"] - mb["T_total"]) <= 2 ** -8 * max(1.0, abs(ma["T_total"])),
          f"{label}: T_total remat on {mb['T_total']!r} vs off {ma['T_total']!r} "
          f"(equal: {ma['T_total'] == mb['T_total']})")

    def tensors(st, grad):
        return {n: (p.grad if grad else p) for n, p in st.transformer.named_parameters()}
    equal, reproducible, *_ = grads_against_floor(
        f"{label}: remat on vs off, the gradients", tensors(a, True), tensors(again, True),
        tensors(b, True))
    clip = cfg.optim.max_grad_norm       # the optimizer's global-norm clip
    params_on_firm_gradients(f"{label}: remat on vs off",
                             tensors(runs[False]["state"], False), tensors(a, False),
                             tensors(b, False), tensors(a, True), tensors(again, True),
                             1.0 if clip is None else clip / max(ma["grad_norm"], clip))
    stats = {n: t for n, t in a.transformer.named_buffers()
             if n.endswith(("running_mean", "running_var"))}
    if nar:
        moved = {n: t for n, t in b.transformer.named_buffers() if n in stats}
        e = max(max_err(stats[n], moved[n]) / max(stats[n].abs().max().item(), 1e-30)
                for n in stats)
        check(len(stats) > 0 and e <= 2 ** -8, f"{label}: the {len(stats)} BatchNorm "
              f"statistics after the step, remat on vs off, within 2^-8 of each leaf's "
              f"largest (the forward is reproducible; {e:.3e})")
        equal = equal and e == 0.0
    gen_equal = torch.equal(a.generator.get_state(), b.generator.get_state())
    check(gen_equal, f"{label}: the generator's state after the step equal with remat on "
          f"and off")
    bit_equal = ma == mb and gen_equal and equal
    worst_grad = max(_leaf_diffs(tensors(a, True), tensors(b, True)).values())
    del again

    # times (off, on, on, off) and each step's peak above what is held
    timing = {False: [], True: [], "peak": {}}
    for remat in (False, True, True, False):
        r = runs[remat]
        s = r["state"].clone()
        for _ in range(WARMUP_STEPS):
            s, _ = r["step"](s, past, future)
        gc.collect()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        times = [host_ms(lambda: r["step"](s, past, future)) for _ in range(3)]
        timing[remat].append(statistics.median(times))
        timing["peak"][remat] = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
        del s
    off_ms, on_ms = min(timing[False]), min(timing[True])
    frames_step = batch * (tc.num_future_frames if nar
                           else tc.num_past_frames + tc.num_future_frames - 1)
    print(f"  {label}: remat off {off_ms:.3f} ms ({timing[False]}), on {on_ms:.3f} ms "
          f"({timing[True]}): x{on_ms / off_ms:.3f}, {frames_step / on_ms * 1e3:.1f} training "
          f"frames/s with remat; step peak above the state off {timing['peak'][False]:.3f} "
          f"GiB, on {timing['peak'][True]:.3f} GiB; bit-equal {bit_equal} (remat off "
          f"reproducible bit for bit: {reproducible}); launches off "
          f"{runs[False]['launches']}, on {runs[True]['launches']}")
    out = dict(off_ms=off_ms, on_ms=on_ms, off_peak_gib=timing["peak"][False],
               on_peak_gib=timing["peak"][True], bit_equal=bit_equal,
               reproducible=reproducible, worst_grad_l2=worst_grad,
               launches_off=runs[False]["launches"], launches_on=runs[True]["launches"])
    del runs, a, b, enc, dec
    gc.collect()
    torch.cuda.empty_cache()
    return out


def remat_phases(dev, dp_extra):
    """Phases 37-39: transformer.remat at far_mnist (the default and the
    fused-FFN route), nar_mnist (with and without TSLMA) and far_bair_dp's
    one-rank step. Returns the readings."""
    from vptr_tpu_torch.config import get_preset
    from vptr_tpu_torch.data.loader import build_loader
    from vptr_tpu_torch.train.trainer import Trainer

    out = {}
    core = {"fused_attention_ln": LAYERS, "attention_core": LAYERS}
    core_bwd = {"fused_attention_ln_bwd": LAYERS, "attention_core_bwd": LAYERS}
    phase("37. transformer.remat at far_mnist full width: the default route and the "
          "fused-FFN route (fused_ffn + fused_dw), remat off against on from one seed")
    out["far_default"] = remat_pair(dev, "far_mnist", {}, "far_mnist default route", core,
                                    core_bwd)
    out["far_ffn"] = remat_pair(
        dev, "far_mnist", {"fused_ffn": True, "fused_dw": True}, "far_mnist fused-FFN route",
        {**core, "fused_ffn": LAYERS, "fused_dw_chain": LAYERS},
        {**core_bwd, "fused_ffn_bwd": LAYERS, "fused_dw_chain_bwd": LAYERS})

    ntc = get_preset("nar_mnist").transformer
    enc_l, dec_l = ntc.num_encoder_layers, ntc.num_decoder_layers
    nfwd = {"fused_attention_ln": enc_l, "fused_attention": dec_l,
            "attention_core": enc_l + 2 * dec_l}
    nbwd = {"fused_attention_ln_bwd": enc_l, "fused_attention_bwd": dec_l,
            "attention_core_bwd": enc_l + 2 * dec_l}
    phase("38. transformer.remat at nar_mnist full width, with and without "
          "transformer.tslma: remat off against on, the BatchNorm statistics too")
    out["nar"] = remat_pair(dev, "nar_mnist", {}, "nar_mnist", nfwd, nbwd)
    out["nar_tslma"] = remat_pair(dev, "nar_mnist", {"tslma": True}, "nar_mnist + tslma",
                                  nfwd, nbwd)

    cfg = get_preset(DP_PRESET).override({"transformer": {"remat": True}})
    tc, dc = cfg.transformer, cfg.data
    phase(f"39. {DP_PRESET}'s one-rank step at the preset's batch {dc.batch_size} with "
          f"transformer.remat (Trainer: the blocks and the decoder checkpointed) against "
          f"phase 33's without")
    from contextlib import closing
    with closing(iter(build_loader(dc, split="train", seed=cfg.seed))) as it:
        past_np, future_np = next(it)
    trainer = Trainer(cfg, write_outputs=False)
    state = trainer.init_state()
    past, future = trainer.put_batch(past_np, future_np)
    want = {k: 2 * tc.num_encoder_layers for k in ("fused_attention_ln", "attention_core")}
    want.update({k: tc.num_encoder_layers for k in ("fused_attention_ln_bwd",
                                                    "attention_core_bwd")})
    torch.cuda.reset_peak_memory_stats()
    state, launches = counted_step(trainer.train_step, state, past, future, want,
                                   f"{DP_PRESET} train step with remat")
    for _ in range(WARMUP_STEPS):
        state, _ = trainer.train_step(state, past, future)
    times = [host_ms(lambda: trainer.train_step(state, past, future))
             for _ in range(TIMED_STEPS)]
    step_ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    frames = dc.batch_size * (dc.num_past_frames + dc.num_future_frames - 1)
    off_ms, off_peak = dp_extra.get("one_rank_step_ms"), dp_extra.get("one_rank_peak_gib")
    print(f"  batch {dc.batch_size}: remat median {step_ms:.3f} ms of {len(times)} "
          f"({[round(t, 3) for t in times]}), {frames / step_ms * 1e3:.1f} training "
          f"frames/s, peak {peak:.3f} GiB; phase 33 without remat: {off_ms} ms, "
          f"{off_peak} GiB (batch {dp_extra.get('one_rank_batch')})")
    check(off_peak is not None and dp_extra.get("one_rank_batch") == dc.batch_size
          and peak < off_peak, f"{DP_PRESET} peak with remat {peak:.3f} GiB below phase "
          f"33's {off_peak} GiB without, at one batch")
    out["far_bair_dp"] = dict(batch=dc.batch_size, ms=step_ms,
                              frames_per_s=frames / step_ms * 1e3, peak_gib=peak,
                              launches=launches, off_ms=off_ms, off_peak_gib=off_peak)
    del trainer, state, past, future
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _stacked(tree, prefix, stack):
    """The JAX scan_layers layout of an unrolled tree: the ``<prefix>{i}``
    subtrees as one ``<stack>/block`` whose leaves stack them on axis 0
    (what nn.scan's variable_axes 0 gives)."""
    layers = [tree.pop(f"{prefix}{i}") for i in range(len(tree))
              if f"{prefix}{i}" in tree]

    def stack_(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack_([n[k] for n in nodes]) for k in nodes[0]}
        return np.stack(nodes)
    if layers:
        tree[stack] = {"block": stack_(layers)}
    return tree


def scan_phases(dev):
    """Phase 40: transformer.scan_layers at far_mnist and nar_mnist full
    width, from the unrolled model's weights as a stacked JAX-layout tree.
    Returns the readings."""
    from vptr_tpu_torch.config import get_preset
    from vptr_tpu_torch.eval.harness import make_predict_fn
    from vptr_tpu_torch.models.autoencoder import build_autoencoder
    from vptr_tpu_torch.models.transformer import build_transformer
    from vptr_tpu_torch.train.optim import build_optimizer
    from vptr_tpu_torch.train.state import create_far_train_state
    from vptr_tpu_torch.train.steps import make_far_train_step, make_nar_train_step
    from vptr_tpu_torch.utils.weights import export_jax_variables, load_jax_variables

    phase("40. transformer.scan_layers at far_mnist and nar_mnist full width: weights "
          "as a stacked JAX-layout tree (numpy) through load_jax_variables; predict and "
          "one train step against the unrolled model's, then with remat too")
    out = {}
    for preset in ("far_mnist", "nar_mnist"):
        cfg = get_preset(preset)
        tc = cfg.transformer
        nar = tc.variant == "nar"
        batch = cfg.data.batch_size if nar else BATCH
        frames = torch.rand(batch, tc.num_past_frames + tc.num_future_frames, 64, 64, 1,
                            generator=torch.Generator().manual_seed(SEED + 220)).to(dev)
        past, future = frames[:, :tc.num_past_frames], frames[:, tc.num_past_frames:]
        enc, dec = build_autoencoder(cfg.ae, torch.bfloat16, dev,
                                     torch.Generator().manual_seed(SEED))
        tree = None
        results = {}
        for label, over in (("unrolled", {}), ("scan_layers", {"scan_layers": True}),
                            ("scan_layers + remat", {"scan_layers": True, "remat": True})):
            rc = cfg.override({"transformer": over})
            tr = build_transformer(rc.transformer, torch.bfloat16, dev,
                                   torch.Generator().manual_seed(SEED + 1 + len(results)))
            if tree is None:
                tree = export_jax_variables(tr)
                stacked = {col: (_stacked(_stacked(dict(t), "enc_block", "enc_blocks"),
                                          "dec_block", "dec_blocks") if nar else
                                 _stacked(dict(t), "block", "blocks"))
                           for col, t in tree.items()}
                stacks = sorted(k for k in stacked["params"] if k.endswith("blocks"))
                lead = {k: next(iter(_flat_leaves(stacked["params"][k]))).shape[0]
                        for k in stacks}
                print(f"  {preset}: stacked tree {stacks}, leading axes {lead}"
                      + (f", batch_stats {sorted(stacked['batch_stats'])}" if nar else ""))
            else:
                load_jax_variables(tr, stacked)
            mode = "nar" if nar else "far_rip"
            predict = make_predict_fn(rc, enc, dec, tr, mode, tc.num_future_frames, dev)
            pred = predict(past)
            opt = build_optimizer(rc.optim, tc.d_model)
            state = create_far_train_state(enc, dec, tr, opt, seed=SEED + 3)
            make = make_nar_train_step if nar else make_far_train_step
            step = make(enc, dec, tr, opt, rc.loss, remat_decoder=rc.transformer.remat)
            runs = []
            for _ in range(2 if label == "unrolled" else 1):   # unrolled twice: the floor
                after, m = step(state.clone(), past, future)
                runs.append(({_unrolled_name(n): p.grad.detach().clone()
                              for n, p in after.transformer.named_parameters()},
                             float(m["T_total"])))
            results[label] = dict(pred=pred, runs=runs)
            del state, tr, opt, predict, after
            torch.cuda.empty_cache()
        (base, base_total), (again, _) = results["unrolled"]["runs"]
        for label in ("scan_layers", "scan_layers + remat"):
            r = results[label]
            grads, total = r["runs"][0]
            e_pred = max_err(r["pred"], results["unrolled"]["pred"])
            check(e_pred == 0.0, f"{preset} {label}: {mode} frames equal the unrolled "
                  f"model's from the same weights (max|err| {e_pred:.3e})")
            check(abs(total - base_total) <= 2 ** -8 * max(1.0, base_total),
                  f"{preset} {label}: T_total {total!r} vs unrolled {base_total!r} "
                  f"(equal: {total == base_total})")
            equal, reproducible, worst, diff, floor = grads_against_floor(
                f"{preset} {label}: the step's gradients against the unrolled step's",
                base, again, grads)
            out[f"{preset} {label}"] = dict(pred_max_abs_err=e_pred, grads_bit_equal=equal,
                                            unrolled_reproducible=reproducible,
                                            worst_leaf=worst, worst_rel=diff,
                                            floor=floor, total=total,
                                            unrolled_total=base_total)
        del results, base, again, enc, dec
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _unrolled_name(name: str) -> str:
    """A scan_layers parameter's name as the unrolled model's
    (``blocks.3.x`` -> ``block3.x``, ``enc_blocks.1.x`` -> ``enc_block1.x``)."""
    return re.sub(r"^(enc_|dec_)?blocks\.(\d+)\.", r"\1block\2.", name)


def _flat_leaves(tree):
    """The numpy leaves of a nested dict, in key order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat_leaves(v)
        else:
            yield v


# ---------------------------------------------------------------- tensor parallelism

TP_SUBSETS = ((4, 0), (4, 4), (2, 0))   # (heads, first head) of 8: Cl 264, 264, 132
DW_TOL = {torch.float32: 1e-3, torch.bfloat16: 6.25e-2}          # phase 3's gates on #9 (#7)
DW_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -5}      # and #10 (and #7/#8)
FFN_GRADS = ("dx", "dw1", "db1", "dw2", "db2", "dls", "dlb")
TP_BATCH = 8                             # phases 42-44's global batch
TP_TIMED_STEPS = 1                       # a rank's timed steps (a gloo step on one card: 3-6 s)
TP_CLI_STEPS = 1                         # phase 44's steps a run (then resumed for as many)
# the fused-FFN route with the folded window residual (phases 44 and 52)
TP_FFN_FLAGS = {"fused_attention": True, "fused_full": True, "fused_residual": True,
                "fused_ffn": True, "fused_dw": True}
# the conv-FFN route with the folded temporal sublayer (phase 54)
TP_CONV_FLAGS = {"fused_conv_ffn": True, "fused_full_temporal": True}
# phase 44's conv-FFN route torchrun (its fused-FFN route one runs TP_FFN_FLAGS
# beside it; one run cannot hold both, fused_dw taking precedence over
# fused_conv_ffn): #1 unfolded at the window sublayer and folded at the
# temporal one, #7/#8 on a hidden subset, #11/#12 as fc1's column- and fc2's
# row-parallel steps
TP_CONV_CLI_FLAGS = {"fused_attention": True, "fused_full": True, "fused_residual": True,
                "fused_ffn": True, "fused_conv_ffn": True, "fused_full_temporal": True}


def _subset_window_ops(ops, hl, h0, hd):
    """A window kernel's operands (x [, x_v], wq, bq, wk, bk, wv, bv, wo, bo,
    ...) for heads h0 .. h0 + hl - 1: the columns of Wq, Wk, Wv and their
    biases, the rows of Wo, bo 0 (the layer adds it once, after the sum)."""
    n_in = 2 if ops[1].dim() == 3 else 1
    xs, (wq, bq, wk, bk, wv, bv, wo, bo), rest = ops[:n_in], ops[n_in:n_in + 8], ops[n_in + 8:]
    cols = slice(h0 * hd, (h0 + hl) * hd)
    return xs + (wq[:, cols].contiguous(), bq[cols].contiguous(), wk[:, cols].contiguous(),
                 bk[cols].contiguous(), wv[:, cols].contiguous(), bv[cols].contiguous(),
                 wo[cols].contiguous(), torch.zeros_like(bo)) + rest


def _subset_yardsticks(sub, two, hl, hd, bias, gout):
    """A window kernel's function on a head subset as one PyTorch call
    (LayerNorm for #1, the q/k/v projections to Cl = hl hd, SDPA with the
    subset's bias, the out projection Cl -> C; bo 0, as the subset's call):
    its forward eager and graph-replayed, its backward, and the bounds of
    the forward and the backward (phase 6's byte and operation counts at Cl)."""
    import torch.nn.functional as F

    windows, tokens, c = sub[0].shape
    dt = sub[0].dtype
    mask = None if bias is None else bias.to(dt)[None]
    split = lambda z: z.view(windows, tokens, hl, hd).transpose(1, 2)
    n_in = 2 if two else 1
    bq, bk, bv = sub[n_in + 1], sub[n_in + 3], sub[n_in + 5]

    def core(xqk, xv, wq, wk, wv, wo):
        o = F.scaled_dot_product_attention(
            split(F.linear(xqk, wq.t(), bq.to(dt))), split(F.linear(xqk, wk.t(), bk.to(dt))),
            split(F.linear(xv, wv.t(), bv.to(dt))), attn_mask=mask)
        return F.linear(o.transpose(1, 2).reshape(windows, tokens, hl * hd), wo.t())

    w4 = (sub[n_in], sub[n_in + 2], sub[n_in + 4], sub[n_in + 6])
    if two:
        fn, ops = core, sub[:2] + w4
    else:
        ls, lb, pos = sub[n_in + 8:n_in + 11]

        def fn(x, wq, wk, wv, wo):
            xn = F.layer_norm(x, (c,), ls.to(dt), lb.to(dt))
            return core(xn + pos.to(dt), xn, wq, wk, wv, wo)
        ops = sub[:1] + w4
    rows, cl, s2 = windows * tokens, hl * hd, 2
    vec = 4 * c * 4 + (hl * tokens * tokens * 4 if bias is not None else 0)
    b_ms, b_by = bound((n_in + 1) * rows * c * s2 + 4 * c * cl * s2 + vec,
                       8 * rows * c * cl + 4 * rows * tokens * cl)
    bb_ms, bb_by = bound((2 * n_in + 1) * rows * c * s2 + 8 * c * cl * s2 + 2 * vec,
                         22 * rows * c * cl + 12 * rows * tokens * cl)
    return dict(library_ms=cuda_ms(lambda: fn(*ops)), library_graph_ms=graph_ms(lambda: fn(*ops)),
                bound_ms=b_ms, bound_by=b_by,
                bwd_library_ms=cuda_ms(grads_of(fn, ops, gout)), bwd_bound_ms=bb_ms,
                bwd_bound_by=bb_by)


def tp_kernel_phases(dev):
    """Phase 41: kernels #1/#3, #5/#6 and #2/#4 on a head subset (heads h0 ..
    h0 + Hl - 1 of 8, hd 66) at the far_mnist / nar_mnist training shapes,
    dropout 0.1, bf16 and f32: each against its plain version on the same
    subset; #2/#4 against the whole call's slice of those heads (bit
    equality reported), also on the long route at 160 tokens; #1's and #5's
    two halves (4 + 4 heads) summed with bo added once against the whole
    call. Returns {kernel name: its head-subset readings}."""
    from vptr_tpu_torch.ops import attention_core as tac
    from vptr_tpu_torch.ops import fused_window_attention as tfw

    phase("41. kernels #1-#6 on a head subset (tensor parallelism)")
    bf, f32 = torch.bfloat16, torch.float32
    tol = {f32: 1e-3, bf: 6.25e-2}                       # as phase 3
    bwd_tol = {f32: 1e-4, bf: 2 ** -5}
    g = torch.Generator().manual_seed(SEED + 41)
    randn = normals(g)
    c, heads, hd, rate = 528, 8, 66, 0.1
    seed = torch.tensor([SEED + 4141], dtype=torch.int32, device=dev)
    far_windows, nar_windows = BATCH * 19 * 4, 16 * 10 * 4     # the FAR / NAR step's windows
    out = {"fused_attention_ln": {}, "fused_attention": {}, "attention_core": {}}

    def window_ops(dtype, bw, two):
        w = [randn(c, c, std=(1.0 / c) ** 0.5).to(dev, dtype) for _ in range(4)]
        b = [randn(c, std=0.02).to(dev) for _ in range(4)]
        xs = tuple(randn(bw, 16, c).to(dev, dtype) for _ in range(2 if two else 1))
        wb = (w[0], b[0], w[1], b[1], w[2], b[2], w[3], b[3])
        if two:
            return xs + wb
        pos = randn(16, c, std=0.5).to(dev)
        return xs + wb + ((1 + randn(c, std=0.1)).to(dev), randn(c, std=0.1).to(dev), pos)

    for name, two, bw in (("fused_attention_ln", False, far_windows),
                          ("fused_attention", True, nar_windows)):
        fwd = tfw.fused_attention if two else tfw.fused_attention_ln
        plain = tfw.fused_attention_plain if two else tfw.fused_attention_ln_plain
        bwd = tfw.fused_attention_backward if two else tfw.fused_attention_ln_backward
        bwd_plain = (tfw.fused_attention_backward_plain if two
                     else tfw.fused_attention_ln_backward_plain)
        for dtype in (bf, f32):
            dn = str(dtype).replace("torch.", "")
            ops = window_ops(dtype, bw, two)
            rpe = randn(heads, 16, 16, std=0.5).to(dev) if two else None
            gout = randn(bw, 16, c).to(dev, dtype)
            halves = []
            for hl, h0 in TP_SUBSETS:
                sub = _subset_window_ops(ops, hl, h0, hd)
                bias = None if rpe is None else rpe[h0:h0 + hl].contiguous()
                kw = dict(num_heads=hl, dropout_rate=rate, mask_heads=heads, head0=h0)
                got = fwd(*sub, bias, seed, **kw)
                e = max_err(got, plain(*sub, bias, seed, **kw))
                route = tfw.kernel_route(16, c, dtype, inner=hl * hd)
                lib = tfw._lib_two() if two else tfw._lib()
                entry = "vptr_fused_window_attention" if two else "vptr_fused_window_attention_ln"
                lib_route = getattr(lib, f"{entry}_route")(16, c, hl * hd, tfw._DTYPES[dtype])
                check(e <= tol[dtype] and (route == "wgmma") == bool(lib_route),
                      f"{name} {dn} heads {h0}..{h0 + hl - 1} of {heads} (Cl {hl * hd}, "
                      f"{route} route, the library's agrees) dropout {rate} vs plain "
                      f"max|err| {e:.3e} <= {tol[dtype]}")
                bargs = (*sub, bias, seed, gout, hl, rate)
                if two:
                    kg = bwd(*bargs, True, heads, h0)
                    pg = bwd_plain(*bargs, True, heads, h0)
                else:
                    kg = bwd(*bargs, None, False, False, heads, h0)
                    pg = bwd_plain(*bargs, None, False, False, heads, h0)
                worst = max(rel_err(a, b) for a, b in zip(kg, pg) if a is not None)
                broute = tfw.backward_route(16, c, dtype, not two, inner=hl * hd)
                check(worst <= bwd_tol[dtype], f"{name} backward {dn} heads {h0}..{h0 + hl - 1}"
                      f" ({broute} route) vs plain worst rel err {worst:.3e} <= "
                      f"{bwd_tol[dtype]}")
                key = f"{dn} {hl} of {heads} heads from {h0}"
                out[name][key] = {"route": route, "backward_route": broute,
                                  "max_abs_err": e, "bwd_rel_err": worst}
                if hl == 4:
                    halves.append((got, kg))
                    if dtype == bf and h0 == 0:
                        kernel_ms, plain_ms = timed_turns(
                            lambda: fwd(*sub, bias, seed, **kw),
                            lambda: plain(*sub, bias, seed, **kw))
                        bk_ms, bp_ms = timed_turns(
                            lambda: bwd(*bargs, True, heads, h0) if two
                            else bwd(*bargs, None, False, False, heads, h0),
                            lambda: bwd_plain(*bargs, True, heads, h0) if two
                            else bwd_plain(*bargs, None, False, False, heads, h0))
                        out[name][key].update(ms=kernel_ms, plain_ms=plain_ms,
                                              bwd_ms=bk_ms, bwd_plain_ms=bp_ms)
                        out[name][key].update(_subset_yardsticks(sub, two, hl, hd, bias, gout))
            kw = dict(num_heads=heads, dropout_rate=rate)
            whole = fwd(*ops, rpe, seed, **kw)
            bo = ops[9 if two else 8]
            summed = halves[0][0].float() + halves[1][0].float() + bo
            e = max_err(summed, whole)
            check(e <= 2 * tol[dtype], f"{name} {dn}: the two halves' outputs (4 + 4 heads) "
                  f"summed, bo once, vs the whole call max|err| {e:.3e} <= {2 * tol[dtype]}")
            wg = (bwd(*ops, rpe, seed, gout, heads, rate, True) if two
                  else bwd(*ops, None, seed, gout, heads, rate, None, False, False))
            n_x = 2 if two else 1
            ex = max(rel_err(halves[0][1][i].float() + halves[1][1][i].float(), wg[i])
                     for i in range(n_x))
            check(ex <= 2 * bwd_tol[dtype], f"{name} backward {dn}: the halves' input "
                  f"gradients summed vs the whole call's rel err {ex:.3e} <= "
                  f"{2 * bwd_tol[dtype]}")
            out[name][f"{dn} halves"] = {"out_max_abs_err": e, "dx_rel_err": ex}

    # #2 / #4: the FAR temporal step's (640 columns, 19 tokens, causal) and
    # TSLMA's long route (64 x 160 tokens), q, k, v in the layer's layout
    causal = torch.full((19, 19), -1e30).triu(1)[None].to(dev)
    for label, b, t, bias_kind, dtypes in (("far temporal", BATCH * 64, 19, "causal", (bf, f32)),
                                           ("per-head bias", BATCH * 64, 19, "heads", (bf,)),
                                           ("long", 64, 160, None, (bf,))):
        for dtype in dtypes:
            dn = str(dtype).replace("torch.", "")
            q, k, v, gq = (randn(b, t, c).to(dev, dtype).view(b, t, heads, hd).transpose(1, 2)
                           for _ in range(4))
            bias = (causal if bias_kind == "causal" else
                    randn(heads, t, t, std=0.5).to(dev) if bias_kind == "heads" else None)
            whole = tac.attention_core(q, k, v, bias, seed, rate)
            wgr = tac.attention_core_backward(q, k, v, bias, seed, gq, rate, bias_kind == "heads")
            for hl, h0 in TP_SUBSETS:
                sl = slice(h0, h0 + hl)

                def sub(z):   # the subset in the layer's layout: (B, Hl, T, hd) of (B, T, Cl)
                    return z[:, sl].transpose(1, 2).contiguous().view(b, t, hl * hd).view(
                        b, t, hl, hd).transpose(1, 2)
                qs, ks, vs, gs = sub(q), sub(k), sub(v), sub(gq)
                bs = bias[sl].contiguous() if bias_kind == "heads" else bias
                got = tac.attention_core(qs, ks, vs, bs, seed, rate, heads, h0)
                e = max_err(got, tac.attention_core_plain(qs, ks, vs, bs, seed, rate, heads, h0))
                eq = torch.equal(got, whole[:, sl])
                route = tac.kernel_route(dtype, hl, t, t, hd)
                check(e <= tol[dtype] and max_err(got, whole[:, sl]) <= tol[dtype],
                      f"attention_core {label} {dn} heads {h0}..{h0 + hl - 1} of {heads} "
                      f"({route} route) vs plain max|err| {e:.3e}; the whole call's slice "
                      f"{'bit-equal' if eq else f'max|err| {max_err(got, whole[:, sl]):.3e}'}")
                kg = tac.attention_core_backward(qs, ks, vs, bs, seed, gs, rate,
                                                 bias_kind == "heads", heads, h0)
                pg = tac.attention_core_backward_plain(qs, ks, vs, bs, seed, gs, rate,
                                                       bias_kind == "heads", heads, h0)
                worst = max(rel_err(a, p) for a, p in zip(kg, pg) if a is not None)
                wslices = [wgr[0][:, sl], wgr[1][:, sl], wgr[2][:, sl]] + (
                    [wgr[3][sl]] if bias_kind == "heads" else [])
                beq = all(torch.equal(a, w) for a, w in zip(kg, wslices))
                bworst = max(rel_err(a, w) for a, w in zip(kg, wslices))
                broute = tac.backward_route(dtype, hl, t, t, hd)
                check(worst <= bwd_tol[dtype] and bworst <= bwd_tol[dtype],
                      f"attention_core backward {label} {dn} heads {h0}..{h0 + hl - 1} "
                      f"({broute} route) vs plain worst rel err {worst:.3e}; the whole "
                      f"call's slice {'bit-equal' if beq else f'rel err {bworst:.3e}'}")
                out["attention_core"][f"{label} {dn} {hl} of {heads} heads from {h0}"] = {
                    "route": route, "backward_route": broute, "max_abs_err": e,
                    "bwd_rel_err": worst, "bit_equal_to_whole_slice": eq,
                    "bwd_bit_equal_to_whole_slice": beq}
    return out


TP_COUNTERS = ("fused_attention_ln", "fused_attention", "attention_core",
               "fused_attention_ln_bwd", "fused_attention_bwd", "attention_core_bwd",
               "fused_ffn", "fused_ffn_bwd", "fused_dw_chain", "fused_dw_chain_bwd",
               "conv_ln_gelu", "conv_ln_gelu_bwd")


def _tp_run(dev, preset, flags, mesh=None):
    """The preset's train step at full width (bf16) from the seeds
    remat_pair uses (the autoencoder SEED, the transformer SEED + 1, the
    state SEED + 3) on moving-square frames: built whole and, on a ``mesh``
    with a model axis, cut to this rank's shares. Returns (step, the state
    before, its parameters whole, the frames)."""
    from vptr_tpu_torch.config import get_preset
    from vptr_tpu_torch.models.autoencoder import build_autoencoder
    from vptr_tpu_torch.models.transformer import build_transformer
    from vptr_tpu_torch.train.optim import build_optimizer
    from vptr_tpu_torch.train.state import create_far_train_state
    from vptr_tpu_torch.train.steps import make_far_train_step, make_nar_train_step

    cfg = get_preset(preset).override({"transformer": flags})
    tc = cfg.transformer
    nar = tc.variant == "nar"
    frames = moving_squares(TP_BATCH, tc.num_past_frames + tc.num_future_frames, 64,
                            torch.Generator().manual_seed(SEED + 420)).to(dev)
    past, future = frames[:, :tc.num_past_frames], frames[:, tc.num_past_frames:]
    enc, dec = build_autoencoder(cfg.ae, torch.bfloat16, dev,
                                 torch.Generator().manual_seed(SEED))
    tr = build_transformer(tc, torch.bfloat16, dev, torch.Generator().manual_seed(SEED + 1),
                           mesh=mesh)
    opt = build_optimizer(cfg.optim, tc.d_model)
    state = create_far_train_state(enc, dec, tr, opt, seed=SEED + 3)
    step = (make_nar_train_step if nar else make_far_train_step)(enc, dec, tr, opt, cfg.loss)
    return step, state, cfg, (past, future)


def _whole(state, grad):
    """The transformer's parameters (or gradients) by name, whole, f32 on the
    CPU (a sharded transformer's shares gathered over the model group)."""
    from vptr_tpu_torch.models.transformer import tp_shards
    from vptr_tpu_torch.parallel.mesh import gather_state

    named = dict(state.transformer.named_parameters())
    got = gather_state({n: (p.grad if grad else p).detach() for n, p in named.items()},
                       tp_shards(state.transformer))
    return {n: t.float().cpu() for n, t in got.items()}


def _worker_tp_step(out_dir):
    """Phases 42, 43, 52 and 54 on each rank: the preset's step on a (1, W) mesh
    (tensor parallelism, and sequence parallelism with the flag), every
    launch counter at 0 just before it; rank 0 saves the whole gradients
    and parameters. Then, that step the warm-up, the next one's ms and
    peak memory (TP_TIMED_STEPS), and one step with
    every collective timed (synchronised before and after it: the model
    group's all-reduces and all-gathers, the only collectives of a step on
    one data rank) for their share."""
    import torch.distributed as dist

    from vptr_tpu_torch.parallel import host_id, make_mesh, num_hosts

    args = json.loads((out_dir / "args.json").read_text())
    mesh = make_mesh(1, num_hosts())
    step, state, cfg, (past, future) = _tp_run(torch.device("cuda"), args["preset"],
                                               args["flags"], mesh)
    start = _whole(state, False)
    from vptr_tpu_torch.ops import conv_ln_gelu as tcl
    from vptr_tpu_torch.ops import fused_dw_chain as tdw

    zero_counters()
    state, m = step(state, past, future)
    torch.cuda.synchronize()
    launches = launch_counts(*TP_COUNTERS)
    dw_routes = {"forward": dict(tdw.fused_dw_chain.launches_by_route),
                 "backward": dict(tdw.fused_dw_chain.bwd_launches_by_route)}
    conv_routes = {"forward": dict(tcl.conv_ln_gelu.launches_by_route),
                   "backward": dict(tcl.conv_ln_gelu.bwd_launches_by_route)}
    grads, params = _whole(state, True), _whole(state, False)
    if host_id() == 0:
        torch.save({"start": start, "grads": grads, "params": params}, out_dir / "got.pt")
    del start, grads, params
    # the replicated leaves (and every rank's gathered whole) the same bits
    # on every rank
    from vptr_tpu_torch.models.transformer import tp_shards

    shards = tp_shards(state.transformer)
    flat = torch.cat([p.detach().float().reshape(-1)
                      for n, p in state.transformer.named_parameters() if n not in shards])
    theirs = flat.clone()
    dist.broadcast(theirs, src=0)
    same = torch.tensor([float(torch.equal(flat, theirs))], device=flat.device)
    dist.all_reduce(same, op=dist.ReduceOp.MIN)
    out = {"backend": dist.get_backend(), "world": num_hosts(),
           "mesh": [mesh.data, mesh.model], "metrics": {k: float(v) for k, v in m.items()},
           "launches": launches, "dw_routes": dw_routes, "conv_routes": conv_routes,
           "replicated_bit_equal": bool(same.item() == 1.0),
           "local_q_rows": int(next(mod for mod in state.transformer.modules()
                                    if type(mod).__name__ == "MultiHeadAttention")
                               .q_proj.weight.shape[0])}
    gc.collect()                           # the counted step was the warm-up
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = [host_ms(lambda: step(state, past, future)) for _ in range(TP_TIMED_STEPS)]
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    spent = [0.0, 0]
    real = {name: getattr(dist, name) for name in ("all_reduce", "all_gather")}

    def timed(fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t0
            spent[1] += 1
            return r
        return call
    for name, fn in real.items():
        setattr(dist, name, timed(fn))
    try:
        instrumented = host_ms(lambda: step(state, past, future))
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)
    out.update(step_ms=statistics.median(times), step_times=times, peak_gib=peak,
               held_gib=held / 2 ** 30, collectives=spent[1],
               collectives_ms=spent[0] * 1e3, instrumented_step_ms=instrumented,
               collectives_share=spent[0] * 1e3 / instrumented)
    return out


def tp_step_phase(dev, card, root, number, preset, flags, want, cards, ranks=2):
    """Phase 42, 43, 52, 54 or 56: the preset's step on ``ranks`` ranks (a
    card each over NCCL where the machine has ``ranks`` cards, else
    ``ranks`` processes on the one card over gloo) on a (1, ranks) mesh,
    against the one-rank step from the same seeds; returns the readings.
    With ``transformer.fused_dw`` every rank's #9/#10 must take the tiled
    route split at its statistics; with ``fused_conv_ffn`` every rank's
    #11/#12 the tiled route's steps, half at fc1 (``tiled_split``) and half
    at fc2 (``tiled_rows``)."""
    own_cards = cards >= ranks
    backend = "nccl" if own_cards else "gloo"
    label = (f"{ranks} cards over NCCL" if own_cards else
             f"{ranks} processes on the one card over gloo (a correctness run: the ranks share "
             f"the card, and every collective is staged through the host)")
    what = f"{preset} mesh.model={ranks}" + (" + sequence_parallel" if flags.get(
        "sequence_parallel") else "") + (" on the fused-FFN route (" + ", ".join(
            k for k in ("fused_residual", "fused_ffn", "fused_dw") if flags.get(k)) + ")"
        if flags.get("fused_ffn") else "") + (" on the conv-FFN route (" + ", ".join(
            k for k in TP_CONV_FLAGS if flags.get(k)) + ")" if flags.get("fused_conv_ffn") else "")
    phase(f"{number}. {what} train step at full width ({label}) against the one-rank step")
    # the one-rank step twice from the same state: the reference and the
    # card's run-to-run floor; then its time and peak
    step, state, cfg, (past, future) = _tp_run(dev, preset, flags)
    start = _whole(state, False)
    a, ma = step(state.clone(), past, future)
    again, _ = step(state.clone(), past, future)
    ref = {"grads": _whole(a, True), "params": _whole(a, False),
           "again": _whole(again, True)}
    ma = {k: float(v) for k, v in ma.items()}
    del again
    s = state.clone()                  # the two steps above were the warm-up
    gc.collect()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    one_ms = statistics.median([host_ms(lambda: step(s, past, future))
                                for _ in range(TIMED_STEPS)])
    one_peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    del s, state, a, step
    gc.collect()
    torch.cuda.empty_cache()
    (root / "args.json").write_text(json.dumps({"preset": preset, "flags": flags}))
    res = launch_ranks("tp_step", ranks, backend, root, one_card=not own_cards)
    out = {"backend": backend, "ranks": ranks, "one_rank_step_ms": one_ms,
           "one_rank_peak_gib": one_peak}
    if not _ranks_ok(res, f"{ranks}-rank {what} step ({label})"):
        return out
    r0 = res[0][2]
    got = torch.load(root / "got.pt")
    check(r0["mesh"] == [1, ranks] and r0["backend"] == backend,
          f"mesh {r0['mesh']} (data 1, model {ranks}), backend {r0['backend']}; q_proj rows a "
          f"rank {r0['local_q_rows']} (of {cfg.transformer.d_model})")
    for x in res:
        check_counts(x[2]["launches"], want, f"a rank's {what} step")
        if flags.get("fused_dw"):
            routes = x[2]["dw_routes"]
            check(routes["forward"]["tiled_split"] == want["fused_dw_chain"]
                  and routes["backward"]["tiled_split"] == want["fused_dw_chain_bwd"],
                  f"#9 / #10 on the tiled route split at its statistics in every launch: "
                  f"{routes}")
        if flags.get("fused_conv_ffn"):
            routes, half = x[2]["conv_routes"], want["conv_ln_gelu"] // 2
            check(all(routes[d][r] == half for d in ("forward", "backward")
                      for r in ("tiled_split", "tiled_rows"))
                  and sum(routes["forward"].values()) == want["conv_ln_gelu"]
                  and sum(routes["backward"].values()) == want["conv_ln_gelu_bwd"],
                  f"#11 / #12 on the tiled route's steps in every launch, {half} at fc1 "
                  f"(tiled_split) and {half} at fc2 (tiled_rows) each way: {routes}")
    check(all(x[2]["metrics"] == r0["metrics"] for x in res),
          "the metrics equal on every rank")
    check(all(x[2]["replicated_bit_equal"] for x in res),
          "the replicated parameters bit-equal on every rank after the step")
    check(all(torch.equal(got["start"][n], start[n]) for n in start),
          "the ranks' shares gathered are the one-rank init, bit for bit")
    d_total = abs(r0["metrics"]["T_total"] - ma["T_total"])
    norm, norm1 = r0["metrics"]["grad_norm"], ma["grad_norm"]
    finite = math.isfinite(norm1)
    d_norm = abs(norm / norm1 - 1) if finite else float("nan")
    check(d_total <= 2e-3 * max(1.0, abs(ma["T_total"])),
          f"T_total {r0['metrics']['T_total']:.6f} against the one-rank {ma['T_total']:.6f}: "
          f"|d| {d_total:.3e}")
    check(d_norm <= 0.05 if finite else norm == norm1,
          f"grad_norm {norm:.6e} against the one-rank {norm1:.6e}: rel diff {d_norm:.3e} <= "
          f"0.05" + ("" if finite else " (both overflow f32 at this init: the NCE head's "
                                       "L2-normalised projections of near-zero features)"))
    # the gradients whole. TP moves the bf16 rounding points (each rank's
    # partial sums rounded, then summed in f32), and a leaf whose gradient
    # cancels over the batch (the conv FFN's hidden norm affines) moves by
    # far more than the card's run-to-run floor; so, as phase 34 holds the
    # data-parallel step, the gradients within 2^-5 as one vector and 2^-2
    # leaf by leaf (f64 sums; leaves whose exact gradient is 0, noise run to
    # run, left out), with each leaf's distance beside that floor reported
    g1, gw, ga = ref["grads"], got["grads"], ref["again"]
    d2 = {n: float((gw[n].double() - g1[n].double()).square().sum()) for n in g1}
    n2 = {n: float(g1[n].double().square().sum()) for n in g1}
    a2 = {n: float((ga[n].double() - g1[n].double()).square().sum()) for n in g1}
    rel = {n: (d2[n] / n2[n]) ** 0.5 if n2[n] > 0 else 0.0 for n in g1}
    floor = {n: (a2[n] / n2[n]) ** 0.5 if n2[n] > 0 else 0.0 for n in g1}
    vec = (sum(d2.values()) / sum(n2.values())) ** 0.5
    firm = {n: r for n, r in rel.items() if floor[n] <= 2 ** -4 and not n.endswith(ZERO_GRAD_LEAF)}
    worst = max(firm, key=firm.get)
    margin = {n: rel[n] / max(2 ** -8, 4 * floor[n]) for n in firm}
    worst_m = max(margin, key=margin.get)
    # (where the norm overflows, the clip zeroes the update and the vector is
    # the NCE head's ~1e19 gradients of near-zero features: leaf by leaf only)
    check(vec <= 2 ** -5 or not finite, f"{what}: the gradients against the one-rank step's "
          f"as one vector: |g_TP - g_1| / |g_1| {vec:.3e} <= 2^-5"
          + ("" if finite else " (not held: the norm overflows, the update is 0)"))
    check(firm[worst] <= 2 ** -2, f"{what}: leaf by leaf ({len(firm)} of {len(rel)}; the "
          f"others noise run to run) within 2^-2 (the worst {worst}: {firm[worst]:.3e})")
    print(f"  against the card's run-to-run floor: {sum(m <= 1 for m in margin.values())} of "
          f"{len(margin)} leaves within 2^-8 or 4x it; the furthest {worst_m} {rel[worst_m]:.3e}"
          f" (floor {floor[worst_m]:.3e})")
    clip = cfg.optim.max_grad_norm
    if finite:
        params_on_firm_gradients(f"{what}: the parameters after the step", start,
                                 ref["params"], got["params"], g1, ga,
                                 1.0 if clip is None else clip / max(norm1, clip))
    else:     # the clip scales every gradient to 0: weight decay alone moves them
        e = max(max_err(got["params"][n], ref["params"][n]) for n in start)
        check(e <= 1e-6, f"{what}: the parameters after the step (the clip zeroes the "
              f"update) against the one-rank step's max|err| {e:.3e} <= 1e-6")
    equal = all(torch.equal(g1[n], gw[n]) for n in g1)
    reproducible = all(torch.equal(g1[n], ga[n]) for n in g1)
    worst_d, worst_floor = firm[worst], floor[worst]
    for r, (_, _, x) in enumerate(res):
        print(f"  {card}: rank {r} step median {x['step_ms']:.3f} ms "
              f"({[round(t, 3) for t in x['step_times']]}), peak {x['peak_gib']:.3f} GiB "
              f"above the held {x['held_gib']:.3f} GiB; {x['collectives']} model-group "
              f"collectives {x['collectives_ms']:.3f} ms of a {x['instrumented_step_ms']:.3f} "
              f"ms step with each one synchronised = {x['collectives_share']:.1%} ({label})")
    print(f"  {card}: the one-rank step {one_ms:.3f} ms, peak {one_peak:.3f} GiB above the "
          f"state; gradients bit-equal {equal} (the one-rank step reproducible bit for "
          f"bit: {reproducible}; the worst leaf {worst} {worst_d:.3e}, floor "
          f"{worst_floor:.3e}); launches a rank {r0['launches']}")
    out.update(grad_vector_rel_err=vec, leaves_within_floor=sum(m <= 1 for m in
                                                                    margin.values()),
               rank_step_ms=[x[2]["step_ms"] for x in res],
               rank_peak_gib=[x[2]["peak_gib"] for x in res],
               collectives=r0["collectives"], collectives_ms=r0["collectives_ms"],
               collectives_share=r0["collectives_share"], launches=r0["launches"],
               grads_bit_equal=equal, worst_grad_leaf=worst, worst_grad_l2=worst_d,
               t_total_diff=d_total, grad_norm_rel_diff=d_norm)
    return out


def tp_cli_phase(card, root, cards):
    """Phase 44: torchrun ... cli train --preset far_mnist with mesh.model 2
    and sequence_parallel on two routes side by side, the fused-FFN route
    (TP_FFN_FLAGS: #1 unfolded, #7/#8 on a hidden subset, #9/#10 split) and
    the conv-FFN route (TP_CONV_CLI_FLAGS: #11/#12 as the conv FFN's
    column- and row-parallel steps); each (TP_CLI_STEPS steps, a checkpoint)
    resumed by one process's cli train with mesh.model 1 for as many more,
    its steps against an unbroken one-process run of both on the route, which
    runs beside the
    torchrun (it needs none of its files)."""
    import os
    from pathlib import Path

    n = 2
    routes = {"fused-FFN route": TP_FFN_FLAGS, "conv-FFN route": TP_CONV_CLI_FLAGS}
    sets_of = {label: {f"transformer.{k}": "true" for k in flags}
               for label, flags in routes.items()}
    shown = lambda label: " ".join(f"--set {k}={v}" for k, v in sets_of[label].items())
    phase(f"44. torchrun --nproc_per_node={n} -m vptr_tpu_torch.cli train --preset far_mnist "
          f"--set mesh.model=2 --set transformer.sequence_parallel=true on two routes side by "
          f"side, " + " and ".join(f"the {label} ({shown(label)})" for label in routes)
          + f" ({TP_CLI_STEPS} step(s) each), each resumed in one process with mesh.model=1, "
          "against an "
          "unbroken one-process run")
    here = str(Path(__file__).resolve().parent)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [here] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else []))}
    if cards < n:          # the ranks share the card, over gloo
        env["VPTR_RANKS_SHARE_CARDS"] = "1"
    sets = lambda label, **kw: [a for k, v in {
        "epochs": 1, "steps_per_epoch": TP_CLI_STEPS, "val_per_epochs": 4,
        "data.batch_size": TP_BATCH,
        **sets_of[label], **kw}.items() for a in ("--set", f"{k}={v}")]
    cli = [sys.executable, "-m", "vptr_tpu_torch.cli", "train", "--preset", "far_mnist"]
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={n}", "-m", "vptr_tpu_torch.cli", "train", "--preset",
           "far_mnist"]

    def start(args, name):     # its output into a file: a pipe could fill while it waits
        log = open(root / f"{name}.out", "w")
        return time.perf_counter(), log, subprocess.Popen(
            args, cwd=here, env=env, stdout=log, stderr=subprocess.STDOUT, text=True)

    def finish(started, what, timed=True):
        """Its wall; None untimed (a run read after others: its end is not seen)."""
        t0, log, p = started
        try:
            p.wait(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        log.close()
        wall = time.perf_counter() - t0 if timed else None
        check(p.returncode == 0, f"{what}: exit {p.returncode}"
              + ("" if wall is None else f" ({wall:.1f} s)"))
        if p.returncode != 0:
            print(open(log.name).read()[-3000:])
        return wall

    out, dirs, runs = {}, {}, {}
    for i, label in enumerate(routes):
        dirs[label] = tp_dir, one_dir = root / f"cli_tp_{i}", root / f"cli_one_{i}"
        runs[label] = (
            start(cli + ["--ckpt-dir", str(one_dir)] + sets(label, epochs=2), f"unbroken_{i}"),
            start(run + ["--ckpt-dir", str(tp_dir)] + sets(
                label, **{"mesh.model": 2, "transformer.sequence_parallel": "true"}), f"tp_{i}"))
    resumed = {}
    for i, label in enumerate(routes):
        tp_dir = dirs[label][0]
        out[label] = {"tp_wall_s": finish(
            runs[label][1], f"{label}: torchrun {n} x cli train --set mesh.model=2 --set "
            f"transformer.sequence_parallel=true {shown(label)}")}
        log = ((tp_dir / "train_log.log").read_text() if (tp_dir / "train_log.log").is_file()
               else "")
        check((tp_dir / "ckpt" / str(TP_CLI_STEPS) / "state.pt").is_file()
              and "tensor parallel over 2 model ranks" in log,
              f"{label}: rank 0 wrote ckpt/{TP_CLI_STEPS}/ and logged the model axis")
        resumed[label] = start(cli + ["--ckpt-dir", str(tp_dir)] + sets(
            label, **{"mesh.model": 1}), f"resumed_{i}")
    for label in routes:
        tp_dir, one_dir = dirs[label]
        r = out[label]
        r["resume_wall_s"] = finish(resumed[label], f"{label}: cli train resumed in one "
                                    f"process (mesh.model=1)")
        finish(runs[label][0], f"{label}: cli train, one process, {2 * TP_CLI_STEPS} steps "
               f"unbroken (beside the torchrun)", False)
        try:
            hist = lambda d: json.loads((d / "ckpt" / "history.json").read_text())
            check(f"resumed from step {TP_CLI_STEPS}" in (tp_dir / "train_log.log").read_text(),
                  f"{label}: the one-process run resumed the mesh's checkpoint at step "
                  f"{TP_CLI_STEPS}")
            ra, rb = hist(tp_dir)["train"]["T_total"], hist(one_dir)["train"]["T_total"]
            print(f"  {label}: T_total by epoch: the mesh then one process {ra}, unbroken {rb}")
            check(len(ra) == len(rb) == 2 and all(
                abs(x[1] - y[1]) <= 2e-3 * max(1.0, abs(y[1])) for x, y in zip(ra, rb)),
                f"{label}: each epoch's T_total within 2e-3 of the unbroken run's")
            last = str(2 * TP_CLI_STEPS)
            sa = torch.load(tp_dir / "ckpt" / last / "state.pt", weights_only=True)
            sb = torch.load(one_dir / "ckpt" / last / "state.pt", weights_only=True)
            num = sum(float((sa["transformer"][k].float() - v.float()).square().sum())
                      for k, v in sb["transformer"].items())
            den = sum(float(v.float().square().sum()) for v in sb["transformer"].values())
            rel = (num / den) ** 0.5
            check(rel <= 2 ** -7, f"{label}: the transformer after {last} steps against the "
                  f"unbroken run's: relative L2 {rel:.3e} <= 2^-7")
            r.update(t_total=ra, unbroken_t_total=rb, state_rel_l2=rel)
        except (OSError, KeyError, ValueError) as e:
            check(False, f"{label}: the runs' histories and checkpoints read: {e!r}")
        print(f"  {card}, {label}: walls {r.get('tp_wall_s') or 0:.1f} s ({n} ranks"
              f"{', gloo on one card' if cards < n else ', NCCL'}), "
              f"{r.get('resume_wall_s') or 0:.1f} s (resumed); the unbroken run beside the "
              f"torchrun, both routes' runs side by side")
    return out


def tp_phases(dev, card, which=(42, 43, 44)):
    """Phases 42-44 (tensor and sequence parallelism at full width; 44's
    torchruns on the fused-FFN and conv-FFN routes), 52 (the fused-FFN
    route's step), 54 (the conv-FFN route's) and 56 (the fused-FFN route's
    at mesh.model 4). Returns the readings."""
    import shutil
    import tempfile
    from pathlib import Path

    cards = torch.cuda.device_count()
    root = Path(tempfile.mkdtemp(prefix="vptr_smoke_tp_"))
    out = {"cards": cards, "card": card}
    try:
        if 42 in which:
            far = {k: 12 for k in ("fused_attention_ln", "attention_core",
                                   "fused_attention_ln_bwd", "attention_core_bwd")}
            far.update(dict.fromkeys(("fused_attention", "fused_attention_bwd", "fused_ffn",
                                      "fused_ffn_bwd", "fused_dw_chain", "fused_dw_chain_bwd",
                                      "conv_ln_gelu", "conv_ln_gelu_bwd"), 0))
            out["far_tp"] = tp_step_phase(dev, card, root, 42, "far_mnist", {}, far, cards)
            gc.collect()
            torch.cuda.empty_cache()
        if 43 in which:
            nar = {"fused_attention_ln": 4, "fused_attention": 8, "attention_core": 20,
                   "fused_attention_ln_bwd": 4, "fused_attention_bwd": 8,
                   "attention_core_bwd": 20, **dict.fromkeys((
                       "fused_ffn", "fused_ffn_bwd", "fused_dw_chain", "fused_dw_chain_bwd",
                       "conv_ln_gelu", "conv_ln_gelu_bwd"), 0)}
            out["nar_tp_sp"] = tp_step_phase(dev, card, root, 43, "nar_mnist",
                                             {"sequence_parallel": True}, nar, cards)
            gc.collect()
            torch.cuda.empty_cache()
        if 44 in which:
            out["cli"] = tp_cli_phase(card, root, cards)
        # the fused-FFN route: every kernel of the route 12 times a rank (#5/#6 none)
        ffn_want = {k: LAYERS for k in TP_COUNTERS}
        ffn_want.update(fused_attention=0, fused_attention_bwd=0, conv_ln_gelu=0,
                        conv_ln_gelu_bwd=0)
        if 52 in which:
            out["far_ffn_tp"] = tp_step_phase(dev, card, root, 52, "far_mnist", TP_FFN_FLAGS,
                                              ffn_want, cards)
        if 54 in which:   # #1/#3 (window and folded temporal) and #11/#12 (fc1, fc2) 24 each
            want = dict.fromkeys(TP_COUNTERS, 0)
            want.update(dict.fromkeys(("fused_attention_ln", "fused_attention_ln_bwd",
                                       "conv_ln_gelu", "conv_ln_gelu_bwd"), 2 * LAYERS))
            out["far_conv_tp"] = tp_step_phase(dev, card, root, 54, "far_mnist", TP_CONV_FLAGS,
                                               want, cards)
        if 56 in which:   # 2 heads, 528 hidden columns and channels a rank
            out["far_ffn_tp4"] = tp_step_phase(dev, card, root, 56, "far_mnist", TP_FFN_FLAGS,
                                               ffn_want, cards, ranks=4)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out



# ------------------------------------------------ tensor parallel, fused-FFN route
# phases 51-52: kernels #7-#10 on a hidden-channel subset, and far_mnist's
# fused-FFN route (with the folded window residual) on a (1, 2) mesh (its
# torchrun cli train is phase 44's)


def ffn_ops(randn, dev, dtype, s, c, hid):
    """#7's operands at S rows x C, hidden H, from the host normals randn."""
    return (randn(s, c).to(dev, dtype), randn(c, hid, std=c ** -0.5).to(dev, dtype),
            randn(hid, std=0.1).to(dev), randn(hid, c, std=hid ** -0.5).to(dev, dtype),
            randn(c, std=0.1).to(dev), (1 + randn(c, std=0.1)).to(dev),
            randn(c, std=0.1).to(dev))


def ffn_share(ops, m, parts):
    """#7's operands and keywords on share m of ``parts`` equal shares of
    the hidden columns: w1's columns, b1's and w2's rows, b2 0 (added
    after the sum), the dropout at the global column."""
    x, w1, b1, w2, b2, ls, lb = ops
    hl = w1.shape[1] // parts
    cols = slice(m * hl, (m + 1) * hl)
    return ((x, w1[:, cols].contiguous(), b1[cols].contiguous(), w2[cols].contiguous(),
             torch.zeros_like(b2), ls, lb), dict(mask_cols=w1.shape[1], col0=m * hl))


def ffn_share_check(out, ops, gout, kseed, rate, parts):
    """Phases 51 and 55: #7/#8 on each of ``parts`` shares of the hidden
    columns against their plain versions (phase 3's gates), and the shares
    summed (b2 once) against the whole call: dx, dls, dlb summed, dw1,
    db1, dw2 the whole's slices. Readings into out["fused_ffn"] and
    out["fused_ffn_bwd"]."""
    from vptr_tpu_torch.ops import fused_ffn as tff

    dtype, (c, hid) = ops[0].dtype, ops[1].shape
    dn, hl = str(dtype).replace("torch.", ""), hid // parts
    tol, btol = DW_TOL[dtype], DW_BWD_TOL[dtype]
    shares = []
    for m in range(parts):
        sub, kw = ffn_share(ops, m, parts)
        got = tff.fused_ffn(*sub, kseed, rate, **kw)
        e = max_err(got, tff.fused_ffn_plain(*sub, kseed, rate, **kw))
        route = tff.kernel_route(c, hl, dtype)
        what = f"{dn} hidden {m * hl}..{(m + 1) * hl - 1} of {hid} dropout {rate}"
        check(e <= tol, f"fused_ffn {what} ({route} route) vs plain max|err| {e:.3e} <= {tol}")
        kg = tff.fused_ffn_backward(*sub, kseed, gout, rate, **kw)
        n_worst, worst = worst_rel(kg, tff.fused_ffn_backward_plain(*sub, kseed, gout, rate,
                                                                    **kw), FFN_GRADS)
        broute = tff.backward_route(c, hl, dtype)
        check(worst <= btol, f"fused_ffn backward {what} ({broute} route) vs plain worst "
              f"{n_worst} rel err {worst:.3e} <= {btol}")
        out["fused_ffn"][what] = {"route": route, "max_abs_err": e}
        out["fused_ffn_bwd"][what] = {"route": broute, "rel_err": worst}
        shares.append((got, kg))
    e = max_err(sum(o.float() for o, _ in shares) + ops[4], tff.fused_ffn(*ops, kseed, rate))
    wg = tff.fused_ffn_backward(*ops, kseed, gout, rate)
    ex = max(rel_err(sum(g[i].float() for _, g in shares), wg[i]) for i in (0, 5, 6))
    es = max(rel_err(torch.cat([g[i] for _, g in shares], dim), wg[i])
             for i, dim in ((1, 1), (2, 0), (3, 0)))
    check(e <= 2 * tol and ex <= 2 * btol and es <= btol,
          f"fused_ffn {dn} dropout {rate}: the {parts} shares' outputs summed (b2 once) vs the "
          f"whole call max|err| {e:.3e} <= {2 * tol}; dx, dls, dlb summed rel err {ex:.3e} <= "
          f"{2 * btol}; dw1, db1, dw2 the whole's slices rel err {es:.3e} <= {btol}")
    out["fused_ffn"][f"{dn} dropout {rate} {parts} shares"] = {
        "out_max_abs_err": e, "grads_summed_rel_err": ex, "shares_rel_err": es}


def _dw_slices(grads, cols):
    """#10's (dx, dtaps, ddwb, ds1, db1, ds2, db2) at the channels cols."""
    return ([grads[0][..., cols], grads[1][:, cols], grads[2][cols]]
            + [d[:, cols] for d in grads[3:]])


def dw_split_check(label, ops, gout, kseed, w, rate, ranks):
    """Phases 51 and 55: #9/#10 on the tiled route split at its statistics
    over ``ranks`` equal shares of ``ops``' channels, run in step in one
    process (run_split: the exchange stacks their partials where a mesh
    gathers them), twice. Each share against the plain version's slice
    (phase 3's gates); the shares against the whole tiled call's slices,
    bit-equal where they are whole 32-channel tiles, else within the same
    gates (a partial tile merges tiles of two sizes, and a whole-call tile
    straddles two ranks); the two calls bit-equal. Returns (#9's readings,
    #10's)."""
    from vptr_tpu_torch.ops import fused_dw_chain as tdw

    dtype, cl = ops[0].dtype, ops[0].shape[-1] // ranks
    dn, tol, btol = str(dtype).replace("torch.", ""), DW_TOL[dtype], DW_BWD_TOL[dtype]
    whole_tiles = cl % tdw.T_CH == 0
    cols = [slice(m * cl, (m + 1) * cl) for m in range(ranks)]
    shares = [tuple(o[..., c].contiguous() for o in ops) for c in cols]
    gshares = [gout[..., c].contiguous() for c in cols]
    split = lambda: tdw.run_split([tdw.split_forward(*shares[m], kseed, w, rate, (ranks, m))
                                   for m in range(ranks)])
    split_bwd = lambda: tdw.run_split([tdw.split_backward(
        *shares[m], kseed, gshares[m], w, rate, (ranks, m)) for m in range(ranks)])
    what = (f"{label} {dn} {tuple(ops[0].shape)} on {ranks} ranks' {cl} channels "
            f"(tiled_split), dropout {rate}")
    against = "" if whole_tiles else f" <= {tol} (a partial tile: not the same bits)"

    outs, again = split(), split()
    whole = tdw._forward_kernel(*ops, kseed, w, rate, route="tiled")
    plain = tdw.fused_dw_chain_plain(*ops, kseed, w, rate)
    e = max(max_err(o, plain[..., c]) for o, c in zip(outs, cols))
    ew = max(max_err(o, whole[..., c]) for o, c in zip(outs, cols))
    eq = all(torch.equal(o, whole[..., c]) for o, c in zip(outs, cols))
    same = all(torch.equal(a, b) for a, b in zip(outs, again))
    check(e <= tol and same and (eq if whole_tiles else ew <= tol),
          f"fused_dw_chain {what} vs plain max|err| {e:.3e} <= {tol}; the whole tiled call's "
          f"slices {'bit-equal' if eq else f'max|err| {ew:.3e}'}{against}; two calls "
          f"bit-equal {same}")
    del outs, again, whole, plain
    bwds, bagain = split_bwd(), split_bwd()
    bsame = all(torch.equal(a, b) for x, y in zip(bwds, bagain) for a, b in zip(x, y))
    wgr = tdw._backward_kernel(*ops, kseed, gout, w, rate, route="tiled")
    beq = all(torch.equal(a, b) for g, c in zip(bwds, cols) for a, b in zip(g, _dw_slices(wgr, c)))
    bw = max(rel_err(a, b) for g, c in zip(bwds, cols) for a, b in zip(g, _dw_slices(wgr, c)))
    del wgr, bagain
    pg = tdw.fused_dw_chain_backward_plain(*ops, kseed, gout, w, rate)
    worst = max(rel_err(a, b) for g, c in zip(bwds, cols) for a, b in zip(g, _dw_slices(pg, c)))
    check(worst <= btol and bsame and (beq if whole_tiles else bw <= btol),
          f"fused_dw_chain backward {what} vs plain worst rel err {worst:.3e} <= {btol}; the "
          f"whole tiled call's slices {'bit-equal' if beq else f'rel err {bw:.3e}'}"
          f"{'' if whole_tiles else f' <= {btol}'}; two calls bit-equal {bsame}")
    return ({"route": "tiled_split", "max_abs_err": e, "bit_equal_to_whole_slice": eq,
             "whole_slice_max_abs_err": ew, "two_calls_bit_equal": same},
            {"route": "tiled_split", "rel_err": worst, "bit_equal_to_whole_slice": beq,
             "whole_slice_rel_err": bw, "two_calls_bit_equal": bsame})


def dw_share_cases(dops, gdw, kseed, w, rate, ranks):
    """Phases 51 and 55's timed cases of #9 and #10 on a rank's share dops
    (N, HW, Cl) of ``ranks`` shares, bf16 (the exchange a local stack of
    the rank's own partials: the mesh's gather is timed in the steps): the
    plain version on the share, the library yardstick (the share's
    LayerNorms, GELUs and depthwise conv) and the bytes and f32 operations
    of the bound, as :func:`time_share_cases` takes them."""
    import torch.nn.functional as F

    from vptr_tpu_torch.ops import fused_dw_chain as tdw

    n, hw, cl = dops[0].shape
    bf, h = torch.bfloat16, hw // w
    own = lambda parts: [torch.stack([parts[0]] * ranks)]

    def library(x, taps, dwb, s1, b1, s2, b2):
        img = x.view(n, h, w, cl).permute(0, 3, 1, 2)
        aff = lambda p: p.t().reshape(cl, h, w).to(bf)
        z = F.gelu(F.layer_norm(img, img.shape[1:], aff(s1), aff(b1)))
        z = F.conv2d(z, taps.t().reshape(cl, 1, 3, 3).to(bf), dwb.to(bf), padding=1, groups=cl)
        return F.gelu(F.layer_norm(z, z.shape[1:], aff(s2), aff(b2)))

    d, s2b = n * hw * cl, 2
    shape = f"{n} x {hw} x {cl} of {cl * ranks}"
    return (
        ("fused_dw_chain",
         lambda: tdw.run_split([tdw.split_forward(*dops, kseed, w, rate, (ranks, 0))], own),
         lambda: tdw.fused_dw_chain_plain(*dops, kseed, w, rate), library, dops, None,
         2 * d * s2b + (10 * cl + 4 * hw * cl) * 4, 80 * d, torch.float32, shape),
        ("fused_dw_chain_bwd",
         lambda: tdw.run_split([tdw.split_backward(*dops, kseed, gdw, w, rate, (ranks, 0))],
                               own),
         lambda: tdw.fused_dw_chain_backward_plain(*dops, kseed, gdw, w, rate), library, dops,
         gdw.view(n, h, w, cl).permute(0, 3, 1, 2), 3 * d * s2b + (20 * cl + 8 * hw * cl) * 4,
         210 * d, torch.float32, shape),
    )


def time_share_cases(out, cases):
    """Each case (name, kernel call, plain call, library yardstick, its
    operands, its output gradient (None: a forward), bytes, operations,
    their dtype, shape): the kernel beside the plain version in turns, the
    library eager and replayed from a CUDA graph (a backward's as forward
    + backward less forward), and the bound, into out[name]."""
    for name, fn, plain, lib, lib_ops, lib_g, nbytes, flops, fdt, shape in cases:
        k_ms, p_ms = timed_turns(fn, plain)
        if lib_g is None:
            lib_ms, lib_graph = cuda_ms(lambda: lib(*lib_ops)), graph_ms(lambda: lib(*lib_ops))
        else:
            lib_ms, lib_graph = cuda_ms(grads_of(lib, lib_ops, lib_g)), graph_bwd_ms(
                lib, lib_ops, lib_g)
        b_ms, b_by = bound(nbytes, flops, fdt)
        out[name].update(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, library_graph_ms=lib_graph,
                         bound_ms=b_ms, bound_by=b_by, shape=shape)
        print(f"  {name} on a rank's share ({shape}): kernel {k_ms:.4f} ms, plain {p_ms:.4f} "
              f"ms, library {lib_ms:.4f} ms (graph "
              f"{lib_graph if lib_graph is None else round(lib_graph, 4)}), bound {b_ms:.4f} "
              f"ms ({b_by}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP "
              f"{str(fdt).replace('torch.', '')})")


def tp_ffn_kernel_phase(dev):
    """Phase 51: kernels #7/#8 on hidden columns 0-1055 and 1056-2111 of
    2112 at far_mnist's step (12,160 rows, C 528), bf16 and f32, dropout 0
    and 0.1, against their plain versions on the same columns and, the
    halves summed (b2 once), against the whole call; #9/#10 on the tiled
    route split at its statistics, two ranks' halves of the channels run
    in step in one process (run_split: the exchange stacks their partials
    where the mesh gathers them), at far_mnist's step (190 samples of 8 x
    8) and nar_kth_128's (80 of 16 x 16), dropout 0.1, against the plain
    version's slice and the whole tiled call's (bit-equal: whole tiles;
    dw_split_check); then each one's time on a rank's share beside its
    plain version, a library yardstick (eager and graph-replayed) and its
    bound. Returns {kernel name: its hidden-subset readings}."""
    import torch.nn.functional as F

    from vptr_tpu_torch.config import get_preset
    from vptr_tpu_torch.ops import fused_ffn as tff

    phase("51. kernels #7-#10 on a hidden-channel subset (tensor parallelism, mesh.model 2)")
    tc = get_preset("far_mnist").transformer
    c, hid, hw, w = (tc.d_model, tc.spatial_ffn_hidden_ratio * tc.d_model,
                     tc.enc_h * tc.enc_w, tc.enc_w)
    ctx = tc.num_past_frames + tc.num_future_frames
    s_step, n_step, hl = BATCH * (ctx - 1) * hw, BATCH * (ctx - 1), hid // 2
    bf, f32 = torch.bfloat16, torch.float32
    kseed = torch.tensor([SEED + 5151], dtype=torch.int32, device=dev)
    randn = normals(torch.Generator().manual_seed(SEED + 51))
    names = ("fused_ffn", "fused_ffn_bwd", "fused_dw_chain", "fused_dw_chain_bwd")
    out = {n: {} for n in names}

    for dtype in (bf, f32):
        ops, gout = ffn_ops(randn, dev, dtype, s_step, c, hid), randn(s_step, c).to(dev, dtype)
        for r in (0.0, 0.1):
            ffn_share_check(out, ops, gout, kseed, r, 2)
        del ops, gout

    def dw_ops(n, hw_, dtype):
        return (randn(n, hw_, hid).to(dev, dtype), randn(9, hid, std=0.3).to(dev),
                randn(hid, std=0.1).to(dev), (1 + randn(hw_, hid, std=0.1)).to(dev),
                randn(hw_, hid, std=0.1).to(dev), (1 + randn(hw_, hid, std=0.1)).to(dev),
                randn(hw_, hid, std=0.1).to(dev))

    rate = tc.dropout
    for label, n, hw_, w_, dtypes in (("far_mnist", n_step, hw, w, (bf, f32)),
                                      ("nar_kth_128", 80, 256, 16, (bf,))):
        for dtype in dtypes:
            dn = str(dtype).replace("torch.", "")
            ops, gout = dw_ops(n, hw_, dtype), randn(n, hw_, hid).to(dev, dtype)
            (out["fused_dw_chain"][f"{label} {dn}"],
             out["fused_dw_chain_bwd"][f"{label} {dn}"]) = dw_split_check(
                label, ops, gout, kseed, w_, rate, 2)
            del ops, gout
    torch.cuda.synchronize()

    # a rank's call at far_mnist's step, bf16 (#7 dropout 0, #8 / #9 / #10
    # at the preset's 0.1, as phase 14): beside the plain version on the
    # same share, one library yardstick (the share's LayerNorm, products,
    # GELU and conv) and the bound of the share's bytes and operations.
    # The split calls' exchange is a local stack of the rank's own
    # partials here (the mesh's gather is timed in phase 52's step)
    fops, gffn = ffn_ops(randn, dev, bf, s_step, c, hid), randn(s_step, c).to(dev, bf)
    sub, kw = ffn_share(fops, 0, 2)
    dops = tuple(o[..., :hl].contiguous() for o in dw_ops(n_step, hw, bf))
    gdw = randn(n_step, hw, hl).to(dev, bf)

    def ffn_library(x, w1, b1, w2):
        xn = F.layer_norm(x, (c,), sub[5].to(bf), sub[6].to(bf))
        return F.linear(F.gelu(F.linear(xn, w1.t(), b1.to(bf))), w2.t())

    e, s2b = s_step * c, 2
    shape = f"{s_step} rows x {c}, hidden {hl} of {hid}"
    time_share_cases(out, (
        ("fused_ffn", lambda: tff.fused_ffn(*sub, kseed, 0.0, **kw),
         lambda: tff.fused_ffn_plain(*sub, kseed, 0.0, **kw), ffn_library, sub[:4], None,
         2 * e * s2b + 2 * c * hl * s2b + (hl + 3 * c) * 4, 4 * s_step * c * hl, bf, shape),
        ("fused_ffn_bwd", lambda: tff.fused_ffn_backward(*sub, kseed, gffn, rate, **kw),
         lambda: tff.fused_ffn_backward_plain(*sub, kseed, gffn, rate, **kw), ffn_library,
         sub[:4], gffn, 3 * e * s2b + 4 * c * hl * s2b + 2 * hl * 4 + 6 * c * 4,
         10 * s_step * c * hl, bf, shape),
    ) + dw_share_cases(dops, gdw, kseed, w, rate, 2))
    return out


# ------------------------------------------------ tensor parallel, conv-FFN route
# phases 53-54: kernels #11/#12 as the conv FFN's column-parallel fc1 and
# row-parallel fc2 (the tiled route's steps with the model group's
# exchanges between them), and far_mnist's conv-FFN route (with the folded
# temporal sublayer) on a (1, 2) mesh (its torchrun cli train is phase 44's)

def tp_conv_kernel_phase(dev):
    """Phase 53: kernels #11/#12 at far_mnist's step (190 samples of 8 x 8,
    C 528, hidden 2112), bf16 and f32: fc1 column-parallel
    (``split_forward`` / ``split_backward``, each rank on its Cout / M hidden
    channels, norm1's per-row partials exchanged) and fc2 row-parallel
    (``rows_forward`` / ``rows_backward``, each rank on its Cin / M, the
    partial products summed in rank order), M ranks run in step in one
    process (``run_split``: the exchange stacks their partials where the
    mesh gathers them), M 2 and 4; against the plain whole call (its
    slices, its sums) and the whole tiled call (the same steps at M 1),
    the difference reported; then a rank's call at M 2 beside its plain
    version, a library yardstick (eager and graph-replayed) and its bound.
    Returns {kernel name: its readings}."""
    import torch.nn.functional as F

    from vptr_tpu_torch.config import get_preset
    from vptr_tpu_torch.ops import conv_ln_gelu as tcl
    from vptr_tpu_torch.ops._split import run_split

    phase("53. kernels #11/#12 as the conv FFN's column-parallel fc1 and row-parallel fc2 "
          "(tensor parallelism, mesh.model 2 and 4)")
    tc = get_preset("far_mnist").transformer
    c, hid, hw = tc.d_model, tc.spatial_ffn_hidden_ratio * tc.d_model, tc.enc_h * tc.enc_w
    ctx = tc.num_past_frames + tc.num_future_frames
    n, bf, f32 = BATCH * (ctx - 1), torch.bfloat16, torch.float32
    s_rows = n * hw
    tol = {f32: 1e-3, bf: 6.25e-2}                       # as phase 3
    bwd_tol = {f32: 1e-4, bf: 2 ** -5}
    randn = normals(torch.Generator().manual_seed(SEED + 53))
    names = ("dx", "dw", "db", "dscale", "dbias2")
    out = {"conv_ln_gelu": {}, "conv_ln_gelu_bwd": {}}

    def ops_of(cin, cout, dtype):
        return (randn(n, hw, cin).to(dev, dtype), randn(cin, cout, std=cin ** -0.5).to(dev, dtype),
                randn(cout, std=0.1).to(dev), (1 + randn(hw, cout, std=0.1)).to(dev),
                randn(hw, cout, std=0.1).to(dev))

    def cols(a, m, mm, dim=-1):      # rank m's share of mm along dim
        k = a.shape[dim] // mm
        return a.narrow(dim, m * k, k).contiguous()

    def split_share(ops, m, mm):     # fc1: w's, b's, scale's, bias2's Cout channels
        x, w, b, sc, b2 = ops
        return (x, cols(w, m, mm), cols(b, m, mm), cols(sc, m, mm), cols(b2, m, mm))

    def rows_share(ops, m, mm):      # fc2: x's and w's Cin channels
        x, w, b, sc, b2 = ops
        return (cols(x, m, mm), cols(w, m, mm, 0), b, sc, b2)

    for dtype, ms in ((bf, (2, 4)), (f32, (2,))):
        dn = str(dtype).replace("torch.", "")
        # fc1, column-parallel
        ops, g = ops_of(c, hid, dtype), randn(n, hw, hid).to(dev, dtype)
        plain = tcl.conv_ln_gelu_plain(*ops)
        pg = tcl.conv_ln_gelu_backward_plain(*ops, g)
        whole = run_split([tcl.split_forward(*ops, (1, 0))])[0]
        wg = run_split([tcl.split_backward(*ops, g, (1, 0))])[0]
        for mm in ms:
            outs = run_split([tcl.split_forward(*split_share(ops, m, mm), (mm, m))
                              for m in range(mm)])
            bwds = run_split([tcl.split_backward(*split_share(ops, m, mm), cols(g, m, mm),
                                                 (mm, m)) for m in range(mm)])
            e = max(max_err(outs[m], cols(plain, m, mm)) for m in range(mm))
            ew = max(max_err(outs[m], cols(whole, m, mm)) for m in range(mm))
            eq = all(torch.equal(outs[m], cols(whole, m, mm)) for m in range(mm))
            dx = sum(b_[0].float() for b_ in bwds)
            share = lambda grads, m: [cols(grads[1], m, mm)] + [cols(d, m, mm) for d in grads[2:]]
            e_dx = rel_err(dx, pg[0])
            e_share = max(rel_err(a, b_) for m in range(mm) for a, b_ in
                          zip(bwds[m][1:], share(pg, m)))
            worst = max(e_dx, e_share)
            worst_w = max([rel_err(dx, wg[0].float())] + [
                rel_err(a, b_) for m in range(mm) for a, b_ in zip(bwds[m][1:], share(wg, m))])
            what = f"fc1 {dn} {tuple(ops[0].shape)} -> {hid // mm} of {hid} on {mm} ranks"
            check(e <= tol[dtype], f"conv_ln_gelu {what} (tiled_split) vs the plain whole call's "
                  f"slices max|err| {e:.3e} <= {tol[dtype]}; vs the whole tiled call's "
                  f"{'bit-equal' if eq else f'max|err| {ew:.3e}'} (the merged statistics differ "
                  f"by rounding)")
            check(e_dx <= 2 * bwd_tol[dtype] and e_share <= bwd_tol[dtype],
                  f"conv_ln_gelu backward {what} (tiled_split) vs plain: dx summed over the "
                  f"ranks rel err {e_dx:.3e} <= {2 * bwd_tol[dtype]}, dw, db, dscale, dbias2 the "
                  f"slices worst {e_share:.3e} <= {bwd_tol[dtype]}; vs the whole tiled call's "
                  f"worst {worst_w:.3e}")
            out["conv_ln_gelu"][what] = {"route": "tiled_split", "max_abs_err": e,
                                         "whole_tiled_max_abs_err": ew,
                                         "bit_equal_to_whole_tiled": eq}
            out["conv_ln_gelu_bwd"][what] = {"route": "tiled_split", "rel_err": worst,
                                             "whole_tiled_rel_err": worst_w}
            del outs, bwds, dx
        del ops, g, plain, pg, whole, wg
        # fc2, row-parallel
        ops, g = ops_of(hid, c, dtype), randn(n, hw, c).to(dev, dtype)
        plain = tcl.conv_ln_gelu_plain(*ops)
        pg = tcl.conv_ln_gelu_backward_plain(*ops, g)
        whole, wu, wst = run_split([tcl.rows_forward(*ops, (1, 0))])[0]
        wg = tcl.rows_backward(*ops, g, wu, wst)
        del wu, wst
        for mm in ms:
            fwds = run_split([tcl.rows_forward(*rows_share(ops, m, mm), (mm, m))
                              for m in range(mm)])
            bwds = [tcl.rows_backward(*rows_share(ops, m, mm), g, *fwds[m][1:])
                    for m in range(mm)]
            same = all(torch.equal(f[0], fwds[0][0]) for f in fwds) and all(
                torch.equal(a, b_) for bw in bwds for a, b_ in zip(bw[2:], bwds[0][2:]))
            e = max(max_err(f[0], plain) for f in fwds)
            ew = max(max_err(f[0], whole) for f in fwds)
            share = lambda grads, m: [cols(grads[0], m, mm), cols(grads[1], m, mm, 0)] + list(
                grads[2:])
            worst = max(rel_err(a, b_) for m in range(mm) for a, b_ in zip(bwds[m],
                                                                           share(pg, m)))
            worst_w = max(rel_err(a, b_) for m in range(mm) for a, b_ in zip(bwds[m],
                                                                             share(wg, m)))
            what = f"fc2 {dn} {tuple(ops[0].shape)} -> {c}, {hid // mm} of {hid} in on {mm} ranks"
            check(e <= tol[dtype] and same, f"conv_ln_gelu {what} (tiled_rows) vs the plain "
                  f"whole call max|err| {e:.3e} <= {tol[dtype]}, every rank's output and db, "
                  f"dscale, dbias2 bit-equal; vs the whole tiled call's max|err| {ew:.3e} (the "
                  f"partial products summed in f32)")
            check(worst <= bwd_tol[dtype], f"conv_ln_gelu backward {what} (tiled_rows) vs plain: "
                  f"dx, dw the slices, db, dscale, dbias2 whole (not summed over the ranks), "
                  f"worst rel err {worst:.3e} <= {bwd_tol[dtype]}; vs the whole tiled call's "
                  f"{worst_w:.3e}")
            out["conv_ln_gelu"][what] = {"route": "tiled_rows", "max_abs_err": e,
                                         "whole_tiled_max_abs_err": ew, "ranks_bit_equal": same}
            out["conv_ln_gelu_bwd"][what] = {"route": "tiled_rows", "rel_err": worst,
                                             "whole_tiled_rel_err": worst_w}
            del fwds, bwds
        del ops, g, plain, pg, whole, wg
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # a rank's call at M 2, bf16, beside the plain version on the same share
    # (a whole call on the share's shape), one library yardstick (the share's
    # product, LayerNorm and GELU; fc2's adds the other rank's partial) and the
    # bound of the share's bytes and operations (fc2's inputs include the
    # other rank's f32 partial, and its backward reads the forward's u)
    own = lambda parts: [torch.stack([parts[0], parts[0]])]
    hl, s2b = hid // 2, 2
    f_ops = split_share(ops_of(c, hid, bf), 0, 2)
    f_g = randn(n, hw, hl).to(dev, bf)
    r_ops = rows_share(ops_of(hid, c, bf), 0, 2)
    r_g = randn(n, hw, c).to(dev, bf)
    _, r_u, r_st = run_split([tcl.rows_forward(*r_ops, (2, 0))], own)[0]
    other = randn(n, hw, c).to(dev)

    def split_library(x, w, b, sc, b2):
        u = F.linear(x, w.t(), b.to(bf))
        return F.gelu(F.layer_norm(u, u.shape[1:], sc.to(bf), b2.to(bf)))

    def rows_library(x, w, b, sc, b2, o):
        u = F.linear(x, w.t()) + (o + b).to(bf)
        return F.gelu(F.layer_norm(u, u.shape[1:], sc.to(bf), b2.to(bf)))

    fv, rv = hl * 4 + 2 * hw * hl * 4, c * 4 + 2 * hw * c * 4
    cases = (
        ("conv_ln_gelu", "tiled_split",
         lambda: run_split([tcl.split_forward(*f_ops, (2, 0))], own)[0],
         lambda: tcl.conv_ln_gelu_plain(*f_ops), split_library, f_ops, None,
         s_rows * (c + hl) * s2b + c * hl * s2b + fv, 2 * s_rows * c * hl),
        ("conv_ln_gelu_bwd", "tiled_split",
         lambda: run_split([tcl.split_backward(*f_ops, f_g, (2, 0))], own)[0],
         lambda: tcl.conv_ln_gelu_backward_plain(*f_ops, f_g), split_library, f_ops, f_g,
         s_rows * (2 * c + hl) * s2b + 2 * c * hl * s2b + 2 * fv + hl * 4, 6 * s_rows * c * hl),
        ("conv_ln_gelu", "tiled_rows",
         lambda: run_split([tcl.rows_forward(*r_ops, (2, 0))], own)[0],
         lambda: tcl.conv_ln_gelu_plain(*r_ops), rows_library, r_ops + (other,), None,
         s_rows * (hl + c) * s2b + 2 * s_rows * c * 4 + hl * c * s2b + rv,
         2 * s_rows * hl * c),
        ("conv_ln_gelu_bwd", "tiled_rows",
         lambda: tcl.rows_backward(*r_ops, r_g, r_u, r_st),
         lambda: tcl.conv_ln_gelu_backward_plain(*r_ops, r_g), rows_library, r_ops + (other,),
         r_g, s_rows * (2 * hl + c) * s2b + s_rows * c * 4 + 2 * hl * c * s2b + 2 * rv + c * 4,
         4 * s_rows * hl * c),
    )
    for name, route, fn, plain, lib, lib_ops, lib_g, nbytes, flops in cases:
        k_ms, p_ms = timed_turns(fn, plain)
        if lib_g is None:
            lib_ms, lib_graph = cuda_ms(lambda: lib(*lib_ops)), graph_ms(lambda: lib(*lib_ops))
        else:
            lib_ms, lib_graph = cuda_ms(grads_of(lib, lib_ops, lib_g)), graph_bwd_ms(
                lib, lib_ops, lib_g)
        b_ms, b_by = bound(nbytes, flops)
        out[name][route] = dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                                library_graph_ms=lib_graph, bound_ms=b_ms, bound_by=b_by,
                                shape=f"{n} x {hw}, " + (f"{c} -> {hl} of {hid}" if route ==
                                                         "tiled_split" else
                                                         f"{hl} of {hid} -> {c}"))
        print(f"  {name} {route} on a rank's share: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
              f"library {lib_ms:.4f} ms (graph {lib_graph if lib_graph is None else round(lib_graph, 4)}), "
              f"bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP)")
    mib = r_u.numel() * r_u.element_size() / 2 ** 20      # the u this run's forward kept
    print(f"  fc2's backward takes the forward's u (N HW x C f32, {mib:.1f} MiB a layer, "
          f"{LAYERS * mib:.1f} MiB over far_mnist's {LAYERS} layers) and statistics, so it needs "
          f"no exchange")
    out["conv_ln_gelu_bwd"]["tiled_rows"]["kept_u_mib_a_layer"] = mib
    return out


# ------------------------------------------------ tensor parallel, mesh.model 4
# phases 55-56: #9/#10's split on a share that ends in a partial tile (and
# #7/#8 on a quarter of the hidden) at far_mnist's step, four ranks in one
# process; far_mnist's fused-FFN route on a (1, 4) mesh (tp_phases, 56)

TP4 = 4                                  # mesh.model of phases 55-56


def tp_quarter_kernel_phase(dev):
    """Phase 55: far_mnist's 2112 hidden channels over mesh.model 4 (528 a
    rank: 16 whole 32-channel tiles and a partial one of 16). #7/#8 on each
    quarter of the hidden columns against their plain versions and,
    summed, the whole call (bf16 and f32, dropout 0 and 0.1); #9/#10 on
    the tiled route split at its statistics, the four ranks run in step in
    one process (run_split), at the step's 190 samples of 8 x 8, bf16 and
    f32, dropout 0 and 0.1: each share against the plain version's slice
    under phase 51's gates, the four together against the whole tiled
    call (within those gates: a whole-call tile straddles two ranks, so not
    the same bits), two calls bit-equal (dw_split_check); then a rank's
    #9/#10 beside its plain version, the library yardstick (eager and
    graph-replayed) and the bound. Returns {kernel name: its readings}."""
    from vptr_tpu_torch.config import get_preset
    from vptr_tpu_torch.ops import fused_dw_chain as tdw

    tc = get_preset("far_mnist").transformer
    c, hid, hw, w = (tc.d_model, tc.spatial_ffn_hidden_ratio * tc.d_model,
                     tc.enc_h * tc.enc_w, tc.enc_w)
    ctx = tc.num_past_frames + tc.num_future_frames
    s_step, n_step, cl = BATCH * (ctx - 1) * hw, BATCH * (ctx - 1), hid // TP4
    phase(f"55. kernels #7-#10 on a quarter of the hidden (tensor parallelism, mesh.model "
          f"{TP4}: {cl} channels a rank, {cl // 32} tiles and a partial one of {cl % 32})")
    bf, f32 = torch.bfloat16, torch.float32
    kseed = torch.tensor([SEED + 5555], dtype=torch.int32, device=dev)
    randn = normals(torch.Generator().manual_seed(SEED + 55))
    out = {n: {} for n in ("fused_ffn", "fused_ffn_bwd", "fused_dw_chain",
                           "fused_dw_chain_bwd")}
    check(tdw.split_ok(hw, cl, w, n_step) and cl % tdw.T_CH != 0,
          f"split_ok takes a {cl}-channel share ({cl % tdw.T_CH} channels in the last tile)")
    for dtype in (bf, f32):
        ops, gout = ffn_ops(randn, dev, dtype, s_step, c, hid), randn(s_step, c).to(dev, dtype)
        for r in (0.0, 0.1):
            ffn_share_check(out, ops, gout, kseed, r, TP4)
        del ops, gout

    def dw_ops(n, dtype):
        return (randn(n, hw, hid).to(dev, dtype), randn(9, hid, std=0.3).to(dev),
                randn(hid, std=0.1).to(dev), (1 + randn(hw, hid, std=0.1)).to(dev),
                randn(hw, hid, std=0.1).to(dev), (1 + randn(hw, hid, std=0.1)).to(dev),
                randn(hw, hid, std=0.1).to(dev))

    for dtype in (bf, f32):
        dn = str(dtype).replace("torch.", "")
        ops, gout = dw_ops(n_step, dtype), randn(n_step, hw, hid).to(dev, dtype)
        for r in (0.0, 0.1):
            (out["fused_dw_chain"][f"{dn} dropout {r}"],
             out["fused_dw_chain_bwd"][f"{dn} dropout {r}"]) = dw_split_check(
                "far_mnist", ops, gout, kseed, w, r, TP4)
        del ops, gout
    torch.cuda.synchronize()

    # a rank's #9 / #10 at the step's 190 samples, bf16, the preset's dropout
    # 0.1 (as phase 51)
    dops = tuple(o[..., :cl].contiguous() for o in dw_ops(n_step, bf))
    time_share_cases(out, dw_share_cases(dops, randn(n_step, hw, cl).to(dev, bf), kseed, w,
                                         tc.dropout, TP4))
    return out


# ---------------------------------------------------------------- the examples
# phase 57: examples/test_vptr_torch.py and examples/test_autoencoder_torch.py
# through their main() on the card

def _example(name):
    """examples/<name>.py as a module (its main() returns what it prints)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_smoke_example_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def example_phase(dev, root, ae_dir=None, far_dir=None):
    """Phase 57: the examples on the card. ``test_vptr_torch.py --mode
    far_rip --max-batches 1 --gif-dir`` on far_mnist's checkpoint (phase
    24's; ``far_dir`` None: a 2-step ``cli train`` here), #1/#2 launches
    counted as phase 25 counts them (evaluate's batch and the GIF
    batch's predict); ``--mode nar`` on nar_mnist's seeded init saved as a
    checkpoint of step 0 (#1, #5, #2 as phase 8's predict; a trained one
    holds NaN, ROADMAP §3);
    ``test_autoencoder_torch.py`` on ae_mnist's checkpoint (phase 23's;
    ``ae_dir`` None: a 2-step ``cli train`` here), which launches none of
    the twelve kernels. Each: the curves or metrics finite, the files
    written where PIL imports. Everything under ``root``. Returns the
    readings."""
    import contextlib
    import importlib.util
    import io

    from vptr_tpu_torch import cli
    from vptr_tpu_torch.config import get_preset
    from vptr_tpu_torch.train.checkpoint import CheckpointManager
    from vptr_tpu_torch.train.trainer import Trainer

    phase("57. the examples on the card: test_vptr_torch.py (far_rip on far_mnist, nar on "
          "nar_mnist) and test_autoencoder_torch.py (ae_mnist)")
    have_pil = importlib.util.find_spec("PIL") is not None
    short = ["--set", "epochs=1", "--set", "steps_per_epoch=2", "--set", "val_per_epochs=4"]
    if ae_dir is None:
        ae_dir = root / "ex_ae"
        cli.main(["train", "--preset", "ae_mnist", "--ckpt-dir", str(ae_dir), *short])
    ae_set = ["--set", f"ae_ckpt={ae_dir / 'ckpt'}"]
    if far_dir is None:
        far_dir = root / "ex_far"
        cli.main(["train", "--preset", "far_mnist", "--ckpt-dir", str(far_dir), *ae_set, *short])
    # nar_mnist's seeded init (on phase 23's autoencoder) as a checkpoint of
    # step 0: its first train step on the card has NaN gradients in the
    # decoder's first block, kernels and plain route alike (ROADMAP §3), so
    # a trained one holds NaN
    nar_dir = root / "ex_nar"
    ncfg = get_preset("nar_mnist").override({"ae_ckpt": str(ae_dir / "ckpt"),
                                             "ckpt_dir": str(nar_dir)})
    CheckpointManager(str(nar_dir / "ckpt")).save(
        0, Trainer(ncfg, device=dev, write_outputs=False).init_state())
    out = {}
    vptr = _example("test_vptr_torch")
    runs = (("far_rip", "far_mnist", far_dir, {"fused_attention_ln": 2 * LAYERS * FUTURE,
                                               "attention_core": 2 * LAYERS * FUTURE}),
            ("nar", "nar_mnist", nar_dir, {"fused_attention_ln": 4, "fused_attention": 8,
                                           "attention_core": 20}))
    for mode, preset, run, want in runs:
        gif_dir = root / f"ex_gifs_{mode}"
        args = ["--preset", preset, "--ckpt-dir", str(run), "--mode", mode, "--max-batches", "1",
                *ae_set] + (["--gif-dir", str(gif_dir)] if mode == "far_rip" else [])
        zero_counters()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            curves = vptr.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print("  " + buf.getvalue().strip().replace("\n", "\n  "))
        got = launch_counts(*want)
        check_counts(got, want, f"test_vptr_torch.py --mode {mode} on {preset}"
                     + (" (evaluate's batch and the GIF batch)" if mode == "far_rip" else ""))
        check(all(len(c) == FUTURE and _finite(c) for c in curves.values())
              and set(curves) == {"psnr", "ssim", "mse"},
              f"test_vptr_torch.py --mode {mode}: psnr, ssim, mse curves finite, {FUTURE} long")
        if mode == "far_rip":
            gifs = sorted(p.name for p in gif_dir.glob("*.gif"))
            check(len(gifs) == 4 if have_pil else "PIL does not import" in buf.getvalue(),
                  f"test_vptr_torch.py --gif-dir: {gifs if have_pil else 'PIL absent, said so'}")
        out[mode] = {"preset": preset, "launches": got, "wall_s": wall,
                     "mean": {m: float(np.mean(c)) for m, c in curves.items()}}
    zero_counters()
    png = root / "ex_recon.png"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ae = _example("test_autoencoder_torch").main(
            ["--preset", "ae_mnist", "--ckpt-dir", str(ae_dir), "--out", str(png)])
    torch.cuda.synchronize()
    print("  " + buf.getvalue().strip().replace("\n", "\n  "))
    counts = launch_counts(*TP_COUNTERS)
    check(_finite(ae.values()) and sum(counts.values()) == 0,
          f"test_autoencoder_torch.py: PSNR {ae['psnr']:.4f}, SSIM {ae['ssim']:.4f} finite; "
          f"none of the twelve kernels launched ({sum(counts.values())})")
    check(png.is_file() if have_pil else "PIL does not import" in buf.getvalue(),
          f"test_autoencoder_torch.py wrote {png.name}" if have_pil else
          "test_autoencoder_torch.py: PIL absent, said so")
    out["autoencoder"] = ae
    return out


# ---------------------------------------------------------------- float16
# phases 58-59: the float16 compute dtype on the default route at full
# width (#1-#6 on their FMA routes; their checks against the plain versions
# and their times are the f16 cases of phases 3, 6, 7 and 10), and its
# times beside bf16's and f32's

F16_TOL, F16_BWD_TOL = 2 ** -7, 2 ** -8     # the f16 gates (bf16's: 2^-4, 2^-5)
F16_NORMAL = 2 ** -14                       # f16's smallest normal magnitude


def _routes_only_fma(what):
    """Every launch of #1-#6 since the counters were zeroed took the FMA
    route: no f16 call reached a bf16 (tensor-core) kernel."""
    from vptr_tpu_torch.ops import fused_window_attention as tfw
    from vptr_tpu_torch.ops.attention_core import attention_core

    by = {}
    for name, w in (("fused_attention_ln", tfw.fused_attention_ln),
                    ("fused_attention", tfw.fused_attention),
                    ("attention_core", attention_core)):
        by[name] = dict(w.launches_by_route)
        by[name + "_bwd"] = dict(w.bwd_launches_by_route)
    tensor_core = sum(n for counts in by.values() for r, n in counts.items() if r != "fma")
    check(tensor_core == 0, f"{what}: every launch of #1-#6 on the FMA route, none on a "
          f"bf16 tensor-core route: {by}")
    return by


def redraw(*modules, seed: int):
    """Every parameter of ``modules`` drawn anew from ``seed`` as the CPU
    parity tests draw theirs (tests/_torch_port_util.py::randomize):
    weights of rank 2 and up normal over sqrt(fan-in), norm scales 1 + 0.1
    normal, every other parameter (biases, tables, queries) 0.1 normal;
    the running statistics kept. Unlike the models' default initializers
    (zero biases), no LayerNorm sees an all-zero input and no decoder
    output is flat, so f16's range holds the FAR step's gradients."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for module in modules:
            for name, p in module.named_parameters():
                noise = torch.randn(p.shape, generator=g)
                if p.dim() >= 2 and name.endswith("weight"):
                    noise = noise / math.sqrt(p[0].numel())
                elif name.endswith("weight"):
                    noise = 1 + 0.1 * noise
                else:
                    noise = 0.1 * noise
                p.copy_(noise.to(p.dtype))


def same_weights(dst, src):
    """``dst`` (the same build functions' modules in f32) given ``src``'s
    parameters and buffers: the step in f32 from the f16 model's weights."""
    for a, b in zip(dst, src):
        a.load_state_dict(b.state_dict())
    return dst


def _grads(module):
    """{name: gradient in f32} of the module's parameters that have one."""
    return {n: p.grad.detach().float() for n, p in module.named_parameters()
            if p.grad is not None}


def _rel_l2(got, want) -> float:
    """|got - want| / |want| over want's leaves as one vector (f64 sums; a
    leaf missing from got counts as 0)."""
    num = sum(float(((got[n].double() if n in got else 0) - w.double()).square().sum())
              for n, w in want.items())
    den = sum(float(w.double().square().sum()) for w in want.values())
    return (num / den) ** 0.5


def f16_default_init_step(kind, cfg, models, past, future):
    """One train step of far_mnist (``kind`` "far") or nar_mnist ("nar") in
    f16 from the default initializers (phases 4/5's and 8/9's seeds),
    beside the same step in f32 on the same weights: ``models`` maps
    "float16" and "float32" to (encoder, decoder, transformer). Each step
    runs on a clone (the modules stay as built). f16 holds magnitudes from
    2^-24 to 65,504 and the step scales no loss (the JAX package has no
    loss scaling): the f16 gradient is finite and non-zero (the leaves that
    are exactly 0 counted, with the f32 step's cotangent at the
    transformer's output beside f16's normal range); or exactly 0 with the
    f16 cotangent at the transformer's output exactly 0 and the f32 step's
    there below 2^-14, f16's smallest normal (underflow: a near-flat random
    decoder passes back cotangents in f16's subnormal range, which its f16
    backward flushes to 0); or not finite where the f32 step's largest
    gradient passes 65,504 (overflow). Any other reading fails. Returns the
    readings."""
    from vptr_tpu_torch.train.optim import build_optimizer
    from vptr_tpu_torch.train.state import create_far_train_state, create_nar_train_state
    from vptr_tpu_torch.train.steps import make_far_train_step, make_nar_train_step

    create, make = ((create_far_train_state, make_far_train_step) if kind == "far"
                    else (create_nar_train_state, make_nar_train_step))
    out = {}
    for name, (enc, dec, tr) in models.items():
        opt = build_optimizer(cfg.optim, cfg.transformer.d_model)
        state = create(enc, dec, tr, opt, seed=SEED + 3).clone()
        seen = []

        def watch(module, inputs, output):      # the cotangent of the transformer's output
            output.register_hook(lambda g: seen.append(g.detach().float().abs().max().item()))

        hook = state.transformer.register_forward_hook(watch)
        state, m = make(enc, dec, tr, opt, cfg.loss)(state, past, future)
        torch.cuda.synchronize()
        hook.remove()
        grads = _grads(state.transformer)
        finite = {n: g for n, g in grads.items() if bool(torch.isfinite(g).all())}
        out[name] = {
            "T_total": float(m["T_total"]), "grad_norm": float(m["grad_norm"]),
            "nonfinite_leaves": len(grads) - len(finite),
            "zero_leaves": sum(not bool(g.any()) for g in finite.values()),
            "leaves": len(grads),
            "largest_grad": max((g.abs().max().item() for g in finite.values()), default=0.0),
            "max_output_cotangent": max(seen, default=float("nan"))}
        del opt, state, grads, finite
    r16, r32 = out["float16"], out["float32"]
    norm = r16["grad_norm"]
    if norm == norm and 0 < norm < float("inf"):
        verdict = (f"finite and non-zero, {r16['zero_leaves']} of {r16['leaves']} leaves "
                   f"exactly 0 (the f32 step's cotangent at the transformer's output "
                   f"{r32['max_output_cotangent']:.3e}, f16's {r16['max_output_cotangent']:.3e}"
                   f"; 2^-14 = {F16_NORMAL:.3e})")
        ok = True
    elif norm == 0:
        verdict = (f"exactly 0 (underflow: the f16 cotangent at the transformer's output "
                   f"{r16['max_output_cotangent']:.3e}, the f32 step's "
                   f"{r32['max_output_cotangent']:.3e} < 2^-14 = {F16_NORMAL:.3e})")
        ok = r16["max_output_cotangent"] == 0 and r32["max_output_cotangent"] < F16_NORMAL
    else:
        verdict = (f"not finite in {r16['nonfinite_leaves']} of {r16['leaves']} leaves "
                   f"(overflow: the f32 step's largest gradient {r32['largest_grad']:.3e} "
                   f"> 65,504)")
        ok = r32["largest_grad"] > 65504
    check(ok, f"{kind}_mnist's f16 step from the default initializers: grad_norm "
          f"{norm:.4e}, {verdict}; f32 on the same weights: grad_norm "
          f"{r32['grad_norm']:.4e}, T_total {r32['T_total']:.6f} (f16 {r16['T_total']:.6f})")
    out["verdict"] = verdict
    return out


def f16_step_gates(train_step, state, step32, models32, past, future, what):
    """step_vs_plain's gates for an f16 stage-2 train step (kernels against
    kernels="plain" from one cloned state: T_total within 2e-3, the
    gradient norm within 5%), then both f16 steps held against the f32 step
    (``step32``, kernels="plain") on ``models32`` (the f32 encoder, decoder
    and transformer) given the state's weights, optimizer moments and
    random stream: the kernels' gradient, as one vector, no farther from
    the f32 step's than 1.5x the plain version's distance + 1e-3 relative
    L2 (the rule tests/test_torch_port_f16.py holds the port's f16 step to
    beside JAX's). Returns the distances."""
    from vptr_tpu_torch.models.layers import use_kernels

    a, b = step_vs_plain(train_step, state, past, future, what)
    enc32, dec32, tr32 = models32
    tr32.load_state_dict(state.transformer.state_dict())
    ref = state.clone()
    ref.enc, ref.dec, ref.transformer = enc32, dec32, tr32
    use_kernels(tr32, "plain")
    ref, m32 = step32(ref, past, future)
    use_kernels(tr32, "cuda")
    g32 = _grads(ref.transformer)
    dk, dp = _rel_l2(_grads(a.transformer), g32), _rel_l2(_grads(b.transformer), g32)
    check(dk <= 1.5 * dp + 1e-3, f"{what}: the gradient against the f32 step's on the same "
          f"weights (grad_norm {float(m32['grad_norm']):.6e}): kernels {dk:.3e} <= 1.5 x "
          f"plain's {dp:.3e} + 1e-3 relative L2")
    del a, b, ref
    return {"kernels_to_f32": dk, "plain_to_f32": dp, "f32_grad_norm": float(m32["grad_norm"])}


def disc_cotangents(disc):
    """Hooks on a discriminator that record, in the backward of D's own
    loss (its first two passes of an AE/GAN step; the generator's term is
    the third), the largest |cotangent| at each conv{n}'s output (n >= 1:
    its norm's input), at each norm{n}'s output and at the logits
    ("head"). Returns (the readings, the hooks' handles)."""
    seen, passes = {}, [0]

    def record(name, t):
        def hook(g):
            if passes[0] <= 2:
                seen[name] = max(seen.get(name, 0.0), g.detach().float().abs().max().item())
        if t.requires_grad:
            t.register_hook(hook)

    def on_norm(n):
        def hook(module, inputs, output):
            record(f"conv{n}", inputs[0])
            record(f"norm{n}", output)
        return hook

    def on_disc(module, inputs, output):
        passes[0] += 1
        record("head", output)

    handles = [getattr(disc, f"norm{n}").register_forward_hook(on_norm(n))
               for n in range(1, disc.n_layers + 1)]
    handles.append(disc.register_forward_hook(on_disc))
    return seen, handles


def f16_phases(dev, card, root):
    """Phases 58-59: float16. 58: the f16 slice at full width (far_mnist's
    far_rip predict and train step, nar_mnist's nar predict and train step
    on phase 8/9's build, the seeded-init NAR first step through the
    Trainer, one ae_mnist AE/GAN step from the default initializers beside
    the f32 step on the same weights, ``cli train --set dtype=float16`` on
    phase 23's autoencoder and ``cli predict`` from it, under ``root``); 59:
    far_rip and the FAR and NAR steps in f16, bf16 and f32 in turns.
    Returns ({"launches" | "train_step_launches": {kernel: count}} for
    #1-#6's f16 rows, extra readings, a summary line)."""
    import contextlib
    import io
    from contextlib import closing

    from vptr_tpu_torch import cli
    from vptr_tpu_torch.config import get_preset
    from vptr_tpu_torch.data.loader import build_loader
    from vptr_tpu_torch.eval.harness import make_predict_fn
    from vptr_tpu_torch.models.autoencoder import build_autoencoder
    from vptr_tpu_torch.models.discriminator import build_discriminator
    from vptr_tpu_torch.models.transformer import build_transformer
    from vptr_tpu_torch.train.optim import build_optimizer
    from vptr_tpu_torch.train.state import (
        create_ae_train_state,
        create_far_train_state,
        create_nar_train_state,
    )
    from vptr_tpu_torch.train.steps import (
        make_ae_train_step,
        make_far_train_step,
        make_nar_train_step,
    )
    from vptr_tpu_torch.train.trainer import Trainer

    f16, bf, f32 = torch.float16, torch.bfloat16, torch.float32
    cfg = get_preset("far_mnist").override({"dtype": "float16"})
    ncfg = get_preset("nar_mnist").override({"dtype": "float16"})
    assert compute_dtype(cfg) == f16 == compute_dtype(ncfg)
    tc, ntc = cfg.transformer, ncfg.transformer
    c = tc.d_model
    tt = PAST + FUTURE - 1
    nbatch = ncfg.data.batch_size

    phase("58. float16 at full width: far_mnist far_rip predict and train step, nar_mnist "
          "nar predict and train step, the seeded-init NAR step, an ae_mnist AE/GAN step, "
          "cli train --set dtype=float16 and cli predict")
    extra = {}
    enc, dec = build_autoencoder(cfg.ae, f16, dev, torch.Generator().manual_seed(SEED))
    tr = build_transformer(tc, f16, dev, torch.Generator().manual_seed(SEED + 1))
    frames = torch.rand(BATCH, PAST + FUTURE, 64, 64, 1,
                        generator=torch.Generator().manual_seed(SEED + 2))
    past, future = frames[:, :PAST], frames[:, PAST:]
    predict = make_predict_fn(cfg, enc, dec, tr, "far_rip", FUTURE, dev)
    want = LAYERS * FUTURE
    _, far_pred = counted_predict(predict, (past,), {"fused_attention_ln": want,
                                                     "attention_core": want},
                                  (BATCH, FUTURE, 64, 64, 1), "f16 far_rip")
    _routes_only_fma("the f16 far_rip predict")
    far = make_predict_fn(cfg, enc, dec, tr, "far", FUTURE, dev)
    predict_vs_plain(far, (past, future), tr, far(past, future), "f16 far mode")
    tpast, tfuture = past.to(dev), future.to(dev)
    e32, d32 = build_autoencoder(cfg.ae, f32, dev, torch.Generator().manual_seed(SEED))
    far32 = same_weights((e32, d32, build_transformer(tc, f32, dev, torch.Generator()
                                                      .manual_seed(SEED + 1))), (enc, dec, tr))
    extra["far_default_init_step"] = f16_default_init_step(
        "far", cfg, {"float16": (enc, dec, tr), "float32": far32}, tpast, tfuture)
    # the FAR train-step gates (and phase 59's times) on weights drawn anew:
    # from the default initializers f16 keeps 2 of the FAR step's 482
    # gradient leaves (PERF.md §6)
    redraw(enc, dec, tr, seed=SEED + 62)
    same_weights(far32, (enc, dec, tr))
    opt = build_optimizer(cfg.optim, c)
    state = create_far_train_state(enc, dec, tr, opt, seed=SEED + 3)
    far_step = make_far_train_step(enc, dec, tr, opt, cfg.loss)
    state, far_launches = counted_step(
        far_step, state, tpast, tfuture,
        {k: LAYERS for k in ("fused_attention_ln", "attention_core", "fused_attention_ln_bwd",
                             "attention_core_bwd")}, "f16 FAR train step")
    _routes_only_fma("the f16 FAR step")
    e32, d32 = build_autoencoder(cfg.ae, f32, dev, torch.Generator().manual_seed(SEED))
    twin = same_weights((e32, d32, build_transformer(tc, f32, dev)), (enc, dec, tr))
    opt32 = build_optimizer(cfg.optim, c)
    create_far_train_state(*twin, opt32)        # frozen autoencoder, as the state's
    extra["far_step_against_f32"] = f16_step_gates(
        far_step, state, make_far_train_step(*twin, opt32, cfg.loss), twin, tpast, tfuture,
        "f16 FAR step")
    del twin
    loss_falls(far_step, state, tpast, tfuture, "f16 FAR")
    far_models = (state, far_step, predict, tpast, tfuture, past, far32)

    nenc, ndec = build_autoencoder(ncfg.ae, f16, dev, torch.Generator().manual_seed(SEED))
    ntr = build_transformer(ntc, f16, dev, torch.Generator().manual_seed(SEED + 1))
    n_past, n_fut = ntc.num_past_frames, ntc.num_future_frames
    nframes = torch.rand(nbatch, n_past + n_fut, 64, 64, 1,
                         generator=torch.Generator().manual_seed(SEED + 2))
    npast, nfuture = nframes[:, :n_past].to(dev), nframes[:, n_past:].to(dev)
    npredict = make_predict_fn(ncfg, nenc, ndec, ntr, "nar", n_fut, dev)
    enc_l, dec_l = ntc.num_encoder_layers, ntc.num_decoder_layers
    pred, nar_pred = counted_predict(
        npredict, (npast,), {"fused_attention_ln": enc_l, "fused_attention": dec_l,
                             "attention_core": enc_l + 2 * dec_l},
        (nbatch, n_fut, 64, 64, 1), "f16 nar predict")
    _routes_only_fma("the f16 nar predict")
    predict_vs_plain(npredict, (npast,), ntr, pred, "f16 nar predict")
    e32, d32 = build_autoencoder(ncfg.ae, f32, dev, torch.Generator().manual_seed(SEED))
    nar32 = same_weights((e32, d32, build_transformer(ntc, f32, dev, torch.Generator()
                                                      .manual_seed(SEED + 1))),
                         (nenc, ndec, ntr))
    extra["nar_default_init_step"] = f16_default_init_step(
        "nar", ncfg, {"float16": (nenc, ndec, ntr), "float32": nar32}, npast, nfuture)
    # the NAR train-step gates on phase 8/9's build itself: its first step
    # counted, the gates on the second (as phase 9; the f32 first step from
    # this build is not a reference: its gradient norm is ~1e10, the NCE
    # head's L2-normalised near-zero features, ROADMAP §3)
    nopt = build_optimizer(ncfg.optim, c)
    nstate = create_nar_train_state(nenc, ndec, ntr, nopt, seed=SEED + 3)
    nar_step = make_nar_train_step(nenc, ndec, ntr, nopt, ncfg.loss)
    nstate, nar_launches = counted_step(
        nar_step, nstate, npast, nfuture,
        {"fused_attention_ln": enc_l, "fused_attention_ln_bwd": enc_l,
         "fused_attention": dec_l, "fused_attention_bwd": dec_l,
         "attention_core": enc_l + 2 * dec_l, "attention_core_bwd": enc_l + 2 * dec_l},
        "f16 NAR train step")
    _routes_only_fma("the f16 NAR step")
    nopt32 = build_optimizer(ncfg.optim, c)
    create_nar_train_state(*nar32, nopt32)      # frozen autoencoder, as the state's
    extra["nar_step_against_f32"] = f16_step_gates(
        nar_step, nstate, make_nar_train_step(*nar32, nopt32, ncfg.loss), nar32, npast,
        nfuture, "f16 NAR step")
    loss_falls(nar_step, nstate, npast, nfuture, "f16 NAR")
    nar_models = (nstate, nar_step, npast, nfuture, nar32)

    # the seeded init's first step (ROADMAP §3 "To check" 3): reported, not gated
    trainer = Trainer(ncfg.override({"mesh": {"data": 1, "model": 1}}), device=dev,
                      write_outputs=False)
    st = trainer.init_state()
    with closing(iter(build_loader(ncfg.data, split="train", seed=ncfg.seed))) as batches:
        bp, bfut = next(batches)
    st, m = trainer.train_step(st, *trainer.put_batch(bp, bfut))
    torch.cuda.synchronize()
    grads = [(n, p.grad) for n, p in st.transformer.named_parameters() if p.grad is not None]
    bad = [n for n, g in grads if not bool(torch.isfinite(g).all())]
    seeded = {"nonfinite_leaves": len(bad), "leaves": len(grads), "first": bad[:4],
              "T_total": float(m["T_total"]), "grad_norm": float(m["grad_norm"])}
    del trainer, st, grads
    print(f"  nar_mnist's seeded-init first step in f16 (Trainer init, the first synthetic "
          f"batch, batch {nbatch}; not gated): {seeded}")
    extra["nar_seeded_init_first_step"] = seeded

    # ae_mnist: one AE/GAN step from the default initializers in f16 and in
    # f32 on the same weights
    acfg = get_preset("ae_mnist").override({"dtype": "float16"})
    ab, ap, af = (acfg.data.batch_size, acfg.data.num_past_frames,
                  acfg.data.num_future_frames)
    aframes = moving_squares(ab, ap + af, 64, torch.Generator().manual_seed(SEED + 33))
    apast, afuture = aframes[:, :ap].to(dev), aframes[:, ap:].to(dev)
    a16 = build_autoencoder(acfg.ae, f16, dev, torch.Generator().manual_seed(SEED + 30)) + (
        build_discriminator(acfg.disc, f16, dev, torch.Generator().manual_seed(SEED + 31)),)
    a32 = same_weights(build_autoencoder(acfg.ae, f32, dev, torch.Generator().manual_seed(
        SEED + 30)) + (build_discriminator(acfg.disc, f32, dev, torch.Generator().manual_seed(
            SEED + 31)),), a16)
    names = ("enc", "dec", "disc")

    def ae_step_from(mods, what):
        """One AE/GAN step from ``mods``' weights: (metrics, the state, the
        step, the parameters it moved of each module, D's gradients, D's
        cotangents, launches of the twelve)."""
        g_opt, d_opt = build_optimizer(acfg.optim), build_optimizer(acfg.optim_d)
        step = make_ae_train_step(*mods, g_opt, d_opt, acfg.loss)
        st = create_ae_train_state(*mods, g_opt, d_opt, seed=SEED + 32)
        held = (st.enc, st.dec, st.disc)
        before = {n: [p.detach().clone() for p in mod.parameters()]
                  for n, mod in zip(names, held)}
        seen, hooks = disc_cotangents(st.disc)
        zero_counters()
        st, m = step(st, apast, afuture)
        torch.cuda.synchronize()
        for h in hooks:
            h.remove()
        moved = {n: sum(not torch.equal(p, q) for p, q in zip(mod.parameters(), before[n]))
                 for n, mod in zip(names, held)}
        print(f"  ae_mnist AE/GAN step ({what}; batch {ab} x {ap + af}): "
              f"{ {k: round(float(v), 6) for k, v in m.items()} }; parameters moved {moved}; "
              f"D's largest cotangents in its own backward "
              f"{ {k: float(f'{v:.3e}') for k, v in seen.items()} }")
        return m, st, step, moved, _grads(st.disc), seen, launch_counts(*TP_COUNTERS)

    am, astate, ae_step, moved, g16, cot16, ae_counts = ae_step_from(
        a16, "f16, the default initializers")
    _, _, _, _, g32, cot32, _ = ae_step_from(a32, "f32 on the same weights")
    total = {n: sum(1 for _ in mod.parameters()) for n, mod in zip(names, a16)}
    check(all(bool(torch.isfinite(v)) for v in am.values()) and float(am["Dtotal"]) > 0,
          f"f16 AE step: metrics finite, Dtotal {float(am['Dtotal']):.6f} > 0")
    check(moved["enc"] == total["enc"] and moved["dec"] == total["dec"]
          and sum(ae_counts.values()) == 0,
          f"f16 AE step: every encoder and decoder parameter moved ({moved} of {total}); "
          f"none of the twelve kernels launched (cuDNN / ATen)")
    # D's loss is lam_gan 0.01 x a mean over 640 frames' patches: its
    # cotangents start near f16's subnormal floor. A D leaf with an exactly-0
    # f16 gradient passes only where the f32 step on the same weights gives
    # every D leaf a non-zero gradient (D's gradient path whole) and, at its
    # layer's output or a later one on the way to the logits, the f16
    # cotangent is exactly 0 where the f32 one is non-zero and below 2^-14
    # (underflow: a zero cotangent there zeroes every gradient before it)
    f32_dead = [n for n, g in g32.items() if not (bool(g.any()) and bool(torch.isfinite(g).all()))]
    check(len(g32) == total["disc"] and not f32_dead,
          f"the f32 AE step on the same weights gives every one of D's {total['disc']} "
          f"parameters a finite non-zero gradient ({len(g32)} with a gradient; 0 or not "
          f"finite: {f32_dead})")
    zero = [n for n, g in g16.items() if not bool(g.any())]
    layers = (["conv0"] + [f"{k}{n}" for n in range(1, a16[2].n_layers + 1)
                           for k in ("conv", "norm")] + ["head"])

    def underflow(leaf):
        """The first point from the leaf's layer to the logits where the f16
        cotangent is exactly 0 and the f32 one non-zero below 2^-14."""
        after = layers[layers.index(leaf.split(".")[0]):]
        return next(((k, cot32[k]) for k in after if cot16.get(k) == 0
                     and 0 < cot32.get(k, 0) < F16_NORMAL), None)

    witness = {n: underflow(n) for n in zero}
    unexplained = [n for n, w in witness.items() if w is None]
    check(moved["disc"] + len(zero) == total["disc"] and not unexplained,
          f"f16 AE step: D moved {moved['disc']} of {total['disc']} parameters; each of the "
          f"other {len(zero)} has an exactly-0 f16 gradient behind a point where the f16 "
          f"cotangent is 0 and the f32 one below 2^-14 = {F16_NORMAL:.3e} (underflow): "
          f"{witness}; unexplained: {unexplained}")
    extra["ae_disc"] = {"moved": moved["disc"], "of": total["disc"], "zero_f16_grad": witness}
    fixed, losses = astate.clone(), []
    for _ in range(TRAIN_STEPS):
        fixed, mm = ae_step(fixed, apast, afuture)
        losses.append(float(mm["AE_total"]))
    print(f"  f16 AE_total over {TRAIN_STEPS} steps on one batch: "
          f"{[round(x, 6) for x in losses]}")
    check(_finite(losses) and losses[-1] < losses[0], f"f16 AE_total finite and falls over "
          f"{TRAIN_STEPS} steps: {losses[0]:.6f} -> {losses[-1]:.6f}")
    del a16, a32, astate, ae_step, fixed, g16, g32
    gc.collect()
    torch.cuda.empty_cache()

    f16_dir = root / "far_f16"
    sets = ["--set", "dtype=float16", "--set", f"ae_ckpt={root / 'ae' / 'ckpt'}"]
    cli.main(["train", "--preset", "far_mnist", "--ckpt-dir", str(f16_dir), *sets,
              "--set", "epochs=1", "--set", "steps_per_epoch=2", "--set", "val_per_epochs=4"])
    hist = _history(f16_dir)
    check((f16_dir / "ckpt" / "2" / "state.pt").is_file() and _finite(hist["train"].values()),
          f"cli train --preset far_mnist --set dtype=float16: 2 steps, ckpt/2/ written, "
          f"losses finite: {hist['train']}")
    config = json.loads((f16_dir / "ckpt" / "config.json").read_text())
    check(config.get("dtype") == "float16", f"the run's config.json dtype {config.get('dtype')}")
    zero_counters()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["predict", "--preset", "far_mnist", "--ckpt-dir", str(f16_dir), *sets,
                  "--mode", "far_rip", "--batches", "1", "--out", str(root / "f16_preds")])
    torch.cuda.synchronize()
    print("  " + buf.getvalue().strip().replace("\n", "\n  "))
    check_counts(launch_counts("fused_attention_ln", "attention_core"),
                 {"fused_attention_ln": want, "attention_core": want},
                 "cli predict far_rip in f16 (1 batch)")
    _routes_only_fma("cli predict in f16")
    gc.collect()
    torch.cuda.empty_cache()

    phase("59. float16 timing: far_rip predict and the FAR and NAR train steps in f16, "
          "bf16 and f32, in turns")
    times = {}
    state, far_step, predict, tpast, tfuture, past, far32 = far_models
    paths = {"float16": (predict, far_step, state)}
    for name, dt in (("bfloat16", bf), ("float32", f32)):
        if dt == f32:
            e, d, t = far32                         # phase 58's f16 weights
        else:
            e, d = build_autoencoder(cfg.ae, dt, dev, torch.Generator().manual_seed(SEED))
            t = build_transformer(tc, dt, dev, torch.Generator().manual_seed(SEED + 1))
            same_weights((e, d, t), far32)
        o = build_optimizer(cfg.optim, c)
        paths[name] = (make_predict_fn(cfg.override({"dtype": name}), e, d, t, "far_rip",
                                       FUTURE, dev),
                       make_far_train_step(e, d, t, o, cfg.loss),
                       create_far_train_state(e, d, t, o, seed=SEED + 3))
    order = list(paths)
    for i in range(3):                          # the first round warms up
        for name in (order if i % 2 == 0 else order[::-1]):
            p, stp, st = paths[name]
            ms = host_ms(lambda: p(past))
            sms = host_ms(lambda: stp(st, tpast, tfuture))
            if i:
                times.setdefault(f"far_rip_{name}", []).append(ms)
                times.setdefault(f"far_step_{name}", []).append(sms)
    del paths, far_models, far32, enc, dec, tr, state, far_step, predict
    gc.collect()
    torch.cuda.empty_cache()
    nstate, nar_step, npast, nfuture, nar32 = nar_models
    paths = {"float16": (nar_step, nstate)}
    for name, dt in (("bfloat16", bf), ("float32", f32)):
        if dt == f32:
            e, d, t = nar32                         # phase 58's f32 twin
        else:
            e, d = build_autoencoder(ncfg.ae, dt, dev, torch.Generator().manual_seed(SEED))
            t = build_transformer(ntc, dt, dev, torch.Generator().manual_seed(SEED + 1))
        o = build_optimizer(ncfg.optim, c)
        paths[name] = (make_nar_train_step(e, d, t, o, ncfg.loss),
                       create_nar_train_state(e, d, t, o, seed=SEED + 3))
    for i in range(3):
        for name in (order if i % 2 == 0 else order[::-1]):
            stp, st = paths[name]
            ms = host_ms(lambda: stp(st, npast, nfuture))
            if i:
                times.setdefault(f"nar_step_{name}", []).append(ms)
    del paths, nar_models, nar32, nenc, ndec, ntr, nstate, nar_step, npredict
    gc.collect()
    torch.cuda.empty_cache()
    med = {k: statistics.median(v) for k, v in times.items()}
    for what, frames_n in (("far_rip", BATCH * FUTURE), ("far_step", BATCH * tt),
                           ("nar_step", nbatch * n_fut)):
        print(f"  {card}: {what} " + ", ".join(
            f"{d} {med[f'{what}_{d}']:.3f} ms ({frames_n / med[f'{what}_{d}'] * 1e3:.1f} "
            f"frames/s; {[round(x, 3) for x in times[f'{what}_{d}']]})" for d in order))
    extra["times_ms"] = med
    counts = {
        "launches": {"fused_attention_ln": far_pred["fused_attention_ln"],
                     "attention_core": far_pred["attention_core"],
                     "fused_attention_ln_bwd": far_launches["fused_attention_ln_bwd"],
                     "attention_core_bwd": far_launches["attention_core_bwd"],
                     "fused_attention": nar_pred["fused_attention"],
                     "fused_attention_bwd": nar_launches["fused_attention_bwd"]},
        "train_step_launches": {**{k: far_launches[k] for k in (
            "fused_attention_ln", "attention_core", "fused_attention_ln_bwd",
            "attention_core_bwd")}, **{k: nar_launches[k] for k in (
                "fused_attention", "fused_attention_bwd")}}}
    extra.update(far_step_launches=far_launches, nar_predict_launches=nar_pred,
                 nar_step_launches=nar_launches)
    summary = " ".join(f"{k} {v:.3f}" for k, v in med.items())
    return counts, extra, summary


# ---------------------------------------------------------------- nar_kth_128
# phases 45-50: kernels #9-#12 on their tiled routes at the 16 x 16 latent,
# nar_kth_128 at full width on three routes, and its entry points

KTH = "nar_kth_128"
KTH_ROUTES = (("default route", {}),
              ("fused-FFN route", {"fused_ffn": True, "fused_dw": True}),
              ("conv-FFN route", {"fused_conv_ffn": True, "fused_full_temporal": True}))


def kth_launches(tc, flags, step):
    """The kernels' launches in one NAR forward of ``tc``'s model on the
    route ``flags`` (one nar call), and with ``step`` in one train step
    (the backward once each too). They follow from the blocks
    (models/transformer.py), not from HW, so they are nar_mnist's on the
    same route. An encoder block: the window attention with its LayerNorm
    (#1), the temporal attention (#2; #1 folded on the conv-FFN route), the
    linear FFN (#7 on the fused-FFN route), the BatchNorm conv FFN (no
    kernel). A decoder block: the two-stream window attention (#5), the
    temporal self-attention (#2; #1 folded), the enc-dec attention (#2),
    the linear FFN (#7), two LayerNorm conv FFNs (#9 each on the fused-FFN
    route; #11 at fc1 and fc2 each on the conv-FFN route)."""
    e, d = tc.num_encoder_layers, tc.num_decoder_layers
    if flags.get("fused_conv_ffn"):
        want = {"fused_attention_ln": 2 * e + d, "fused_attention": d, "attention_core": d,
                "conv_ln_gelu": 4 * d}
    else:
        want = {"fused_attention_ln": e, "fused_attention": d, "attention_core": e + 2 * d}
        if flags.get("fused_ffn"):
            want.update(fused_ffn=e + d, fused_dw_chain=2 * d)
    if step:
        want.update({f"{k}_bwd": v for k, v in list(want.items())})
    return want


def check_tanh_frames(pred, shape, what):
    """The frames' shape, finite, and in the tanh output layer's [-1, 1]."""
    check(tuple(pred.shape) == shape, f"{what} output shape {tuple(pred.shape)} == {shape}")
    check(bool(torch.isfinite(pred.float()).all()), f"{what} output finite")
    lo, hi = pred.float().min().item(), pred.float().max().item()
    check(-1.0 <= lo and hi <= 1.0, f"{what} output in [-1, 1] ({lo:.4f}, {hi:.4f})")


def kth_kernel_phases(dev):
    """Phases 45-46: kernels #9-#12 at nar_kth_128's shapes (80 decoder
    samples of 16 x 16 positions; #9/#10 at the hidden 2112 on a 16-wide
    grid, #11/#12 at fc1 528 -> 2112 and fc2 2112 -> 528) against their
    plain versions, bf16 and f32, dropout 0 and 0.1, two calls bit-equal,
    on the routes the route functions name; then their times beside the
    plain versions, a library yardstick (eager and graph-replayed) and the
    bound. Returns {row name: readings}."""
    import torch.nn.functional as F

    from vptr_tpu_torch.config import get_preset
    from vptr_tpu_torch.ops import conv_ln_gelu as tcl
    from vptr_tpu_torch.ops import fused_dw_chain as tdw

    cfg = get_preset(KTH)
    tc = cfg.transformer
    c, h, w = tc.d_model, tc.enc_h, tc.enc_w
    hid, hw = tc.spatial_ffn_hidden_ratio * c, h * w
    n = cfg.data.batch_size * tc.num_future_frames        # 80: the decoder's samples
    rate = tc.dropout
    bf, f32 = torch.bfloat16, torch.float32
    tol = {f32: 1e-3, bf: 6.25e-2}                       # as phase 3
    bwd_tol = {f32: 1e-4, bf: 2 ** -5}
    randn = normals(torch.Generator().manual_seed(SEED + 45))
    kseed = torch.tensor([SEED + 4545], dtype=torch.int32, device=dev)
    stages = {"fc1": (c, hid), "fc2": (hid, c)}
    dw_names = ("dx", "dtaps", "ddwb", "ds1", "db1", "ds2", "db2")
    cl_names = ("dx", "dw", "db", "dscale", "dbias2")

    def dw_ops(dtype):
        return (randn(n, hw, hid).to(dev, dtype), randn(9, hid, std=0.3).to(dev),
                randn(hid, std=0.1).to(dev), (1 + randn(hw, hid, std=0.1)).to(dev),
                randn(hw, hid, std=0.1).to(dev), (1 + randn(hw, hid, std=0.1)).to(dev),
                randn(hw, hid, std=0.1).to(dev))

    def conv_ops(cin, cout, dtype):
        return (randn(n, hw, cin).to(dev, dtype), randn(cin, cout, std=cin ** -0.5).to(dev, dtype),
                randn(cout, std=0.1).to(dev), (1 + randn(hw, cout, std=0.1)).to(dev),
                randn(hw, cout, std=0.1).to(dev))

    phase(f"45. kernels #9-#12 at {KTH}'s 16 x 16 latent against their plain versions (card)")
    routes = {}
    for dtype in (bf, f32):
        dn = str(dtype).replace("torch.", "")
        routes[dn] = {"fused_dw_chain": tdw.kernel_route(hw, hid, dtype, w),
                      "fused_dw_chain_bwd": tdw.backward_route(hw, hid, dtype, w),
                      **{f"conv_ln_gelu {st}": tcl.kernel_route(hw, ci, co, dtype)
                         for st, (ci, co) in stages.items()}}
    print(f"  routes the route functions name: {routes}")
    errs = {}
    for dtype in (bf, f32):
        dn = str(dtype).replace("torch.", "")
        ops, gd = dw_ops(dtype), randn(n, hw, hid).to(dev, dtype)
        for r in (0.0, rate):
            got = tdw.fused_dw_chain(*ops, kseed, w, r)
            e = max_err(got, tdw.fused_dw_chain_plain(*ops, kseed, w, r))
            check(e <= tol[dtype], f"fused_dw_chain {dn} dropout {r} {tuple(ops[0].shape)} w {w} "
                  f"({routes[dn]['fused_dw_chain']}) max|err| {e:.3e} <= {tol[dtype]}")
            check(torch.equal(got, tdw.fused_dw_chain(*ops, kseed, w, r)),
                  f"fused_dw_chain {dn} dropout {r}: two calls give the same bits")
            got = tdw.fused_dw_chain_backward(*ops, kseed, gd, w, r)
            want = tdw.fused_dw_chain_backward_plain(*ops, kseed, gd, w, r)
            n_worst, worst = worst_rel(got, want, dw_names)
            check(worst <= bwd_tol[dtype], f"fused_dw_chain backward {dn} dropout {r} "
                  f"({routes[dn]['fused_dw_chain_bwd']}) worst {n_worst} rel err {worst:.2e} "
                  f"<= {bwd_tol[dtype]:.2e}")
            again = tdw.fused_dw_chain_backward(*ops, kseed, gd, w, r)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"fused_dw_chain backward {dn} dropout {r}: two calls give the same bits")
            if dtype == bf:
                errs[("fused_dw_chain", r)] = e
                errs[("fused_dw_chain_bwd", r)] = max(max_err(a, b) for a, b in zip(got, want))
            del got, want, again
        del ops, gd
        for st, (ci, co) in stages.items():
            ops, gc_ = conv_ops(ci, co, dtype), randn(n, hw, co).to(dev, dtype)
            got = tcl.conv_ln_gelu(*ops)
            e = max_err(got, tcl.conv_ln_gelu_plain(*ops))
            route = routes[dn][f"conv_ln_gelu {st}"]
            check(e <= tol[dtype], f"conv_ln_gelu {dn} {st} {tuple(ops[0].shape)} -> {co} "
                  f"({route}) max|err| {e:.3e} <= {tol[dtype]}")
            check(torch.equal(got, tcl.conv_ln_gelu(*ops)),
                  f"conv_ln_gelu {dn} {st}: two calls give the same bits")
            got = tcl.conv_ln_gelu_backward(*ops, gc_)
            want = tcl.conv_ln_gelu_backward_plain(*ops, gc_)
            n_worst, worst = worst_rel(got, want, cl_names)
            check(worst <= bwd_tol[dtype], f"conv_ln_gelu backward {dn} {st} ({route}) worst "
                  f"{n_worst} rel err {worst:.2e} <= {bwd_tol[dtype]:.2e}")
            again = tcl.conv_ln_gelu_backward(*ops, gc_)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"conv_ln_gelu backward {dn} {st}: two calls give the same bits")
            if dtype == bf:
                errs[("conv_ln_gelu", st)] = e
                errs[("conv_ln_gelu_bwd", st)] = max(max_err(a, b) for a, b in zip(got, want))
            del ops, gc_, got, want, again
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    phase(f"46. kernels #9-#12 at {KTH}'s shapes: times beside the plain versions, the "
          f"library and the bound (bf16)")

    def dw_library(x, taps, dwb, s1, b1, s2, b2):
        img = x.view(n, h, w, hid).permute(0, 3, 1, 2)
        aff = lambda p: p.t().reshape(hid, h, w).to(bf)
        z = F.gelu(F.layer_norm(img, img.shape[1:], aff(s1), aff(b1)))
        z = F.conv2d(z, taps.t().reshape(hid, 1, 3, 3).to(bf), dwb.to(bf), padding=1, groups=hid)
        return F.gelu(F.layer_norm(z, z.shape[1:], aff(s2), aff(b2)))

    def conv_library(x, wt, b, scale, bias2):
        u = F.linear(x, wt.t(), b.to(bf))
        return F.gelu(F.layer_norm(u, u.shape[1:], scale.to(bf), bias2.to(bf)))

    readings = {}

    def timed(key, fn, plain, lib, lib_bwd_ops, nbytes, flops, fdt):
        k_ms, p_ms = timed_turns(fn, plain)
        b_ms, b_by = bound(nbytes, flops, fdt)
        if lib_bwd_ops is None:
            lib_ms, lib_graph = cuda_ms(lib), graph_ms(lib)
        else:
            lib_ms = cuda_ms(grads_of(*lib_bwd_ops))
            lib_graph = graph_bwd_ms(*lib_bwd_ops)
        readings[key] = dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                             library_graph_ms=lib_graph, bound_ms=b_ms, bound_by=b_by)
        print(f"  {' '.join(key)}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, library "
              f"{lib_ms:.4f} ms (graph-replayed {lib_graph}), bound {b_ms:.4f} ms ({b_by}: "
              f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP "
              f"{str(fdt).replace('torch.', '')})")

    d, s2b = n * hw * hid, 2
    ops, gd = dw_ops(bf), randn(n, hw, hid).to(dev, bf)
    # as phase 14: ~80 f32 operations an element forward, ~210 backward
    timed(("fused_dw_chain", KTH), lambda: tdw.fused_dw_chain(*ops, kseed, w, 0.0),
          lambda: tdw.fused_dw_chain_plain(*ops, kseed, w, 0.0), lambda: dw_library(*ops), None,
          2 * d * s2b + (10 * hid + 4 * hw * hid) * 4, 80 * d, f32)
    timed(("fused_dw_chain_bwd", KTH),
          lambda: tdw.fused_dw_chain_backward(*ops, kseed, gd, w, rate),
          lambda: tdw.fused_dw_chain_backward_plain(*ops, kseed, gd, w, rate), None,
          (dw_library, ops, gd.view(n, h, w, hid).permute(0, 3, 1, 2)),
          3 * d * s2b + (20 * hid + 8 * hw * hid) * 4, 210 * d, f32)
    del ops, gd
    for st, (ci, co) in stages.items():
        ops, gc_ = conv_ops(ci, co, bf), randn(n, hw, co).to(dev, bf)
        rows, vecs = n * hw, co * 4 + 2 * hw * co * 4
        timed(("conv_ln_gelu", st), lambda: tcl.conv_ln_gelu(*ops),
              lambda: tcl.conv_ln_gelu_plain(*ops), lambda: conv_library(*ops), None,
              rows * (ci + co) * s2b + ci * co * s2b + vecs, 2 * rows * ci * co, bf)
        timed(("conv_ln_gelu_bwd", st), lambda: tcl.conv_ln_gelu_backward(*ops, gc_),
              lambda: tcl.conv_ln_gelu_backward_plain(*ops, gc_), None,
              (conv_library, ops, gc_),
              rows * (2 * ci + co) * s2b + 2 * ci * co * s2b + 2 * vecs + co * 4,
              6 * rows * ci * co, bf)
        del ops, gc_
    torch.cuda.empty_cache()
    out = {}
    for name in ("fused_dw_chain", "fused_dw_chain_bwd"):
        out[name] = {**readings[(name, KTH)],
                     "max_abs_err": errs[(name, 0.0 if name == "fused_dw_chain" else rate)],
                     "route": routes["bfloat16"][name], "f32_route": routes["float32"][name],
                     "shape": [n, hw, hid], "grid_w": w}
    for name in ("conv_ln_gelu", "conv_ln_gelu_bwd"):
        out[name] = {**readings[(name, "fc1")], "max_abs_err": errs[(name, "fc1")],
                     "route": routes["bfloat16"]["conv_ln_gelu fc1"],
                     "shape": [n, hw, c, hid],
                     "fc2_stage": {**readings[(name, "fc2")], "max_abs_err": errs[(name, "fc2")]}}
    return out


def kth_batches(cfg, dev):
    """One batch of the synthetic KTH-shaped loader's train split (Tp + Tf
    frames) and one of its test split (Tp + test_future_frames), on the
    card."""
    import contextlib

    from vptr_tpu_torch.data.loader import build_loader

    put = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    out = []
    for split in ("train", "test"):
        with contextlib.closing(iter(build_loader(cfg.data, split=split, seed=cfg.seed))) as it:
            past, future = next(it)
        out.append((put(past), put(future)))
    return out


def kth_route_phase(dev, number, label, flags, train, test):
    """Phase ``number``: nar_kth_128 at full width (AE ngf 64 / feat 528 at
    128 x 128 x 1, NAR 4 + 8 blocks at d 528, 8 heads, RPE, bf16; seeded
    random weights) on a route: the nar predict 10 -> 10 with every counter
    at 0 just before and read just after (kth_launches), its frames against
    kernels="plain"; 10 -> 40 through nar_rollout (four NAR calls: four
    times the launches), 8 x 40 frames of 128 x 128 x 1 finite and in
    [-1, 1]; the train step's launches, the step against kernels="plain"
    (phase 5's gates; on the fused routes on the batch's first
    KTH_PLAIN_ROWS clips) and TRAIN_STEPS steps on one batch with a falling loss; the
    predict's and the step's ms, frames/s and memory peak. Returns the
    readings."""
    from vptr_tpu_torch.config import get_preset
    from vptr_tpu_torch.eval.harness import make_predict_fn
    from vptr_tpu_torch.models.autoencoder import build_autoencoder
    from vptr_tpu_torch.models.layers import use_kernels
    from vptr_tpu_torch.models.transformer import build_transformer
    from vptr_tpu_torch.train.optim import build_optimizer
    from vptr_tpu_torch.train.state import create_nar_train_state
    from vptr_tpu_torch.train.steps import make_nar_train_step

    cfg = get_preset(KTH).override({"transformer": flags}) if flags else get_preset(KTH)
    tc, dc = cfg.transformer, cfg.data
    bf = torch.bfloat16
    b, n_past, n_fut, n_test = (dc.batch_size, tc.num_past_frames, tc.num_future_frames,
                                dc.test_future_frames)
    size = dc.img_size
    what = f"{KTH} {label}"
    phase(f"{number}. {KTH} at full width, {label}"
          + (f" ({' + '.join(flags)})" if flags else "")
          + f": nar predict {n_past} -> {n_fut} and {n_past} -> {n_test}, train step")
    enc, dec = build_autoencoder(cfg.ae, bf, dev, torch.Generator().manual_seed(SEED))
    tr = build_transformer(tc, bf, dev, torch.Generator().manual_seed(SEED + 1))
    past, future = train
    test_past = test[0]
    predict = make_predict_fn(cfg, enc, dec, tr, "nar", n_fut, dev)
    want = kth_launches(tc, flags, False)
    zero_counters()
    pred = predict(past)
    torch.cuda.synchronize()
    pred_launches = launch_counts(*want)
    check_counts(pred_launches, want, f"the {what} nar predict")
    check_tanh_frames(pred, (b, n_fut, size, size, 1), f"{what} nar predict")
    use_kernels(tr, "plain")
    e = max_err(pred, predict(past))
    use_kernels(tr, "cuda")
    check(e <= 1e-1, f"{what} nar predict kernels vs kernels='plain' max|err| {e:.3e} <= 1e-1 "
          f"(bf16 tanh frames in [-1, 1] after 12 layers: phase 4's 5e-2 on sigmoid frames, "
          f"over twice the range)")
    predict40 = make_predict_fn(cfg, enc, dec, tr, "nar", n_test, dev)
    calls = -(-n_test // n_fut)
    zero_counters()
    pred40 = predict40(test_past)
    torch.cuda.synchronize()
    check_counts(launch_counts(*want), {k: calls * v for k, v in want.items()},
                 f"the {what} nar predict {n_past} -> {n_test} ({calls} NAR calls)")
    check_tanh_frames(pred40, (b, n_test, size, size, 1), f"{what} nar predict {n_past} -> "
                      f"{n_test}")
    del pred, pred40

    opt = build_optimizer(cfg.optim, tc.d_model)
    state = create_nar_train_state(enc, dec, tr, opt, seed=SEED + 3)
    step = make_nar_train_step(enc, dec, tr, opt, cfg.loss)
    state, _ = step(state, past, future)    # the first step's norm is ~1e10
    state, step_launches = counted_step(step, state, past, future,
                                        kth_launches(tc, flags, True), f"{what} NAR train step")
    # the plain versions of #9-#12 keep their f32 intermediates for autograd
    # (tens of GiB at 80 samples of 256 x 2112): on those routes the step is
    # held against kernels="plain" on the batch's first KTH_PLAIN_ROWS clips
    rows = b if not flags else KTH_PLAIN_ROWS
    step_vs_plain(step, state, past[:rows], future[:rows], f"{what} step (batch {rows})")
    loss_falls(step, state, past, future, what)

    pred_ms = statistics.median([host_ms(lambda: predict(past)) for _ in range(4)][1:])
    pred40_ms = statistics.median([host_ms(lambda: predict40(test_past)) for _ in range(3)])
    use_kernels(tr, "plain")
    plain_pred_ms = host_ms(lambda: predict(past))
    use_kernels(tr, "cuda")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step_times = [host_ms(lambda: step(state, past, future)) for _ in range(WARMUP_STEPS + 4)]
    step_peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    step_ms = statistics.median(step_times[WARMUP_STEPS:])
    out = {"predict_ms": pred_ms, "predict_frames_per_s": b * n_fut / pred_ms * 1e3,
           "plain_predict_ms": plain_pred_ms, "predict_40_ms": pred40_ms,
           "predict_40_frames_per_s": b * n_test / pred40_ms * 1e3,
           "train_step_ms": step_ms, "train_frames_per_s": b * n_fut / step_ms * 1e3,
           "step_peak_gib_above_held": step_peak, "held_gib": held / 2 ** 30,
           "predict_launches": pred_launches, "step_launches": step_launches}
    print(f"  {what}: nar predict (batch {b}, {n_past} -> {n_fut}) {pred_ms:.3f} ms "
          f"({out['predict_frames_per_s']:.1f} frames/s; kernels='plain' {plain_pred_ms:.3f} "
          f"ms), {n_past} -> {n_test} {pred40_ms:.3f} ms ({out['predict_40_frames_per_s']:.1f} "
          f"frames/s); train step {step_ms:.3f} ms ({[round(t, 3) for t in step_times]}), "
          f"{out['train_frames_per_s']:.1f} training frames/s, peak {step_peak:.3f} GiB above "
          f"the {held / 2 ** 30:.3f} GiB held")
    del enc, dec, tr, state, step, predict, predict40, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out


KTH_CLI_STEPS = 3
KTH_PLAIN_ROWS = 2   # the clips of a fused route's step against kernels="plain"


def kth_cli_phase(dev, number):
    """Phase ``number``: ``cli train --preset nar_kth_128`` at full width on
    the synthetic KTH-shaped loader (KTH_CLI_STEPS steps and a validation
    pass: the epoch cut, nothing else), a second ``cli train`` that resumes
    it, ``cli eval --mode nar --max-batches 1`` (10 -> 40: four NAR calls
    a batch) and ``cli predict --mode nar --batches 1``, every counter at 0
    before each command, in a temporary directory removed at the end.
    Returns the readings."""
    import contextlib
    import importlib.util
    import io
    import shutil
    import tempfile
    from pathlib import Path

    from vptr_tpu_torch import cli
    from vptr_tpu_torch.config import get_preset
    from vptr_tpu_torch.data.loader import build_loader

    cfg = get_preset(KTH)
    tc, dc = cfg.transformer, cfg.data
    phase(f"{number}. cli train --preset {KTH} ({KTH_CLI_STEPS} steps and a validation pass), "
          f"a resumed run, cli eval --mode nar --max-batches 1, cli predict --mode nar "
          f"--batches 1")
    root = Path(tempfile.mkdtemp(prefix="vptr_kth_"))
    records = _Records()
    logging.getLogger("vptr_tpu_torch").addHandler(records)
    out = {}
    try:
        ckpt = root / "kth"
        args = ["--preset", KTH, "--ckpt-dir", str(ckpt), "--set", "epochs=1", "--set",
                f"steps_per_epoch={KTH_CLI_STEPS}", "--set", "val_per_epochs=1"]
        val_batches = len(build_loader(dc, split="val", seed=cfg.seed))
        fwd = kth_launches(tc, {}, False)
        zero_counters()
        t0 = time.perf_counter()
        cli.main(["train", *args])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        want = {k: v * (KTH_CLI_STEPS + val_batches) for k, v in fwd.items()}
        want.update({f"{k}_bwd": v * KTH_CLI_STEPS for k, v in fwd.items()})
        got = launch_counts(*want)
        check_counts(got, want, f"cli train {KTH} ({KTH_CLI_STEPS} steps, {val_batches} "
                     f"validation batches)")
        hist = _history(ckpt)
        print(f"  train {hist['train']}\n  val {hist['val']}")
        check(_finite(hist["train"].values()) and _finite(hist["val"].values()),
              f"{KTH} cli train: train and val metrics finite")
        check((ckpt / "ckpt" / str(KTH_CLI_STEPS) / "state.pt").is_file(),
              f"{KTH} cli train wrote ckpt/{KTH_CLI_STEPS}/")
        sps = hist["train"]["steps_per_sec"]
        out.update(cli_train_steps_per_s=sps, cli_train_wall_s=wall, cli_train_launches=got)
        records.messages.clear()
        cli.main(["train", *args])
        resumed = [m for m in records.messages if m.startswith("resumed from step")]
        check(resumed == [f"resumed from step {KTH_CLI_STEPS} (epoch 1)"],
              f"the second cli train logs {resumed}")
        check((ckpt / "ckpt" / str(2 * KTH_CLI_STEPS) / "state.pt").is_file(),
              f"the resumed run continued to ckpt/{2 * KTH_CLI_STEPS}/")
        gc.collect()
        torch.cuda.empty_cache()

        calls = -(-dc.test_future_frames // tc.num_future_frames)
        want = {k: calls * v for k, v in fwd.items()}
        zero_counters()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["eval", *args, "--mode", "nar", "--max-batches", "1"])
        torch.cuda.synchronize()
        curves = json.loads(buf.getvalue())
        print(f"  {json.dumps(curves)}")
        check_counts(launch_counts(*want), want, f"cli eval nar ({calls} NAR calls)")
        check(all(len(curves[m]) == dc.test_future_frames and _finite(curves[m])
                  for m in ("psnr", "ssim", "mse")),
              f"cli eval curves finite, {dc.test_future_frames} long")
        out["cli_eval_curves_mean"] = {m: curves[m + "_mean"] if m + "_mean" in curves
                                       else statistics.mean(curves[m])
                                       for m in ("psnr", "ssim", "mse")}

        zero_counters()
        buf = io.StringIO()
        preds = root / "predictions"
        with contextlib.redirect_stdout(buf):
            cli.main(["predict", *args, "--mode", "nar", "--out", str(preds), "--batches", "1"])
        torch.cuda.synchronize()
        print("  " + buf.getvalue().strip().replace("\n", "\n  "))
        check_counts(launch_counts(*want), want, f"cli predict nar ({calls} NAR calls)")
        written = sorted(p.name for p in preds.rglob("*") if p.is_file())
        if importlib.util.find_spec("PIL") is not None:
            check(len(written) > 0, f"cli predict wrote {written}")
        else:
            check("PIL does not import" in buf.getvalue(),
                  "cli predict said that PIL does not import")
    finally:
        logging.getLogger("vptr_tpu_torch").removeHandler(records)
        shutil.rmtree(root, ignore_errors=True)
    return out


def kth_phases(dev):
    """Phases 45-50 (nar_kth_128). Returns (the kernel readings of #9-#12 at
    its shapes by row name, the routes' and the commands' readings, the
    summary line)."""
    from vptr_tpu_torch.config import get_preset

    kernels = kth_kernel_phases(dev)
    gc.collect()
    torch.cuda.empty_cache()
    train, test = kth_batches(get_preset(KTH), dev)
    routes = {}
    for i, (label, flags) in enumerate(KTH_ROUTES):
        routes[label] = kth_route_phase(dev, 47 + i, label, flags, train, test)
    del train, test
    gc.collect()
    torch.cuda.empty_cache()
    cli_out = kth_cli_phase(dev, 50)
    summary = " ".join(
        f"kth_{label.split()[0].replace('-', '_').lower()}_predict_ms {r['predict_ms']:.3f} "
        f"kth_{label.split()[0].replace('-', '_').lower()}_train_step_ms "
        f"{r['train_step_ms']:.3f}" for label, r in routes.items())
    return kernels, {"routes": routes, "cli": cli_out}, summary


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA GPU only", file=sys.stderr)
        return 1
    import tempfile
    from pathlib import Path

    import torch.nn.functional as F

    from vptr_tpu_torch.config import get_preset
    from vptr_tpu_torch.eval.harness import make_predict_fn
    from vptr_tpu_torch.models.autoencoder import build_autoencoder
    from vptr_tpu_torch.models.layers import use_kernels
    from vptr_tpu_torch.models.position import position_embedding_2d
    from vptr_tpu_torch.models.transformer import build_transformer
    from vptr_tpu_torch.ops import _build
    from vptr_tpu_torch.ops import attention_core as tac
    from vptr_tpu_torch.ops import fused_window_attention as tfw
    from vptr_tpu_torch.ops.attention_core import (
        attention_core,
        attention_core_backward_plain,
        attention_core_plain,
    )
    from vptr_tpu_torch.ops.fused_window_attention import (
        fused_attention_ln,
        fused_attention_ln_backward_plain,
        fused_attention_ln_plain,
        fused_attention_ln_res,
        kernel_route,
    )
    from vptr_tpu_torch.train.optim import build_optimizer
    from vptr_tpu_torch.train.state import create_far_train_state
    from vptr_tpu_torch.train.steps import make_far_train_step

    run_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False    # plain f32 = full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()

    phase("1. card")
    print(f"  {card}")
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}")

    phase("2. build")
    t0 = time.perf_counter()
    paths = _build.build()
    print(f"  built {len(paths)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        log = path.with_suffix(".log")
        for line in (log.read_text().splitlines() if log.is_file() else []):
            if "registers" in line or "spill" in line or "C7520" in line:   # serialised wgmma
                print(f"  {name}: {line.strip()}")
    core_log = paths["attention_core"].with_suffix(".log")
    for number, kernel in (("#2", "attention_core_mma_kernel"),
                           ("#4", "attention_core_bwd_mma_kernel")):
        core_report = ptxas_report(core_log.read_text() if core_log.is_file() else "",
                                   kernel)
        for line in core_report:
            print(f"  {number} bf16 kernel {line}")
        check(len(core_report) > 0, f"ptxas reports {kernel} ({len(core_report)} lines)")
    wg_libs = ("conv_ln_gelu", "conv_ln_gelu_bwd", "fused_ffn", "fused_ffn_bwd",
               "fused_window_attention_ln", "fused_window_attention",
               "fused_window_attention_ln_bwd", "fused_window_attention_bwd")
    with ThreadPoolExecutor(len(wg_libs)) as pool:   # one cuobjdump a library, together
        counts = list(pool.map(lambda lib: hgmma_count(paths[lib]), wg_libs))
    for lib, n_hgmma in zip(wg_libs, counts):
        check(n_hgmma > 0, f"{lib} library SASS holds {n_hgmma} HGMMA (wgmma) "
              f"instructions > 0")

    # ---- shapes of the far_rip path: N=10, context 20, 8x8 latent, C=528
    cfg = get_preset("far_mnist")
    tc = cfg.transformer
    c, heads = tc.d_model, tc.n_heads
    hd = c // heads
    ctx = tc.num_past_frames + tc.num_future_frames
    windows = BATCH * ctx * (tc.enc_h // tc.window_size) * (
        tc.enc_w // tc.window_size)
    tokens = tc.window_size ** 2
    cols = BATCH * tc.enc_h * tc.enc_w
    g = torch.Generator().manual_seed(SEED)
    randn = normals(g)

    def window_operands(dtype, bw=windows, l=tokens):
        w = [randn(c, c, std=(1.0 / c) ** 0.5).to(dev, dtype) for _ in range(4)]
        b = [randn(c, std=0.02).to(dev) for _ in range(4)]
        pos = position_embedding_2d(4, 4, c).reshape(16, c)[:l]
        if l > 16:
            pos = torch.cat([pos, randn(l - 16, c)])
        return (randn(bw, l, c).to(dev, dtype), w[0], b[0], w[1], b[1], w[2],
                b[2], w[3], b[3], (1 + randn(c, std=0.1)).to(dev),
                randn(c, std=0.1).to(dev), pos.to(dev))

    causal = torch.full((ctx, ctx), -1e30).triu(1)[None].to(dev)

    def core_operands(dtype, b=cols, tq=ctx, tk=ctx):
        return tuple(randn(b, heads, t, hd).to(dev, dtype)
                     for t in (tq, tk, tk))

    def strided_operands(dtype, b=cols, tq=ctx, tk=ctx):
        """q, k, v as the attention layer hands them to #2: the (B, H, T, D)
        view of its projections' contiguous (B, T, H*D)."""
        return tuple(randn(b, t, c).to(dev, dtype).view(b, t, heads, hd).transpose(1, 2)
                     for t in (tq, tk, tk))

    nar_cols = 16 * tc.enc_h * tc.enc_w    # nar_mnist: batch 16 of 8 x 8 latents

    # tolerances: f32 — kernel and plain differ in summation order only
    # (528-long dot products, four chained products in the window kernel);
    # bf16 — one bf16 ulp of an output of magnitude <= 8 is 2^-5, and a
    # rounding that flips at an intermediate (xn, q/k/v, weights) moves
    # the output by less than that; f16 (F16_TOL) — the same at f16's 2^-11
    # ulp, 2^-7 (bf16's gate over 8)
    tol = {torch.float32: 1e-3, torch.bfloat16: 6.25e-2, torch.float16: F16_TOL}

    # the training path: T = 19 teacher-forced frames, dropout 0.1
    tt = ctx - 1
    twindows = windows // ctx * tt
    rate = tc.dropout
    kseed = torch.tensor([SEED + 12345], dtype=torch.int32, device=dev)
    # backward tolerances, relative to the larger of 1 and the largest
    # magnitude of each gradient: f32 1e-4 — summation order (the weight
    # gradients sum 12,160 rows); bf16 2^-5 — every gradient is rounded to
    # bf16 (2^-8), and an intermediate rounding (xn, q/k/v, the dropped
    # weights) that falls the other way moves the terms it feeds by one
    # bf16 ulp; the weight gradients are cast to bf16 at the end; f16
    # (F16_BWD_TOL) 2^-8, bf16's over 8
    bwd_tol = {torch.float32: 1e-4, torch.bfloat16: 2 ** -5, torch.float16: F16_BWD_TOL}
    grad_names = ("dx", "dwq", "dbq", "dwk", "dbk", "dwv", "dbv", "dwo",
                  "dbo", "dls", "dlb", "dbias")

    phase("3. kernels against their plain versions (card)")
    errs = {}
    for dtype in (torch.bfloat16, torch.float32, torch.float16):
        name = str(dtype).replace("torch.", "")
        zero_counters()
        ops = window_operands(dtype)
        e = max_err(fused_attention_ln(*ops, None, num_heads=heads),
                    fused_attention_ln_plain(*ops, None, num_heads=heads))
        check(e <= tol[dtype], f"fused_attention_ln {name} {tuple(ops[0].shape)}"
              f" ({kernel_route(tokens, c, dtype)}) max|err| {e:.3e} <= "
              f"{tol[dtype]}")
        errs[("window", dtype)] = e
        scale = (torch.rand(windows, generator=g) * 2).to(dev)
        e = max_err(fused_attention_ln_res(*ops, None, scale, num_heads=heads),
                    fused_attention_ln_plain(*ops, None, num_heads=heads,
                                             scale=scale, res=True))
        check(e <= tol[dtype], f"fused_attention_ln_res {name} (scale, res) "
              f"max|err| {e:.3e} <= {tol[dtype]}")
        ops19 = window_operands(dtype, bw=64, l=19)
        for r in (0.0, rate):   # dropout: the mask index over 24 tokens (bf16: 32)
            e = max_err(fused_attention_ln(*ops19, causal[:, :19, :19], kseed, heads, r),
                        fused_attention_ln_plain(*ops19, causal[:, :19, :19], kseed, heads,
                                                 r))
            check(e <= tol[dtype], f"fused_attention_ln {name} L=19 causal bias dropout {r} "
                  f"max|err| {e:.3e} <= {tol[dtype]}")
        q, k, v = core_operands(dtype)
        e = max_err(attention_core(q, k, v, causal),
                    attention_core_plain(q, k, v, causal))
        check(e <= tol[dtype], f"attention_core {name} {tuple(q.shape)} causal "
              f"max|err| {e:.3e} <= {tol[dtype]}")
        errs[("core", dtype)] = e
        q, k, v = core_operands(dtype, b=256, tq=10, tk=20)
        hb = torch.randn(heads, 10, 20, generator=g).to(dev)
        e = max_err(attention_core(q, k, v, hb),
                    attention_core_plain(q, k, v, hb))
        check(e <= tol[dtype], f"attention_core {name} rectangular "
              f"{tuple(q.shape)}x{tuple(k.shape)} per-head bias "
              f"max|err| {e:.3e} <= {tol[dtype]}")

        # dropout forwards at the training shapes (hash masks are exact)
        tops = window_operands(dtype, bw=twindows)
        e = max_err(fused_attention_ln(*tops, None, kseed, heads, rate),
                    fused_attention_ln_plain(*tops, None, kseed, heads, rate))
        check(e <= tol[dtype], f"fused_attention_ln {name} dropout {rate} "
              f"{tuple(tops[0].shape)} max|err| {e:.3e} <= {tol[dtype]}")
        e = max_err(fused_attention_ln(*ops, None, kseed, heads, rate),
                    fused_attention_ln_plain(*ops, None, kseed, heads, rate))
        check(e <= tol[dtype], f"fused_attention_ln {name} dropout {rate} "
              f"{tuple(ops[0].shape)} max|err| {e:.3e} <= {tol[dtype]}")
        tscale = (torch.rand(twindows, generator=g) * 2).to(dev)
        for r in (0.0, rate):     # the FAR step's call: res and the DropPath scale
            e = max_err(fused_attention_ln_res(*tops, None, tscale, kseed, heads, r),
                        fused_attention_ln_plain(*tops, None, kseed, heads, r,
                                                 scale=tscale, res=True))
            check(e <= tol[dtype], f"fused_attention_ln_res {name} (scale, res) dropout "
                  f"{r} {tuple(tops[0].shape)} max|err| {e:.3e} <= {tol[dtype]}")
        tq_, tk_, tv_ = core_operands(dtype, tq=tt, tk=tt)
        tcausal = causal[:, :tt, :tt]
        e = max_err(attention_core(tq_, tk_, tv_, tcausal, kseed, rate),
                    attention_core_plain(tq_, tk_, tv_, tcausal, kseed, rate))
        check(e <= tol[dtype], f"attention_core {name} dropout {rate} "
              f"{tuple(tq_.shape)} causal max|err| {e:.3e} <= {tol[dtype]}")
        # #2 on the layer's strided operands: far_rip's, the FAR step's, NAR's
        for b_, t_, bias_, r_, what in ((cols, ctx, causal, 0.0, "far_rip"),
                                        (cols, tt, causal[:, :tt, :tt], rate, "FAR step"),
                                        (nar_cols, 10, None, 0.0, "NAR"),
                                        (nar_cols, 10, None, rate, "NAR step")):
            sq, sk, sv = strided_operands(dtype, b_, t_, t_)
            got = attention_core(sq, sk, sv, bias_, kseed, r_)
            e = max_err(got, attention_core_plain(sq, sk, sv, bias_, kseed, r_))
            check(e <= tol[dtype] and got.stride() == sq.stride(),
                  f"attention_core {name} strided {what} {tuple(sq.shape)} "
                  f"({tac.kernel_route(dtype, heads, t_, t_, hd)} route) dropout {r_}: "
                  f"max|err| {e:.3e} <= {tol[dtype]}, out in q's layout")
            errs[("core_strided", what, dtype)] = e

        # backward kernels at the training shapes
        for r in (0.0, rate):
            gout = randn(twindows, tokens, c).to(dev, dtype)
            wbias = torch.randn(heads, tokens, tokens, generator=g).to(dev)
            for bias, sc, res in ((None, None, False),
                                  (wbias, (torch.rand(twindows, generator=g)
                                           * 2).to(dev), True)):
                got = tfw.fused_attention_ln_backward(
                    *tops, bias, kseed, gout, heads, r, sc, res)
                want = fused_attention_ln_backward_plain(
                    *tops, bias, kseed, gout, heads, r, sc, res)
                worst = {n: rel_err(a, b) for n, a, b in
                         zip(grad_names, got, want) if b is not None}
                n_worst = max(worst, key=worst.get)
                what = "res, scale, per-head bias" if res else "no bias"
                check(worst[n_worst] <= bwd_tol[dtype],
                      f"fused_attention_ln backward {name} dropout {r} ({what}; "
                      f"{tfw.backward_route(tokens, c, dtype)} route) worst {n_worst} "
                      f"rel err {worst[n_worst]:.2e} <= {bwd_tol[dtype]:.2e}")
                if r > 0 and not res:
                    errs[("window_bwd", dtype)] = max(
                        max_err(a, b) for a, b in zip(got, want) if b is not None)
            gcore = core_operands(dtype, tq=tt, tk=tt)[0]
            hbias = torch.randn(heads, tt, tt, generator=g).to(dev)
            for bias in (tcausal, hbias):
                got = tac.attention_core_backward(
                    tq_, tk_, tv_, bias, kseed, gcore, r,
                    need_dbias=bias is hbias)
                want = attention_core_backward_plain(
                    tq_, tk_, tv_, bias, kseed, gcore, r, bias is hbias)
                worst = {n: rel_err(a, b) for n, a, b in
                         zip(("dq", "dk", "dv", "dbias"), got, want)
                         if b is not None}
                n_worst = max(worst, key=worst.get)
                what = "per-head bias, dbias" if bias is hbias else "causal"
                check(worst[n_worst] <= bwd_tol[dtype],
                      f"attention_core backward {name} dropout {r} ({what}) "
                      f"worst {n_worst} rel err {worst[n_worst]:.2e} <= "
                      f"{bwd_tol[dtype]:.2e}")
                if dtype == torch.bfloat16 and r > 0 and bias is tcausal:
                    errs[("core_bwd", dtype)] = max(
                        max_err(a, b) for a, b in zip(got, want) if b is not None)
        # #4 on the layer's strided q, k, v and g: the FAR step's, NAR's, and
        # an 8-head bias with its gradient (two calls bit-equal)
        hbias = torch.randn(heads, tt, tt, generator=g).to(dev)
        for b_, t_, bias_, r_, what in ((cols, tt, causal[:, :tt, :tt], rate, "FAR step"),
                                        (nar_cols, 10, None, 0.0, "NAR"),
                                        (nar_cols, 10, None, rate, "NAR step"),
                                        (cols, tt, hbias, rate, "8-head bias, dbias")):
            sq, sk, sv = strided_operands(dtype, b_, t_, t_)
            sg = strided_operands(dtype, b_, t_, t_)[0]
            got = tac.attention_core_backward(sq, sk, sv, bias_, kseed, sg, r_)
            want = attention_core_backward_plain(sq, sk, sv, bias_, kseed, sg, r_)
            n_worst, worst = worst_rel(got, want, ("dq", "dk", "dv", "dbias"))
            strides = all(a.stride() == x.stride() for a, x in zip(got, (sq, sk, sv)))
            same = True
            if bias_ is hbias:
                again = tac.attention_core_backward(sq, sk, sv, bias_, kseed, sg, r_)
                same = all(torch.equal(a, b) for a, b in zip(got, again))
            check(worst <= bwd_tol[dtype] and strides and same,
                  f"attention_core backward {name} strided {what} {tuple(sq.shape)} "
                  f"({tac.backward_route(dtype, heads, t_, t_, hd)} route) dropout {r_}: "
                  f"worst {n_worst} rel err {worst:.2e} <= {bwd_tol[dtype]:.2e}, dq, dk, "
                  f"dv in their inputs' layouts" + (", two calls bit-equal"
                                                     if bias_ is hbias else ""))
            errs[("core_bwd_strided", what, dtype)] = max(
                max_err(a, b) for a, b in zip(got, want) if b is not None)
            del sq, sk, sv, sg, got, want
        if dtype == torch.float16:
            torch.cuda.synchronize()
            _routes_only_fma("phase 3's f16 calls")
    torch.cuda.synchronize()

    phase("4. far_mnist full width, far_rip predict")
    dtype = compute_dtype(cfg)
    enc, dec = build_autoencoder(cfg.ae, dtype, dev,
                                 torch.Generator().manual_seed(SEED))
    tr = build_transformer(tc, dtype, dev, torch.Generator().manual_seed(SEED + 1))
    n_params = sum(p.numel() for m in (enc, dec, tr) for p in m.parameters())
    print(f"  params {n_params} (enc+dec+FAR), dtype {dtype}")
    frames = torch.rand(BATCH, PAST + FUTURE, 64, 64, 1,
                        generator=torch.Generator().manual_seed(SEED + 2))
    past, future = frames[:, :PAST], frames[:, PAST:]
    predict = make_predict_fn(cfg, enc, dec, tr, "far_rip", FUTURE, dev)
    want = LAYERS * FUTURE
    _, launches = counted_predict(
        predict, (past,), {"fused_attention_ln": want, "attention_core": want},
        (BATCH, FUTURE, 64, 64, 1), "far_rip")
    far = make_predict_fn(cfg, enc, dec, tr, "far", FUTURE, dev)
    predict_vs_plain(far, (past, future), tr, far(past, future), "far mode")

    phase("5. far_mnist full width, train step")
    opt = build_optimizer(cfg.optim, tc.d_model)
    print(f"  optimizer {cfg.optim.optimizer} lr {cfg.optim.lr} clip "
          f"{cfg.optim.max_grad_norm} mu_dtype {cfg.optim.mu_dtype}; dropout "
          f"{tc.dropout} attention dropout {tc.attention_dropout} drop_path "
          f"{tc.drop_path}")
    state = create_far_train_state(enc, dec, tr, opt, seed=SEED + 3)
    train_step = make_far_train_step(enc, dec, tr, opt, cfg.loss)
    tpast, tfuture = past.to(dev), future.to(dev)
    state, train_launches = counted_step(
        train_step, state, tpast, tfuture,
        {k: LAYERS for k in ("fused_attention_ln", "attention_core",
                             "fused_attention_ln_bwd", "attention_core_bwd")},
        "FAR train step")
    step_vs_plain(train_step, state, tpast, tfuture, "FAR step")
    loss_falls(train_step, state, tpast, tfuture, "FAR")

    phase("6. timing")
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2 ** 30   # weights + train state
    times = [host_ms(lambda: predict(past)) for _ in range(6)][1:]  # the first warms up
    pred_ms = statistics.median(times)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  far_rip predict (batch {BATCH}, {FUTURE} frames): median "
          f"{pred_ms:.3f} ms of {len(times)} ({[round(t, 3) for t in times]}),"
          f" {BATCH * FUTURE / pred_ms * 1e3:.1f} frames/s, peak "
          f"{peak_gib:.3f} GiB ({held:.3f} GiB of it held before the call: "
          f"the modules and the train state)")

    use_kernels(tr, "plain")
    plain_pred_ms = statistics.median(
        [cuda_ms(lambda: predict(past), iters=1, warmup=0) for _ in range(3)])
    use_kernels(tr, "cuda")
    print(f"  far_rip predict with kernels='plain': {plain_pred_ms:.3f} ms")

    # the kernels' state and the plain one take steps in turns (kernels,
    # plain, plain, kernels, ...), so host noise falls on both alike
    frames_per_step = BATCH * tt
    kstate, pstate = state.clone(), state.clone()
    use_kernels(pstate.transformer, "plain")
    del state
    torch.cuda.reset_peak_memory_stats()
    step_times, plain_times = [], []
    for i in range(WARMUP_STEPS + TIMED_STEPS):
        order = ((kstate, step_times), (pstate, plain_times))
        for which, out in (order if i % 2 == 0 else order[::-1]):
            ms = host_ms(lambda: train_step(which, tpast, tfuture))
            if i >= WARMUP_STEPS:
                out.append(ms)
    step_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = statistics.median(step_times)
    plain_step_ms = statistics.median(plain_times)
    del kstate, pstate
    print(f"  train step (batch {BATCH}, T {tt}): median {step_ms:.3f} ms of "
          f"{len(step_times)} ({[round(t, 3) for t in step_times]}), "
          f"{frames_per_step / step_ms * 1e3:.1f} frames/s; kernels='plain' "
          f"median {plain_step_ms:.3f} ms ({[round(t, 3) for t in plain_times]});"
          f" peak {step_peak:.3f} GiB with both states held")

    def timing_rows(dt, launches=None, step_launches=None):
        """#1-#4's rows of the kernels line in ``dt`` (bf16; f16 on the FMA
        routes, named ``<name>_f16``): far_rip's #1/#2 and the FAR step's
        #3/#4 (dropout 0.1, no window bias, the causal temporal mask) on the
        path's operands, each timed beside its plain version in turns, the
        library yardstick in ``dt`` (eager, and replayed from CUDA graphs)
        and the bound (the same bytes in either 2-byte dtype, the products
        at the dtype's peak). ``launches`` / ``step_launches``: the counts
        of the predict and the train step in ``dt`` (None: filled in by the
        caller). Returns (the rows, the strided operands of #2 and #4)."""
        s = dt.itemsize
        wops = window_operands(dt)
        x, wq, bq, wk, bk, wv, bv, wo, bo, ls, lb, pos = wops

        def window_library(x=x, wq=wq, wk=wk, wv=wv, wo=wo):
            xn = F.layer_norm(x, (c,), ls.to(dt), lb.to(dt))
            xqk = xn + pos.to(dt)
            split = lambda z: z.view(x.shape[0], tokens, heads, hd).transpose(1, 2)
            o = F.scaled_dot_product_attention(
                split(F.linear(xqk, wq.t(), bq.to(dt))),
                split(F.linear(xqk, wk.t(), bk.to(dt))),
                split(F.linear(xn, wv.t(), bv.to(dt))))
            return F.linear(o.transpose(1, 2).reshape(x.shape[0], tokens, c),
                            wo.t(), bo.to(dt))

        w_bytes = 2 * windows * tokens * c * s + 4 * c * c * s + (6 * c + tokens * c) * 4
        w_flops = 8 * windows * tokens * c * c + 4 * windows * heads * tokens * tokens * hd
        sq, sk, sv = strided_operands(dt)       # #2's operands as the path gives them
        c_bytes = 4 * cols * heads * ctx * hd * s + ctx * ctx * 4
        c_flops = 4 * cols * heads * ctx * ctx * hd

        # the backward kernels at the training shapes (dropout 0.1, the
        # path's operands: no window bias, the causal temporal mask)
        rows = twindows * tokens
        tops = window_operands(dt, bw=twindows)
        gwin = randn(twindows, tokens, c).to(dev, dt)
        # x, g read; dx written; four weights read, four dW written; vectors
        wb_bytes = 3 * rows * c * s + 8 * c * c * s + (14 * c + tokens * c) * 4
        # eleven R x C x C products (q, k, v recomputed, d(attn), four dW, three
        # for d(xn)) plus the per-head attention backward
        wb_flops = 22 * rows * c * c + 12 * twindows * tokens * tokens * c
        # #4's operands as the FAR step's layer gives them: q, k, v and g views
        # of (B, T, H*D) tensors
        bq_, bk_, bv_ = strided_operands(dt, cols, tt, tt)
        bg_ = strided_operands(dt, cols, tt, tt)[0]
        cb_bytes = 7 * cols * heads * tt * hd * s + tt * tt * 4
        cb_flops = 10 * cols * heads * tt * tt * hd

        # the library yardsticks' backwards: dx and the four weight gradients;
        # dq, dk, dv
        lib_g = torch.randn(twindows, tokens, c, generator=g).to(dev, dt)
        window_lib_bwd = grads_of(window_library, (tops[0], wq, wk, wv, wo), lib_g)

        def core_library(q, k, v):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=tcausal.to(dt))

        core_lib_bwd = grads_of(core_library, (bq_, bk_, bv_), bg_)

        # the yardsticks replayed from CUDA graphs (no host between launches)
        graph = {"fused_attention_ln": graph_ms(window_library),
                 "fused_attention_ln_bwd": graph_bwd_ms(window_library,
                                                        (tops[0], wq, wk, wv, wo), lib_g),
                 "attention_core": graph_ms(lambda: F.scaled_dot_product_attention(
                     sq, sk, sv, attn_mask=causal.to(dt))),
                 "attention_core_bwd": graph_bwd_ms(core_library, (bq_, bk_, bv_), bg_)}
        print(f"  library yardsticks ({dt}) replayed from CUDA graphs: fused_attention_ln "
              f"{graph['fused_attention_ln']:.4f} ms, attention_core "
              f"{graph['attention_core']:.4f} ms")
        suffix = "_f16" if dt == torch.float16 else ""
        out = []
        for name, src, replaces, fn, plain, lib, nbytes, flops, err in (
            ("fused_attention_ln", "vptr_tpu_torch/csrc/fused_window_attention_ln.cu",
             "vptr_tpu/ops/fused_window_attention.py:586",
             lambda: fused_attention_ln(*wops, None, num_heads=heads),
             lambda: fused_attention_ln_plain(*wops, None, num_heads=heads),
             window_library, w_bytes, w_flops, errs[("window", dt)]),
            ("attention_core", "vptr_tpu_torch/csrc/attention_core.cu",
             "vptr_tpu/ops/attention_core.py:188",
             lambda: attention_core(sq, sk, sv, causal),
             lambda: attention_core_plain(sq, sk, sv, causal),
             lambda: F.scaled_dot_product_attention(sq, sk, sv, attn_mask=causal.to(dt)),
             c_bytes, c_flops, errs[("core_strided", "far_rip", dt)]),
            ("fused_attention_ln_bwd",
             "vptr_tpu_torch/csrc/fused_window_attention_ln_bwd.cu",
             "vptr_tpu/ops/fused_window_attention.py:769",
             lambda: tfw.fused_attention_ln_backward(*tops, None, kseed, gwin, heads,
                                                     rate),
             lambda: fused_attention_ln_backward_plain(*tops, None, kseed, gwin,
                                                       heads, rate),
             window_lib_bwd, wb_bytes, wb_flops, errs[("window_bwd", dt)]),
            ("attention_core_bwd", "vptr_tpu_torch/csrc/attention_core.cu",
             "vptr_tpu/ops/attention_core.py:317",
             lambda: tac.attention_core_backward(bq_, bk_, bv_, tcausal, kseed,
                                                 bg_, rate, need_dbias=False),
             lambda: attention_core_backward_plain(bq_, bk_, bv_, tcausal, kseed,
                                                   bg_, rate, False),
             core_lib_bwd, cb_bytes, cb_flops, errs[("core_bwd_strided", "FAR step", dt)]),
        ):
            before = (attention_core.launches, fused_attention_ln.launches,
                      attention_core.bwd_launches, fused_attention_ln.bwd_launches)
            # plain, kernel, kernel, plain: compare within one call, in turns
            p1, k1, k2, p2 = (cuda_ms(plain), cuda_ms(fn), cuda_ms(fn), cuda_ms(plain))
            (attention_core.launches, fused_attention_ln.launches,
             attention_core.bwd_launches, fused_attention_ln.bwd_launches) = before
            lib_ms = cuda_ms(lib)
            b_ms, b_by = bound(nbytes, flops, dt)
            row = {"name": name + suffix, "route": "cuda", "source": src,
                   "replaces": replaces, "dtype": str(dt).replace("torch.", ""),
                   "launches": launches[name] if launches else None,
                   "max_abs_err": err, "ms": min(k1, k2), "plain_ms": min(p1, p2),
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                   "library_graph_ms": graph[name],
                   "train_step_launches": step_launches[name] if step_launches else None}
            out.append(row)
            print(f"  {card}: {name} {dt}: kernel {k1:.4f}/{k2:.4f} ms, plain "
                  f"{p1:.4f}/{p2:.4f} ms, library {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
                  f"({b_by}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP)")
        return out, (sq, sk, sv), (bq_, bk_, bv_, bg_)

    bf = torch.bfloat16
    far_launches = {**launches, **{k: train_launches[k] for k in ("fused_attention_ln_bwd",
                                                                  "attention_core_bwd")}}
    rows_out, (sq, sk, sv), (bq_, bk_, bv_, bg_) = timing_rows(bf, far_launches, train_launches)
    f16_far_rows, _, _ = timing_rows(torch.float16)
    rows_out += f16_far_rows
    tcausal = causal[:, :tt, :tt]
    q, k, v = core_operands(bf)
    tq_, tk_, tv_ = core_operands(bf, tq=tt, tk=tt)
    gcore = core_operands(bf, tq=tt, tk=tt)[0]
    s = 2   # bytes per bf16 element

    # #2 also on contiguous operands (the layout of its earlier readings)
    # and at nar_mnist's shape (1024 x 8 x 10, no bias, the layer's layout);
    # graph_ms: the call replayed from a CUDA graph, the device time without
    # the wrapper's host time between back-to-back calls
    core_row = next(row for row in rows_out if row["name"] == "attention_core")
    core_row["kernel_route"] = tac.kernel_route(bf, heads, ctx, ctx, hd)
    core_row["graph_ms"] = graph_ms(lambda: attention_core(sq, sk, sv, causal))
    k1, k2 = (cuda_ms(lambda: attention_core(q, k, v, causal)) for _ in range(2))
    core_row["contiguous_ms"] = min(k1, k2)
    core_row["contiguous_graph_ms"] = graph_ms(lambda: attention_core(q, k, v, causal))
    nq, nk, nv = strided_operands(bf, nar_cols, 10, 10)
    k_ms, p_ms = timed_turns(lambda: attention_core(nq, nk, nv),
                             lambda: attention_core_plain(nq, nk, nv))
    n_lib = lambda: F.scaled_dot_product_attention(nq, nk, nv)
    b_ms, b_by = bound(4 * nar_cols * heads * 10 * hd * s, 4 * nar_cols * heads * 100 * hd)
    core_row["nar_shape"] = dict(
        ms=k_ms, graph_ms=graph_ms(lambda: attention_core(nq, nk, nv)), plain_ms=p_ms,
        library_ms=cuda_ms(n_lib), library_graph_ms=graph_ms(n_lib), bound_ms=b_ms,
        bound_by=b_by, max_abs_err=errs[("core_strided", "NAR", bf)])
    print(f"  attention_core ({core_row['kernel_route']} route): the layer's layout "
          f"{core_row['ms']:.4f} ms, graph {core_row['graph_ms']:.4f}; contiguous "
          f"{k1:.4f}/{k2:.4f}, graph {core_row['contiguous_graph_ms']:.4f}; NAR shape "
          f"{tuple(nq.shape)}: {core_row['nar_shape']}")

    # #4 likewise: the layer's layout above; contiguous operands; nar_mnist's
    # step shape (1024 x 8 x 10, no bias, dropout 0.1, the layer's layout)
    bwd_row = next(row for row in rows_out if row["name"] == "attention_core_bwd")
    bwd_row["backward_route"] = tac.backward_route(bf, heads, tt, tt, hd)
    # max_abs_err above is on the layer's strided operands; this one on the
    # contiguous operands of phase 3 (the FAR step's, dropout 0.1, causal)
    bwd_row["contiguous_max_abs_err"] = errs[("core_bwd", bf)]
    bwd = lambda *ops: (lambda: tac.attention_core_backward(
        *ops[:3], ops[4], kseed, ops[3], rate, need_dbias=False))
    bwd_row["graph_ms"] = graph_ms(bwd(bq_, bk_, bv_, bg_, tcausal))
    k1, k2 = (cuda_ms(bwd(tq_, tk_, tv_, gcore, tcausal)) for _ in range(2))
    bwd_row["contiguous_ms"] = min(k1, k2)
    bwd_row["contiguous_graph_ms"] = graph_ms(bwd(tq_, tk_, tv_, gcore, tcausal))
    nops = strided_operands(bf, nar_cols, 10, 10) + strided_operands(bf, nar_cols, 10, 10)[:1]
    k_ms, p_ms = timed_turns(bwd(*nops, None), lambda: attention_core_backward_plain(
        *nops[:3], None, kseed, nops[3], rate, False))
    n_lib = lambda q, k, v: F.scaled_dot_product_attention(q, k, v)
    b_ms, b_by = bound(7 * nar_cols * heads * 10 * hd * s, 10 * nar_cols * heads * 100 * hd)
    bwd_row["nar_shape"] = dict(
        ms=k_ms, graph_ms=graph_ms(bwd(*nops, None)), plain_ms=p_ms,
        library_ms=cuda_ms(grads_of(n_lib, nops[:3], nops[3])),
        library_graph_ms=graph_bwd_ms(n_lib, nops[:3], nops[3]), bound_ms=b_ms,
        bound_by=b_by, max_abs_err=errs[("core_bwd_strided", "NAR step", bf)])
    print(f"  attention_core_bwd ({bwd_row['backward_route']} route): the layer's layout "
          f"{bwd_row['ms']:.4f} ms, graph {bwd_row['graph_ms']:.4f}; contiguous "
          f"{k1:.4f}/{k2:.4f}, graph {bwd_row['contiguous_graph_ms']:.4f}; NAR shape "
          f"{tuple(nops[0].shape)}: {bwd_row['nar_shape']}")

    # the FAR path's modules and operands go before the NAR phases
    del enc, dec, tr, predict, far, q, k, v, sq, sk, sv, nq, nk, nv
    del gcore, tq_, tk_, tv_, bq_, bk_, bv_, bg_, nops
    torch.cuda.empty_cache()
    nar_rows, nar_extra, nar_summary = nar_phases(dev)
    rows_out += nar_rows
    torch.cuda.empty_cache()
    ffn_rows, ffn_extra, ffn_summary = ffn_phases(dev)
    rows_out += ffn_rows
    torch.cuda.empty_cache()
    conv_rows, temporal_rows, conv_extra, conv_summary = conv_phases(dev)
    rows_out += conv_rows
    for row in rows_out:          # #1 / #3 at the folded temporal sublayer's shapes
        if row["name"] in temporal_rows:
            row["temporal_shapes"] = temporal_rows[row["name"]]
        nar_ln = nar_extra["nar_shape_ln_kernels"].get(f"{row['name']} (NAR shape, RPE bias)")
        if nar_ln:                # and at the NAR shape
            row["nar_shape"] = nar_ln

    torch.cuda.empty_cache()
    ae_summary, ae_extra = ae_gan_phases(dev)
    torch.cuda.empty_cache()
    # phases 23-26's directory, kept for phase 57's examples and phase 58's
    # f16 cli run (removed after them, or at exit)
    entry_dir = tempfile.TemporaryDirectory(prefix="vptr_smoke_")
    entry_root = Path(entry_dir.name)
    cli_summary, cli_extra = entry_point_phases(dev, step_ms, ae_extra["ae_train_step_ms"],
                                                entry_root)
    torch.cuda.empty_cache()
    tslma_rows, tslma_extra, tslma_summary = tslma_phases(dev)
    rows_out += tslma_rows
    gc.collect()
    torch.cuda.empty_cache()
    dp_summary, dp_extra, dp_launches = dp_phases(dev, card)
    for row in rows_out:          # #1-#4 in one far_bair_dp train step (phase 33)
        if dp_launches and row["name"] in dp_launches:
            row["far_bair_dp_launches"] = dp_launches[row["name"]]
    gc.collect()
    torch.cuda.empty_cache()
    upstream_extra, tar_launches = upstream_phases(dev)
    remat_extra = remat_phases(dev, dp_extra)
    scan_extra = scan_phases(dev)
    remat_launches = {**remat_extra["far_default"]["launches_on"],
                      **remat_extra["far_ffn"]["launches_on"]}
    for row in rows_out:
        name = row["name"]
        if tar_launches and name in tar_launches:     # phase 36's far_rip from the .tar
            row["upstream_far_rip_launches"] = tar_launches[name]
        if name in remat_launches:   # a far_mnist remat step (phase 37; #7-#10: fused-FFN)
            row["far_remat_step_launches"] = remat_launches[name]
    gc.collect()
    torch.cuda.empty_cache()
    tp_kernels = tp_kernel_phases(dev)
    gc.collect()
    torch.cuda.empty_cache()
    tp_extra = tp_phases(dev, card)
    for row in rows_out:          # #1-#6 on a head subset (phase 41), a rank's
        name = row["name"]        # launches in the mesh.model = 2 steps (42, 43)
        base = name[:-4] if name.endswith("_bwd") else name
        if base in tp_kernels:
            row["head_subset"] = tp_kernels[base]
        for key in ("far_tp", "nar_tp_sp"):
            counts = tp_extra.get(key, {}).get("launches") or {}
            if name in counts:
                row.setdefault("tp_step_launches_a_rank", {})[key] = counts[name]

    gc.collect()
    torch.cuda.empty_cache()
    kth_kernels, kth_extra, kth_summary = kth_phases(dev)
    for row in rows_out:          # #9-#12 at nar_kth_128's shapes (phases 45-46), their
        name = row["name"]        # launches in its nar predict / train step (47-49)
        if name in kth_kernels:
            route = ("fused-FFN route" if name.startswith("fused_dw_chain")
                     else "conv-FFN route")
            r = kth_extra["routes"][route]
            row["nar_kth_128"] = {**kth_kernels[name],
                                  "predict_launches": r["predict_launches"].get(name, 0),
                                  "train_step_launches": r["step_launches"][name]}

    gc.collect()
    torch.cuda.empty_cache()
    tp_ffn_kernels = tp_ffn_kernel_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    tp_ffn_extra = tp_phases(dev, card, which=(52,))
    ffn_counts = tp_ffn_extra.get("far_ffn_tp", {}).get("launches") or {}
    for row in rows_out:          # #7-#10 on a hidden subset (phase 51), a rank's launches
        name = row["name"]        # in the fused-FFN route's mesh.model = 2 step (52)
        if name in tp_ffn_kernels:
            row["hidden_subset"] = tp_ffn_kernels[name]
        if name in ffn_counts:
            row.setdefault("tp_step_launches_a_rank", {})["far_ffn_tp"] = ffn_counts[name]

    gc.collect()
    torch.cuda.empty_cache()
    tp_conv_kernels = tp_conv_kernel_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    tp_conv_extra = tp_phases(dev, card, which=(54,))
    conv_counts = tp_conv_extra.get("far_conv_tp", {}).get("launches") or {}
    for row in rows_out:          # #11/#12 as fc1's column- and fc2's row-parallel steps
        name = row["name"]        # (phase 53), a rank's launches in the conv-FFN route's
        if name in tp_conv_kernels:                         # mesh.model = 2 step (54)
            row["tensor_parallel"] = tp_conv_kernels[name]
        if name in conv_counts:
            row.setdefault("tp_step_launches_a_rank", {})["far_conv_tp"] = conv_counts[name]

    gc.collect()
    torch.cuda.empty_cache()
    tp4_kernels = tp_quarter_kernel_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    tp4_extra = tp_phases(dev, card, which=(56,))
    tp4_counts = tp4_extra.get("far_ffn_tp4", {}).get("launches") or {}
    for row in rows_out:          # #7-#10 on a quarter of the hidden (phase 55), a rank's
        name = row["name"]        # launches in the fused-FFN route's mesh.model = 4 step (56)
        if name in tp4_kernels:
            row["hidden_quarter"] = tp4_kernels[name]
        if name in tp4_counts:
            row.setdefault("tp_step_launches_a_rank", {})["far_ffn_tp4"] = tp4_counts[name]
    gc.collect()
    torch.cuda.empty_cache()
    try:
        example_extra = example_phase(dev, entry_root, entry_root / "ae", entry_root / "far")
        gc.collect()
        torch.cuda.empty_cache()
        f16_counts, f16_extra, f16_summary = f16_phases(dev, card, entry_root)
        for row in rows_out:      # #1-#6's f16 rows: launches in phase 58's f16 runs
            if row["name"].endswith("_f16"):
                for key, counts in f16_counts.items():
                    row[key] = counts[row["name"][:-4]]
    finally:
        entry_dir.cleanup()

    phase("60. result")
    print(f"  predict_ms {pred_ms:.3f} plain_predict_ms {plain_pred_ms:.3f} "
          f"train_step_ms {step_ms:.3f} plain_train_step_ms {plain_step_ms:.3f} "
          f"train_frames_per_s {frames_per_step / step_ms * 1e3:.1f} "
          f"train_peak_gib {step_peak:.3f}")
    print(f"  {nar_summary}")
    print(f"  {json.dumps(nar_extra)}")
    print(f"  {ffn_summary}")
    print(f"  {json.dumps(ffn_extra)}")
    print(f"  {conv_summary}")
    print(f"  {json.dumps(conv_extra)}")
    print(f"  {ae_summary}")
    print(f"  {json.dumps(ae_extra)}")
    print(f"  {cli_summary}")
    print(f"  {json.dumps(cli_extra)}")
    print(f"  {tslma_summary}")
    print(f"  {json.dumps(tslma_extra)}")
    print(f"  {dp_summary}")
    print(f"  {json.dumps(dp_extra)}")
    print(f"  upstream .tar: {json.dumps(upstream_extra)}")
    print(f"  remat: {json.dumps(remat_extra)}")
    print(f"  scan_layers: {json.dumps(scan_extra)}")
    print(f"  tensor parallel: {json.dumps(tp_extra)}")
    print(f"  tensor parallel, fused-FFN route: {json.dumps(tp_ffn_extra)}")
    print(f"  tensor parallel, conv-FFN route: {json.dumps(tp_conv_extra)}")
    print(f"  tensor parallel at mesh.model 4, fused-FFN route: {json.dumps(tp4_extra)}")
    print(f"  the examples: {json.dumps(example_extra)}")
    print(f"  {kth_summary}")
    print(f"  {KTH}: {json.dumps(kth_extra)}")
    print(f"  float16: {f16_summary}")
    print(f"  float16: {json.dumps(f16_extra)}")
    print(f"  the whole run: {time.perf_counter() - run_start:.1f} s")
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed: {failures}",
              file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": rows_out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        sys.exit(dp_worker(sys.argv[2:]))
    sys.exit(main())
