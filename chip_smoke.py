#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (imageenhancement_mp_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. Prints the Python, torch and CUDA versions and the card's name and power
   limit from nvidia-smi; exits non-zero when torch sees no CUDA device.
2. Builds the kernels from imageenhancement_mp_tpu_torch/kernels/csrc with
   nvcc (sm_90a) into build/ie_torch_kernels/ and prints the build time and
   ptxas's register and shared-memory report; fails if ptxas spilled in a
   median kernel (median.cu, fused.cu).
3. Holds each kernel against its plain PyTorch version on the card, at 0 LSB,
   over the CPU tests' cases plus tiny planes, a storage offset of one element,
   sep_conv_u8's every instance and route (k 3/5/7, runtime; packed, int32;
   blur, lane and FMA epilogues) on its residues (widths = 0, 1, 15 mod 16,
   across its warps' 240 (runtime instance 224) columns, 1917, 1, 2, 3;
   heights across its 8-row warps and 64-row blocks; edge-only planes), each
   also misaligned,
   1080x1920 and 4K planes, non-divisible CLAHE geometries, tiles of a few
   pixels (the u8 blend's narrow chunks and one-row bands), the geometry
   where the TPU quadrant blend is wrong (164x164, grid 2x2), clip limits 0,
   2 and 40, u16 tables, a [70000, 8, 8] batch (more planes than a grid axis
   of 65535 holds) and a 1100x1080x1920 batch (flat offsets past 2^31), and
   times both at the main paths' shapes.  K1's two counting kernels
   (hist256, hist256_tiles) are also held on random, smooth (a 9x16 grid of
   u8 values upsampled bilinearly, plus +-2 noise) and constant (all 255)
   planes, each at odd widths and misaligned by one byte, and on
   [1, 2_200_000, 8], and timed on each kind of plane.  u16 CLAHE's stage A
   (hist65536_tiles), stages A and B in one launch (tile_luts65536: the
   cluster kernel with stage B in its epilogue) and the blend are held on
   random, smooth, constant, 12-bit
   (values below 4096) and two-extreme ({0, 65535}) planes at eleven
   geometries (divisible and not, tiles of a few pixels, one tile column,
   the 164x164 grid 2x2 one, 1079x1917, 4K), each also at a storage offset
   of one element, on tiles of 65535 and of 153600 equal pixels (an even,
   an odd, the first and the last bin), [70000, 8, 8] (grid 1x1) and
   [1, 2_200_000, 8], and timed on each kind at 2x2160x3840 beside their
   bytes bounds, stage A also beside one torch.bincount.  Stage B at
   S = 65536 (clahe_lut, one cluster of blocks a tile) is also held on
   peaked random histograms and on stage_b_cases' adversarial ones (an
   excess for each value step can take, resid 0 and 65535, all mass in one
   bin, tiles of one pixel, areas up to 2^31 - 1; T = 1, 3, 13 and 511),
   and timed on each kind of u16 plane beside its bytes bound.
   The fused count + LUT kernels (hist256_lut: each plane's equalize LUT,
   tile_luts256: each tile's CLAHE LUT, stage B run by the last block of a
   plane or tile on its finished histogram) are held against their plain
   versions on random, smooth, constant and two-valued planes at
   8x1080x1920, 2x2160x3840 (config 5's tiles), 1079x1917 and five small or
   uneven geometries, each also misaligned by one byte, clip 0, 2 and 40;
   on [70000, 8, 8] (grids 2x2 and 8x8), [1, 2_200_000, 8] and the last
   planes of the 1100x1080x1920 batch; over 100 back-to-back calls of
   changing plane count and tile grid on one stream and 20 rounds of calls
   interleaved on two streams, which hold only if every ticket counter
   comes back to 0; on 20x4000x4000 tiles of one plane each (more scratch
   rows than a stream's workspace keeps); and timed on each kind of plane.
4. Drives the first main path through the public functions — equalize_unsharp
   at 8x1080x1920 and 2x2160x3840 and equalize_hist at 8x1080x1920, u8 from
   numpy seed 0 — each call with the launch counters set to 0 just before
   and read just after; fails unless each of its kernels was launched
   exactly once (and no other kernel at all): hist256_lut and sep_conv_u8
   for equalize_unsharp, hist256_lut and apply_lut256 for equalize_hist.  Holds the
   results against the plain path on the card and one 1080p frame against
   the plain path on the CPU, at 0 LSB, then times equalize_unsharp (kernel
   path vs plain path, CUDA events around 10 back-to-back calls, median of 20
   such runs after 3 warm-up calls).
5. Drives config 5 (median 5x5 -> CLAHE 2.0, 8x8 -> unsharp) the same way:
   get_preset("denoise_clahe_sharpen") on 2x2160x3840 u8, stream_frames over
   8 such batches from host NumPy, clahe on 1x2160x3840x3 RGB and on
   2x2160x3840 u16, median_blur(5) on u16 and i16, each path with counters
   of its own; fails unless each path launched exactly its kernels (median,
   tile_luts256, clahe_blend, sep_conv_u8 once per batch through the
   preset; tile_luts256 and clahe_blend for u8 clahe, tile_luts65536 and
   clahe_blend for u16; median for median_blur) and no other; hist256_tiles
   and hist65536_tiles (stage A alone) and clahe_lut at S = 65536 (stage B
   alone), on no path, are each driven by itself once.
   Before the paths, holds the median kernel (the schedules of
   median_networks.cuh) against its plain networks at 0 LSB, k 3 and 5, u8,
   u16 and i16: each residue of the thread and block tiles (1x1, 2x3, 5x7,
   37x131, 1079x1917), random, {0, 1}, constant, ramp and two-extreme planes
   ({0, 65535} u16, {-32768, 32767} i16: lanes that leaked into each other
   would show), a storage offset of one element, [70000, 8, 8] and
   [1, 2_200_000, 8].
   Holds every result against the plain path on the card, the streamed
   outputs against the direct calls, and one 4K frame against the plain path
   on the CPU, at 0 LSB; then times each path, kernels against plain, and
   median_blur at k 3 and 5 on each type beside its bytes bound and its issue
   floor (the schedule's min/max instructions per pixel over 132 SMs x 64
   lanes at the SM clock nvidia-smi reports as clocks.max.sm).
6. Holds the bilateral and athresh kernels against their plain versions at
   0 LSB: bilateral at d 3, 5, 7, 9 and 11 (each compile-time instance, and
   the runtime instance at the same radius), 13, 51 and sigma-derived radii;
   sigma pairs 75/75, 30/30, 10/200; widths 0, 1 and 7 mod 8 and across the
   64-column tile, heights across its 32 rows, tiny planes, planes smaller
   than the radius, a plane whose colour-table indices differ across each
   warp's lanes; athresh at every block size 3 to 51 through the screen (3
   to 11 also through the runtime instance; 3, 11, 31 and 51 also with the
   f64 recompute forced on every pixel), 61 and 101 through the two-pass
   route, both types, C in {-3.5, 0, 2, 7.2}, across the 64x64 tile; a
   storage offset of one element, 1079x1917, [70000, 8, 8]; prints ptxas's
   registers and spills for each instance, the issue floors at the timed
   shape and the share of pixels the screen recomputes there (from its plain
   mirror); runs a [1, 2_200_000, 8] plane (more row tiles
   than a grid axis of 65535 holds) through sep_conv_u8, median, CLAHE,
   bilateral and athresh against their plain versions; then drives
   bilateral_filter(9, 75, 75), adaptive_threshold(gaussian, 11, 2),
   threshold(otsu) and make_pipeline(bilateral -> adaptive_threshold) at
   2x2160x3840 u8, each with counters of its own (exactly one bilateral, one
   athresh, one hist256 launch, one of each), against the plain path on the
   card and one 4K frame against the plain path on the CPU, and times them.
7. The warp family: holds warp_gather_u8 against its plain version at 0 LSB
   (linear and nearest; constant border with values 9 and 300, saturated to
   255 as the ops do, and replicate; rotations 15, 31 and -23 degrees at
   scales 0.9, 1.1 and 0.125, a shear-translate, three homographies, polar
   forward and inverse, linear and semilog, random remap maps reaching
   +-3e9; 1x1 and 2x3 planes, a storage offset of one element, [70000, 8,
   8], a [1, 2_200_000, 8] plane under the identity map and a
   1100x1080x1920 batch); holds its matrix route (warp_matrix_u8: the
   coordinates computed in the kernel) against the plain gather at the
   torch-built field over the same affines and homographies, corners past
   +-2e9, a zero denominator, outputs with ow % 16 in {0, 1, 7, 15}, the
   tiny and misaligned planes, [70000, 8, 8], the [1, 2_200_000, 8] plane
   under the identity matrix and the 1100x1080x1920 batch (rot15 and a
   homography); checks that the affine and perspective fields built on the
   card equal the host NumPy fields bit for bit, then drives warp_affine
   (rot15), warp_perspective, warp_polar and remap at 2x2160x3840 u8
   through the public functions, each with counters of its own (exactly one
   warp_gather_u8 launch and no other kernel), against the plain path on the
   card and one 4K frame against the plain path on the CPU, and times them
   with the device's busy share under torch.profiler: the kernel on both
   routes, the map build, polar's first (map-building) call apart from its
   cached calls, and torch's grid_sample (bilinear, f32) as a yardstick
   that is not the same function.
8. Computes each kernel's bound at its timed shape and times the PyTorch
   calls that compute the same function (bincount over plane or tile
   offsets, gather).
9. Colour conversion and non-local means: holds take_table against its
   plain version at 0 LSB (the K15 probe's [8, 128] inputs against their
   expected output; shared [L] and per-plane [B, L] tables, int32 and
   int64, L in {1, 128, 256, 3072, 4096, 36864, 35937} and on both sides of
   the shared-memory limit, indices at 0, at L - 1 and beyond both ends,
   1x1 planes, a storage offset of one element, [70000, 8, 8] and
   [1, 2_200_000, 8]); runs every cvt_color code and dtype on 2x270x480
   card against CPU (0 LSB, the f32 tolerances, +-1 on u8 luv2rgb with the
   share printed); then drives cvt_color rgb2lab, lab2rgb, rgb2luv and
   rgb2gray at 32x1080x1920x3, clahe_lab at 1x2160x3840x3 and the four
   non-local-means functions at 1080p (and u16 L1 at 512x512), each with
   counters of its own (exactly 6, 9, 25, 0, 15 plus tile_luts256 and
   clahe_blend, 441, 891, 1323 and 441 take_table launches), against the plain
   path on the card (the same ops with take_table_plain) and on the CPU at
   0 LSB, and times them; then times take_table alone at the rgb2lab shape
   beside its bound and torch.take.
10. The LUT family and the fused median -> unsharp: holds apply_lut256
   (every table dtype: u8, and u16/i16/i32/f32 through apply_lut256_wide),
   apply_luts_multi (K in {1, 9, 64}, across the 32-table shared-memory
   chunk) and median_unsharp (km 3 and 5, amounts 1, 1.5, -0.5, 2 and 64,
   ksize 3, 5 and 31) against their plain versions bit for bit (i32 entries
   at +-(2^31 - 1), f32 infinities, NaN, NaN payloads and subnormals; the
   CPU tests' cases, 1x1 and 2x3 planes, a storage offset of one element,
   widths 15 to 300001 at byte offsets 1, 4, 8 and 12 (the wide route's
   heads, tails and vector paths), 1079x1917, [70000, 8, 8],
   [1, 2_200_000, 8]; for median_unsharp also the median
   network cases of phase 5 on u8) and median_unsharp against the
   median -> sep_conv_u8 chain; then drives config 2
   (get_preset("gamma_stretch") on 32x1080x1920x3: exactly 2 apply_lut256
   launches), equalize_hist(per_frame=False) on 8x1080x1920x3 (one
   hist256_lut pooling a group a channel, one apply_lut256; the grouped
   LUTs held against their plain version first at C = 1, 3 and B on 8 1080p
   frames), apply_lut_planes with [8, 256] f32
   tables (one apply_lut256_wide), apply_luts_multi K = 9 (one launch) and
   median_unsharp(5, 1.0, 5) at 2x2160x3840 (one launch, equal to the chain),
   each against the plain path on the card and on the CPU; then times the
   paths and each kernel beside its bound, torch.gather (K5, K13) and the
   two-kernel chain (K14, with its median's issue floor).
11. The filters and config 3: holds sep_conv_u8 past 31 taps (its wide
   instance where an axis keeps more than 31 taps once its zero ends are
   trimmed, taps from a device buffer) against its plain version at 0 LSB:
   33 and 37 taps (sigma 6 on u8), 33x5, 3x37, 1x35, 37x3, 67, 121, an
   asymmetric 33x33 and 541 taps (a halo deeper than the tile and than the
   small planes), printing each set's route, on fourteen shapes (the
   runtime instance's residues, tiny planes), each epilogue, with and
   without a LUT, each also misaligned, 8x1080x1920 at every timed set
   from 33 to 541 taps, [70000, 8, 8] and [1, 2_200_000, 8]; times it at
   8x1080x1920 from 33 to 541 taps beside its bound (bytes, or its MACs
   after trimming at the int8 rate, whichever is larger) and the k 5
   instance; drives gaussian_blur at sigma 6 and 20, unsharp_mask(1.0, 35)
   and equalize_unsharp(1.0, 33), one sep_conv_u8 launch each (and one
   hist256_lut), one frame card against CPU; runs every function of
   ops/filters.py (gaussian_blur and unsharp_mask on u16/i16/f32,
   laplacian, laplacian_sharpen, sobel, scharr, box_blur, box_filter,
   corner_harris, corner_min_eigen_val, spatial_gradient, sqr_box_filter,
   stack_blur; 48 calls over their dtypes) on 2x2160x3840 card against CPU
   at 0 (f32 too: the same torch ops in the same order, the min-eigenvalue
   root rounded from f64), each with counters of its own (no kernel); then
   drives config 3 (make_pipeline gaussian_blur(k) -> laplacian_sharpen ->
   unsharp_mask(1.0, k), k 3 and 5) on 8x1080x1920 and 2x2160x3840 u8,
   each with counters of its own (exactly two sep_conv_u8 launches), one
   frame card against CPU at 0 LSB, timed back to back and device-paced
   beside its 6 B/px floor, its device time split by kernel under
   torch.profiler.
12. The rest of the registry and median_unsharp past 31 taps: holds
   median_unsharp at ksize 33, 37 and 101 (km 3 and 5; the median ->
   sep_conv_u8 chain) against its plain version at 0 LSB on phase 10's
   shapes, each also misaligned, and at 2x2160x3840 (exactly one median and
   one sep_conv_u8 launch) and times it beside the fused kernel at ksize
   31; runs every function of this slice (morphology_ex's seven ops at rect
   3 and 15 and ellipse 15, erode/dilate with iterations 2, filter2d with an
   integer 3x3, a float 5x5 and a float 15x15 kernel, pyr_down, pyr_up,
   resize with every interpolation down to 1080x1920 and up to 4320x7680,
   the general area downscale to 1000x1800, flip, rotate, transpose, Canny
   at apertures 3/5/7 L1 and L2, connected components at connectivity 4
   and 8 on a thresholded plane, match_template with a 32x32 template and
   every method, add_weighted, integral with sq off and on,
   apply_color_map, calc_back_project; u8, and u16/i16/f32 where they take
   them; 121 calls) on 2x2160x3840 with counters of its own
   (calc_back_project exactly one apply_lut256, the rest none), holds the
   first plane, or a 1080x1920 corner on both devices where the CPU is
   slow, against the plain path on the CPU (0, except match_template at
   3e-6 of the largest value and f32 integrals at one f32 ulp: the f64
   scans sum in another order on each device) and times each back to back;
   then drives the inspection chain (make_pipeline resize area 1080x1920 ->
   morphology tophat 15 -> canny 50/150, then connected_components 8) on
   2x2160x3840 u8 with counters of its own (no kernel), the first plane
   card against CPU at 0, prints the hysteresis steps, times it back to
   back and splits its device time by torch kernel under torch.profiler.
13. Arithmetic, statistics and the video-tracking family (plain torch on the
   card; no kernel of their own): every per-element op (add, subtract,
   absdiff, min, max, multiply and divide at scales 1, 0.37 and 255, compare
   gt and eq, the bitwise ops) on 2x2160x3840 u8/u16/i16/f32 with zero
   divisors and 0/0, the four accumulators (u8/u16/f32 into f32, masked and
   not) and blend_linear (u8 and f32 4K, u8 4K RGB), each card against CPU
   at 0 (NaN and infinities at the same places; the 2x2160x3840 calls on
   their first plane on the CPU) with counters of its own (no kernel); psnr(frames, equalize_unsharp(frames)) at 8x1080x1920 (one
   hist256_lut and one sep_conv_u8), norm l1/l2/inf of the frames and of
   the difference, mean_std_dev, min_max_loc of a 32x32 match_template
   response on a 2160x3840 plane, moments_device of a u8 and an f32
   2160x3840 plane (integer inputs equal, f32 within 1 ulp); the tracking
   chain on a textured 1080p frame and the same scene moved by (2.35, -1.6)
   px with fresh noise: good_features_to_track(500, 0.01, 10),
   corner_sub_pix((5, 5)) and calc_optical_flow_pyr_lk at cv2's defaults
   (21x21, level 3, 30 iterations), exact bitwise card against CPU, the
   median tracked shift within 0.05 px of the true one, exact=False within
   0.1 px; the CamShift chain over 30 frames of 1080p RGB with a moving red
   disc (rgb2hsv, the hue's back projection: exactly 30 apply_lut256
   launches, cam_shift), its windows equal to the CPU's and on the disc;
   pyr_mean_shift_filtering(10, 20, 1) at 480x640 card against CPU at 0,
   timed at 480x640 and 720x1280.  Each family prints its ms per call back
   to back, its device launches per call and busy share under
   torch.profiler.
14. OpenCV's photo module and its companions (plain torch on the card;
   merge_debevec's two f32 tables through apply_lut256_wide, decolor's u8
   Lab legs through take_table): edgePreservingFilter (recursive and
   normconv), detailEnhance, stylization and pencilSketch at cv2's defaults
   on one 1080x1920x3 u8 frame; a three-exposure 2160x3840x3 bracket with
   known shifts through align_mtb (the shifts found equal the true ones) ->
   merge_mertens and merge_debevec (times 1/30, 1/8, 1/2: exactly 2
   apply_lut256_wide launches) -> tonemap (gamma 2.2), Reinhard, Drago and
   Mantiuk; decolor at 1080x1920x3 (exactly 15 take_table launches);
   denoise_tvl1 on 3 observations of 1080x1920, 30 iterations;
   phase_correlate of a 1080x1920 f32 pair under a Hanning window (within
   0.05 px of the true shift); seamless_clone of a 400x600 RGB region into a
   1080x1920 frame; inpaint (Telea, radius 3) of a 480x640 gray image with
   strokes over 1 % of it.  Each with counters of its own, card against CPU
   (pencil, align_mtb and inpaint at 0; the filters and TV-L1 +-1 with the
   differing pixels counted; Mertens 1e-4, Debevec 1e-4 relative, tonemap
   6e-8, the other tonemaps 5e-5 on values finite on both with more than
   99.9 % finite; decolor gray +-1 and boost 8; seamless max 2, mean 0.05;
   the phase shift 0.05 px), each printed with its ms per call, device
   launches per call and busy share under torch.profiler.
15. The segment-and-measure slice (plain torch on the card, no kernel of
   its own; the host helpers on NumPy): distance_transform on a burst of
   eight 1080x1920 masks thresholded from photos (L1, C, L2 3x3, L2 5x5 to
   f32 and L1 to u8), flood_fill on 1080x1920 gray and RGB frames (8- and
   4-connected, fixed range 70 and floating range 20, one with a mask wall
   and mask_only) from a seed in the background, hough_lines (rho 1,
   theta pi/180) on a 1080p Canny map of a photo with eight straight bars,
   and at 480x640 hough_lines_p, find_contours in every mode and method,
   the shape descriptors and match_shapes.  Each device op with counters
   of its own (no kernel), card against CPU at 0 (the first frame of the
   burst; one flood fill at full size and the rest on a 270x480 crop; the
   lines bit for bit), the flood fill's fixpoint steps printed; the host
   helpers on the card's fetched masks and edges against the CPU's, equal.
   Each family prints its ms per call back to back, launches per call and
   busy share under torch.profiler (the host helpers: ms on the host
   clock).
16. The port's entry points: the CUDA self-check
   (selftest.run_selftest((128, 131), 0): the JAX selftest's rows, spatial/cfg5
   on a 1-device mesh of cuda:0 among them, and the 128x256 rows, each on the card with counters of its
   own and again on the CPU, every row within its budget, the 128x256
   rows' exact launches: sep_conv_u8's k 3/5/7, runtime and wide instances,
   hist256_lut, the u8 and u16 CLAHE stages), whether the native frame
   loader and writer built, then the CLI in-process through cli.main: batch
   mode on four 1080x1920 gray frames and one 1080x1920x3 frame
   (histeq -> unsharp:1.0:5; exactly 5 hist256_lut, apply_lut256 and
   sep_conv_u8 launches), once as PGM/PPM and once as PNG, each on the card
   and with --device cpu (no launch), the outputs equal byte for byte and
   the wall time a frame split into decode, H2D, device, D2H and
   encode/write; single-image mode on a 2160x3840 .npy through config 5's
   ops (median:5 clahe:2.0:8:8 unsharp: one median, tile_luts256,
   clahe_blend and sep_conv_u8 launch), card against CPU at 0 LSB.
17. The mesh (parallel/): config 5 batch-sharded on 4x2160x3840 u8 over
   make_mesh(1) and over a mesh that names cuda:0 four times (each of its
   four kernels once per shard), equal to the unsharded call at 0 LSB and a
   frame equal to the CPU plain path; the pooled equalize over the 4-entry
   mesh on 8x1080x1920 (channels 1 and 3: hist256, equalize_lut256 and
   apply_lut256 once per shard; unsharded, hist256_lut and apply_lut256
   once); config 5 row-sharded on one 4320x7680 frame,
   u8 and u16; each of the 16 non-pointwise spatial twins on a 2160x3840
   frame, every kernel of the unsharded call once per shard; three batches
   through stream_frames(mesh=), each output sharded and equal to the
   unsharded call; back-to-back ms and host us a call of the unsharded call,
   the 1-device mesh and the four shards on one card (not a scaling figure).
   The geometry twins on the 4320x7680 frame, row-sharded over the 4-entry
   mesh: resize to 2160x3840 (nearest, linear, cubic, Lanczos-4, area) and
   to 1728x3072 (the general area downscale), u16 linear; warpAffine rot15
   x0.9 into a centred 2160x3840 window in u8 linear and nearest
   (warp_gather_u8's matrix route with each shard's first row: once per
   shard), u16 linear, i16 linear and f32
   cubic; u8 remap on maps split by rows and warpPolar forward and inverse
   (its maps route, once per shard); Canny (3, L1) and (5, L2); each equal
   to the unsharded call at 0 LSB (f32 bit for bit) and timed beside it.
   The matrix route with a first row other than 0 is held against its plain
   version.
18. The port's clock (profiling.py) on equalize_unsharp 8x1080x1920, config
   2 (get_preset("gamma_stretch") on 32x1080x1920x3), config 3
   (make_pipeline(config3_stages(5)) on 8x1080x1920) and config 5
   (get_preset("denoise_clahe_sharpen") on 2x2160x3840): each path's chain
   replayed as CUDA graphs equal to the eager chain on the card (n 2 and 5)
   and, on 2x270x480, to the CPU plain chain (n 1, 2 and 5), at 0; then
   time_op (blocked), time_op_chained (target 0.25 s), the back-to-back and
   sleep-paced event clocks, torch.profiler's kernel sum a call and the
   bytes bound on one line, failing if the chained time is below the
   bound, with whether the sleep outlasts the host's enqueue; time_op on
   merge_mertens over a list of three 2160x3840x3 exposures and in a
   closure that returns nothing, each failing if it reads less than the
   call's device time (its kernels under torch.profiler); Otsu, which
   reads the host, must make time_op_chained raise.
19. Prints a one-line JSON per-kernel summary (launches on the main paths,
   max_abs_err, kernel and plain ms, the bound from bytes or operations at
   the timed shape, and the time of one PyTorch call computing the same
   function where there is one), then, as the last line,
   {"ok": true, "device": {...}}.

Every check raises on failure; nothing is caught but the one refusal phase 18
expects (and fails without).  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
PKG = "imageenhancement_mp_tpu_torch"
MAIN_KERNELS = ("hist256_lut", "apply_lut256", "sep_conv_u8")
CONFIG5_KERNELS = ("median", "tile_luts256", "clahe_blend", "sep_conv_u8")
SLICE3_KERNELS = ("bilateral", "athresh")
# held in phase 3; hist256 serves Otsu and the mesh's pooled equalize_hist,
# hist256_tiles is stage A alone, equalize_lut256 serves the mesh's pooled
# equalize_hist, clahe_lut (stage B alone) no path
SCAN_KERNELS = ("hist256", "equalize_lut256", "hist256_tiles", "clahe_lut")
KERNELS = MAIN_KERNELS + CONFIG5_KERNELS[:-1] + SCAN_KERNELS + SLICE3_KERNELS
WARP_KERNELS = ("warp_gather_u8",)
TAKE_KERNELS = ("take_table",)
LUT_KERNELS = ("apply_lut256_wide", "apply_luts_multi", "median_unsharp")
U16_KERNELS = ("hist65536_tiles", "tile_luts65536")
# the summary line's order: every kernel of earlier slices as before, the
# fused ones last
ALL_KERNELS = (("hist256", "equalize_lut256", "apply_lut256", "sep_conv_u8", "median",
                "hist256_tiles", "clahe_lut", "clahe_blend") + SLICE3_KERNELS + WARP_KERNELS
               + TAKE_KERNELS + LUT_KERNELS + U16_KERNELS[:1] + ("hist256_lut", "tile_luts256")
               + U16_KERNELS[1:])
SOURCES = {
    "hist256": f"{PKG}/kernels/csrc/hist.cu",
    "equalize_lut256": f"{PKG}/kernels/csrc/hist.cu",
    "apply_lut256": f"{PKG}/kernels/csrc/hist.cu",
    "sep_conv_u8": f"{PKG}/kernels/csrc/conv.cu",
    "median": f"{PKG}/kernels/csrc/median.cu",
    "hist256_tiles": f"{PKG}/kernels/csrc/clahe.cu",
    "clahe_lut": f"{PKG}/kernels/csrc/clahe.cu",
    "clahe_blend": f"{PKG}/kernels/csrc/clahe.cu",
    "bilateral": f"{PKG}/kernels/csrc/bilateral.cu",
    "athresh": f"{PKG}/kernels/csrc/athresh.cu",
    "warp_gather_u8": f"{PKG}/kernels/csrc/warp.cu",
    "take_table": f"{PKG}/kernels/csrc/take.cu",
    "apply_lut256_wide": f"{PKG}/kernels/csrc/hist.cu",
    "apply_luts_multi": f"{PKG}/kernels/csrc/hist.cu",
    "median_unsharp": f"{PKG}/kernels/csrc/fused.cu",
    "hist65536_tiles": f"{PKG}/kernels/csrc/clahe.cu",
    "hist256_lut": f"{PKG}/kernels/csrc/hist.cu",
    "tile_luts256": f"{PKG}/kernels/csrc/clahe.cu",
    "tile_luts65536": f"{PKG}/kernels/csrc/clahe.cu",
}
REPLACES = {
    "hist256": "imageenhancement_mp_tpu/kernels/hist.py:156",
    "equalize_lut256": "imageenhancement_mp_tpu/kernels/hist.py:572",
    "apply_lut256": "imageenhancement_mp_tpu/kernels/hist.py:228",
    "sep_conv_u8": "imageenhancement_mp_tpu/kernels/conv2.py:326",
    "median": "imageenhancement_mp_tpu/kernels/median.py:126",
    "hist256_tiles": "imageenhancement_mp_tpu/kernels/hist.py:156 via imageenhancement_mp_tpu/ops/clahe.py:212",
    "clahe_lut": "imageenhancement_mp_tpu/ops/clahe.py:74 (an XLA stage; no Pallas kernel)",
    "clahe_blend": "imageenhancement_mp_tpu/kernels/clahe_u16.py:201 and imageenhancement_mp_tpu/kernels/clahe_blend.py:136",
    "bilateral": "imageenhancement_mp_tpu/kernels/bilateral.py:158",
    "athresh": "imageenhancement_mp_tpu/kernels/dfconv.py:183",
    "warp_gather_u8": "imageenhancement_mp_tpu/kernels/warp.py:241",
    "take_table": "imageenhancement_mp_tpu/kernels/hist.py:415 and imageenhancement_mp_tpu/kernels/hist.py:87",
    "apply_lut256_wide": "imageenhancement_mp_tpu/kernels/hist.py:281 and imageenhancement_mp_tpu/kernels/hist.py:228 (u16/i16/i32/f32 tables)",
    "apply_luts_multi": "imageenhancement_mp_tpu/kernels/hist.py:350",
    "median_unsharp": "imageenhancement_mp_tpu/kernels/fused.py:240",
    "hist65536_tiles": "imageenhancement_mp_tpu/ops/clahe.py:55-61 (an XLA stage; no Pallas kernel)",
    "hist256_lut": "imageenhancement_mp_tpu/kernels/hist.py:572 (equalize_hist_pallas's histogram and LUT phases) and imageenhancement_mp_tpu/kernels/hist.py:156",
    "tile_luts256": "imageenhancement_mp_tpu/kernels/hist.py:156 via imageenhancement_mp_tpu/ops/clahe.py:212, and imageenhancement_mp_tpu/ops/clahe.py:74 (an XLA stage)",
    "tile_luts65536": "imageenhancement_mp_tpu/ops/clahe.py:55-61 and :74-97 (XLA stages)",
}
# each timed run is CALLS_PER_RUN back-to-back calls between two CUDA events:
# the steady state of a stream of batches, which an isolated call (whose
# host enqueue time lands between its events) overstates
TIMED_RUNS, WARMUPS, CALLS_PER_RUN = 20, 3, 10
# the least time a kernel could take: H100 SXM data sheet, 3.35 TB/s HBM3,
# 67 TFLOP/s f32 and 34 TFLOP/s f64 outside the tensor cores, 1,979 TOP/s
# int8 (dense, on the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "f64": 34e12, "int8": 1979e12}


def bound_ms(nbytes: float, ops: float = 0.0, kind: str = "f32") -> tuple[float, str]:
    """The larger of bytes over the memory rate and operations over the peak
    rate for their type, in ms, and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def sm_clock_max_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.strip().splitlines()[0])


def issue_floor_ms(k: int, pixels: int, clock_mhz: float) -> float:
    """The median's integer issue floor: the tile schedule's min/max
    instructions per pixel (two 16-bit lanes per instruction) over 132 SMs
    issuing 64 of them per clock."""
    from imageenhancement_mp_tpu_torch.kernels import median_networks as mnet
    per_px = next(s.ops_per_output for s in mnet.SCHEDULES if s.name == f"median_tile{k}") / 2
    return per_px * pixels / (132 * 64 * clock_mhz * 1e6) * 1e3


def doc_issue_floors_ms(visits: int, k: int, pixels: int, clock_mhz: float) -> tuple[float, float]:
    """Issue floors of the document kernels over 132 SMs issuing 128 lanes of
    instructions per clock: bilateral, 6 instructions per disc visit (its
    four rounded f32 operations, the table gather and the add that forms its
    address); athresh, the screen's 2k FFMAs per pixel (k per pass)."""
    lanes_per_ms = 132 * 128 * clock_mhz * 1e6 / 1e3
    return 6 * visits / lanes_per_ms, 2 * k * pixels / lanes_per_ms


# planes for the median schedules: random, {0, 1}, constant, a ramp, and the
# type's two extremes at random (packed lanes that leaked into each other
# would show)
NETWORK_PLANES = ("random", "0/1", "constant", "ramp", "extremes")
NETWORK_SHAPES = [(1, 1, 1), (1, 2, 3), (2, 5, 7), (1, 37, 131), (1, 1079, 1917)]


def network_planes(dtype, shape: tuple, kind: str, rng) -> np.ndarray:
    info = np.iinfo(dtype)
    if kind == "random":
        return rng.integers(info.min, info.max + 1, shape).astype(dtype)
    if kind == "0/1":
        return rng.integers(0, 2, shape).astype(dtype)
    if kind == "constant":
        return np.full(shape, info.max // 3, dtype)
    if kind == "ramp":
        _, H, W = shape
        ramp = (np.arange(H)[:, None] * 257 + np.arange(W)[None, :] * 13) % (info.max - info.min + 1)
        return np.broadcast_to(ramp + info.min, shape).astype(dtype)
    return np.where(rng.integers(0, 2, shape) == 1, info.max, info.min).astype(dtype)


# K1's planes: random; smooth (a 9x16 grid of u8 values upsampled
# bilinearly, plus +-2 noise: most lanes of a warp count one bin or two); and
# constant 255, a blank page (every lane on one bin)
K1_PLANES = ("random", "smooth", "constant")


def k1_planes(shape: tuple, kind: str, rng) -> np.ndarray:
    B, H, W = shape
    if kind == "random":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    if kind == "constant":
        return np.full(shape, 255, np.uint8)
    ys, xs = np.linspace(0, 8, H), np.linspace(0, 15, W)
    y0, x0 = np.minimum(ys.astype(np.int64), 7), np.minimum(xs.astype(np.int64), 14)
    fy, fx = (ys - y0)[:, None], (xs - x0)[None, :]
    out = np.empty(shape, np.uint8)
    for b in range(B):
        g = rng.integers(0, 256, (9, 16)).astype(np.float64)
        v = ((g[y0][:, x0] * (1 - fx) + g[y0][:, x0 + 1] * fx) * (1 - fy)
             + (g[y0 + 1][:, x0] * (1 - fx) + g[y0 + 1][:, x0 + 1] * fx) * fy)
        out[b] = np.clip(np.rint(v) + rng.integers(-2, 3, (H, W)), 0, 255)
    return out


def fold_planes(shape: tuple, kind: str, rng) -> np.ndarray:
    """k1_planes' kinds and two-valued planes ({3, 200}, a binarised scan)."""
    if kind == "two-valued":
        return np.where(rng.integers(0, 2, shape) == 1, 200, 3).astype(np.uint8)
    return k1_planes(shape, kind, rng)


FOLD_PLANES = K1_PLANES + ("two-valued",)


# u16 CLAHE's planes: random; smooth (k1_planes' pattern on a 9x16 grid of
# u16 values, plus +-2 noise); constant 40000; 12-bit (random below 4096, a
# medical or raw-sensor frame); extremes ({0, 65535})
U16_PLANES = ("random", "smooth", "constant", "12-bit", "extremes")


def u16_planes(shape: tuple, kind: str, rng) -> np.ndarray:
    B, H, W = shape
    if kind == "random":
        return rng.integers(0, 65536, shape).astype(np.uint16)
    if kind == "constant":
        return np.full(shape, 40000, np.uint16)
    if kind == "12-bit":
        return rng.integers(0, 4096, shape).astype(np.uint16)
    if kind == "extremes":
        return (rng.integers(0, 2, shape) * 65535).astype(np.uint16)
    ys, xs = np.linspace(0, 8, H), np.linspace(0, 15, W)
    y0, x0 = np.minimum(ys.astype(np.int64), 7), np.minimum(xs.astype(np.int64), 14)
    fy, fx = (ys - y0)[:, None], (xs - x0)[None, :]
    out = np.empty(shape, np.uint16)
    for b in range(B):
        g = rng.integers(0, 65536, (9, 16)).astype(np.float64)
        v = ((g[y0][:, x0] * (1 - fx) + g[y0][:, x0 + 1] * fx) * (1 - fy)
             + (g[y0 + 1][:, x0] * (1 - fx) + g[y0 + 1][:, x0 + 1] * fx) * fy)
        out[b] = np.clip(np.rint(v) + rng.integers(-2, 3, (H, W)), 0, 65535)
    return out


def stage_b_cases(rng) -> list:
    """Adversarial [T, 65536] int32 histograms for CLAHE stage B (the
    closed form of csrc/clahe.cu::clahe_lut16_kernel): ``(label, hists,
    area, clip limits)``.  An excess over clip_abs = 1 (clip limit 1e-9) in
    the residue class mod 65536 that gives each value step can take (the
    least such resid), resid 0 and 65535, T = 1; all mass in one bin, tiles
    of one pixel, areas up to 2^31 - 1 with and without a clip; T = 13."""
    S, tiny = 65536, 1e-9

    def with_excess(resids, area):
        # n ones on random bins and the rest in one more: excess = area - 1 - n
        h = np.zeros((len(resids), S), np.int32)
        for t, rho in enumerate(resids):
            n = (area - 1 - int(rho)) % S
            bins = rng.permutation(S)[:n + 1]
            h[t, bins[:n]] = 1
            h[t, bins[n]] = area - n
        return h

    area = 3 * S + 12345
    step_resids = sorted({max(S // r, 1): r for r in range(S - 1, 0, -1)}.values())
    cases = [("an excess for each value of step", with_excess(step_resids, area), area, (tiny,)),
             ("resid 0, 65535, 0", with_excess([0, S - 1, 0], area), area, (tiny,)),
             ("resid 65535", with_excess([S - 1], area), area, (tiny,))]
    for a in (1, 7, 153600, 2**31 - 1):
        one = np.zeros((13, S), np.int32)
        one[np.arange(13), rng.integers(0, S, 13)] = a
        cases.append(("all mass in one bin", one, a, (0.0, tiny, 2.0, 40.0)))
    big = 2**31 - 12
    cases.append(("random", np.stack([rng.multinomial(big, p) for p in
                                      rng.dirichlet(np.full(S, 0.05), size=3)]).astype(np.int32),
                  big, (0.0, 2.0, 40.0)))
    return cases


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} {b.dtype}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64).to(a.device)).abs().max())


def time_ms(fn, runs: int = TIMED_RUNS, calls: int = CALLS_PER_RUN,
            warmups: int = WARMUPS) -> tuple[float, float]:
    """Median and interquartile range over ``runs`` runs of the per-call time
    of ``fn`` (ms), each run timing ``calls`` back-to-back calls with two
    CUDA events."""
    for _ in range(warmups):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    q1, q2, q3 = statistics.quantiles(times, n=4)
    return q2, q3 - q1


def device_split(fn, calls: int = CALLS_PER_RUN,
                 warmups: int = WARMUPS) -> tuple[float, float, list]:
    """Device time per call by kernel under torch.profiler over ``calls``
    back-to-back calls of ``fn``: (busy us per call, wall us per call, [(us
    per call, launches per call, kernel name)] largest first)."""
    from torch.autograd import DeviceType
    for _ in range(warmups):
        fn()
    torch.cuda.synchronize()
    acts = [a for a in (torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA)
            if a in torch.profiler.supported_activities()]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels: dict[str, list] = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            k = kernels.setdefault(ev.name, [0.0, 0])
            k[0] += ev.time_range.elapsed_us()
            k[1] += 1
    rows = sorted(((t / calls, n / calls, name) for name, (t, n) in kernels.items()), reverse=True)
    return sum(r[0] for r in rows), wall_us / calls, rows


def busy_share(fn, calls: int = CALLS_PER_RUN) -> str:
    """The device's busy share over ``calls`` back-to-back calls of ``fn``
    under torch.profiler: kernel time on the device over the wall time."""
    busy, wall, _ = device_split(fn, calls)
    return (f"under torch.profiler {busy:.2f} us of device time per call in "
            f"{wall:.2f} us of wall, busy {100 * busy / wall:.1f} %")


def noisy(lead: tuple, H: int, W: int, trail: tuple, seed: int, sigma: float) -> np.ndarray:
    """A smooth pattern plus Gaussian noise of ``sigma``, u8, of shape
    ``lead + (H, W) + trail``: the kind of frame non-local means is for."""
    rng = np.random.default_rng(seed)
    yy, xx = np.ogrid[0:H, 0:W]
    base = 128 + 60 * np.sin(yy / 9.0) + 50 * np.cos(xx / 13.0)
    base = base.reshape(base.shape + (1,) * len(trail))
    return np.clip(base + rng.normal(0, sigma, lead + (H, W) + trail), 0, 255).astype(np.uint8)


def colour_and_nlmeans(port, dev, smi, gen, on_card, misaligned, check, drive, clahe_plain,
                       ms, bounds, library) -> dict:
    """Phase 9: take_table against its plain version, then cvt_color,
    clahe_lab and the four non-local-means functions on the card, each with
    counters of its own, against the plain path on the card and the CPU, and
    timed.  Fills ``ms``, ``bounds`` and ``library`` for take_table and
    returns the counts of the cvt_color rgb2lab call."""
    from imageenhancement_mp_tpu_torch.api import _CVT_CODES
    from imageenhancement_mp_tpu_torch.kernels import launch_counts
    from imageenhancement_mp_tpu_torch.kernels import take as ktake
    from imageenhancement_mp_tpu_torch.ops import color as tcolor
    from imageenhancement_mp_tpu_torch.ops import nlmeans as tnlm

    I32, I64 = torch.int32, torch.int64
    before = dict(launch_counts)
    n_take = 0

    def rand_table(shape, dtype) -> torch.Tensor:
        t = torch.randint(-2**31, 2**31 - 1, shape, generator=gen, device=dev, dtype=I64)
        return (t * 4099).to(dtype) if dtype == I64 else t.to(dtype)  # int64: past 32 bits

    def rand_idx(shape, lo: int, hi: int) -> torch.Tensor:
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=I32)

    def check_take(idx: torch.Tensor, tab: torch.Tensor, what: str) -> None:
        nonlocal n_take
        check("take_table", ktake.take_table(idx, tab), ktake.take_table_plain(idx, tab), what)
        n_take += 1

    # (a) the K15 probe's inputs, then shared and per-plane tables of both
    # types, lengths on both sides of the shared-memory limit, indices at 0,
    # at L - 1 and beyond both ends (clamped), tiny planes, offset 1
    tn = torch.arange(8 * 128, dtype=I32, device=dev).view(8, 128)
    ixn = (tn * 7 + 3) % 128
    check("take_table", ktake.take_table(ixn, tn),
          tn[torch.arange(8, device=dev)[:, None], ixn.long()], "K15 probe, its expected output")
    check_take(ixn, tn, "K15 probe")
    for dtype in (I32, I64):
        at_limit = ktake.SMEM_TABLE_BYTES // torch.empty((), dtype=dtype).element_size()
        for L in (1, 128, 256, 3072, 4096, 36864, 35937, at_limit, at_limit + 1):
            for per_plane in (False, True):
                for shape in ((3, 37, 131), (2, 1, 1)):
                    idx = rand_idx(shape, -3, L + 3)
                    idx.view(-1)[0], idx.view(-1)[-1] = 0, L - 1
                    tab = rand_table((shape[0], L) if per_plane else (L,), dtype)
                    what = f"{dtype} L={L} per_plane={per_plane} {shape}"
                    check_take(idx, tab, what)
                    check_take(misaligned(idx), tab, what + " offset 1")
    many = rand_idx((70000, 8, 8), -1, 129)
    check_take(many, rand_table((70000, 128), I32), "[70000, 8, 8] per-plane int32 L=128")
    check_take(rand_idx((70000, 8, 8), 0, 36864), rand_table((36864,), I64),
               "[70000, 8, 8] shared int64 L=36864")
    tall = rand_idx((1, 2_200_000, 8), -1, 4097)
    check_take(tall, rand_table((1, 4096), I32), "[1, 2200000, 8] per-plane int32 L=4096")
    check_take(rand_idx((1, 2_200_000, 8), 0, 35937), rand_table((35937,), I64),
               "[1, 2200000, 8] shared int64 L=35937")
    del many, tall
    torch.cuda.synchronize()
    if launch_counts["take_table"] <= before["take_table"]:
        raise AssertionError("take_table: the comparison phase launched no kernel")
    print(f"take_table vs plain on the card: 0 LSB over {n_take} cases (the K15 probe, int32 "
          f"and int64, shared and per-plane tables, L from 1 to 36864 and on both sides of "
          f"the {ktake.SMEM_TABLE_BYTES}-byte shared-memory limit, 1x1 planes, offset 1, "
          "[70000, 8, 8], [1, 2200000, 8])")

    # every code and dtype on small images, card against the CPU: 0 LSB on
    # the integer paths and the f32 fma32 chains, the stated tolerances on
    # the f32 XYZ (1e-6), Lab and Luv forwards (1e-3), inverses (1e-5), and
    # +-1 on u8 luv2rgb (f32 pow), with the share of differing values
    rng = np.random.default_rng(24)
    small = {np.uint8: rng.integers(0, 256, (2, 270, 480, 4), dtype=np.uint8),
             np.uint16: rng.integers(0, 65536, (2, 270, 480, 4)).astype(np.uint16),
             np.float32: rng.random((2, 270, 480, 4), dtype=np.float32)}
    f32_tol = {"xyz": (1e-6, 1e-6), "lab": (1e-3, 1e-5), "luv": (1e-3, 1e-5)}
    n_codes, worst = 0, {}
    for code in _CVT_CODES:
        for dtype, x in small.items():
            x = x if code[:4] in ("rgba", "bgra") else np.ascontiguousarray(x[..., :3])
            try:
                want = port.cvt_color(torch.from_numpy(x), code)
            except TypeError:
                continue  # a dtype the code does not take (the CPU tests check the card's error)
            got = port.cvt_color(on_card(x), code).cpu()
            if got.shape != want.shape or got.dtype != want.dtype:
                raise AssertionError(f"cvt_color {code} {dtype.__name__}: {got.shape} {got.dtype}")
            space = next(s for s in ("ycrcb", "hsv", "hls", "xyz", "lab", "luv", "gray")
                         if s in code)
            e = float((got.double() - want.double()).abs().max())
            if dtype == np.float32 and space in f32_tol:
                tol = f32_tol[space][0 if code.startswith(("rgb", "bgr")) else 1]
            elif code.startswith("luv") and dtype == np.uint8:
                tol = 1
                print(f"cvt_color {code} u8 card vs CPU: max {e:.0f}, "
                      f"{float((got != want).double().mean()):.6%} of values differ")
            else:
                tol = 0
            worst[f"{code} {dtype.__name__}"] = e
            if e > tol:
                raise AssertionError(f"cvt_color {code} {dtype.__name__}: card vs CPU {e} > {tol}")
            n_codes += 1
    print(f"cvt_color card vs CPU on 2x270x480: {n_codes} code/dtype pairs within their "
          f"tolerances; f32 worst: " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()
                                                 if k.endswith("float32") and v))

    # (b) the public functions, each with counters of its own; the plain path
    # on the card is the same ops with take_table_plain in place of the kernel
    @contextlib.contextmanager
    def plain_takes():
        counts = dict(launch_counts)
        tcolor.take_table = tnlm.take_table = ktake.take_table_plain
        try:
            yield
        finally:
            tcolor.take_table = tnlm.take_table = ktake.take_table
        if dict(launch_counts) != counts:
            raise AssertionError("the plain path launched a kernel")

    def plain(fn):
        def run():
            with plain_takes():
                return fn()
        return run

    def plain_clahe_lab(img: torch.Tensor) -> torch.Tensor:
        with plain_takes():
            lab = tcolor.rgb_to_lab_nhwc(img)
            L = clahe_plain(lab[..., 0].reshape((-1,) + tuple(lab.shape[-3:-1])), 2.0, (8, 8))
            L = L.reshape(lab.shape[:-1])
            return tcolor.lab_to_rgb_nhwc(torch.cat([L[..., None], lab[..., 1:]], dim=-1))

    x_c = np.random.default_rng(20).integers(0, 256, (32, 1080, 1920, 3), dtype=np.uint8)
    x_lab = np.random.default_rng(21).integers(0, 256, (32, 1080, 1920, 3), dtype=np.uint8)
    x_4k = np.random.default_rng(22).integers(0, 256, (1, 2160, 3840, 3), dtype=np.uint8)
    x_gray = noisy((), 1080, 1920, (), 23, 8.0)
    x_col = noisy((), 1080, 1920, (3,), 24, 3.0)
    x_multi = noisy((3,), 1080, 1920, (), 25, 3.0)
    x_u16 = np.clip(noisy((), 512, 512, (), 26, 0.0).astype(np.float64) * 257
                    + np.random.default_rng(26).normal(0, 400, (512, 512)), 0, 65535
                    ).astype(np.uint16)
    paths = [  # label, input, public call, takes, other launches, plain path (None: plain())
        ("cvt_color rgb2lab 32x1080x1920x3 u8", x_c, lambda x: port.cvt_color(x, "rgb2lab"),
         6, {}, None),
        ("cvt_color lab2rgb 32x1080x1920x3 u8", x_lab, lambda x: port.cvt_color(x, "lab2rgb"),
         9, {}, None),
        ("cvt_color rgb2luv 32x1080x1920x3 u8", x_c, lambda x: port.cvt_color(x, "rgb2luv"),
         25, {}, None),
        ("cvt_color rgb2gray 32x1080x1920x3 u8", x_c, lambda x: port.cvt_color(x, "rgb2gray"),
         0, {}, None),
        ("clahe_lab(2.0, 8x8) 1x2160x3840x3 u8", x_4k, lambda x: port.clahe_lab(x, 2.0, (8, 8)),
         15, {"tile_luts256": 1, "clahe_blend": 1}, plain_clahe_lab),
        ("fast_nl_means_denoising(h=10, 7, 21) 1080x1920 u8", x_gray,
         lambda x: port.fast_nl_means_denoising(x, 10.0, 7, 21), 441, {}, None),
        ("fast_nl_means_denoising_colored(3, 3, 7, 21) 1080x1920x3 u8", x_col,
         lambda x: port.fast_nl_means_denoising_colored(x, 3.0, 3.0, 7, 21), 891, {}, None),
        ("fast_nl_means_denoising_multi(frames, 1, 3, h=3) 3x1080x1920 u8", x_multi,
         lambda x: port.fast_nl_means_denoising_multi(x, 1, 3, 3.0, 7, 21), 1323, {}, None),
        ("fast_nl_means_denoising(h=30000, 7, 21, l1) 512x512 u16", x_u16,
         lambda x: port.fast_nl_means_denoising(x, 30000.0, 7, 21, norm_type="l1"), 441, {},
         None),
    ]
    rgb2lab_counts = None
    for label, x, fn, takes, others, plain_fn in paths:
        g = on_card(x)
        plain_run = (lambda: plain_fn(g)) if plain_fn else plain(lambda: fn(g))
        out, got = drive(label, lambda: fn(g), {"take_table": takes, **others})
        if rgb2lab_counts is None:
            rgb2lab_counts = got
        want = plain_run()
        one = x[:1] if x.shape[0] == 32 else x
        cpu = fn(torch.from_numpy(one))
        if out.dtype != cpu.dtype or out.device != dev or out.shape[1:] != cpu.shape[1:]:
            raise AssertionError(f"{label}: output {tuple(out.shape)} {out.dtype} {out.device}")
        if out.float().std() == 0:
            raise AssertionError(f"{label}: output is constant")
        if "nl_means" in label and torch.equal(out.cpu(), torch.from_numpy(
                x[1] if "multi" in label else x)):
            raise AssertionError(f"{label}: the output equals the input")
        e = max_err(out, want)
        e_cpu = max_err(out[:1].cpu() if x.shape[0] == 32 else out.cpu(), cpu)
        print(f"{label}: kernel path vs plain path on the card, max abs err {e}; "
              f"{'one image' if x.shape[0] == 32 else 'the same input'} vs the plain path on "
              f"the CPU, max abs err {e_cpu}")
        if e or e_cpu:
            raise AssertionError(f"{label}: kernel path differs from the plain path")
        del out, want, cpu
        runs = (5, 2) if "nl_means" in label else (TIMED_RUNS, CALLS_PER_RUN)
        (k_ms, k_iqr), (p_ms, p_iqr) = time_ms(lambda: fn(g), *runs), time_ms(plain_run, 5, 2)
        pixels = x[1].size if "multi" in label else x.size // (3 if x.shape[-1] == 3 else 1)
        gpix = pixels / 1e9
        print(f"{label}: kernel path {k_ms:.4f} ms (IQR {k_iqr:.4f}) = {gpix / (k_ms / 1e3):.4f}"
              f" GPix/s, plain path {p_ms:.4f} ms (IQR {p_iqr:.4f}), {takes} take_table "
              f"launches per call  [{smi}]")
        del g

    # (c) take_table alone at the rgb2lab shape (its first lookup: the gamma
    # table, 256 int32 entries in shared memory), beside torch.take
    gc = on_card(x_c[..., 0])
    idx = gc.to(I32)
    gamma = tcolor._lab_device_tabs(dev)[0]
    (k_ms, k_iqr), (p_ms, p_iqr) = (time_ms(lambda: ktake.take_table(idx, gamma)),
                                    time_ms(lambda: ktake.take_table_plain(idx, gamma), 10, 3))
    ms["take_table"] = (k_ms, p_ms)
    bounds["take_table"] = bound_ms(8 * idx.numel() + 4 * gamma.numel())
    idx64 = idx.long()
    if not torch.equal(torch.take(gamma, idx64), ktake.take_table(idx, gamma)):
        raise AssertionError("torch.take differs from take_table")
    library["take_table"] = time_ms(lambda: torch.take(gamma, idx64))[0]
    print(f"  take_table at {tuple(idx.shape)}, 256-entry int32 table: kernel {k_ms:.4f} ms "
          f"(IQR {k_iqr:.4f}), plain {p_ms:.4f} ms (IQR {p_iqr:.4f}), bound "
          f"{bounds['take_table'][0]:.4f} ms (bytes), torch.take on int64 indices made "
          f"beforehand {library['take_table']:.4f} ms  [{smi}]")
    del idx64
    # the route through L1/L2 at the same shape, and one lookup of the
    # non-local-means loop (its live LUT, one 1080p frame)
    abxz = tcolor._lab_device_tabs(dev)[7]
    idx_l2 = rand_idx(tuple(idx.shape), 0, abxz.numel())
    l2_ms, l2_iqr = time_ms(lambda: ktake.take_table(idx_l2, abxz))
    lut = tnlm._lut(10.0, 7, 21, 1, 1, "l2", 255, dev)[0]
    idx_nlm = rand_idx((1, 1080, 1920), 0, lut.numel())
    n_ms, n_iqr = time_ms(lambda: ktake.take_table(idx_nlm, lut))
    print(f"  take_table at {tuple(idx.shape)}, 36864-entry int32 table (L1/L2 route): "
          f"{l2_ms:.4f} ms (IQR {l2_iqr:.4f}); at (1, 1080, 1920) with the {lut.numel()}-entry "
          f"NLMeans LUT: {n_ms:.4f} ms (IQR {n_iqr:.4f}), bound "
          f"{bound_ms(8 * idx_nlm.numel())[0]:.4f} ms  [{smi}]")
    return rgb2lab_counts


def lut_family_and_fused(port, dev, smi, gen, on_card, misaligned, check, drive, ms, bounds,
                         library) -> dict:
    """Phase 10: apply_lut256 with every table dtype (apply_lut256_wide),
    apply_luts_multi and median_unsharp against their plain versions; then
    config 2 through get_preset("gamma_stretch"), pooled equalize_hist,
    apply_lut_planes with f32 tables, apply_luts_multi and median_unsharp on
    the card, each with counters of its own, against the plain path on the
    card and on the CPU, and timed.  Fills ``ms``, ``bounds`` and ``library``
    for the three kernels and returns their launches on their paths."""
    from imageenhancement_mp_tpu_torch.kernels import conv as kconv
    from imageenhancement_mp_tpu_torch.kernels import fused as kfused
    from imageenhancement_mp_tpu_torch.kernels import hist as khist
    from imageenhancement_mp_tpu_torch.kernels import launch_counts
    from imageenhancement_mp_tpu_torch.kernels import median as kmedian
    from imageenhancement_mp_tpu_torch.ops import histogram as thist
    from imageenhancement_mp_tpu_torch.ops import pointwise as tpoint

    U8, F32 = torch.uint8, torch.float32
    table_dtypes = (U8, torch.uint16, torch.int16, torch.int32, F32)
    before = dict(launch_counts)
    counted = dict.fromkeys(("apply_lut256",) + LUT_KERNELS, 0)

    def rand_u8(shape) -> torch.Tensor:
        return torch.randint(0, 256, shape, generator=gen, device=dev, dtype=U8)

    def tables(shape, dtype) -> torch.Tensor:
        """Random tables over the type's full range: i32 entries at
        +-(2^31 - 1), f32 infinities, NaN, zeros of both signs, subnormals."""
        if dtype == F32:
            t = torch.randn(shape, generator=gen, device=dev) * 1e3
            specials = torch.tensor([float("inf"), float("-inf"), float("nan"), 1e-45, -1e-45,
                                     1e-40, 0.0, -0.0, 3.4028235e38], device=dev)
            every7 = t.view(-1)[::7]
            every7.copy_(specials.repeat(every7.numel() // specials.numel() + 1)[:every7.numel()])
            return t
        info = torch.iinfo(dtype)
        t = torch.randint(info.min, info.max + 1, shape, generator=gen, device=dev,
                          dtype=torch.int64).to(dtype)
        t.view(-1)[:2] = torch.tensor([max(info.min, -info.max), info.max], device=dev)
        return t

    def bits(t: torch.Tensor) -> torch.Tensor:
        return t.view(torch.int32) if t.dtype == F32 else t  # NaN payloads, -0.0

    def check_lut(x: torch.Tensor, lut: torch.Tensor, what: str) -> None:
        name = "apply_lut256" if lut.dtype == U8 else "apply_lut256_wide"
        check(name, bits(khist.apply_lut256(x, lut)), bits(khist.apply_lut256_plain(x, lut)),
              f"{what} {lut.dtype} table {tuple(lut.shape)}")
        counted[name] += 1

    def check_multi(x: torch.Tensor, luts: torch.Tensor, what: str) -> None:
        got = khist.apply_luts_multi(x, luts)
        want = khist.apply_luts_multi_plain(x, luts)
        if len(got) != luts.shape[1]:
            raise AssertionError(f"apply_luts_multi {what}: {len(got)} outputs")
        for k, (g, w) in enumerate(zip(got, want)):
            check("apply_luts_multi", bits(g), bits(w), f"{what} {luts.dtype} K={luts.shape[1]} "
                  f"output {k}")
        counted["apply_luts_multi"] += 1

    def check_fused(x: torch.Tensor, km: int, amount: float, ksize: int, what: str) -> None:
        check("median_unsharp", kfused.median_unsharp(x, km, amount, ksize),
              kfused.median_unsharp_plain(x, km, amount, ksize),
              f"{what} km={km} amount={amount} ksize={ksize}")
        counted["median_unsharp"] += 1

    # (a) each kernel against its plain version: the CPU tests' cases, tiny
    # planes, a storage offset of one element, 1079x1917, more planes than a
    # grid axis holds, a plane taller than 65535 row tiles
    small = [(2, 64, 256), (1, 37, 131), (3, 1000), (1, 1, 1), (1, 2, 3)]
    for shape in small + [(1, 1079, 1917)]:
        x = rand_u8(shape)
        for xx in (x, misaligned(x)):
            what = f"{tuple(xx.shape)} offset {xx.storage_offset()}"
            for dtype in table_dtypes:
                for lut_shape in ((256,), (shape[0], 256)):
                    check_lut(xx, tables(lut_shape, dtype), what)
                for K in ((1, 9, 64) if shape in small else (9,)):
                    check_multi(xx, tables((shape[0], K, 256), dtype), what)
            check_lut(xx, misaligned(tables((shape[0], 256), F32)), what + ", table offset 1")
    many, tall = rand_u8((70000, 8, 8)), rand_u8((1, 2_200_000, 8))
    for dtype in table_dtypes:
        check_lut(many, tables((70000, 256), dtype), "[70000, 8, 8]")
        check_lut(tall, tables((256,), dtype), "[1, 2200000, 8]")
    check_multi(many, tables((70000, 9, 256), U8), "[70000, 8, 8]")
    check_multi(many, tables((70000, 3, 256), F32), "[70000, 8, 8]")
    for dtype, K in ((U8, 9), (F32, 9), (torch.uint16, 64)):
        check_multi(tall, tables((1, K, 256), dtype), "[1, 2200000, 8]")
    del many, tall
    # K5's wide route (csrc/hist.cu::lut_wide_kernel) and apply_luts_multi at
    # K = 1, which shares it: widths below one warp's 512 pixels, odd, heads
    # and tails; views at byte offsets 1, 4, 8 and 12 (4-byte entries keep
    # the vector route at 4, 8 and 12, 2-byte ones at 8); f32 tables with
    # NaN payloads
    nan_bits = torch.from_numpy(np.array([0x7FC00001, 0xFFBADBAD, 0x7F800001, 0x7FBFFFFF,
                                          0xFFFFFFFF, 0x80000001], np.uint32).view(np.int32))

    def at_offset(x: torch.Tensor, k: int) -> torch.Tensor:
        buf = torch.empty(x.numel() + k, dtype=x.dtype, device=x.device)
        view = buf[k:].view(x.shape)
        view.copy_(x)
        return view

    for shape in ((3, 15), (2, 511), (1, 512), (2, 513), (3, 1000), (2, 16 * 32 * 3 + 7),
                  (1, 8192 + 83), (1, 300_001), (3, 17, 333)):
        x = rand_u8(shape)
        for k in (0, 1, 4, 8, 12):
            xx = at_offset(x, k)
            what = f"{shape} byte offset {k}"
            for dtype in table_dtypes[1:]:
                for lut_shape in ((256,), (shape[0], 256)):
                    lut = tables(lut_shape, dtype)
                    if dtype == F32:
                        lut.view(torch.int32).view(-1)[:nan_bits.numel()] = nan_bits.to(dev)
                    check_lut(xx, lut, what)
                check_multi(xx, tables((shape[0], 1, 256), dtype), what)
    fused_shapes = [(2, 64, 131), (1, 37, 131), (1, 1, 1), (1, 2, 3), (2, 4, 131), (3, 5, 9),
                    (1, 70, 3), (1, 1079, 1917)]
    for shape in fused_shapes:
        x = rand_u8(shape)
        for xx in (x, misaligned(x)):
            for km in (3, 5):
                for amount in (1.0, 1.5, -0.5, 2.0, 64.0):
                    for ksize in (3, 5, 31):
                        check_fused(xx, km, amount, ksize,
                                    f"{tuple(xx.shape)} offset {xx.storage_offset()}")
    for shape in ((70000, 8, 8), (1, 2_200_000, 8)):
        x = rand_u8(shape)
        check_fused(x, 5, 1.0, 5, str(shape))
        check_fused(x, 3, 1.5, 31, str(shape))
    # the median schedules inside the fused kernel: phase 5's network planes
    nrng = np.random.default_rng(40)
    for shape in NETWORK_SHAPES:
        for planes in NETWORK_PLANES:
            x = on_card(network_planes(np.uint8, shape, planes, nrng))
            for xx in (x, misaligned(x)):
                for km in (3, 5):
                    for amount, ksize in ((1.0, 5), (-0.5, 31)):
                        check_fused(xx, km, amount, ksize,
                                    f"{tuple(xx.shape)} {planes} offset {xx.storage_offset()}")
    # the fused kernel against the two-kernel chain median -> sep_conv_u8
    for shape in ((1, 1, 1), (1, 2, 3), (1, 1079, 1917)):
        x = rand_u8(shape)
        for km, amount, ksize in ((5, 1.0, 5), (3, -0.5, 31), (5, 64.0, 3)):
            taps = kfused.fused_taps(ksize)
            check("median_unsharp", kfused.median_unsharp(x, km, amount, ksize),
                  kconv.sep_conv_u8(kmedian.median_blur(x, km), taps, taps, amount),
                  f"{shape} km={km} amount={amount} ksize={ksize} against the two-kernel chain")
    # pooled equalizeHist's LUTs in one count launch: hist256_lut with C
    # groups (plane b in group b % C) on 8 1080p frames, gray (C = 1) and
    # RGB planes (C = 3), and C = B (one LUT a plane)
    for shape, groups in (((8, 1080, 1920), (1, 8)), ((24, 1080, 1920), (3, 1, 24))):
        x = rand_u8(shape)
        for C in groups:
            check("hist256_lut", khist.hist256_equalize_lut(x, C),
                  khist.hist256_equalize_lut_plain(x, C), f"{shape} in {C} pooled groups")
    torch.cuda.synchronize()
    for name in counted:
        if launch_counts[name] <= before[name]:
            raise AssertionError(f"{name}: the comparison phase launched no kernel")
    print("hist256_lut with pooled groups vs plain on the card: 0 LSB on 8x1080x1920 (C 1, 8) "
          "and 24x1080x1920 (C 3, 1, 24)")
    print(f"LUT family and fused kernels vs plain on the card, bit for bit: {counted} cases "
          "(u8, u16, i16, i32 and f32 tables, shared and per plane, i32 at +-(2^31-1), f32 "
          "inf/NaN/-0.0/subnormals and NaN payloads, K in {1, 9, 64}, km 3/5, amounts 1, 1.5, "
          "-0.5, 2, 64, ksize 3/5/31, 1x1, 2x3, offset 1, byte offsets 1/4/8/12 at widths 15 to "
          "300001, 1079x1917, [70000, 8, 8], [1, 2200000, 8]); "
          "median_unsharp equals median -> sep_conv_u8 on 1x1, 2x3 and 1079x1917")

    # (b) the paths, each with counters of its own; the plain path on the card
    # is the same ops with the plain LUT-family versions in the kernels' place
    @contextlib.contextmanager
    def plain_luts():
        counts = dict(launch_counts)
        saved = (tpoint.apply_lut256, thist.hist256, thist.equalize_lut256, thist.apply_lut256,
                 thist.hist256_equalize_lut)
        tpoint.apply_lut256 = thist.apply_lut256 = khist.apply_lut256_plain
        thist.hist256, thist.equalize_lut256 = khist.hist256_plain, khist.equalize_lut256_plain
        thist.hist256_equalize_lut = khist.hist256_equalize_lut_plain
        try:
            yield
        finally:
            (tpoint.apply_lut256, thist.hist256, thist.equalize_lut256,
             thist.apply_lut256, thist.hist256_equalize_lut) = saved
        if dict(launch_counts) != counts:
            raise AssertionError("the plain path launched a kernel")

    def plain(fn):
        def run():
            with plain_luts():
                return fn()
        return run

    pipe2 = port.get_preset("gamma_stretch")
    x2 = np.random.default_rng(30).integers(0, 256, (32, 1080, 1920, 3), dtype=np.uint8)
    x_eq = np.random.default_rng(31).integers(0, 256, (8, 1080, 1920, 3), dtype=np.uint8)
    x8 = np.random.default_rng(32).integers(0, 256, (8, 1080, 1920), dtype=np.uint8)
    x4k = np.random.default_rng(33).integers(0, 256, (2, 2160, 3840), dtype=np.uint8)
    lut_f32 = tables((8, 256), F32)
    luts9 = tables((8, 9, 256), U8)
    paths = [  # label, input, call on a tensor of the input's device, launches, plain, CPU input
        ("config 2 get_preset('gamma_stretch') 32x1080x1920x3 u8", x2, pipe2,
         {"apply_lut256": 2}, plain(lambda: pipe2(g)), "one frame"),
        ("equalize_hist(per_frame=False) 8x1080x1920x3 u8", x_eq,
         lambda x: port.equalize_hist(x, per_frame=False),
         {"hist256_lut": 1, "apply_lut256": 1},
         plain(lambda: port.equalize_hist(g, per_frame=False)), "the whole batch"),
        ("apply_lut_planes 8x1080x1920 u8, [8, 256] f32 tables", x8,
         lambda x: tpoint.apply_lut_planes(x, lut_f32[:x.shape[0]].to(x.device)),
         {"apply_lut256_wide": 1},
         lambda: khist.apply_lut256_plain(g, lut_f32), "one plane"),
        ("apply_luts_multi [8, 1080, 1920] u8, K = 9 u8 tables", x8,
         lambda x: khist.apply_luts_multi(x, luts9[:x.shape[0]].to(x.device)),
         {"apply_luts_multi": 1}, lambda: khist.apply_luts_multi_plain(g, luts9), "one plane"),
        ("median_unsharp(5, 1.0, 5) 2x2160x3840 u8", x4k,
         lambda x: kfused.median_unsharp(x, 5, 1.0, 5), {"median_unsharp": 1},
         lambda: kfused.median_unsharp_plain(g, 5, 1.0, 5), "one plane"),
    ]
    path_launches, timing = {}, []
    for label, x, fn, expect, plain_run, cpu_part in paths:
        g = on_card(x)
        out, got = drive(label, lambda: fn(g), expect)
        path_launches.update({n: got[n] for n in LUT_KERNELS if n in expect})
        want = plain_run()
        cpu_in = x if cpu_part == "the whole batch" else x[:1]
        cpu = fn(torch.from_numpy(cpu_in))
        if isinstance(out, tuple):  # apply_luts_multi's K outputs
            out, want, cpu = torch.stack(out), torch.stack(want), torch.stack(cpu)
            e_cpu = max_err(out[:, :1].cpu(), cpu)
        else:
            e_cpu = max_err(out[:cpu_in.shape[0]].cpu(), cpu)
        if out.device != dev or out.float().std() == 0:
            raise AssertionError(f"{label}: output on {out.device}, or constant")
        e = max_err(bits(out), bits(want))
        print(f"{label}: kernel path vs plain path on the card, max abs err {e}; {cpu_part} vs "
              f"the plain path on the CPU, max abs err {e_cpu}")
        if e or e_cpu:
            raise AssertionError(f"{label}: kernel path differs from the plain path")
        if "median_unsharp" in label:
            taps = kfused.fused_taps(5)
            chain = kconv.sep_conv_u8(kmedian.median_blur(g, 5), taps, taps, 1.0)
            e_chain = max_err(out, chain)
            print(f"{label}: against the median -> sep_conv_u8 chain, max abs err {e_chain}")
            if e_chain:
                raise AssertionError("median_unsharp differs from the two-kernel chain")
        del out, want, cpu
        timing.append((label, x, g, fn, plain_run))

    # (c) time each path, kernel path against plain path
    for label, x, g, fn, plain_run in timing:
        (k_ms, k_iqr), (p_ms, p_iqr) = time_ms(lambda: fn(g)), time_ms(plain_run, 5, 2)
        gpix = x.size / 1e9  # pixels of all planes
        extra = ""
        if label.startswith("config 2"):
            extra = (f", bytes floor {bound_ms(5 * x.size)[0]:.4f} ms (5 B/px: the gamma read "
                     "and write, the min/max read, the stretch read and write)")
        print(f"{label}: kernel path {k_ms:.4f} ms (IQR {k_iqr:.4f}) = {gpix / (k_ms / 1e3):.4f} "
              f"GPix/s, plain path {p_ms:.4f} ms (IQR {p_iqr:.4f}){extra}  [{smi}]")
    g8, g4k = timing[2][2], timing[4][2]
    del timing

    # (d) each kernel at its path's shape beside its bound and a PyTorch call
    B8, n8 = g8.shape[0], g8[0].numel()
    idx8 = g8.view(B8, -1).long()
    for dtype in (torch.int16, F32):  # 2- and 4-byte entries (torch.gather has no uint16)
        lut = tables((B8, 256), dtype)
        (k_ms, k_iqr), (p_ms, p_iqr) = (time_ms(lambda: khist.apply_lut256(g8, lut)),
                                        time_ms(lambda: khist.apply_lut256_plain(g8, lut), 10, 3))
        if not torch.equal(bits(torch.gather(lut, 1, idx8).view_as(g8)),
                           bits(khist.apply_lut256(g8, lut))):
            raise AssertionError("torch.gather with the tables differs from apply_lut256_wide")
        lib = time_ms(lambda: torch.gather(lut, 1, idx8))[0]
        b = bound_ms(B8 * n8 * (1 + lut.element_size()) + lut.numel() * lut.element_size())
        print(f"  apply_lut256_wide at {tuple(g8.shape)}, {dtype} tables: kernel {k_ms:.4f} ms "
              f"(IQR {k_iqr:.4f}), plain {p_ms:.4f} ms (IQR {p_iqr:.4f}), bound {b[0]:.4f} ms "
              f"({b[1]}), torch.gather on int64 indices made beforehand {lib:.4f} ms  [{smi}]")
        if dtype == F32:  # the path's tables
            ms["apply_lut256_wide"], bounds["apply_lut256_wide"] = (k_ms, p_ms), b
            library["apply_lut256_wide"] = lib
    idx9 = idx8[:, None, :].expand(B8, 9, n8)
    for dtype in (U8, F32):
        luts = tables((B8, 9, 256), dtype)
        (k_ms, k_iqr), (p_ms, p_iqr) = (time_ms(lambda: khist.apply_luts_multi(g8, luts)),
                                        time_ms(lambda: khist.apply_luts_multi_plain(g8, luts),
                                                5, 2))
        stacked = torch.gather(luts, 2, idx9)
        for k, o in enumerate(khist.apply_luts_multi(g8, luts)):
            if not torch.equal(bits(stacked[:, k].reshape(g8.shape)), bits(o)):
                raise AssertionError("torch.gather of the K tables differs from apply_luts_multi")
        del stacked
        lib = time_ms(lambda: torch.gather(luts, 2, idx9))[0]
        b = bound_ms(B8 * n8 * (1 + 9 * luts.element_size()) + luts.numel() * luts.element_size())
        print(f"  apply_luts_multi at {tuple(g8.shape)}, K = 9 {dtype} tables: kernel {k_ms:.4f} "
              f"ms (IQR {k_iqr:.4f}), plain {p_ms:.4f} ms (IQR {p_iqr:.4f}), bound {b[0]:.4f} ms "
              f"({b[1]}), one torch.gather of the [B, K, 256] tables (index expanded to "
              f"[B, K, n]) {lib:.4f} ms  [{smi}]")
        if dtype == U8:  # the path's tables
            ms["apply_luts_multi"], bounds["apply_luts_multi"] = (k_ms, p_ms), b
            library["apply_luts_multi"] = lib
    del idx8, idx9
    taps5 = kfused.fused_taps(5)
    (k_ms, k_iqr), (p_ms, p_iqr), (c_ms, c_iqr), (m_ms, _), (s_ms, _) = (
        time_ms(lambda: kfused.median_unsharp(g4k, 5, 1.0, 5)),
        time_ms(lambda: kfused.median_unsharp_plain(g4k, 5, 1.0, 5), 5, 2),
        time_ms(lambda: kconv.sep_conv_u8(kmedian.median_blur(g4k, 5), taps5, taps5, 1.0)),
        time_ms(lambda: kmedian.median_blur(g4k, 5)),
        time_ms(lambda: kconv.sep_conv_u8(g4k, taps5, taps5, 1.0)))
    ms["median_unsharp"] = (k_ms, p_ms)
    bounds["median_unsharp"] = bound_ms(2 * g4k.numel())  # integer min/max: no rate
    library["median_unsharp"] = None  # no PyTorch call does cv2's median and Q8 Gaussian
    print(f"  median_unsharp at {tuple(g4k.shape)} km=5 amount=1 ksize=5: kernel {k_ms:.4f} ms "
          f"(IQR {k_iqr:.4f}), plain {p_ms:.4f} ms (IQR {p_iqr:.4f}), the two-kernel chain "
          f"median -> sep_conv_u8 {c_ms:.4f} ms (IQR {c_iqr:.4f}; median alone {m_ms:.4f}, "
          f"sep_conv_u8 alone {s_ms:.4f}), bound {bounds['median_unsharp'][0]:.4f} ms (bytes), "
          f"its median's issue floor {issue_floor_ms(5, g4k.numel(), sm_clock_max_mhz()):.4f} ms "
          f"(the fused kernel computes its Gaussian halo's medians too)  [{smi}]")
    return path_launches


# the config-3 chain: Gaussian blur -> Laplacian sharpen -> unsharp mask
# (BASELINE.json:9), at ksize k for both blurs
def config3_stages(k: int) -> list:
    return [("gaussian_blur", {"ksize": k}), ("laplacian_sharpen", {}),
            ("unsharp_mask", {"amount": 1.0, "ksize": k})]


def paced_ms(fn, sleep_cycles: int, runs: int = TIMED_RUNS, calls: int = CALLS_PER_RUN) -> float:
    """Median per-call time of ``fn`` with the device held by a sleep kernel
    while the host enqueues the run, so the events see the device's work
    alone (device-paced)."""
    for _ in range(WARMUPS):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def wide_bound_ms(n: int, tv, th) -> tuple[float, str]:
    """The wide instance's bound on n pixels: 2 B/px, or its MACs (a nonzero
    tap of either axis after trimming, 2 operations each) at the card's int8
    peak, whichever is larger: the products are u8 pixels times Q8 integer
    taps, which the tensor cores take as int8.  Bytes at every Gaussian."""
    from imageenhancement_mp_tpu_torch.kernels import conv as kconv

    r = kconv.conv_route(tv, th)
    macs = sum(1 for t in r.taps_v + r.taps_h if t)
    return bound_ms(2 * n, 2.0 * n * macs, "int8")


def filters_and_config3(port, dev, smi, on_card, misaligned, check, drive) -> dict:
    """Phase 11: sep_conv_u8's wide instance (more than 31 taps on an axis
    after trimming) against its plain version and timed beside its bound,
    from 37 to 541 taps; every filter
    of ops/filters.py card against CPU at 2x2160x3840; config 3 through
    make_pipeline at k 3 and 5 on 8x1080x1920 and 2x2160x3840 u8, with
    counters of its own, card against CPU on one frame, timed back to back
    and device-paced, and its device time split by kernel under
    torch.profiler.  Returns sep_conv_u8's launches on config 3's paths."""
    from imageenhancement_mp_tpu_torch.kernels import conv as kconv
    from imageenhancement_mp_tpu_torch.ops.filters import q8_taps

    t_phase = time.perf_counter()
    rng = np.random.default_rng(11)

    def rand_u8(shape) -> torch.Tensor:
        return on_card(rng.integers(0, 256, shape, dtype=np.uint8))

    # -- past 31 taps: 33 and 37 taps (sigma 6 on u8), rectangular pairs
    # with one axis wide, 67 and 121 taps, an asymmetric set (the unpaired
    # vertical pass), and 541 taps (radius 270: the halo deeper than the
    # tile and than the small planes, which reflect again), on the runtime
    # instance's residues, tiny planes, misaligned views, every epilogue,
    # with and without a LUT.  33, 33x5 and 1x35 take the runtime instance
    # once their zero ends are trimmed; the rest the wide one
    wide_taps = [q8_taps(33, 0.0), q8_taps(0, 6.0), q8_taps((33, 5), 0.0),
                 q8_taps((3, 37), 0.0), q8_taps((1, 35), 0.0), q8_taps((0, 3), 6.0, 0.0),
                 q8_taps(0, 12.0), q8_taps(0, 20.0), q8_taps(0, 90.0),
                 ((1,) * 20 + (2,) * 13, (2,) * 13 + (1,) * 20)]
    wide_shapes = [(2, 64, 256), (1, 37, 131), (1, 5, 9), (1, 1, 1), (1, 17, 257), (2, 15, 271),
                   (1, 129, 1917), (1, 3, 1), (1, 2, 2), (2, 40, 3), (1, 1, 640), (1, 16, 255),
                   (1, 33, 513), (1, 300, 700)]
    routes, n_wide = [], 0
    for tv, th in wide_taps:
        r = kconv.conv_route(tv, th)
        routes.append(f"{len(tv)}x{len(th)} -> {len(r.taps_v)}x{len(r.taps_h)} {r.describe()}")
        for shape in wide_shapes:
            x = rand_u8(shape)
            for amount in (None, 1.0, 0.5, -1.0, 100.0):
                for luts in (None, rand_u8((shape[0], 256))):
                    for xx in (x, misaligned(x)):
                        what = (f"{shape} {len(tv)}x{len(th)} taps amount={amount} "
                                f"lut={luts is not None} offset {xx.storage_offset()}")
                        check("sep_conv_u8", kconv.sep_conv_u8(xx, tv, th, amount, luts),
                              kconv.sep_conv_u8_plain(xx, tv, th, amount, luts), what)
                        n_wide += 1
    tv37, th37 = q8_taps(0, 6.0)
    tv33, th33 = q8_taps(33, 0.0)
    x8 = rand_u8((8, 1080, 1920))
    for tv, th in ((tv37, th37), (tv33, th33), q8_taps((33, 5), 0.0), q8_taps(0, 10.0),
                   q8_taps(0, 20.0), q8_taps(0, 45.0), q8_taps(0, 90.0)):
        for amount in (None, 1.0, 0.5):
            check("sep_conv_u8", kconv.sep_conv_u8(x8, tv, th, amount),
                  kconv.sep_conv_u8_plain(x8, tv, th, amount), f"8x1080x1920 {len(tv)}x{len(th)}")
            n_wide += 1
    # the row caps: more planes, and more row blocks, than a grid axis holds
    many, tall = rand_u8((70000, 8, 8)), rand_u8((1, 2_200_000, 8))
    lm = rand_u8((70000, 256))
    check("sep_conv_u8", kconv.sep_conv_u8(many, tv37, th37, 1.0, lm),
          kconv.sep_conv_u8_plain(many, tv37, th37, 1.0, lm), "70000x8x8, 37 taps")
    check("sep_conv_u8", kconv.sep_conv_u8(tall, tv33, th33, 0.5),
          kconv.sep_conv_u8_plain(tall, tv33, th33, 0.5), "1x2200000x8, 33 taps")
    del many, tall, lm
    print(f"sep_conv_u8 past 31 taps vs plain on the card: 0 LSB over {n_wide + 2} cases "
          f"(taps before -> after trimming and route: {'; '.join(routes)}; [70000, 8, 8] and "
          f"[1, 2_200_000, 8])")
    n8 = x8.numel()
    timed = [("37 taps (sigma 6), blur", (tv37, th37), None),
             ("37 taps (sigma 6), amount 1", (tv37, th37), 1.0),
             ("33 taps, blur", (tv33, th33), None),
             ("33x5 taps, blur", q8_taps((33, 5), 0.0), None)]
    timed += [(f"{len(q8_taps(0, sg)[0])} taps (sigma {sg:g}), {'blur' if a is None else 'amount 1'}",
               q8_taps(0, sg), a) for sg in (10.0, 20.0, 45.0, 90.0) for a in (None, 1.0)]
    for label, (tv, th), amount in timed:
        r = kconv.conv_route(tv, th)
        k_ms, k_iqr = time_ms(lambda: kconv.sep_conv_u8(x8, tv, th, amount))
        p_ms, p_iqr = time_ms(lambda: kconv.sep_conv_u8_plain(x8, tv, th, amount), 3, 1)
        b_ms, b_by = wide_bound_ms(n8, tv, th)
        print(f"  sep_conv_u8 at (8, 1080, 1920) {label}, {len(r.taps_v)}x{len(r.taps_h)} after "
              f"trimming on the {r.describe()} route: kernel {k_ms:.4f} ms (IQR {k_iqr:.4f}), "
              f"plain {p_ms:.4f} ms (IQR {p_iqr:.4f}), bound {b_ms:.4f} ms ({b_by}; bytes "
              f"{bound_ms(2 * n8)[0]:.4f})  [{smi}]")
    k5_ms = time_ms(lambda: kconv.sep_conv_u8(x8, *q8_taps(5, 0.0)))[0]
    print(f"  sep_conv_u8 k5 instance at (8, 1080, 1920), blur, for comparison: {k5_ms:.4f} ms"
          f"  [{smi}]")
    # the public calls past 31 taps go through the kernel, once, no plain
    # fallback (unsharp_mask at 35 and equalize_unsharp at 33 take the
    # runtime instance after trimming; sigma 6 and 20 the wide one)
    for label, fn, expect in (
            ("gaussian_blur(x, 0, sigma=6.0)", lambda x: port.gaussian_blur(
                x, 0, 6.0, channels_last=False), {"sep_conv_u8": 1}),
            ("gaussian_blur(x, 0, sigma=20.0)", lambda x: port.gaussian_blur(
                x, 0, 20.0, channels_last=False), {"sep_conv_u8": 1}),
            ("unsharp_mask(x, 1.0, 35)", lambda x: port.unsharp_mask(
                x, 1.0, 35, channels_last=False), {"sep_conv_u8": 1}),
            ("equalize_unsharp(x, 1.0, 33)", lambda x: port.equalize_unsharp(x, 1.0, 33),
             {"hist256_lut": 1, "sep_conv_u8": 1})):
        out, _ = drive(f"{label} 8x1080x1920", lambda: fn(x8), expect)
        e = max_err(out[:1].cpu(), fn(x8[:1].cpu()))
        print(f"{label} 8x1080x1920: one frame card vs the plain path on the CPU, max abs err {e}")
        if e:
            raise AssertionError(f"{label}: the card differs from the CPU")
    del x8
    print(f"phase 11 past 31 taps: {time.perf_counter() - t_phase:.1f} s")

    # -- every filter card against CPU at 2x2160x3840
    shape4 = (2, 2160, 3840)
    host = {torch.uint8: rng.integers(0, 256, shape4, dtype=np.uint8),
            torch.uint16: rng.integers(0, 65536, shape4).astype(np.uint16),
            torch.int16: rng.integers(-32768, 32768, shape4).astype(np.int16),
            torch.float32: (rng.random(shape4, dtype=np.float32) * 500 - 100).astype(np.float32)}
    u8, u16, i16, f32 = torch.uint8, torch.uint16, torch.int16, torch.float32
    calls = [(f"gaussian_blur {ks} sigma {sg}", dt, lambda x, ks=ks, sg=sg: port.gaussian_blur(
                 x, ks, sg, channels_last=False))
             for dt in (u16, i16, f32) for ks, sg in ((5, 0.0), (0, 2.0))]
    calls += [(f"unsharp_mask amount {a}", dt, lambda x, a=a: port.unsharp_mask(
                  x, a, 5, channels_last=False)) for dt in (u16, i16, f32) for a in (1.0, 1.5)]
    calls += [(f"laplacian ksize {k}", dt, lambda x, k=k: port.laplacian(x, k, channels_last=False))
              for dt in (u8, u16, i16, f32) for k in (1, 3)]
    calls += [("laplacian ksize 5 delta 3", u8, lambda x: port.laplacian(x, 5, 3.0,
                                                                        channels_last=False))]
    calls += [("laplacian_sharpen", dt, lambda x: port.laplacian_sharpen(x, channels_last=False))
              for dt in (u8, u16, i16, f32)]
    calls += [(f"sobel {dx},{dy} ksize {k} scale {sc}", dt,
               lambda x, dx=dx, dy=dy, k=k, sc=sc: port.sobel(x, dx, dy, k, sc, 7.0,
                                                              channels_last=False))
              for dt, dx, dy, k, sc in ((u8, 1, 0, 3, 1.0), (u16, 0, 1, 5, 1.0),
                                        (i16, 1, 1, 3, 1.0), (f32, 1, 0, 3, 1.0),
                                        (u8, 1, 0, 3, 0.37))]
    calls += [(f"scharr {dx},{dy}", dt, lambda x, dx=dx, dy=dy: port.scharr(
                  x, dx, dy, channels_last=False)) for dt, dx, dy in ((u8, 0, 1), (f32, 1, 0))]
    calls += [(f"box_blur {k}", dt, lambda x, k=k: port.box_blur(x, k, channels_last=False))
              for dt, k in ((u8, 5), (u16, 3), (i16, (3, 7)), (f32, 5))]
    calls += [(f"box_filter {k} raw", dt, lambda x, k=k: port.box_filter(
                  x, k, False, channels_last=False)) for dt, k in ((u8, 2), (u16, (4, 3)), (f32, 3))]
    calls += [("corner_harris 2 3 0.04", u8, lambda x: port.corner_harris(x, channels_last=False)),
              ("corner_min_eigen_val 3 3", u8, lambda x: port.corner_min_eigen_val(
                  x, channels_last=False))]
    calls += [(f"spatial_gradient {b}", u8, lambda x, b=b: torch.stack(port.spatial_gradient(
                  x, b, channels_last=False))) for b in ("reflect101", "replicate")]
    calls += [(f"sqr_box_filter {k} normalize {nm}", dt, lambda x, k=k, nm=nm: port.sqr_box_filter(
                  x, k, nm, channels_last=False))
              for dt, k, nm in ((u8, 3, True), (u16, (5, 2), False), (f32, 3, True))]
    calls += [(f"stack_blur {k}", u8, lambda x, k=k: port.stack_blur(x, k, channels_last=False))
              for k in (5, (3, 9))]
    t0 = time.perf_counter()
    for label, dt, fn in calls:
        x = torch.from_numpy(host[dt])
        got = drive(f"{label} {dt} 2x2160x3840", lambda: fn(x.to(dev)), {})[0].cpu()
        want = fn(x)
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{label} {dt}: card {tuple(got.shape)} {got.dtype}, CPU "
                                 f"{tuple(want.shape)} {want.dtype}")
        # the same torch ops in the same order on both devices, no FMA
        # contraction across ops: f32 outputs too are held at 0
        e = float((got.double() - want.double()).abs().max())
        if e != 0 or not torch.equal(torch.isnan(got), torch.isnan(want)):
            raise AssertionError(f"{label} {dt}: card vs CPU max abs err {e}")
    print(f"the filters on the card vs the CPU at 2x2160x3840: 0 over {len(calls)} calls "
          f"(every dtype; {time.perf_counter() - t0:.1f} s)")

    # -- config 3 through make_pipeline
    launches = 0
    for shape in ((8, 1080, 1920), (2, 2160, 3840)):
        xh = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
        g = on_card(xh)
        gpix = g.numel() / 1e9
        for k in (3, 5):
            pipe = port.make_pipeline(config3_stages(k))
            label = f"config 3 k={k} {'x'.join(map(str, shape))} u8"
            out, counts = drive(label, lambda: pipe(g), {"sep_conv_u8": 2})
            launches += counts["sep_conv_u8"]
            if out.shape != g.shape or out.dtype != torch.uint8 or out.float().std() == 0:
                raise AssertionError(f"{label}: output {tuple(out.shape)} {out.dtype}")
            e = max_err(out[:1].cpu(), pipe(torch.from_numpy(xh[:1])))
            print(f"{label}: one frame card vs the plain path on the CPU, max abs err {e}")
            if e:
                raise AssertionError(f"{label}: the card differs from the CPU")
            b_ms, b_iqr = time_ms(lambda: pipe(g))
            d_ms = paced_ms(lambda: pipe(g), 40_000_000)
            busy, wall, rows = device_split(lambda: pipe(g))
            print(f"{label}: back to back {b_ms:.4f} ms (IQR {b_iqr:.4f}) = "
                  f"{gpix / (b_ms / 1e3):.3f} GPix/s, device-paced {d_ms:.4f} ms, bytes floor "
                  f"{bound_ms(6 * g.numel())[0]:.4f} ms (6 B/px: three passes); under "
                  f"torch.profiler {busy:.2f} us of device time per call in {wall:.2f} us of "
                  f"wall ({100 * busy / wall:.1f} % busy)  [{smi}]")
            for us, n, name in rows[:12]:
                print(f"    {us:9.2f} us per call  {100 * us / busy:5.1f} %  x{n:g}  {name[:100]}")
    print(f"phase 11: {time.perf_counter() - t_phase:.1f} s")
    return {"sep_conv_u8": launches}


# the inspection chain of phase 12: an area downscale to 1080p, a white
# top-hat of 15x15 (bright defects on a dark background), Canny, then the
# edges' connected components
def inspection_stages(oh: int, ow: int) -> list:
    return [("resize", {"dsize": (oh, ow), "interpolation": "area"}),
            ("morphology", {"op": "tophat", "ksize": 15}),
            ("canny", {"threshold1": 50.0, "threshold2": 150.0})]


def geometry_and_inspection(port, dev, smi, on_card, misaligned, check, drive) -> None:
    """Phase 12: median_unsharp past 31 taps (the median -> sep_conv_u8
    chain) against its plain version; every function of this slice on
    2x2160x3840 (u8, and u16/i16/f32 where it takes them) card against CPU,
    each with counters of its own (calc_back_project: one apply_lut256;
    the rest: no kernel), timed; the inspection chain through make_pipeline
    and connected_components, card against CPU, timed back to back and split
    by torch kernel under torch.profiler."""
    from imageenhancement_mp_tpu_torch.kernels import fused as kfused
    from imageenhancement_mp_tpu_torch.ops import canny as tcanny
    from imageenhancement_mp_tpu_torch.ops.morphology import MORPH_OPS
    from imageenhancement_mp_tpu_torch.ops.resize import INTERPOLATIONS
    from imageenhancement_mp_tpu_torch.ops.template import METHODS

    rng = np.random.default_rng(12)
    shape4 = (2, 2160, 3840)
    crop = (1080, 1920)  # where the CPU is slow: both devices run this corner

    # -- median_unsharp past 31 taps: the chain route, against the plain version
    n_p6 = 0
    fused_shapes = [(2, 64, 131), (1, 37, 131), (1, 1, 1), (1, 2, 3), (2, 4, 131), (3, 5, 9),
                    (1, 70, 3), (1, 1079, 1917)]
    for shape in fused_shapes:
        x = on_card(rng.integers(0, 256, shape, dtype=np.uint8))
        for xx in (x, misaligned(x)):
            for km in (3, 5):
                for ksize, amount in ((33, 1.0), (37, -0.5), (101, 1.5)):
                    check("median_unsharp", kfused.median_unsharp(xx, km, amount, ksize),
                          kfused.median_unsharp_plain(xx, km, amount, ksize),
                          f"{tuple(xx.shape)} offset {xx.storage_offset()} km={km} ksize={ksize}")
                    n_p6 += 1
    g4 = on_card(rng.integers(0, 256, shape4, dtype=np.uint8))
    for km in (3, 5):
        for ksize in (33, 37, 101):
            label = f"median_unsharp({km}, 1.0, {ksize}) {'x'.join(map(str, shape4))} u8"
            out, _ = drive(label, lambda: kfused.median_unsharp(g4, km, 1.0, ksize),
                           {"median": 1, "sep_conv_u8": 1})
            check("median_unsharp", out, kfused.median_unsharp_plain(g4, km, 1.0, ksize), label)
            n_p6 += 1
    print(f"median_unsharp past 31 taps (median -> sep_conv_u8) vs plain on the card: 0 LSB over "
          f"{n_p6} cases (ksize 33, 37, 101; km 3 and 5; phase 10's shapes, offset 0 and 1, "
          f"{shape4})")
    for km, ksize in ((5, 31), (5, 33), (5, 101)):
        k_ms, k_iqr = time_ms(lambda: kfused.median_unsharp(g4, km, 1.0, ksize))
        route = "fused kernel" if ksize <= kfused.FUSED_MAX_TAPS else "median -> sep_conv_u8"
        print(f"  median_unsharp({km}, 1.0, {ksize}) at {shape4} ({route}): {k_ms:.4f} ms "
              f"(IQR {k_iqr:.4f})  [{smi}]")
    del g4

    # -- every function of this slice, card against CPU
    u8, u16, i16, f32 = torch.uint8, torch.uint16, torch.int16, torch.float32
    smooth = noisy((shape4[0],), shape4[1], shape4[2], (), 120, 10.0)
    host = {u8: rng.integers(0, 256, shape4, dtype=np.uint8),
            u16: rng.integers(0, 65536, shape4).astype(np.uint16),
            i16: rng.integers(-32768, 32768, shape4).astype(np.int16),
            f32: (rng.random(shape4, dtype=np.float32) * 500 - 100).astype(np.float32),
            "smooth": smooth, "mask": (smooth > 128).astype(np.uint8)}
    templ = smooth[0, 700:732, 1200:1232].copy()
    ell15 = port.get_structuring_element("ellipse", 15)
    sharpen = np.array([[0, -1, 0], [-1, 5, -1], [0, -1, 0]], np.float64)
    float5 = rng.normal(size=(5, 5))
    float15 = rng.normal(size=(15, 15)) * 0.05
    hist = rng.random(32) * 400

    def rs(interp, fy, fx):
        """resize to a size relative to the input's, so a crop keeps the route"""
        return lambda x: port.resize(x, (x.shape[-2] * fy[0] // fy[1],
                                         x.shape[-1] * fx[0] // fx[1]), interp, channels_last=False)

    # (label, input, call, launches, CPU part: "plane" or "crop", limit); the
    # limit is 0 except for match_template (relative) and the f32 integrals
    calls = []
    for op in MORPH_OPS:
        calls += [(f"morphology_ex {op} rect 3", u8, lambda x, op=op: port.morphology_ex(
                       x, op, 3, channels_last=False), "plane"),
                  (f"morphology_ex {op} rect 15", u8, lambda x, op=op: port.morphology_ex(
                       x, op, 15, channels_last=False), "crop"),
                  (f"morphology_ex {op} ellipse 15", u8, lambda x, op=op: port.morphology_ex(
                       x, op, kernel=ell15, channels_last=False), "crop")]
    calls += [("erode rect 3 iterations 2", dt, lambda x: port.erode(x, 3, 2, channels_last=False),
               "plane") for dt in (u8, u16, i16, f32)]
    calls += [("dilate (4, 7) iterations 2", u8,
               lambda x: port.dilate(x, (4, 7), 2, channels_last=False), "plane"),
              ("morphology_ex tophat rect 15", u16, lambda x: port.morphology_ex(
                  x, "tophat", 15, channels_last=False), "crop"),
              ("morphology_ex blackhat ellipse 15", i16, lambda x: port.morphology_ex(
                  x, "blackhat", kernel=ell15, channels_last=False), "crop"),
              ("morphology_ex gradient rect 3", f32, lambda x: port.morphology_ex(
                  x, "gradient", 3, channels_last=False), "plane")]
    for dt in (u8, u16, i16, f32):
        calls += [("filter2d integer 3x3 delta 2.5", dt, lambda x: port.filter2d(
                       x, sharpen, 2.5, channels_last=False), "plane"),
                  ("filter2d float 5x5", dt, lambda x: port.filter2d(x, float5, -1.5,
                                                                     channels_last=False), "crop"),
                  ("pyr_down", dt, lambda x: port.pyr_down(x, channels_last=False), "plane"),
                  ("pyr_up", dt, lambda x: port.pyr_up(x, channels_last=False), "crop"),
                  ("flip 0", dt, lambda x: port.flip(x, 0, channels_last=False), "plane"),
                  ("flip -1", dt, lambda x: port.flip(x, -1, channels_last=False), "plane"),
                  ("rotate 90cw", dt, lambda x: port.rotate(x, "90cw", channels_last=False),
                   "plane"),
                  ("rotate 180", dt, lambda x: port.rotate(x, "180", channels_last=False), "plane"),
                  ("transpose", dt, lambda x: port.transpose(x, channels_last=False), "plane"),
                  ("resize area general (1000/2160, 1800/3840)", dt, rs("area", (25, 54), (15, 32)),
                   "crop"),
                  ("add_weighted 0.7, -0.35, 9.5", dt, lambda x: port.add_weighted(
                      x, 0.7, torch.cat([x[..., 1:], x[..., :1]], -1), -0.35, 9.5), "plane"),
                  ("integral", dt, lambda x: port.integral(x, channels_last=False), "plane"),
                  ("integral sq", dt, lambda x: port.integral(x, True, channels_last=False)[1],
                   "plane")]
        for interp in ("linear", "cubic", "lanczos4"):
            if dt != u8:
                calls.append((f"resize {interp} down 1/2", dt, rs(interp, (1, 2), (1, 2)), "crop"))
    calls += [("filter2d float 15x15", dt, lambda x: port.filter2d(x, float15, 0.0,
                                                                   channels_last=False), "crop")
              for dt in (u8, f32)]
    for interp in INTERPOLATIONS:
        calls += [(f"resize {interp} down to 1080x1920", u8, rs(interp, (1, 2), (1, 2)), "crop"),
                  (f"resize {interp} up to 4320x7680", u8, rs(interp, (2, 1), (2, 1)), "crop")]
    for ap in (3, 5, 7):
        for l2 in (False, True):
            calls.append((f"canny aperture {ap} {'L2' if l2 else 'L1'}", "smooth",
                          lambda x, ap=ap, l2=l2: port.canny(x, 50.0, 150.0, ap, l2,
                                                             channels_last=False), "crop"))
    calls += [(f"connected_components connectivity {c}", "mask",
               lambda x, c=c: port.connected_components(x, c, channels_last=False), "crop")
              for c in (4, 8)]
    calls += [(f"match_template 32x32 {m}", "smooth", lambda x, m=m: port.match_template(
                  x, templ, m, channels_last=False), "crop") for m in METHODS]
    calls += [(f"match_template 32x32 ccoeff_normed", dt, lambda x: port.match_template(
                  x, templ, "ccoeff_normed", channels_last=False), "crop") for dt in (u16, f32)]
    calls += [(f"apply_color_map {c}", u8, lambda x, c=c: port.apply_color_map(
                  x, c, channels_last=False), "plane") for c in ("jet", "turbo")]
    calls += [("calc_back_project 32 bins scale 0.6", u8, lambda x: port.calc_back_project(
                  x, hist, 0.6, channels_last=False), "plane")]

    t0, rows = time.perf_counter(), []
    for label, key, fn, part in calls:
        x = torch.from_numpy(host[key])
        dname = key if isinstance(key, str) else str(key).replace("torch.", "")
        name = f"{label} {dname} {'x'.join(map(str, shape4))}"
        expect = {"apply_lut256": 1} if label.startswith("calc_back_project") else {}
        g = x.to(dev)
        out = drive(name, lambda: fn(g), expect)[0]
        if out.device != dev or out.numel() == 0:
            raise AssertionError(f"{name}: output on {out.device}, {tuple(out.shape)}")
        cpu_in = x[:1] if part == "plane" else x[:1, :crop[0], :crop[1]].contiguous()
        got = (out[:1] if part == "plane" else fn(cpu_in.to(dev))).cpu()
        want = fn(cpu_in)
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{name}: card {tuple(got.shape)} {got.dtype}, CPU "
                                 f"{tuple(want.shape)} {want.dtype}")
        diff = (got.double() - want.double()).abs()
        e, scale = float(diff.max()), float(want.double().abs().max())
        ndiff = int((diff > 0).sum())
        if label.startswith("match_template"):
            ok, limit = e <= 3e-6 * max(scale, 1e-30), f"3e-6 of {scale:.4g}"
        elif label.startswith("integral") and want.dtype == torch.float32:
            # f64 sums in another order (torch's scans differ by device),
            # each cast once: at most one f32 ulp apart
            ulp = torch.finfo(torch.float32).eps * want.double().abs()
            ok, limit = bool((diff <= ulp).all()), "1 f32 ulp"
        else:
            ok, limit = e == 0, "0"
        if not ok:
            raise AssertionError(f"{name}: card vs CPU max abs err {e} ({ndiff} values) over "
                                 f"the limit {limit}")
        ms_, _ = time_ms(lambda: fn(g), 5, 2)
        rows.append((name, ms_, e, ndiff, limit, part))
        del out, got, want, g
    print(f"phase 12's functions on the card vs the CPU: within their limits over {len(calls)} "
          f"calls ({time.perf_counter() - t0:.1f} s)")
    for name, ms_, e, ndiff, limit, part in rows:
        where = "first plane" if part == "plane" else f"{crop[0]}x{crop[1]} crop"
        print(f"  {name}: {ms_:.4f} ms back to back; vs CPU ({where}) max abs err {e:g} "
              f"({ndiff} values, limit {limit})  [{smi}]")

    # -- the inspection chain through make_pipeline, then connected components
    oh, ow = shape4[1] // 2, shape4[2] // 2
    pipe = port.make_pipeline(inspection_stages(oh, ow))
    xh = noisy((shape4[0],), shape4[1], shape4[2], (), 121, 10.0)
    g = on_card(xh)

    def chain(x):
        return port.connected_components(pipe(x), 8, channels_last=False)

    label = (f"inspection chain (resize area {oh}x{ow} -> tophat 15 -> canny 50/150 -> "
             f"connected_components 8) {'x'.join(map(str, shape4))} u8")
    labels, _ = drive(label, lambda: chain(g), {})
    edges = pipe(g)
    if labels.shape != (shape4[0], oh, ow) or labels.dtype != torch.int32 or not bool(edges.any()):
        raise AssertionError(f"{label}: {tuple(labels.shape)} {labels.dtype}, or no edges")
    cpu_labels = chain(torch.from_numpy(xh[:1]))
    e = max_err(labels[:1].cpu(), cpu_labels)
    tophat = port.morphology_ex(port.resize(g, (oh, ow), "area", channels_last=False),
                                "tophat", 15, channels_last=False)
    _, steps = tcanny.hysteresis(*tcanny.canny_candidates(tophat, 50.0, 150.0))
    print(f"{label}: first plane card vs the plain path on the CPU, max abs err {e}; "
          f"{int(edges.sum()) // 255} edge pixels, {int(labels[0].amax())} components in "
          f"plane 0 and {int(labels[1:].amax())} in plane 1; Canny's hysteresis ran {steps} "
          f"steps (checked every {tcanny.CHECK_EVERY})")
    if e:
        raise AssertionError(f"{label}: the card differs from the CPU")
    b_ms, b_iqr = time_ms(lambda: chain(g))
    busy, wall, krows = device_split(lambda: chain(g))
    gpix = g.numel() / 1e9
    print(f"{label}: back to back {b_ms:.4f} ms (IQR {b_iqr:.4f}) = {gpix / (b_ms / 1e3):.3f} "
          f"GPix/s of input; under torch.profiler {busy:.2f} us of device time per call in "
          f"{wall:.2f} us of wall ({100 * busy / wall:.1f} % busy)  [{smi}]")
    for us, n, name in krows[:15]:
        print(f"    {us:9.2f} us per call  {100 * us / busy:5.1f} %  x{n:g}  {name[:100]}")
    small = port.resize(g, (oh, ow), "area", channels_last=False)
    for stage, fn in (("resize area", lambda: port.resize(g, (oh, ow), "area",
                                                          channels_last=False)),
                      ("morphology tophat 15", lambda: port.morphology_ex(
                          small, "tophat", 15, channels_last=False)),
                      ("canny 50/150", lambda: port.canny(tophat, 50.0, 150.0,
                                                          channels_last=False)),
                      ("connected_components 8", lambda: port.connected_components(
                          edges, 8, channels_last=False))):
        s_ms, s_iqr = time_ms(fn, 10, 2)
        print(f"  inspection chain stage {stage}: {s_ms:.4f} ms back to back (IQR {s_iqr:.4f})"
              f"  [{smi}]")


# phase 13's sizes: the ones its users run (4K planes for the per-element
# ops, a 1080p burst for the statistics and the trackers, VGA and 720p
# frames for the segmentation); the CPU comparison runs at the same sizes
P13 = {"arith": (2, 2160, 3840), "blend": (2160, 3840), "stats": (8, 1080, 1920),
       "plane": (2160, 3840), "track": (1080, 1920), "corners": 500, "camshift": (30, 1080, 1920),
       "segment": (480, 640), "segment_timed": ((480, 640), (720, 1280))}
TRUE_SHIFT = (2.35, -1.6)


def tracking_frames(H: int, W: int, shift: tuple, seed: int) -> tuple:
    """A textured gray frame (saddles of two crossed sines, an oblique wave,
    a fine ripple, noise of sigma 2) and the same scene moved by ``shift``
    (dx, dy) in sub-pixel steps with its own noise, u8."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)

    def scene(x, y):
        return (128 + 45 * np.sin(x / 7.3) * np.sin(y / 9.1) + 25 * np.sin(x / 23.0 + y / 17.0)
                + 15 * np.sin(x / 3.1 - y / 4.7))

    a = scene(xx, yy) + rng.normal(0, 2, (H, W))
    b = scene(xx - shift[0], yy - shift[1]) + rng.normal(0, 2, (H, W))
    return tuple(np.clip(np.rint(f), 0, 255).astype(np.uint8) for f in (a, b))


def camshift_frames(T: int, H: int, W: int, seed: int) -> tuple:
    """RGB frames of a red disc of radius H/9 crossing a green-blue noisy
    background, and the window around the disc in the first frame."""
    rng = np.random.default_rng(seed)
    r = H // 9
    frames = np.empty((T, H, W, 3), np.uint8)
    yy, xx = np.ogrid[0:H, 0:W]
    for t in range(T):
        frames[t, ..., 0] = rng.integers(0, 60, (H, W), dtype=np.uint8)
        frames[t, ..., 1] = rng.integers(80, 200, (H, W), dtype=np.uint8)
        frames[t, ..., 2] = rng.integers(60, 220, (H, W), dtype=np.uint8)
        cx, cy = W * 0.25 + t * W * 0.015, H * 0.3 + t * H * 0.012
        disc = (xx - cx) ** 2 + (yy - cy) ** 2 < r * r
        frames[t][disc] = rng.integers(0, 40, (int(disc.sum()), 3), dtype=np.uint8) + \
            np.array([200, 0, 0], np.uint8)
    win = (int(W * 0.25) - r // 2, int(H * 0.3) - r // 2, r, r)
    return frames, win, (W * 0.25 + (T - 1) * W * 0.015, H * 0.3 + (T - 1) * H * 0.012)


def segmentation_image(H: int, W: int, seed: int) -> np.ndarray:
    """A colour scene for mean-shift segmentation: a gradient, a few dozen
    flat rectangles and discs of random colours, noise of sigma 6."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    img = np.stack([60 + 100 * xx / W, 80 + 90 * yy / H, 150 - 60 * xx / W], -1)
    for _ in range(40):
        c = rng.uniform(0, 255, 3)
        y0, x0 = rng.integers(0, H), rng.integers(0, W)
        if rng.random() < 0.5:
            img[y0:y0 + rng.integers(H // 20, H // 4), x0:x0 + rng.integers(W // 20, W // 4)] = c
        else:
            img[(yy - y0) ** 2 + (xx - x0) ** 2 < rng.integers(H // 30, H // 8) ** 2] = c
    return np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)


def family_line(label: str, fn, smi: str, runs: int = 5, calls: int = 2,
                warmups: int = WARMUPS) -> float:
    """Print one family's ms per call back to back (CUDA events), its device
    launches per call and busy share under torch.profiler (one call after
    the usual warm-ups; late in this script the profiler keeps fewer
    kernel events than tools/torch_phase13.py, which runs this phase
    alone); return the ms.  Calls of a second or more take one warm-up
    before ``runs`` runs of one call."""
    ms_, iqr = time_ms(fn, runs, calls, warmups)
    busy, wall, rows = device_split(fn, 1)
    launches = sum(n for _, n, _ in rows)
    print(f"  {label}: {ms_:.4f} ms per call back to back (IQR {iqr:.4f}); {launches:g} device "
          f"launches per call, {busy:.2f} us of device time in {wall:.2f} us of wall under "
          f"torch.profiler (busy {100 * busy / wall:.1f} %)  [{smi}]")
    return ms_


def _same(got, want, what: str, ulps: int = 0) -> None:
    """Card against CPU: equal dtype and shape, NaN at the same places, and
    the values equal (``ulps`` > 0: within that many f32 spacings)."""
    got = got.cpu()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: card {tuple(got.shape)} {got.dtype}, CPU "
                             f"{tuple(want.shape)} {want.dtype}")
    if got.dtype.is_floating_point:
        gn, wn = torch.isnan(got), torch.isnan(want)
        if not torch.equal(gn, wn):
            raise AssertionError(f"{what}: NaN at other places")
        g, w = got[~gn].double(), want[~wn].double()
        inf = torch.isinf(w)
        if not torch.equal(g[inf], w[inf]):
            raise AssertionError(f"{what}: infinities differ")
        d = (g[~inf] - w[~inf]).abs()
        lim = ulps * torch.finfo(torch.float32).eps * w[~inf].abs() if ulps else 0.0
        if d.numel() and bool((d > lim).any()):
            raise AssertionError(f"{what}: card vs CPU max abs err {float(d.max())} "
                                 f"(limit {ulps} ulp)")
    elif not torch.equal(got, want):
        raise AssertionError(f"{what}: card vs CPU max abs err {max_err(got, want)}")


def _flat(out) -> list:
    """The tensors of a (nested) tuple of outputs, in order."""
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [out]


def _on(dev, out) -> None:
    for t in _flat(out):
        if t.device != dev:
            raise AssertionError(f"output on {t.device}, not {dev}")


def arith_stats_and_tracking(port, dev, smi, on_card, drive, sizes: dict = P13) -> None:
    """Phase 13: per-element arithmetic, the accumulators and blendLinear in
    every dtype each takes, the device statistics, the detect -> refine ->
    track chain, the CamShift chain and mean-shift segmentation, each with
    counters of its own, card against CPU, timed back to back with its
    launches and busy share."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(13)
    u8, u16, i16, f32 = torch.uint8, torch.uint16, torch.int16, torch.float32

    def run(label, fn, args, timed=True, planes=None):
        """Drive ``fn(*args)`` on the card with counters of its own, hold it
        against the same call on the CPU (an elementwise ``fn`` on the
        first ``planes`` planes only, where given), return the card's
        output."""
        g = [a.to(dev) if isinstance(a, torch.Tensor) else a for a in args]
        out, _ = drive(label, lambda: fn(*g), {})
        _on(dev, out)
        cpu = [a[:planes] if isinstance(a, torch.Tensor) and planes else a for a in args]
        for o, w in zip(_flat(out), _flat(fn(*cpu)), strict=True):
            _same(o[:planes] if planes else o, w, label)
        if timed:
            ms_, _ = time_ms(lambda: fn(*g), 5, 2)
            print(f"  {label}: card vs CPU equal; {ms_:.4f} ms back to back  [{smi}]")
        return out

    # -- per-element arithmetic, the accumulators and blendLinear
    shape = sizes["arith"]
    pairs = {}
    for dt, npdt in ((u8, np.uint8), (u16, np.uint16), (i16, np.int16)):
        info = np.iinfo(npdt)
        a = rng.integers(info.min, info.max + 1, shape).astype(npdt)
        b = rng.integers(info.min, info.max + 1, shape).astype(npdt)
        b[:, 0, :64] = 0
        pairs[dt] = (torch.from_numpy(a), torch.from_numpy(b))
    a = (rng.random(shape, dtype=np.float32) * 500 - 100).astype(np.float32)
    b = (rng.random(shape, dtype=np.float32) * 500 - 100).astype(np.float32)
    b[:, 0, :64] = 0
    a[:, 0, :8] = 0  # 0/0: NaN
    pairs[f32] = (torch.from_numpy(a), torch.from_numpy(b))
    sname = "x".join(map(str, shape))
    n_arith = 0
    t0 = time.perf_counter()
    for dt, (x, y) in pairs.items():
        d = str(dt).replace("torch.", "")
        ops = [("add", ()), ("subtract", ()), ("absdiff", ()), ("minimum", ()), ("maximum", ()),
               ("multiply", (1.0,)), ("multiply", (0.37,)), ("divide", (1.0,)),
               ("divide", (255.0,)), ("compare", ("gt",)), ("compare", ("eq",))]
        if dt != f32:
            ops += [("bitwise_and", ()), ("bitwise_or", ()), ("bitwise_xor", ())]
        for op, extra in ops:
            run(f"{op}{extra} {d} {sname}", lambda p, q, op=op, extra=extra: getattr(port, op)(
                p, q, *extra), (x, y), planes=1)
            n_arith += 1
        if dt != f32:
            run(f"bitwise_not {d} {sname}", port.bitwise_not, (x,), planes=1)
            n_arith += 1
    acc = torch.from_numpy((rng.random(shape, dtype=np.float32) * 1000).astype(np.float32))
    mask = torch.from_numpy(rng.integers(0, 2, shape, dtype=np.uint8))
    for dt in (u8, u16, f32):
        s1, s2 = pairs[dt][0], pairs[dt][1]
        if dt == f32:
            s1, s2 = s1.abs(), s2.abs()
        d = str(dt).replace("torch.", "")
        for name, fn, args in (
                ("accumulate", port.accumulate, (s1, acc)),
                ("accumulate masked", port.accumulate, (s1, acc, mask)),
                ("accumulate_square", port.accumulate_square, (s1, acc)),
                ("accumulate_product", port.accumulate_product, (s1, s2, acc)),
                ("accumulate_weighted 0.05", lambda s, c: port.accumulate_weighted(s, c, 0.05),
                 (s1, acc)),
                ("accumulate_weighted 0.05 masked",
                 lambda s, c, m: port.accumulate_weighted(s, c, 0.05, m), (s1, acc, mask))):
            run(f"{name} {d} into f32 {sname}", fn, args, planes=1)
            n_arith += 1
    bh, bw = sizes["blend"]
    w1 = torch.from_numpy(rng.random((bh, bw), dtype=np.float32))
    w2 = torch.from_numpy(rng.random((bh, bw), dtype=np.float32))
    blends = [(f"blend_linear u8 {bh}x{bw}", pairs[u8][0][0, :bh, :bw], pairs[u8][1][0, :bh, :bw]),
              (f"blend_linear u8 {bh}x{bw}x3", *(torch.from_numpy(rng.integers(
                  0, 256, (bh, bw, 3), dtype=np.uint8)) for _ in range(2))),
              (f"blend_linear f32 {bh}x{bw}", pairs[f32][0][0, :bh, :bw].abs(),
               pairs[f32][1][0, :bh, :bw].abs())]
    for label, s1, s2 in blends:
        run(label, port.blend_linear, (s1.contiguous(), s2.contiguous(), w1, w2))
        n_arith += 1
    print(f"phase 13 arithmetic, accumulate and blendLinear: card vs CPU at 0 over {n_arith} "
          f"calls (the {sname} calls on their first plane on the CPU), no kernel launched "
          f"({time.perf_counter() - t0:.1f} s)")
    gx, gy = pairs[u8][0].to(dev), pairs[u8][1].to(dev)
    family_line(f"family arithmetic: add u8 {sname}", lambda: port.add(gx, gy), smi)
    gx, gy = pairs[u16][0].to(dev), pairs[u16][1].to(dev)
    family_line(f"family arithmetic: multiply u16 scale 0.37 {sname}",
                lambda: port.multiply(gx, gy, 0.37), smi)
    gs, gacc = pairs[u8][0].to(dev), acc.to(dev)
    family_line(f"family accumulate: accumulate_weighted u8 into f32 {sname}",
                lambda: port.accumulate_weighted(gs, gacc, 0.05), smi)
    g1, g2, gw1, gw2 = blends[1][1].to(dev), blends[1][2].to(dev), w1.to(dev), w2.to(dev)
    family_line(f"family blendLinear: u8 {bh}x{bw}x3", lambda: port.blend_linear(g1, g2, gw1, gw2),
                smi)
    del pairs, acc, mask, gx, gy, gs, gacc, g1, g2

    # -- statistics: the PSNR of the main path, norms, meanStdDev, minMaxLoc
    # on a match_template response, moments of a 4K plane
    t0 = time.perf_counter()
    N, H, W = sizes["stats"]
    frames = torch.from_numpy(noisy((N,), H, W, (), 131, 10.0))
    gf = frames.to(dev)
    label = f"psnr(frames, equalize_unsharp(frames)) {N}x{H}x{W} u8"
    got, _ = drive(label, lambda: port.psnr(gf, port.equalize_unsharp(gf)),
                   {"hist256_lut": 1, "sep_conv_u8": 1})
    _on(dev, got)
    eq_cpu = port.equalize_unsharp(frames)
    _same(got, port.psnr(frames, eq_cpu), label)
    print(f"{label}: {float(got):.6f} dB, card vs CPU equal")
    for nt in ("l1", "l2", "inf"):
        run(f"norm {nt} {N}x{H}x{W} u8", port.norm, (frames, nt))
        run(f"norm {nt} of the difference {N}x{H}x{W} u8", port.norm, (frames, nt, eq_cpu))
    run(f"mean_std_dev {N}x{H}x{W} u8", port.mean_std_dev, (frames,))
    ph, pw = sizes["plane"]
    smooth = noisy((1,), ph, pw, (), 120, 10.0)
    templ = smooth[0, ph // 3:ph // 3 + 32, pw // 3:pw // 3 + 32].copy()
    resp = port.match_template(on_card(smooth), templ, "ccoeff_normed", channels_last=False)[0]
    label = f"min_max_loc of match_template ccoeff_normed 32x32 on {ph}x{pw}"
    mml = run(label, port.min_max_loc, (resp.cpu(),))
    print(f"  {label}: max {float(mml[1]):.6f} at ({int(mml[3][0])}, {int(mml[3][1])}), the "
          f"template cut at ({pw // 3}, {ph // 3})")
    plane = torch.from_numpy(smooth[0])
    planef = torch.from_numpy(rng.random((ph, pw), dtype=np.float32))
    label = f"moments_device u8 {ph}x{pw}"
    got, _ = drive(label, lambda: port.moments_device(plane.to(dev)), {})
    want = port.moments_device(plane)
    for k in want:
        _on(dev, got[k])
        _same(got[k], want[k], f"{label} {k}")
    label = f"moments_device f32 {ph}x{pw}"
    gotf = port.moments_device(planef.to(dev))
    wantf = port.moments_device(planef)
    for k in wantf:
        _same(gotf[k], wantf[k], f"{label} {k}", ulps=1)
    print(f"  moments_device: u8 card vs CPU equal on 24 entries, f32 within 1 ulp "
          f"(m00 {float(got['m00']):.6g}, nu11 {float(got['nu11']):.6g})")
    print(f"phase 13 statistics: card vs CPU within their limits ({time.perf_counter() - t0:.1f} s)")
    family_line(f"family statistics: psnr(frames, equalize_unsharp(frames)) {N}x{H}x{W}",
                lambda: port.psnr(gf, port.equalize_unsharp(gf)), smi)
    family_line(f"family statistics: norm l2 and mean_std_dev {N}x{H}x{W}",
                lambda: (port.norm(gf, "l2"), port.mean_std_dev(gf)), smi)
    gplane = plane.to(dev)
    family_line(f"family statistics: moments_device u8 {ph}x{pw}",
                lambda: port.moments_device(gplane), smi)
    del frames, gf, eq_cpu, resp

    # -- the detect -> refine -> track chain
    t0 = time.perf_counter()
    H, W = sizes["track"]
    f0, f1 = tracking_frames(H, W, TRUE_SHIFT, 1313)
    c0, c1 = torch.from_numpy(f0), torch.from_numpy(f1)
    g0, g1 = c0.to(dev), c1.to(dev)
    n_c = sizes["corners"]
    pts = run(f"good_features_to_track({n_c}, 0.01, 10) {H}x{W}",
              lambda im: port.good_features_to_track(im, n_c, 0.01, 10.0), (c0,), timed=False)
    ref_pts = run(f"corner_sub_pix(win (5, 5)) of {pts.shape[0]} corners",
                  lambda im, p: port.corner_sub_pix(im, p, (5, 5)), (c0, pts.cpu()), timed=False)
    label = f"calc_optical_flow_pyr_lk(21x21, max_level 3, 30 iterations) {pts.shape[0]} points"
    nxt, st, err_ = run(label, lambda a, b, p: port.calc_optical_flow_pyr_lk(a, b, p), (c0, c1,
                                                                                   ref_pts.cpu()),
                        timed=False)
    ok = st == 1
    flow = (nxt[ok] - ref_pts[ok]).cpu().double()
    med = flow.median(0).values
    print(f"{label}: bitwise card vs CPU (points, status, err); {int(ok.sum())} of "
          f"{pts.shape[0]} tracked, median shift ({float(med[0]):.4f}, {float(med[1]):.4f}) px "
          f"against the true {TRUE_SHIFT}")
    if (med - torch.tensor(TRUE_SHIFT, dtype=torch.float64)).abs().max() > 0.05:
        raise AssertionError(f"{label}: median shift {med.tolist()} off the true {TRUE_SHIFT}")
    fast = port.calc_optical_flow_pyr_lk(g0, g1, ref_pts, exact=False)
    both = ok & (fast[1] == 1)
    dfast = float((fast[0][both] - nxt[both]).abs().max())
    print(f"  exact=False: {int((fast[1] == 1).sum())} tracked, within {dfast:.6f} px of exact")
    if dfast >= 0.1:
        raise AssertionError(f"exact=False is {dfast} px off exact")
    print(f"phase 13 tracking chain: card vs CPU equal ({time.perf_counter() - t0:.1f} s)")
    gref = ref_pts.to(dev)
    family_line(f"family tracking: good_features_to_track {H}x{W}",
                lambda: port.good_features_to_track(g0, n_c, 0.01, 10.0), smi, 3, 1, 1)
    t0 = time.perf_counter()
    port.corner_sub_pix(g0, pts, (5, 5))
    print(f"  family tracking: corner_sub_pix {pts.shape[0]} corners: "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms on the host clock (a host helper: no "
          f"device launch)  [{smi}]")
    family_line(f"family tracking: calc_optical_flow_pyr_lk exact {pts.shape[0]} points",
                lambda: port.calc_optical_flow_pyr_lk(g0, g1, gref), smi, 3, 1, 1)
    family_line(f"family tracking: calc_optical_flow_pyr_lk exact=False {pts.shape[0]} points",
                lambda: port.calc_optical_flow_pyr_lk(g0, g1, gref, exact=False), smi, 3, 1, 1)
    del g0, g1, gref

    # -- the CamShift chain: rgb2hsv, the hue's back projection, cam_shift
    t0 = time.perf_counter()
    T, H, W = sizes["camshift"]
    frames, win0, end = camshift_frames(T, H, W, 1314)
    hue0 = port.cvt_color(torch.from_numpy(frames[0]), "rgb2hsv")[..., 0].numpy()
    x, y, w, h = win0
    hist = np.bincount(hue0[y:y + h, x:x + w].astype(np.int64).ravel() * 32 // 256, minlength=32)
    hist = hist * (255.0 / hist.max())

    def camshift_chain(fr):
        win, out = win0, []
        for t in range(fr.shape[0]):
            hue = port.cvt_color(fr[t], "rgb2hsv")[..., 0].contiguous()
            box, win = port.cam_shift(port.calc_back_project(hue, hist), win, 10, 1.0)
            out.append((box, win))
        return out

    gfr = torch.from_numpy(frames).to(dev)
    label = f"CamShift chain (rgb2hsv -> calc_back_project -> cam_shift) {T}x{H}x{W}x3"
    got, _ = drive(label, lambda: camshift_chain(gfr), {"apply_lut256": T})
    want = camshift_chain(torch.from_numpy(frames))
    if got != want:
        raise AssertionError(f"{label}: card windows {got[-1]}, CPU {want[-1]}")
    x, y, w, h = got[-1][1]
    print(f"{label}: windows and boxes equal card vs CPU over {T} frames; last window "
          f"{got[-1][1]} centred ({x + w / 2:.1f}, {y + h / 2:.1f}), the disc at "
          f"({end[0]:.1f}, {end[1]:.1f}) ({time.perf_counter() - t0:.1f} s)")
    if abs(x + w / 2 - end[0]) > 8 or abs(y + h / 2 - end[1]) > 8:
        raise AssertionError(f"{label}: the window lost the disc")
    ms_ = family_line(f"family CamShift: {T} frames {H}x{W}x3", lambda: camshift_chain(gfr), smi,
                      3, 1, 1)
    print(f"  CamShift chain: {ms_ / T:.4f} ms a frame  [{smi}]")
    del gfr, frames

    # -- mean-shift segmentation, the OpenCV sample's settings
    t0 = time.perf_counter()
    H, W = sizes["segment"]
    img = torch.from_numpy(segmentation_image(H, W, 1315))
    label = f"pyr_mean_shift_filtering(sp 10, sr 20, max_level 1) {H}x{W}x3"
    out = run(label, lambda im: port.pyr_mean_shift_filtering(im, 10, 20, 1), (img,), timed=False)
    print(f"{label}: card vs CPU at 0 LSB, {int(torch.unique(out.reshape(-1, 3), dim=0).shape[0])} "
          f"colours from {int(torch.unique(img.reshape(-1, 3), dim=0).shape[0])} "
          f"({time.perf_counter() - t0:.1f} s)")
    for H, W in sizes["segment_timed"]:
        g = on_card(segmentation_image(H, W, 1316))
        family_line(f"family segmentation: pyr_mean_shift_filtering(10, 20, 1) {H}x{W}x3",
                    lambda: port.pyr_mean_shift_filtering(g, 10, 20, 1), smi, 3, 1, 1)
    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s")


# phase 14's sizes: a 1080p photo for the photo editor's filters, decolor,
# TV-L1 and phase correlation, a 4K bracket of three exposures for the HDR
# chain, a 400x600 region cloned into a 1080p frame, the OpenCV inpaint
# sample's 480x640 scale
P14 = {"photo": (1080, 1920), "bracket": (2160, 3840), "tvl1": (3, 1080, 1920),
       "clone": ((400, 600), (1080, 1920)), "inpaint": (480, 640)}
BRACKET_SHIFTS = ((3, -5), (0, 0), (-2, 4))      # (dy, dx) of each exposure's crop
BRACKET_TIMES = (1 / 30, 1 / 8, 1 / 2)
PHASE_SHIFT = (-5, 3)                             # (dy, dx) of the second frame


def photo_scene(H: int, W: int, seed: int) -> np.ndarray:
    """An RGB photo, u8: crossed sines and an oblique wave over a few flat
    discs (edges for the edge-preserving filters), noise of sigma 4."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    g = 120 + 40 * np.sin(xx / 37.0) * np.sin(yy / 29.0) + 25 * np.sin((xx + yy) / 61.0)
    img = np.stack([g, g * 0.8 + 30, 200 - g * 0.6], -1)
    for _ in range(12):
        cy, cx, r = rng.uniform(0, H), rng.uniform(0, W), rng.uniform(H / 20, H / 6)
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.uniform(20, 235, 3)
    return np.clip(img + rng.normal(0, 4, img.shape), 0, 255).astype(np.uint8)


def smooth_field(H: int, W: int, cell: int, rng) -> np.ndarray:
    """Normal noise on a grid of ``cell`` pixels, bilinearly upsampled to
    H x W (f32)."""
    g = rng.normal(0, 1, (H // cell + 2, W // cell + 2)).astype(np.float32)
    y, x = np.arange(H, dtype=np.float32) / cell, np.arange(W, dtype=np.float32) / cell
    y0, x0 = y.astype(np.int64), x.astype(np.int64)
    fy, fx = (y - y0)[:, None], (x - x0)[None, :]
    top = g[y0][:, x0] * (1 - fx) + g[y0][:, x0 + 1] * fx
    bot = g[y0 + 1][:, x0] * (1 - fx) + g[y0 + 1][:, x0 + 1] * fx
    return top * (1 - fy) + bot * fy


def exposure_bracket(H: int, W: int, seed: int) -> list:
    """Three u8 exposures (BRACKET_TIMES) of a radiance field of about 4
    stops with random texture at 1, 6 and 24 pixels, each cut from the scene at
    its BRACKET_SHIFTS offset, with noise of sigma 1 (medians near 9, 36
    and 144)."""
    rng = np.random.default_rng(seed)
    h, w = H + 16, W + 16
    lum = 400 * np.exp(0.6 * smooth_field(h, w, max(h // 4, 8), rng)
                       + 0.5 * smooth_field(h, w, 24, rng) + 0.3 * smooth_field(h, w, 6, rng))
    lum *= rng.uniform(0.7, 1.3, (h, w)).astype(np.float32)
    rad = np.stack([lum, lum * 0.85, lum * 0.7], -1)
    frames = []
    for t, (dy, dx) in zip(BRACKET_TIMES, BRACKET_SHIFTS):
        crop = rad[8 + dy:8 + dy + H, 8 + dx:8 + dx + W] * t
        frames.append(np.clip(crop + rng.normal(0, 1, crop.shape), 0, 255).astype(np.uint8))
    return frames


def stroke_mask(H: int, W: int, seed: int, share: float = 0.01) -> np.ndarray:
    """Random 3-pixel strokes (scratches) over about ``share`` of an H x W
    image, u8 0/255."""
    rng = np.random.default_rng(seed)
    m = np.zeros((H, W), np.uint8)
    while (m > 0).mean() < share:
        y0, x0 = rng.uniform(8, H - 8), rng.uniform(8, W - 8)
        ang, n = rng.uniform(0, np.pi), int(rng.uniform(20, 90))
        ys = np.clip(np.round(y0 + np.sin(ang) * np.arange(n)), 2, H - 3).astype(int)
        xs = np.clip(np.round(x0 + np.cos(ang) * np.arange(n)), 2, W - 3).astype(int)
        for d in (-1, 0, 1):
            m[ys + d, xs] = 255
    return m


def _near(got, want, what: str, lsb: int = None, tol: float = None, rel: bool = False,
          finite: float = None) -> None:
    """Card against CPU within a tolerance: integer outputs within ``lsb``
    (the differing values counted), float outputs within ``tol`` (absolute,
    or relative to max(|want|, 1e-4)) on the values finite on both, at
    least ``finite`` of them finite (else finite at the same places)."""
    got = got.cpu()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: card {tuple(got.shape)} {got.dtype}, CPU "
                             f"{tuple(want.shape)} {want.dtype}")
    if lsb is not None:
        d = (got.to(torch.int64) - want.to(torch.int64)).abs()
        m = int(d.max()) if d.numel() else 0
        print(f"  {what}: card vs CPU max {m} LSB, {int((d > 0).sum())} of {d.numel()} differ")
        if m > lsb:
            raise AssertionError(f"{what}: card vs CPU {m} LSB (limit {lsb})")
        return
    fin = torch.isfinite(got) & torch.isfinite(want)
    share = float(fin.float().mean())
    if finite is None and not torch.equal(torch.isfinite(got), torch.isfinite(want)):
        raise AssertionError(f"{what}: non-finite values at other places")
    if finite is not None and share <= finite:
        raise AssertionError(f"{what}: {share:.6f} finite on both (limit {finite})")
    g, w = got[fin].double(), want[fin].double()
    d = (g - w).abs() / (w.abs().clamp_min(1e-4) if rel else 1.0)
    m = float(d.max()) if d.numel() else 0.0
    print(f"  {what}: card vs CPU max {'relative' if rel else 'abs'} err {m:.3g} "
          f"(limit {tol}), {share:.6f} finite")
    if m > tol:
        raise AssertionError(f"{what}: card vs CPU {m} (limit {tol})")


def photo_and_hdr(port, dev, smi, on_card, drive, sizes: dict = P14) -> None:
    """Phase 14: the photo module's filters, the HDR bracket chain, decolor,
    TV-L1, phase correlation, seamless cloning and inpainting at the sizes
    their users run, each with counters of its own, card against CPU, timed
    with its launches and busy share."""
    from imageenhancement_mp_tpu_torch.utils.photo_host import create_hanning_window, mtb_shifts

    t_phase = time.perf_counter()

    def run(label, fn, args, expect=None, **tol):
        """Drive ``fn(*args)`` on the card with counters of its own, hold
        each output against the same call on the CPU, return the card's."""
        g = [on_card(a) if isinstance(a, np.ndarray) else a for a in args]
        out, _ = drive(label, lambda: fn(*g), expect or {})
        _on(dev, out)
        cpu = [torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
               for a in args]
        for i, (o, w) in enumerate(zip(_flat(out), _flat(fn(*cpu)), strict=True)):
            _near(o, w, f"{label} [{i}]", **tol) if tol else _same(o, w, f"{label} [{i}]")
        return out, g

    # -- the photo editor's filters on one 1080p frame, cv2's defaults
    t0 = time.perf_counter()
    H, W = sizes["photo"]
    photo = photo_scene(H, W, 1401)
    filters = [("edge_preserving_filter recursive (60, 0.4)", port.edge_preserving_filter, {}),
               ("edge_preserving_filter normconv (60, 0.4)",
                lambda im: port.edge_preserving_filter(im, "normconv"), {}),
               ("detail_enhance (10, 0.15)", port.detail_enhance, {}),
               ("stylization (60, 0.45)", port.stylization, {}),
               ("pencil_sketch (60, 0.07, 0.02)", port.pencil_sketch, None)]
    for name, fn, tol in filters:
        label = f"{name} {H}x{W}x3"
        _, g = run(label, fn, (photo,), **({} if tol is None else {"lsb": 1}))
        family_line(f"family photo: {label}", lambda: fn(g[0]), smi, 2, 1, 1)
    print(f"phase 14 domain-transform filters: card vs CPU within their limits "
          f"({time.perf_counter() - t0:.1f} s)")

    # -- the HDR bracket: align, merge both ways, tonemap
    t0 = time.perf_counter()
    H, W = sizes["bracket"]
    frames = exposure_bracket(H, W, 1402)
    stack = np.stack(frames)
    label = f"align_mtb 3x{H}x{W}x3"
    aligned, g = run(label, port.align_mtb, (stack,))
    shifts = mtb_shifts([port.cvt_gray(torch.from_numpy(f)).numpy() for f in frames])
    want = [(dx, dy) for dy, dx in BRACKET_SHIFTS]
    print(f"{label}: shifts {shifts}, true {want}; aligned to {tuple(aligned[0].shape)}")
    if shifts != want:
        raise AssertionError(f"{label}: shifts {shifts}, true {want}")
    family_line(f"family HDR: {label}", lambda: port.align_mtb(g[0]), smi, 2, 1, 1)
    al = torch.stack(aligned)
    al_cpu = al.cpu()
    ah, aw = al.shape[1:3]
    label = f"merge_mertens 3x{ah}x{aw}x3"
    fused, _ = drive(label, lambda: port.merge_mertens(al), {})
    _near(fused, port.merge_mertens(al_cpu), label, tol=1e-4)
    family_line(f"family HDR: {label}", lambda: port.merge_mertens(al), smi)
    label = f"merge_debevec 3x{ah}x{aw}x3 (1/30, 1/8, 1/2 s)"
    hdr, _ = drive(label, lambda: port.merge_debevec(al, BRACKET_TIMES),
                   {"apply_lut256_wide": 2})
    hdr_cpu = port.merge_debevec(al_cpu, BRACKET_TIMES)
    _near(hdr, hdr_cpu, label, tol=1e-4, rel=True)
    family_line(f"family HDR: {label}", lambda: port.merge_debevec(al, BRACKET_TIMES), smi)
    for name, fn, tol in (("tonemap(2.2)", lambda x: port.tonemap(x, 2.2), dict(tol=6e-8)),
                          ("tonemap_reinhard", port.tonemap_reinhard,
                           dict(tol=5e-5, finite=0.999)),
                          ("tonemap_drago", port.tonemap_drago, dict(tol=5e-5, finite=0.999)),
                          ("tonemap_mantiuk", port.tonemap_mantiuk,
                           dict(tol=5e-5, finite=0.999))):
        label = f"{name} of the radiance {ah}x{aw}x3"
        mapped, _ = drive(label, lambda: fn(hdr), {})
        _near(mapped, fn(hdr_cpu), label, **tol)
        family_line(f"family HDR: {label}", lambda: fn(hdr), smi)
    print(f"phase 14 HDR chain: card vs CPU within their limits ({time.perf_counter() - t0:.1f} s)")
    del al, al_cpu, hdr, hdr_cpu, aligned, g, stack, frames, fused, mapped

    # -- decolor and TV-L1 on 1080p
    t0 = time.perf_counter()
    H, W = sizes["photo"]
    label = f"decolor {H}x{W}x3"
    gphoto = on_card(photo)
    (g8, boost), _ = drive(label, lambda: port.decolor(gphoto), {"take_table": 15})
    _on(dev, (g8, boost))
    want_g, want_b = port.decolor(torch.from_numpy(photo))
    _near(g8, want_g, f"{label} gray", lsb=1)
    _near(boost, want_b, f"{label} color boost", lsb=8)
    family_line(f"family decolor: {label}", lambda: port.decolor(gphoto), smi, 2, 1, 1)
    K, H, W = sizes["tvl1"]
    clean = photo_scene(H, W, 1403)[..., 1]
    rng = np.random.default_rng(1404)
    obs = np.stack([np.clip(clean + rng.normal(0, 20, clean.shape), 0, 255).astype(np.uint8)
                    for _ in range(K)])
    label = f"denoise_tvl1 {K}x{H}x{W}, 30 iterations"
    out, g = run(label, port.denoise_tvl1, (obs,), lsb=1)
    err_in = float(np.abs(obs[0].astype(float) - clean).mean())
    err_out = float((out.cpu().double() - torch.from_numpy(clean).double()).abs().mean())
    print(f"  {label}: mean |error| {err_in:.2f} in the first observation, {err_out:.2f} after")
    family_line(f"family TV-L1: {label}", lambda: port.denoise_tvl1(g[0]), smi)
    print(f"phase 14 decolor and TV-L1: card vs CPU within their limits "
          f"({time.perf_counter() - t0:.1f} s)")

    # -- phase correlation with a Hanning window
    t0 = time.perf_counter()
    H, W = sizes["photo"]
    big = photo_scene(H + 16, W + 16, 1405)[..., 0].astype(np.float32)
    dy, dx = PHASE_SHIFT
    a, b = big[8:8 + H, 8:8 + W], big[8 + dy:8 + dy + H, 8 + dx:8 + dx + W]
    win = create_hanning_window((H, W)).astype(np.float32)
    ga, gb, gw = on_card(a), on_card(b), on_card(win)
    label = f"phase_correlate {H}x{W} f32, Hanning window"
    (px, py), resp = drive(label, lambda: port.phase_correlate(ga, gb, gw), {})[0]
    (cx, cy), cresp = port.phase_correlate(*(torch.from_numpy(v) for v in (a, b, win)))
    print(f"{label}: card ({px:.5f}, {py:.5f}) response {resp:.5f}, CPU ({cx:.5f}, {cy:.5f}) "
          f"{cresp:.5f}, true ({-dx}, {-dy})")
    if max(abs(px - cx), abs(py - cy), abs(px + dx), abs(py + dy)) >= 0.05:
        raise AssertionError(f"{label}: shift off the CPU's or the true one by 0.05 px or more")
    family_line(f"family phase correlation: {label}", lambda: port.phase_correlate(ga, gb, gw),
                smi, 5)

    # -- seamless cloning of a region into a frame
    (rh, rw), (H, W) = sizes["clone"]
    src = photo_scene(H, W, 1406)
    dst = photo_scene(H, W, 1407)
    mask = np.zeros((H, W), np.uint8)
    yy, xx = np.ogrid[0:H, 0:W]
    mask[((yy - H / 2) / (rh / 2)) ** 2 + ((xx - W / 2) / (rw / 2)) ** 2 < 1] = 255
    label = f"seamless_clone of a {rh}x{rw} region into {H}x{W}x3"
    g = [on_card(v) for v in (src, dst, mask)]
    out, _ = drive(label, lambda: port.seamless_clone(*g, (W // 2, H // 2)), {})
    _on(dev, out)
    want = port.seamless_clone(*(torch.from_numpy(v) for v in (src, dst, mask)), (W // 2, H // 2))
    _near(out, want, label, lsb=2)
    mean = float((out.cpu().to(torch.int64) - want.to(torch.int64)).abs().double().mean())
    if mean >= 0.05:
        raise AssertionError(f"{label}: card vs CPU mean {mean}")
    family_line(f"family seamless clone: {label}",
                lambda: port.seamless_clone(*g, (W // 2, H // 2)), smi, 5)

    # -- inpainting scratches, the OpenCV sample's scale
    H, W = sizes["inpaint"]
    img = photo_scene(H, W, 1408)[..., 1].copy()
    mask = stroke_mask(H, W, 1409)
    label = f"inpaint (Telea, radius 3) {H}x{W}, {100 * (mask > 0).mean():.2f} % masked"
    out, g = run(label, lambda im, m: port.inpaint(im, m, 3.0), (img, mask))
    t1 = time.perf_counter()
    port.inpaint(g[0], g[1], 3.0)
    print(f"  family inpaint: {label}: {(time.perf_counter() - t1) * 1e3:.1f} ms on the host "
          f"clock (a host helper: no device launch)  [{smi}]")
    print(f"phase 14 phase correlation, seamless clone and inpaint: card vs CPU within their "
          f"limits ({time.perf_counter() - t0:.1f} s)")
    print(f"phase 14: {time.perf_counter() - t_phase:.1f} s")


# phase 15's sizes: a burst of eight 1080p masks for the distance transform
# (a document scanner's or an inspection line's frames), 1080p gray and RGB
# frames for the flood fill and the standard Hough transform, OpenCV's
# sample scale 480x640 for the host helpers (HoughLinesP, findContours and
# the shape descriptors)
P15 = {"distance": (8, 1080, 1920), "flood": (1080, 1920), "flood_crop": (270, 480),
       "hough": (1080, 1920), "hough_threshold": 150, "contours": (480, 640)}


def line_scene(H: int, W: int, seed: int) -> np.ndarray:
    """``photo_scene`` with eight dark straight bars 3 pixels wide across it
    (lane or page edges for the Hough transforms), u8 RGB."""
    rng = np.random.default_rng(seed)
    img = photo_scene(H, W, seed).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    for _ in range(8):
        ang = rng.uniform(0, np.pi)
        cy, cx = rng.uniform(0.2, 0.8) * H, rng.uniform(0.2, 0.8) * W
        d = np.abs((xx - cx) * np.sin(ang) - (yy - cy) * np.cos(ang))
        img[d < 1.5] = rng.uniform(0, 30, 3)
    return img.astype(np.uint8)


def background_point(H: int, W: int, seed: int) -> tuple:
    """An (x, y) of ``photo_scene(H, W, seed)``'s background, at least 4
    pixels outside each of its discs (their centres and radii replayed from
    its generator), the first such point right of the centre."""
    rng = np.random.default_rng(seed)
    discs = []
    for _ in range(12):
        cy, cx, r = rng.uniform(0, H), rng.uniform(0, W), rng.uniform(H / 20, H / 6)
        rng.uniform(20, 235, 3)
        discs.append((cy, cx, r + 4))
    y = H // 2
    for x in range(W // 2, W):
        if all((y - cy) ** 2 + (x - cx) ** 2 >= r * r for cy, cx, r in discs):
            return x, y
    raise AssertionError("no background point on the middle row")


def _host_ms(fn) -> tuple:
    """One call of a host helper on the host clock: (ms, result)."""
    t0 = time.perf_counter()
    out = fn()
    return (time.perf_counter() - t0) * 1e3, out


def _equal_results(a, b, what: str) -> None:
    """Equal host results: arrays of one dtype and equal elements, tuples,
    lists and dicts elementwise, numbers as values."""
    if isinstance(a, dict):
        if a.keys() != b.keys():
            raise AssertionError(f"{what}: keys differ")
        for k in a:
            _equal_results(a[k], b[k], f"{what}[{k}]")
    elif isinstance(a, (tuple, list)):
        if len(a) != len(b):
            raise AssertionError(f"{what}: {len(a)} items, CPU {len(b)}")
        for i, (x, y) in enumerate(zip(a, b)):
            _equal_results(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        if a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(a, b):
            raise AssertionError(f"{what}: card-derived {a.dtype} {a.shape}, CPU {b.dtype} "
                                 f"{b.shape} differ")
    elif a != b:
        raise AssertionError(f"{what}: {a} against the CPU's {b}")


def contours_and_shapes(port, dev, smi, on_card, drive, sizes: dict = P15) -> None:
    """Phase 15: distanceTransform on a burst of masks, floodFill on 1080p
    gray and RGB frames, HoughLines on a 1080p Canny edge map, and the host
    helpers (HoughLinesP, findContours, the shape descriptors, matchShapes)
    at 480x640, each device op with counters of its own (no kernel), card
    against CPU at 0, timed with its launches and busy share."""
    from imageenhancement_mp_tpu_torch.ops.floodfill import flood_region

    t_phase = time.perf_counter()

    # -- distanceTransform: the four (type, mask) pairs and L1 to u8 on the
    # masks of a burst of thresholded photos
    t0 = time.perf_counter()
    B, H, W = sizes["distance"]
    greens = np.stack([photo_scene(H, W, 1501 + b)[..., 1] for b in range(B)])
    g = on_card(greens)
    _, masks = port.threshold(g, 128.0, 255.0, channels_last=False)
    _, masks0 = port.threshold(torch.from_numpy(greens[:1]), 128.0, 255.0, channels_last=False)
    _same(masks[:1], masks0, "phase 15 masks")
    print(f"phase 15 masks: {B}x{H}x{W} u8, {100 * float((masks > 0).float().mean()):.1f} % "
          f"nonzero (distance sources are the zeros)")
    for dt, mask, dst in (("l1", 3, "f32"), ("c", 3, "f32"), ("l2", 3, "f32"), ("l2", 5, "f32"),
                          ("l1", 3, "u8")):
        label = f"distance_transform {dt} mask {mask} to {dst} {B}x{H}x{W}"
        out, _ = drive(label, lambda: port.distance_transform(masks, dt, mask, dst,
                                                              channels_last=False), {})
        _on(dev, out)
        t1 = time.perf_counter()
        _same(out[:1], port.distance_transform(masks0, dt, mask, dst, channels_last=False), label)
        cpu_s = time.perf_counter() - t1
        finite = out[out < 3e38]
        print(f"  {label}: card vs CPU at 0 over the first {H}x{W} frame (CPU {cpu_s:.1f} s); "
              f"largest finite distance {float(finite.max()) if finite.numel() else 0:.4f}")
        fn = lambda: port.distance_transform(masks, dt, mask, dst,  # noqa: E731
                                             channels_last=False)
        if (dt, mask, dst) in (("l1", 3, "f32"), ("l2", 5, "f32")):
            family_line(f"family distance: {label}", fn, smi, 2, 1, 0)
        else:   # the profiler's 25k-event post-processing takes ~20 s: one per mask size
            ms_d, iqr = time_ms(fn, 2, 1, 0)
            print(f"  family distance: {label}: {ms_d:.4f} ms per call back to back (IQR "
                  f"{iqr:.4f}); launches and busy share as the profiled call of its mask size"
                  f"  [{smi}]")
    print(f"phase 15 distance_transform: card vs CPU at 0 ({time.perf_counter() - t0:.1f} s)")
    del g, masks, masks0, greens, out, finite

    # -- floodFill on a 1080p frame, the seed in the background that spans
    # most of it; one full-size call on the CPU, a crop for the rest
    t0 = time.perf_counter()
    H, W = sizes["flood"]
    ch, cw = sizes["flood_crop"]
    rgb = photo_scene(H, W, 1511)
    gray = np.ascontiguousarray(rgb[..., 1])
    block = np.zeros((H + 2, W + 2), np.uint8)
    block[1:-1, W // 3] = 1                                   # a wall with a gap at the top
    block[1:H // 8, W // 3] = 0
    cases = [("gray 8-connected fixed range 70", gray, 8, True, (70,), None, False),
             ("gray 4-connected floating range 20", gray, 4, False, (20,), None, False),
             ("RGB 8-connected floating range 20", rgb, 8, False, (20, 20, 20), None, False),
             ("RGB 4-connected fixed range 70, a mask, mask_only", rgb, 4, True,
              (70, 70, 70), block, True)]
    sx, sy = background_point(H, W, 1511)
    for k, (name, img, conn, fixed, diff, mk, mo) in enumerate(cases):
        args = ((sx, sy), (255, 0, 0) if img.ndim == 3 else 255, diff, diff, conn, fixed)
        gi = on_card(img)
        gm = None if mk is None else on_card(mk)
        label = f"flood_fill {name} {H}x{W}"
        (n, out, om, rect), _ = drive(label, lambda: port.flood_fill(
            gi, *args, mask=gm, mask_only=mo, mask_fill=255 if mo else 1), {})
        _on(dev, (out, om))
        if k == 0:
            want = port.flood_fill(torch.from_numpy(img), *args)
        else:
            cy0, cx0 = sy - ch // 2, sx - cw // 2
            crop = np.ascontiguousarray(img[cy0:cy0 + ch, cx0:cx0 + cw])
            cargs = ((cw // 2, ch // 2),) + args[1:]
            cm = None if mk is None else mk[cy0:cy0 + ch + 2, cx0:cx0 + cw + 2].copy()
            got_c = port.flood_fill(on_card(crop), *cargs, mask=None if cm is None
                                    else on_card(cm), mask_only=mo, mask_fill=255 if mo else 1)
            want_c = port.flood_fill(torch.from_numpy(crop), *cargs, mask=cm, mask_only=mo,
                                     mask_fill=255 if mo else 1)
            if got_c[0] != want_c[0] or got_c[3] != want_c[3]:
                raise AssertionError(f"{label}: {ch}x{cw} crop card {got_c[0]} {got_c[3]}, CPU "
                                     f"{want_c[0]} {want_c[3]}")
            _same(got_c[1], want_c[1], f"{label} {ch}x{cw} crop image")
            _same(got_c[2], want_c[2], f"{label} {ch}x{cw} crop mask")
        if k == 0:
            if n != want[0] or rect != want[3]:
                raise AssertionError(f"{label}: card {n} {rect}, CPU {want[0]} {want[3]}")
            _same(out, want[1], f"{label} image")
            _same(om, want[2], f"{label} mask")
        region = om[1:-1, 1:-1] == (255 if mo else 1)
        if int(region.sum()) != n:
            raise AssertionError(f"{label}: the mask marks {int(region.sum())} cells, n {n}")
        x = gi.reshape(H, W, -1).to(torch.float32)
        blocked = torch.zeros((H, W), dtype=torch.bool, device=dev) if gm is None \
            else gm[1:-1, 1:-1] != 0
        _, _, _, steps = flood_region(x, blocked, (sy, sx), torch.tensor(diff, dtype=torch.float32),
                                      torch.tensor(diff, dtype=torch.float32), conn, fixed)
        print(f"  {label}: seed ({sx}, {sy}), {n} pixels ({100 * n / (H * W):.1f} %), rect "
              f"{rect}; {steps} fixpoint steps; card vs CPU at 0 "
              f"{'at full size' if k == 0 else f'on a {ch}x{cw} crop'}")
        if n < H * W // 2:
            raise AssertionError(f"{label}: the region covers less than half the frame")
        family_line(f"family flood fill: {label}", lambda: port.flood_fill(
            gi, *args, mask=gm, mask_only=mo, mask_fill=255 if mo else 1), smi, 3, 1, 1)
    print(f"phase 15 flood_fill: card vs CPU at 0 ({time.perf_counter() - t0:.1f} s)")
    del gi, out, om, x

    # -- HoughLines on a 1080p Canny edge map (rho 1, theta pi/180)
    t0 = time.perf_counter()
    H, W = sizes["hough"]
    scene = np.ascontiguousarray(line_scene(H, W, 1521)[..., 1])
    ge = port.canny(on_card(scene), 50.0, 150.0)
    ce = port.canny(torch.from_numpy(scene), 50.0, 150.0)
    _same(ge, ce, "phase 15 Canny edges")
    nnz = int((ce > 0).sum())
    thr = sizes["hough_threshold"]
    label = f"hough_lines rho 1 theta pi/180 threshold {thr} on a {H}x{W} Canny map"
    lines, _ = drive(label, lambda: port.hough_lines(ge, 1.0, np.pi / 180, thr), {})
    want = port.hough_lines(ce, 1.0, np.pi / 180, thr)
    _equal_results(lines.view(np.int32), want.view(np.int32), label)
    print(f"  {label}: {nnz} edge pixels vote in 180 angles x "
          f"{int(np.rint(((W + H) * 2 + 1) / 1.0))} distances; {len(lines)} lines, card vs CPU "
          f"equal bit for bit")
    if len(lines) < 8:
        raise AssertionError(f"{label}: {len(lines)} lines, the scene has 8 bars")
    family_line(f"family hough: {label}", lambda: port.hough_lines(ge, 1.0, np.pi / 180, thr),
                smi, 5, 2, 1)
    print(f"phase 15 hough_lines: card vs CPU equal ({time.perf_counter() - t0:.1f} s)")

    # -- the host helpers at 480x640: HoughLinesP, findContours, descriptors
    t0 = time.perf_counter()
    H, W = sizes["contours"]
    scene = np.ascontiguousarray(line_scene(H, W, 1531)[..., 1])
    ge = port.canny(on_card(scene), 50.0, 150.0)
    ce = port.canny(torch.from_numpy(scene), 50.0, 150.0)
    _same(ge, ce, "phase 15 480x640 Canny edges")
    label = f"hough_lines_p (1, pi/180, 50, 30, 5) on a {H}x{W} Canny map"
    ms_c, segs = _host_ms(lambda: port.hough_lines_p(ge, 1.0, np.pi / 180, 50, 30, 5))
    _equal_results(segs, port.hough_lines_p(ce, 1.0, np.pi / 180, 50, 30, 5), label)
    print(f"  family host helpers: {label}: {len(segs)} segments, {ms_c:.1f} ms on the host "
          f"clock (a host helper: no device launch)  [{smi}]")
    # a segmentation mask: the photo's green channel blurred (Gaussian 7)
    # and thresholded at 128, on both devices
    green = photo_scene(H, W, 1532)[..., 1].copy()
    _, gmask = port.threshold(port.gaussian_blur(on_card(green), 7), 128.0, 255.0)
    _, cmask = port.threshold(port.gaussian_blur(torch.from_numpy(green), 7), 128.0, 255.0)
    _same(gmask, cmask, "phase 15 480x640 mask")
    times = []
    for mode in ("list", "external", "ccomp", "tree"):
        for method in ("none", "simple"):
            ms_c, got = _host_ms(lambda: port.find_contours(gmask, mode, method))
            _equal_results(got, port.find_contours(cmask, mode, method),
                           f"find_contours {mode} {method}")
            times.append(f"{mode}/{method} {len(got[0])} contours {ms_c:.1f} ms")
    print(f"  family host helpers: find_contours on a {H}x{W} mask, card-derived against CPU "
          f"equal (contours and hierarchy): {'; '.join(times)} on the host clock  [{smi}]")
    cs_, _ = port.find_contours(gmask, "list", "simple")
    ccs = [torch.from_numpy(c) for c in cs_]
    big = max(cs_, key=port.contour_area)
    cbig = torch.from_numpy(big)
    hull_i = port.convex_hull(big, False, False)
    hull = port.convex_hull(big)
    descriptors = [
        (f"area, arc length, bounding box of {len(cs_)} contours",
         lambda cs: [(port.contour_area(c), port.arc_length(c, True), port.bounding_rect(c))
                     for c in cs], cs_, ccs),
        (f"moments of the largest ({len(big)} points)", port.contour_moments, big, cbig),
        ("convex hull, points and indices", lambda c: (port.convex_hull(c),
                                                        port.convex_hull(c, False, False)),
         big, cbig),
        ("is_contour_convex, convexity_defects",
         lambda c: (port.is_contour_convex(c), port.convexity_defects(c, hull_i)), big, cbig),
        ("approx_poly_dp eps 3", lambda c: port.approx_poly_dp(c, 3.0, True), big, cbig),
        ("min_area_rect, box_points", lambda c: (port.min_area_rect(c),
                                                 port.box_points(port.min_area_rect(c))),
         big, cbig),
        (f"min_enclosing_circle of the hull ({len(hull)} points)", port.min_enclosing_circle,
         hull, torch.from_numpy(hull)),
        ("fit_line l2 and huber", lambda c: (port.fit_line(c, "l2"), port.fit_line(c, "huber")),
         big, cbig),
        ("fit_ellipse", port.fit_ellipse, big, cbig),
        ("point_polygon_test at the centre", lambda c: port.point_polygon_test(
            c, (W / 2, H / 2), True), big, cbig)]
    times = []
    for name, fn, arg, carg in descriptors:
        ms_c, got = _host_ms(lambda: fn(arg))
        _equal_results(got, fn(carg), name)
        times.append(f"{name} {ms_c:.1f} ms")
    ms_m, dist = _host_ms(lambda: port.match_shapes(gmask, port.flip(gmask, 1), "i1"))
    _equal_results(dist, port.match_shapes(cmask, port.flip(cmask, 1), "i1"), "match_shapes")
    times.append(f"match_shapes of the mask and its mirror ({dist:.6g}) {ms_m:.1f} ms")
    print(f"  family host helpers: descriptors, arrays against tensors equal: "
          f"{'; '.join(times)} on the host clock  [{smi}]")
    print(f"phase 15 host helpers: card-derived against CPU equal "
          f"({time.perf_counter() - t0:.1f} s)")
    print(f"phase 15: {time.perf_counter() - t_phase:.1f} s")


# phase 16's sizes: the selftest's own (128x131, and its 128x256 rows), a
# batch of four 1080p gray frames and one 1080p RGB frame, one 4K gray frame
# through config 5's ops in single-image mode
P16 = {"selftest": (128, 131), "frame": (1080, 1920), "single": (2160, 3840)}
# the 128x256 rows: the conv instance each Gaussian row's taps take, and the
# kernels each row must launch on the card
WIDE_CONV = {"wide/gauss3": (3, 0.0), "wide/gauss5": (5, 0.0), "wide/gauss7": (7, 0.0),
             "wide/gauss15": (15, 0.0), "wide/gauss37/s6": (37, 6.0)}
WIDE_LAUNCHES = {"wide/gauss3": {"sep_conv_u8": 1}, "wide/gauss5": {"sep_conv_u8": 1},
                 "wide/gauss7": {"sep_conv_u8": 1}, "wide/gauss15": {"sep_conv_u8": 1},
                 "wide/gauss37/s6": {"sep_conv_u8": 1},
                 "wide/eq_unsharp": {"hist256_lut": 1, "sep_conv_u8": 1},
                 "wide/clahe": {"tile_luts256": 1, "clahe_blend": 1},
                 "wide/clahe/u16": {"tile_luts65536": 1, "clahe_blend": 1}}


def _batch_split(label: str, s: dict, smi: str) -> None:
    """Print a CLI batch run's seconds by stage, per frame."""
    from imageenhancement_mp_tpu_torch.cli import STAGES

    n = s["frames"]
    print(f"  {label}: {n} frames, {sum(s[k] for k in STAGES) * 1e3 / n:.3f} ms a frame "
          f"in all  [{smi}]")
    for k, name in zip(STAGES, ("decode (waiting on the prefetch)", "H2D", "device (the ops)",
                                "D2H", "encode/write (queueing and the final flush)")):
        print(f"    {name}: {s[k] * 1e3 / n:.3f} ms a frame")


def entry_points(smi: str, drive, sizes: dict = P16) -> None:
    """Phase 16: the port's two entry points.  The selftest on the card,
    every row within its budget, the 128x256 rows through the conv kernel's
    k 3/5/7, runtime and wide instances and the u8 and u16 CLAHE blends;
    the CLI's batch mode in-process on 1080p PNM and PNG frames and its
    single-image mode on a 4K .npy through config 5's ops, each on the card
    and with --device cpu, the outputs equal byte for byte."""
    import tempfile

    import imageenhancement_mp_tpu_torch as port
    from imageenhancement_mp_tpu_torch import cli, selftest
    from imageenhancement_mp_tpu_torch.io import FrameLoader, FrameWriter
    from imageenhancement_mp_tpu_torch.kernels import conv as kconv
    from imageenhancement_mp_tpu_torch.ops.filters import q8_taps

    t_phase = time.perf_counter()
    # -- the selftest: each row on cuda:0 with counters of its own, then on
    # the CPU
    results = []
    t0 = time.perf_counter()
    ok = selftest.run_selftest(sizes["selftest"], 0, verbose=False, results=results)
    secs = time.perf_counter() - t0
    bad = [r for r in results if r["lsb"] is None or r["lsb"] > r["budget"]]
    for r in bad:
        print(f"  selftest row {r['name']}: max-LSB {r['lsb']} over its budget {r['budget']}")
    if not ok:
        raise AssertionError(f"selftest: {len(bad)} of {len(results)} rows over their budgets")
    worst = max(results, key=lambda r: r["seconds"])
    print(f"phase 16 selftest {sizes['selftest']} seed 0: all {len(results)} rows within their "
          f"budgets in {secs:.1f} s (card and CPU; the slowest card run {worst['name']} "
          f"{worst['seconds']:.3f} s)  [{smi}]")
    nonzero = [f"{r['name']} {r['lsb']}" for r in results if r["lsb"]]
    print(f"  rows off the CPU within their budgets: {', '.join(nonzero) or 'none'}")
    by_name = {r["name"]: r for r in results}
    for name, want in WIDE_LAUNCHES.items():
        got = by_name[name]["launches"]
        route = (f", sep_conv_u8 instance {kconv.conv_route(*q8_taps(*WIDE_CONV[name])).describe()}"
                 if name in WIDE_CONV else "")
        print(f"  {name} {selftest.WIDE_SIZE}: launches {got}{route}")
        if got != want:
            raise AssertionError(f"selftest {name}: launches {got}, expected {want}")
    print(f"  nlmeans/u16 launches: {by_name['nlmeans/u16']['launches']}")

    # -- the CLI: the native frame loader and writer (their g++ build first)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        with FrameWriter(threads=1) as fw:
            writer_native = fw.native
        loader_native = FrameLoader([]).native
        print(f"phase 16 frame IO: native loader {'built' if loader_native else 'not built'}, "
              f"native writer {'built' if writer_native else 'not built'} "
              f"({time.perf_counter() - t0:.1f} s)")
        H, W = sizes["frame"]
        a, b = photo_scene(H, W, 1601), photo_scene(H, W, 1602)
        frames = [a[..., 0], a[..., 1], b[..., 0], b[..., 2], b]
        ops = ["--op", "histeq", "--op", "unsharp:1.0:5"]
        expect = {"hist256_lut": 5, "apply_lut256": 5, "sep_conv_u8": 5}
        for kind in ("pnm", "png"):
            names = [f"f{i}." + ("png" if kind == "png" else "ppm" if f.ndim == 3 else "pgm")
                     for i, f in enumerate(frames)]
            with FrameWriter(threads=4) as fw:
                for n, f in zip(names, frames):
                    fw.save(tmp / n, f)
            ins = [str(tmp / n) for n in names]
            outs = {}
            for device in ("cuda", "cpu"):
                out = tmp / f"{kind}_{device}"
                label = f"cli batch {kind} {len(frames)}x{H}x{W} on {device}"
                split = {}
                rc, _ = drive(label, lambda: cli.main([*ins, "-o", str(out), *ops,
                                                       "--device", device], split),
                              expect if device == "cuda" else {})
                if rc != 0:
                    raise AssertionError(f"{label}: exit code {rc}")
                _batch_split(label, split, smi)
                outs[device] = {p.name: p.read_bytes() for p in sorted(out.iterdir())}
            if list(outs["cuda"]) != [n.replace(".", "_out.") for n in names] or (
                    outs["cuda"] != outs["cpu"]):
                raise AssertionError(f"cli batch {kind}: card and CPU outputs differ "
                                     f"({list(outs['cuda'])}, {list(outs['cpu'])})")
            print(f"  cli batch {kind}: card and CPU outputs equal byte for byte "
                  f"({sum(map(len, outs['cuda'].values()))} bytes in {len(names)} files)")
        back = next(iter(FrameLoader([tmp / "png_cuda" / "f4_out.png"])))
        want = port.unsharp_mask(port.equalize_hist(torch.from_numpy(b)), 1.0, 5).numpy()
        if not np.array_equal(back, want):
            raise AssertionError("cli batch: the RGB frame's output is not histeq -> unsharp")

        # -- single-image mode: a 4K .npy through config 5's ops
        Hs, Ws = sizes["single"]
        np.save(tmp / "in.npy", noisy((), Hs, Ws, (), 1603, 10.0))
        ops5 = ["--op", "median:5", "--op", "clahe:2.0:8:8", "--op", "unsharp"]
        got = {}
        for device in ("cuda", "cpu"):
            label = f"cli single {Hs}x{Ws} config 5 on {device}"
            t0 = time.perf_counter()
            rc, _ = drive(label, lambda: cli.main([str(tmp / "in.npy"), "-o",
                                                   str(tmp / f"{device}.npy"), *ops5,
                                                   "--device", device]),
                          {"median": 1, "tile_luts256": 1, "clahe_blend": 1, "sep_conv_u8": 1}
                          if device == "cuda" else {})
            if rc != 0:
                raise AssertionError(f"{label}: exit code {rc}")
            got[device] = np.load(tmp / f"{device}.npy")
            print(f"  {label}: {(time.perf_counter() - t0) * 1e3:.1f} ms for the command "
                  f"(load, H2D, ops, D2H, save)  [{smi}]")
        e = max_err(torch.from_numpy(got["cuda"]), torch.from_numpy(got["cpu"]))
        if got["cuda"].shape != (Hs, Ws) or got["cuda"].dtype != np.uint8 or e:
            raise AssertionError(f"cli single: card {got['cuda'].shape} {got['cuda'].dtype}, "
                                 f"{e} LSB off the CPU")
        print(f"  cli single {Hs}x{Ws}: card against CPU 0 LSB")
    print(f"phase 16: {time.perf_counter() - t_phase:.1f} s")


# phase 17's sizes: config 5 on a batch of four 4K frames (batch-sharded, a
# frame a shard), the pooled equalize on eight 1080p frames (gray and RGB),
# one 8K scan or aerial tile row-sharded (u8 and u16), the spatial twins on
# a 4K frame, and three streamed batches of four 4K frames
P17 = {"batch": (4, 2160, 3840), "pool": (8, 1080, 1920), "scan": (4320, 7680),
       "twin": (2160, 3840), "half": (2160, 3840), "area": (1728, 3072)}
SHARDS = 4
# the non-pointwise spatial twins, one stage each (parallel/spatial.py)
TWINS17 = (("gaussian_blur", {"ksize": 5}), ("unsharp_mask", {"amount": 1.0}),
           ("median_blur", {"ksize": 5}), ("box_blur", {"ksize": 5}),
           ("bilateral", {"d": 5, "sigma_color": 30.0, "sigma_space": 6.0}),
           ("adaptive_threshold", {"method": "gaussian", "block_size": 11, "C": 2.0}),
           ("erode", {"ksize": 3}), ("dilate", {"ksize": (5, 3)}),
           ("morphology", {"op": "open", "ksize": (3, 5)}), ("sobel", {"dx": 1, "dy": 1}),
           ("filter2d", {"kernel": ((0, -1, 0), (-1, 5, -1), (0, -1, 0)), "delta": 2.5}),
           ("laplacian_sharpen", {}), ("equalize_hist", {}), ("equalize_hist_global", {}),
           ("contrast_stretch", {"out_range": (30.5, 200.25)}),
           ("clahe", {"clip_limit": 2.0, "tile_grid": (8, 8)}))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launches(dev: torch.device, fn) -> tuple:
    """``fn()`` and the launches it made, counters at 0 just before."""
    from imageenhancement_mp_tpu_torch.kernels import launch_counts, reset_launch_counts

    _sync(dev)
    reset_launch_counts()
    out = fn()
    _sync(dev)
    return out, {k: c for k, c in launch_counts.items() if c}


def host_us(dev: torch.device, fn, calls: int = 10, rounds: int = 5) -> float:
    """Host microseconds a call: the median over ``rounds`` rounds of
    ``calls`` calls queued back to back on the host clock, each timed
    before the stream is waited for."""
    fn()
    _sync(dev)
    per_call = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per_call.append((time.perf_counter() - t0) / calls * 1e6)
        _sync(dev)
    return statistics.median(per_call)


def geometry_twins(smi: str, drive, dev: torch.device, rows, sizes: dict) -> int:
    """Phase 17's geometry twins on the scan frame over the row mesh
    ``rows``: each equal to the unsharded call (bit for bit), with its
    launches counted and its time beside the unsharded call's.  Returns
    warp_gather_u8's largest error against its plain version on the matrix
    route with a first row other than 0."""
    import imageenhancement_mp_tpu_torch as port
    from imageenhancement_mp_tpu_torch.kernels import warp as kwarp
    from imageenhancement_mp_tpu_torch.ops import warp as twarp
    from imageenhancement_mp_tpu_torch.parallel import mesh as pmesh
    from imageenhancement_mp_tpu_torch.parallel import spatial as psp
    from imageenhancement_mp_tpu_torch.utils.warp_coords import (get_rotation_matrix_2d,
                                                                  invert_affine)

    t0 = time.perf_counter()
    Hs, Ws = sizes["scan"]
    x8 = noisy((), Hs, Ws, (), 1705, 10.0)
    rng = np.random.default_rng(1706)
    frames = {"u8": x8, "u16": x8.astype(np.uint16) * 256 + rng.integers(0, 256, (Hs, Ws),
                                                                        dtype=np.uint16),
              "i16": (x8.astype(np.int16) - 128) * 200,
              "f32": x8.astype(np.float32) * np.float32(1 / 255.0)}
    frames = {k: torch.from_numpy(v).to(dev) for k, v in frames.items()}
    half, area = sizes["half"], sizes["area"]
    # rot15 x0.9 about the frame's centre, into a window of half its size
    # centred on it (the host-table routes build a coordinate a pixel)
    M = get_rotation_matrix_2d((Ws / 2, Hs / 2), 15.0, 0.9)
    M[:, 2] -= ((Ws - half[1]) / 2, (Hs - half[0]) / 2)
    polar_args = ((Ws // 2, Hs // 2), (Ws / 2, Hs / 2), float(min(Hs, Ws)) / 2)
    mx = (torch.rand((Hs, Ws), generator=torch.Generator(device=dev).manual_seed(1707),
                     device=dev) * (Ws + 4) - 2).contiguous()
    my = (torch.rand((Hs, Ws), generator=torch.Generator(device=dev).manual_seed(1708),
                     device=dev) * (Hs + 4) - 2).contiguous()

    def stage(name: str, dt: str, **kw) -> tuple:
        one = [(name, kw)]
        return (dt, lambda g: port.make_pipeline(one)(g),
                lambda g: port.make_pipeline(one, mesh=rows, shard="spatial")(g))

    polar = {inv: (lambda g, inv=inv: twarp.warp_polar_planes(g[None], *polar_args, False,
                                                              inv)[0],
                   lambda g, inv=inv: psp.shard_spatial(lambda p: psp.warp_polar_spatial(
                       p, *polar_args, False, inv), rows)(g[None])[0]) for inv in (False, True)}
    remap_rows = pmesh.run_sharded(lambda p, a, b: psp.remap_spatial(p, a, b), rows,
                                   [(None, "y"), ("y",), ("y",)], (None, "y"))
    cases = {
        **{f"resize {i} -> {half[0]}x{half[1]} u8": stage("resize", "u8", dsize=half,
                                                          interpolation=i)
           for i in ("nearest", "linear", "cubic", "lanczos4", "area")},
        f"resize area -> {area[0]}x{area[1]} u8 (general)": stage("resize", "u8", dsize=area,
                                                                  interpolation="area"),
        f"resize linear -> {half[0]}x{half[1]} u16": stage("resize", "u16", dsize=half),
        **{f"warpAffine rot15 x0.9 {i} {dt}": stage("warp_affine", dt, M=M, dsize=half,
                                                    interpolation=i)
           for i, dt in (("linear", "u8"), ("nearest", "u8"), ("linear", "u16"),
                         ("linear", "i16"), ("cubic", "f32"))},
        "remap u8, maps split by rows": (
            "u8", lambda g: twarp.remap_planes(g[None], mx, my)[0],
            lambda g: remap_rows(g[None], mx, my)[0]),
        "warpPolar u8": ("u8", *polar[False]),
        "warpPolar inverse u8": ("u8", *polar[True]),
        "Canny (3, L1) u8": stage("canny", "u8", threshold1=50.0, threshold2=150.0),
        "Canny (5, L2) u8": stage("canny", "u8", threshold1=400.0, threshold2=1200.0,
                                  aperture_size=5, l2_gradient=True),
    }
    kernel_paths = {"warpAffine rot15 x0.9 linear u8", "warpAffine rot15 x0.9 nearest u8",
                    "remap u8, maps split by rows", "warpPolar u8", "warpPolar inverse u8"}
    for label, (dt, unsharded, sharded) in cases.items():
        g = frames[dt]
        want, counts = _launches(dev, lambda: unsharded(g))
        on_card = dev.type == "cuda" and label in kernel_paths  # a CPU tensor launches nothing
        if counts != ({"warp_gather_u8": 1} if on_card else {}):
            raise AssertionError(f"phase 17 {label}: unsharded launches {counts}")
        got, _ = drive(f"phase 17 spatial {label}, {SHARDS} shards", lambda: sharded(g),
                       {k: SHARDS * c for k, c in counts.items()})
        if isinstance(got, pmesh.ShardedTensor):
            got = got.gather()
        # f32 compared through its bits
        e = max_err(*(t.view(torch.int32) if t.dtype == torch.float32 else t
                      for t in (got, want)))
        if e or got.device != want.device:
            raise AssertionError(f"phase 17 spatial {label}: {e} off the unsharded call")
        ms1, _ = time_ms(lambda: unsharded(g), runs=3, calls=1, warmups=1)
        ms4, _ = time_ms(lambda: sharded(g), runs=3, calls=1, warmups=1)
        was = (" (the band sums by rows, then columns, before the pairwise cells: 1.3512 ms "
               "unsharded on an NVIDIA H100 80GB HBM3 at 700 W)"
               if "(general)" in label else "")
        print(f"  spatial {label} {Hs}x{Ws} -> {tuple(want.shape)}: 0 LSB; unsharded {ms1:.4f} ms, "
              f"{SHARDS} shards on one card {ms4:.4f} ms a call back to back, host "
              f"{host_us(dev, lambda: sharded(g), 1, 3):.1f} us a call{was}  [{smi}]")
    # the matrix route with each shard's first row against its plain version
    err, n = 0, 0
    oloc, Mi, g = half[0] // SHARDS, invert_affine(M), frames["u8"][None]
    for idx in range(1, SHARDS):
        for nearest in (False, True):
            for border, bv in (("constant", 9), ("replicate", 0)):
                args = (g, Mi, oloc, half[1], False, nearest, border, bv, idx * oloc)
                err = max(err, max_err(kwarp.warp_matrix_u8(*args),
                                       kwarp.warp_matrix_u8_plain(*args)))
                n += 1
    if err:
        raise AssertionError(f"warp_gather_u8 matrix route with row0: {err} LSB off its plain "
                             "version")
    print(f"phase 17 spatial geometry: {len(cases)} twins on {Hs}x{Ws} over {SHARDS} shards at "
          f"0 LSB against the unsharded calls; warp_gather_u8's matrix route at first rows "
          f"{oloc}..{(SHARDS - 1) * oloc} 0 LSB against its plain version over {n} cases "
          f"({time.perf_counter() - t0:.1f} s)")
    return err


def mesh_sharding(smi: str, drive, dev: torch.device, sizes: dict = P17) -> int:
    """Phase 17: the port's mesh (parallel/).  One card, so the 4-entry mesh
    names it four times: every split, halo, psum and gather runs on the
    card's kernels, four shards on one card, not a scaling figure."""
    import imageenhancement_mp_tpu_torch as port
    from imageenhancement_mp_tpu_torch.models.presets import PRESETS
    from imageenhancement_mp_tpu_torch.ops.histogram import equalize_hist_global_planes
    from imageenhancement_mp_tpu_torch.parallel import mesh as pmesh
    from imageenhancement_mp_tpu_torch.parallel import sharding as psh

    t_phase = time.perf_counter()
    config5 = "denoise_clahe_sharpen"
    one = pmesh.make_mesh(1, device=dev.type)
    four = pmesh.Mesh([dev] * SHARDS, ("batch",))
    rows = pmesh.Mesh([dev] * SHARDS, ("y",))
    single = port.get_preset(config5)
    per_shard = dict.fromkeys(CONFIG5_KERNELS, SHARDS)

    def same(got, want, what: str) -> None:
        if isinstance(got, pmesh.ShardedTensor):
            got = got.gather()
        e = max_err(got, want)
        if e or got.device != want.device:
            raise AssertionError(f"phase 17 {what}: {e} LSB off the unsharded call, on {got.device}")

    try:
        # -- config 5, batch-sharded: a 1-device mesh and four shards
        N, H, W = sizes["batch"]
        x = noisy((N,), H, W, (), 1701, 10.0)
        g = torch.from_numpy(x).to(dev)
        want, _ = drive(f"phase 17 config 5 unsharded {N}x{H}x{W}", lambda: single(g),
                        dict.fromkeys(CONFIG5_KERNELS, 1))
        cpu = single(torch.from_numpy(x[:1]))
        e = max_err(want[:1].cpu(), cpu)
        if e:
            raise AssertionError(f"phase 17 config 5: a frame {e} LSB off the CPU plain path")
        pipes = {"1-device mesh": (port.get_preset(config5, mesh=one), 1),
                 f"{SHARDS} shards on one card": (port.get_preset(config5, mesh=four), SHARDS)}
        for label, (pipe, n) in pipes.items():
            got, _ = drive(f"phase 17 config 5 batch-sharded, {label}", lambda: pipe(g),
                           dict.fromkeys(CONFIG5_KERNELS, n))
            same(got, want, f"config 5 batch-sharded, {label}")
        print(f"phase 17 config 5 batch-sharded {N}x{H}x{W} u8: the 1-device mesh and {SHARDS} "
              "shards equal the unsharded call at 0 LSB, a frame equals the CPU plain path at 0")
        timed = {"unsharded": single, **{k: p for k, (p, _) in pipes.items()}}
        for label, fn in timed.items():
            ms, iqr = time_ms(lambda: fn(g), runs=10, calls=4)
            print(f"  config 5 {N}x{H}x{W} {label}: {ms:.4f} ms a call back to back (IQR "
                  f"{iqr:.4f}), host {host_us(dev, lambda: fn(g)):.1f} us a call  [{smi}]")
        del g, want, got

        # -- pooled hist-eq over four shards, gray and RGB
        Np, Hp, Wp = sizes["pool"]
        rng = np.random.default_rng(1702)
        for channels in (1, 3):
            xp = torch.from_numpy(rng.integers(0, 256, (Np * channels, Hp, Wp), dtype=np.uint8)
                                  ).to(dev)
            # unsharded: one grouped count (a group a channel) and the apply;
            # across shards: a count a shard, a psum, the LUT kernel, the apply
            want, _ = drive(f"phase 17 pooled equalize unsharded, channels {channels}",
                            lambda: equalize_hist_global_planes(xp, channels),
                            {"hist256_lut": 1, "apply_lut256": 1})
            fn = psh.equalize_hist_global_sharded(four, channels=channels)
            got, pooled_launches = drive(
                f"phase 17 pooled equalize, {SHARDS} shards, channels {channels}", lambda: fn(xp),
                dict.fromkeys(("hist256", "equalize_lut256", "apply_lut256"), SHARDS))
            same(got, want, f"pooled equalize, channels {channels}")
        print(f"phase 17 pooled equalize {Np}x{Hp}x{Wp} (channels 1 and 3) over {SHARDS} shards: "
              "0 LSB against the unsharded call")
        del xp, want, got

        # -- config 5, row-sharded: one 8K frame, u8 and u16
        Hs, Ws = sizes["scan"]
        x8 = noisy((), Hs, Ws, (), 1703, 10.0)
        spipe = port.make_pipeline(PRESETS[config5], mesh=rows, shard="spatial")
        frames = {"u8": torch.from_numpy(x8).to(dev),
                  "u16": torch.from_numpy(x8.astype(np.uint16) * 256 + rng.integers(
                      0, 256, (Hs, Ws), dtype=np.uint16)).to(dev)}
        for dt, gs in frames.items():
            want, counts = _launches(dev, lambda: single(gs))
            got, _ = drive(f"phase 17 config 5 row-sharded {Hs}x{Ws} {dt}, {SHARDS} shards",
                           lambda: spipe(gs), {k: SHARDS * c for k, c in counts.items()})
            same(got, want, f"config 5 row-sharded {dt}")
            ms1, _ = time_ms(lambda: single(gs), runs=5, calls=2)
            ms4, _ = time_ms(lambda: spipe(gs), runs=5, calls=2)
            print(f"phase 17 config 5 row-sharded {Hs}x{Ws} {dt}: 0 LSB against the unsharded "
                  f"call (launches a call unsharded {counts}); unsharded {ms1:.4f} ms, "
                  f"{SHARDS} shards on one card {ms4:.4f} ms a call back to back, host "
                  f"{host_us(dev, lambda: spipe(gs), 4):.1f} us a call  [{smi}]")
        del frames, gs, want, got

        # -- every non-pointwise spatial twin on a 4K frame
        Ht, Wt = sizes["twin"]
        gt = torch.from_numpy(noisy((), Ht, Wt, (), 1704, 10.0)).to(dev)
        t0 = time.perf_counter()
        for name, kw in TWINS17:
            stage = [(name, kw)]
            want, counts = _launches(dev, lambda: port.make_pipeline(stage)(gt))
            expect = {k: SHARDS * c for k, c in counts.items()}
            if name in ("equalize_hist", "equalize_hist_global"):
                # the bins pool across the shards (a psum), then the LUT kernel
                expect = dict.fromkeys(("hist256", "equalize_lut256", "apply_lut256"), SHARDS)
            got, _ = drive(f"phase 17 spatial {name} {Ht}x{Wt}, {SHARDS} shards",
                           lambda: port.make_pipeline(stage, mesh=rows, shard="spatial")(gt),
                           expect)
            same(got, want, f"spatial {name}")
        print(f"phase 17 spatial twins: {len(TWINS17)} twins on {Ht}x{Wt} over {SHARDS} shards at "
              f"0 LSB against the unsharded calls ({time.perf_counter() - t0:.1f} s)")
        del gt, want, got

        # -- the geometry twins on the 8K frame
        row0_err = geometry_twins(smi, drive, dev, rows, sizes)

        # -- three batches through stream_frames(mesh=)
        stream = [noisy((N,), H, W, (), 1710 + i, 10.0) for i in range(3)]
        spipe5 = port.get_preset(config5, mesh=four)
        outs, _ = drive(f"phase 17 stream_frames 3x({N}x{H}x{W}), {SHARDS} shards",
                        lambda: list(port.stream_frames(spipe5, stream, 2, mesh=four)),
                        {k: 3 * c for k, c in per_shard.items()})
        for f, out in zip(stream, outs):
            if not isinstance(out, pmesh.ShardedTensor):
                raise AssertionError(f"phase 17 stream_frames yielded {type(out).__name__}")
            same(out, single(torch.from_numpy(f).to(dev)), "stream_frames")
        if len(outs) != 3:
            raise AssertionError(f"phase 17 stream_frames yielded {len(outs)} of 3 batches")
        print(f"phase 17 stream_frames: 3 batches equal the unsharded calls at 0 LSB, each part "
              f"sent to its shard and kept there")
    finally:
        for m in (one, four, rows):
            m.close()
    print(f"phase 17: {time.perf_counter() - t_phase:.1f} s")
    return row0_err, pooled_launches


# phase 18's sizes: the four main paths at their full widths (the north
# star, configs 2, 3 and 5) and the size their CPU chains run at
P18 = {"equalize_unsharp": (8, 1080, 1920), "config 2": (32, 1080, 1920, 3),
       "config 3": (8, 1080, 1920), "config 5": (2, 2160, 3840), "small": (2, 270, 480),
       "bracket": (2160, 3840)}
# the device-paced figures' sleep (tools/torch_*_profile.py): about 2 ms at
# 1.98 GHz, which must outlast the host's enqueue of a run's calls
P18_SLEEP_CYCLES = 4_000_000
P18_TARGET_SECS = 0.25


def the_clock(smi: str, dev: torch.device, sizes: dict = P18) -> None:
    """Phase 18: the port's clock (``profiling.py``) on the four main paths.
    For each path the CUDA-graph chain's scalar equals the eager chain's on
    the card at full width (n = 2 and 5) and the CPU plain chain's at the
    small size (n = 1, 2 and 5), all at 0; then the path's blocked
    ``time_op``, its ``time_op_chained``, the back-to-back and sleep-paced
    event clocks, torch.profiler's kernel sum and the bytes bound (input
    read once, output written once) on one line.  A chained time below the
    bound fails the phase: a clock that beats the memory cannot be right.
    Then ``time_op`` on ``merge_mertens`` with its frames in a list and in a
    closure: each reading at least the call's device time.  Last, a call
    that reads the host (Otsu) must refuse to be chained."""
    import imageenhancement_mp_tpu_torch as port
    from imageenhancement_mp_tpu_torch import profiling as prof

    t_phase = time.perf_counter()
    on_cuda = dev.type == "cuda"
    sleep = P18_SLEEP_CYCLES / (sm_clock_max_mhz() * 1e3) if on_cuda else 0.0  # ms
    paths = [("equalize_unsharp", sizes["equalize_unsharp"],
              lambda x: port.equalize_unsharp(x, 1.0, 5, 0.0)),
             ("config 2 get_preset('gamma_stretch')", sizes["config 2"],
              port.get_preset("gamma_stretch")),
             ("config 3 make_pipeline(config3_stages(5))", sizes["config 3"],
              port.make_pipeline(config3_stages(5))),
             ("config 5 get_preset('denoise_clahe_sharpen')", sizes["config 5"],
              port.get_preset("denoise_clahe_sharpen"))]
    for i, (label, shape, fn) in enumerate(paths):
        t0 = time.perf_counter()
        rng = np.random.default_rng(1800 + i)
        x = rng.integers(0, 256, shape, dtype=np.uint8)
        g = torch.from_numpy(x).to(dev)
        for n in (2, 5):  # time_op_chained's n_lo and a longer chain
            graph = int(prof._chain_program(fn, g, n)(g).item())
            eager = int(prof._chain_eager(fn, g, n).item())
            if graph != eager:
                raise AssertionError(f"phase 18 {label}: the chain of {n} replayed {graph}, "
                                     f"eager {eager}")
        small = sizes["small"] + tuple(shape[3:])
        xs = rng.integers(0, 256, small, dtype=np.uint8)
        for n in (1, 2, 5):
            gs = torch.from_numpy(xs).to(dev)
            card = int(prof._chain_program(fn, gs, n)(gs).item())
            cpu = int(prof._chain_program(fn, torch.from_numpy(xs), n)(torch.from_numpy(xs)))
            if card != cpu:
                raise AssertionError(f"phase 18 {label} {small}: the chain of {n} on the card "
                                     f"{card}, on the CPU {cpu}")
        mode = "refeed" if prof._chain_step(fn, g, "auto")[1] else "auto"
        blocked = prof.time_op(fn, g, iters=20, warmup=3) * 1e3
        chained = prof.time_op_chained(fn, g, target_secs=P18_TARGET_SECS) * 1e3
        b2b, iqr = time_ms(lambda: fn(g))
        paced = paced_ms(lambda: fn(g), P18_SLEEP_CYCLES)
        busy, _, _ = device_split(lambda: fn(g))
        bound, _ = bound_ms(2 * g.numel())
        enqueue = host_us(dev, lambda: fn(g)) * CALLS_PER_RUN / 1e3
        # the profiler keeps fewer kernel events inside the whole script, at
        # times none: the ratio is printed, never asserted
        ratio = (f"{busy / 1e3:.4f} ms a call (chained / kernel sum {chained * 1e3 / busy:.3f})"
                 if busy else "not measured (no kernel event kept)")
        print(f"phase 18 {label} {'x'.join(map(str, shape))} u8: time_op {blocked:.4f} ms "
              f"(blocked, median of 20), time_op_chained {chained:.4f} ms "
              f"({mode}, {prof.throughput_gpixs(shape, chained / 1e3):.2f} GPix/s), back to back "
              f"{b2b:.4f} ms (IQR {iqr:.4f}), sleep-paced {paced:.4f} ms, torch.profiler kernel "
              f"sum {ratio}, bytes bound {bound:.4f} ms; the sleep "
              f"{sleep:.2f} ms {'covers' if sleep > enqueue else 'does not cover'} the host's "
              f"enqueue of {CALLS_PER_RUN} calls, {enqueue:.2f} ms; graph = eager at 0 (n 2, 5), "
              f"card = CPU at 0 on {'x'.join(map(str, small))} (n 1, 2, 5) "
              f"({time.perf_counter() - t0:.1f} s)  [{smi}]")
        if chained < bound:
            raise AssertionError(f"phase 18 {label}: time_op_chained {chained:.4f} ms is below "
                                 f"the bytes bound {bound:.4f} ms")
        del g
    # time_op blocks on a call's CUDA work wherever its tensors are: in a list
    # argument (merge_mertens over three 4K exposures) and in a closure that
    # returns nothing; each reading is at least the call's device time (the
    # kernels of one eager call under torch.profiler, which cannot outlast
    # the call's wall time; "not measured" when the profiler keeps no event)
    t0 = time.perf_counter()
    frames = [torch.from_numpy(f).to(dev) for f in exposure_bracket(*sizes["bracket"], 1811)]
    device_ms = device_split(lambda: port.merge_mertens(frames), calls=2, warmups=1)[0] / 1e3
    listed = prof.time_op(port.merge_mertens, frames, iters=5, warmup=1) * 1e3
    closure = prof.time_op(lambda: (port.merge_mertens(frames), None)[1], iters=5, warmup=1) * 1e3
    device = f"{device_ms:.4f} ms" if device_ms else "not measured (no kernel event kept)"
    print(f"phase 18 time_op on merge_mertens 3x{'x'.join(map(str, sizes['bracket']))}x3 u8: "
          f"{listed:.4f} ms with the frames in a list argument, {closure:.4f} ms in a closure "
          f"that returns nothing; the call's device time (torch.profiler kernel sum) {device} "
          f"({time.perf_counter() - t0:.1f} s)  [{smi}]")
    if on_cuda and min(listed, closure) < device_ms:
        raise AssertionError(f"phase 18: time_op read {min(listed, closure):.4f} ms for "
                             f"merge_mertens, under its device time {device_ms:.4f} ms")
    del frames
    if on_cuda:
        planes = torch.from_numpy(np.random.default_rng(1810).integers(
            0, 256, (2, 64, 64), dtype=np.uint8)).to(dev)
        try:
            prof.time_op_chained(lambda p: port.threshold(p, method="otsu")[1], planes, n_hi=4)
        except RuntimeError as e:
            print(f"phase 18 Otsu (reads the host): time_op_chained refused, {str(e)[:160]}")
        else:
            raise AssertionError("phase 18: time_op_chained chained Otsu, which reads the host")
        want = port.equalize_hist(planes.cpu())
        if max_err(port.equalize_hist(planes).cpu(), want):
            raise AssertionError("phase 18: the card's results changed after a refused capture")
    print(f"phase 18: {time.perf_counter() - t_phase:.1f} s")


def main() -> None:
    t_start = time.perf_counter()
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import imageenhancement_mp_tpu_torch as port
    from imageenhancement_mp_tpu_torch.kernels import _build, launch_counts, reset_launch_counts
    from imageenhancement_mp_tpu_torch.kernels import athresh as kathr
    from imageenhancement_mp_tpu_torch.kernels import bilateral as kbil
    from imageenhancement_mp_tpu_torch.kernels import clahe as kclahe
    from imageenhancement_mp_tpu_torch.kernels import conv as kconv
    from imageenhancement_mp_tpu_torch.kernels import hist as khist
    from imageenhancement_mp_tpu_torch.kernels import median as kmedian
    from imageenhancement_mp_tpu_torch.ops import bilateral as tbil
    from imageenhancement_mp_tpu_torch.ops import clahe as tclahe
    from imageenhancement_mp_tpu_torch.ops import threshold as tthr
    from imageenhancement_mp_tpu_torch.ops.filters import q8_taps
    from imageenhancement_mp_tpu_torch.utils.thresholds import otsu_threshold

    if Path(port.__file__).resolve().parent != ROOT / PKG:
        raise SystemExit(f"chip_smoke: imported {port.__file__}, not this checkout's {PKG}")
    if "jax" in sys.modules:
        raise SystemExit("chip_smoke: JAX was imported")
    smi = nvidia_smi_line()
    print(smi)
    dev = torch.device("cuda", 0)
    device_name = torch.cuda.get_device_name(0)
    print(f"device: {device_name}  count {torch.cuda.device_count()}  "
          f"capability {torch.cuda.get_device_capability(0)}")

    # -- 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {lib._name}")
    log = (Path(lib._name).parent / "nvcc.log")
    if log.is_file():
        entry = ""
        for line in log.read_text().splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print("  ptxas:", line.split(":", 1)[-1].strip())
            if "Compiling entry" in line:
                entry = line
            if ("median" in entry and "spill" in line
                    and ("0 bytes spill stores, 0 bytes spill loads" not in line)):
                raise AssertionError(f"ptxas spilled in {entry}: {line.strip()}")
        # the document kernels' instances: <R> radius (0 runtime), <K> block size (0 runtime)
        entry, doc = "", {}
        for line in log.read_text().splitlines():
            if "Compiling entry" in line:
                m = re.search(r"(bilateral_gray_kernel|athresh_screen_kernel)ILi(\d+)E", line)
                entry = f"{m.group(1)}<{m.group(2)}>" if m else ""
            elif entry and "Used" in line:
                doc[entry] = re.search(r"Used (\d+) registers", line).group(1) + " registers"
            elif entry and "spill stores" in line:
                doc.setdefault(entry + " spills", line.split(",", 1)[1].strip())
        print("  ptxas, document kernels: " + "; ".join(
            f"{k}: {v}, {doc.get(k + ' spills', '?')}" for k, v in doc.items() if "spills" not in k))

    # -- 3. each kernel against its plain version, on the card -----------------
    rng = np.random.default_rng(0)
    err = dict.fromkeys(ALL_KERNELS, 0)

    def on_card(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def rand_u8(shape, lo=0, hi=256) -> torch.Tensor:
        return on_card(rng.integers(lo, hi, shape, dtype=np.uint8))

    def rand(shape, dtype) -> torch.Tensor:
        info = np.iinfo(dtype)
        return on_card(rng.integers(info.min, info.max + 1, shape).astype(dtype))

    def misaligned(x: torch.Tensor) -> torch.Tensor:
        """The same values at a storage offset of 1 element (contiguous)."""
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        view = buf[1:].view(x.shape)
        view.copy_(x)
        return view

    def check(name: str, got: torch.Tensor, want: torch.Tensor, what: str) -> None:
        e = max_err(got, want)
        err[name] = max(err[name], e)
        if e:
            raise AssertionError(f"{name} {what}: kernel vs plain max abs err {e}")

    def coord_tables(H: int, W: int, geo) -> tuple:
        gh, gw, th, tw = geo
        return (*tclahe._coord_tables(H, th, gh, dev), *tclahe._coord_tables(W, tw, gw, dev))

    def clahe_plain(planes: torch.Tensor, clip: float, grid) -> torch.Tensor:
        """CLAHE through the plain version of every stage."""
        B, H, W = planes.shape
        geo = tclahe.tile_geometry(H, W, grid)
        luts = kclahe.clahe_lut_plain(kclahe.tile_hists_plain(planes, *geo), geo[2] * geo[3], clip)
        return kclahe.clahe_blend_plain(planes, luts, geo[0], geo[1], *coord_tables(H, W, geo))

    before = dict(launch_counts)
    shapes = [(2, 64, 256), (1, 37, 131), (3, 5, 9), (1, 1, 1), (8, 1080, 1920)]
    planes_cases = [rand_u8(s) for s in shapes]
    planes_cases += [rand_u8((2, 64, 256), 100, 201),                  # empty low range
                     torch.full((2, 37, 131), 77, dtype=torch.uint8, device=dev),  # constant
                     rand_u8((3, 1000)),                                # [B, P] rows
                     misaligned(rand_u8((1, 37, 131)))]
    for x in planes_cases:
        what = f"{tuple(x.shape)} offset {x.storage_offset()}"
        h = khist.hist256(x)
        check("hist256", h, khist.hist256_plain(x), what)
        total = x[0].numel()
        luts = khist.equalize_lut256(h, total)
        check("equalize_lut256", luts, khist.equalize_lut256_plain(h, total), what)
        check("apply_lut256", khist.apply_lut256(x, luts), khist.apply_lut256_plain(x, luts), what)
        shared = luts[0].contiguous()
        check("apply_lut256", khist.apply_lut256(x, shared),
              khist.apply_lut256_plain(x, shared), what + " shared table")
    # random histograms straight into the LUT kernel (rows sum to total)
    hr = on_card(rng.multinomial(5000, rng.dirichlet(np.full(256, 0.3)), size=64).astype(np.int32))
    check("equalize_lut256", khist.equalize_lut256(hr, 5000),
          khist.equalize_lut256_plain(hr, 5000), "random histograms")
    # mismatched in/out alignment in the LUT apply
    xm = misaligned(rand_u8((2, 64, 256)))
    lm = rand_u8((2, 256))
    check("apply_lut256", khist.apply_lut256(xm, lm), khist.apply_lut256_plain(xm, lm),
          "misaligned input")
    # K1's counting on random, smooth and constant planes: odd widths, tiles
    # off 16-byte boundaries, pads, 1-byte misaligned views
    n_k1 = 0
    k1_geoms = [((8, 1080, 1920), (8, 8)), ((2, 2160, 3840), (8, 8)), ((2, 1079, 1917), (8, 8)),
                ((1, 37, 131), (8, 8)), ((1, 20, 27), (4, 3)), ((1, 5, 1), (3, 8)),
                ((1, 300, 301), (3, 7)), ((3, 5, 9), (2, 2)), ((1, 6, 1100), (2, 1)),
                ((2, 37, 128), (8, 8))]
    for kind in K1_PLANES:
        for shape, grid in k1_geoms:
            x = on_card(k1_planes(shape, kind, rng))
            geo = tclahe.tile_geometry(shape[1], shape[2], grid)
            for xx in (x, misaligned(x)):
                what = f"{kind} {shape} grid {grid} offset {xx.storage_offset()}"
                check("hist256", khist.hist256(xx), khist.hist256_plain(xx), what)
                check("hist256_tiles", kclahe.hist256_tiles(xx, *geo),
                      kclahe.tile_hists_plain(xx, *geo), what)
                n_k1 += 1
    del x, xx
    print(f"hist256 and hist256_tiles vs plain on the card: 0 LSB over {n_k1} cases "
          f"({', '.join(K1_PLANES)} planes; odd widths; offset 0 and 1)")

    # the fused count + LUT kernels: hist256_lut (equalize LUTs) and
    # tile_luts256 (CLAHE stage B on the finished tile counts), on each kind
    # of plane, at the main paths' shapes, odd widths and uneven grids, 1-byte
    # misaligned views, three clip limits
    n_fold = 0
    fold_geoms = [((8, 1080, 1920), (8, 8)), ((2, 2160, 3840), (8, 8)), ((2, 1079, 1917), (8, 8)),
                  ((1, 300, 301), (3, 7)), ((1, 37, 131), (8, 8)), ((3, 5, 9), (2, 2)),
                  ((1, 6, 1100), (2, 1)), ((1, 20, 27), (4, 3))]
    for kind in FOLD_PLANES:
        for shape, grid in fold_geoms:
            x = on_card(fold_planes(shape, kind, rng))
            geo = tclahe.tile_geometry(shape[1], shape[2], grid)
            for xx in (x, misaligned(x)):
                what = f"{kind} {shape} grid {grid} offset {xx.storage_offset()}"
                check("hist256_lut", khist.hist256_equalize_lut(xx),
                      khist.hist256_equalize_lut_plain(xx), what)
                for clip in (0.0, 2.0, 40.0):
                    check("tile_luts256", kclahe.tile_luts256(xx, *geo, clip),
                          kclahe.tile_luts256_plain(xx, *geo, clip), f"{what} clip {clip}")
                n_fold += 1
    del x, xx
    # back-to-back calls of changing plane count and tile grid on one stream:
    # each call must leave its ticket counters at 0 for the next
    frng = np.random.default_rng(17)
    for i in range(100):
        B, H, W = int(frng.integers(1, 12)), int(frng.integers(1, 700)), int(frng.integers(1, 1000))
        x = on_card(frng.integers(0, 256, (B, H, W), dtype=np.uint8))
        geo = tclahe.tile_geometry(H, W, (int(frng.integers(1, 9)), int(frng.integers(1, 9))))
        check("hist256_lut", khist.hist256_equalize_lut(x), khist.hist256_equalize_lut_plain(x),
              f"back-to-back call {i} {(B, H, W)}")
        check("tile_luts256", kclahe.tile_luts256(x, *geo, 2.0),
              kclahe.tile_luts256_plain(x, *geo, 2.0), f"back-to-back call {i} {(B, H, W)} {geo}")
    # calls interleaved on two streams, no synchronisation between them: each
    # stream keeps its own counters
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    xs = [on_card(frng.integers(0, 256, (4, 1080, 1920), dtype=np.uint8)) for _ in range(2)]
    geo2 = tclahe.tile_geometry(1080, 1920, (8, 8))
    torch.cuda.synchronize()
    outs = []
    for _ in range(20):
        for stream, x in zip((s1, s2), xs):
            with torch.cuda.stream(stream):
                outs.append((x, khist.hist256_equalize_lut(x), kclahe.tile_luts256(x, *geo2, 2.0)))
    torch.cuda.synchronize()
    for x, lut, tl in outs:
        check("hist256_lut", lut, khist.hist256_equalize_lut_plain(x), "two streams")
        check("tile_luts256", tl, kclahe.tile_luts256_plain(x, *geo2, 2.0), "two streams")
    # more scratch rows than a stream's workspace keeps (kernels/hist.py::
    # WORKSPACE_ROWS): 20 tiles of 4000x4000, 250 band blocks each
    x = on_card(frng.integers(0, 256, (20, 4000, 4000), dtype=np.uint8))
    if 20 * kclahe.tile_band_plan(20, 1, 1, 4000, 4000)[2] <= khist.WORKSPACE_ROWS:
        raise AssertionError("20x4000x4000 grid 1x1 no longer needs rows past the workspace")
    check("tile_luts256", kclahe.tile_luts256(x, 1, 1, 4000, 4000, 2.0),
          kclahe.tile_luts256_plain(x, 1, 1, 4000, 4000, 2.0), "20x4000x4000 grid 1x1")
    check("hist256_tiles", kclahe.hist256_tiles(x, 1, 1, 4000, 4000),
          kclahe.tile_hists_plain(x, 1, 1, 4000, 4000), "20x4000x4000 grid 1x1")
    del x, xs, outs
    print(f"hist256_lut and tile_luts256 vs plain on the card: 0 LSB over {n_fold} cases "
          f"({', '.join(FOLD_PLANES)} planes; offset 0 and 1; clip 0, 2, 40), 100 back-to-back "
          "calls of changing shape and grid, 20 rounds on two streams, scratch rows past the "
          "workspace (20x4000x4000 grid 1x1)")

    # sep_conv_u8: every instance and route (k 3/5/7 compile-time, packed at
    # sigma 0 and int32 at sigma 1.1/1.5/2.3; the runtime instance at k 1, 9,
    # 31, (3, 5), (1, 31)) on the kernel's residues: widths = 0, 1, 15 mod 16,
    # across a warp's 240 columns (224 in the runtime instance), 1917, 1, 2, 3;
    # heights across a warp's 8 rows and a block's 64; planes of edge lanes or
    # reflected rows only;
    # each also at a storage offset of one element (the byte path); every
    # amount route: None, lanes (1, 100), the two FMAs (0.5, -1)
    conv_ks = [(1, 0.0), (3, 0.0), (5, 0.0), (7, 0.0), ((3, 5), 0.0), (3, 1.1), (5, 1.5),
               (5, 2.3), (7, 2.3), (9, 0.0), (31, 0.0), ((1, 31), 0.0)]
    conv_shapes = [(2, 64, 256), (1, 37, 131), (1, 5, 9), (1, 1, 1), (1, 16, 256), (1, 17, 257),
                   (2, 15, 271), (1, 129, 1917), (1, 127, 240), (1, 128, 241), (2, 33, 239),
                   (1, 3, 1), (1, 2, 2), (2, 40, 3), (1, 1, 640), (3, 4, 6), (1, 8, 224),
                   (1, 9, 225), (2, 7, 223), (1, 63, 257), (1, 65, 240)]
    # tap sets no Gaussian gives: k 7 packed, k 3 packed at shift 1, k 3 int32 at the sum limit
    conv_taps = [q8_taps(ks, sg) for ks, sg in conv_ks] + [
        ((0, 0, 64, 128, 64, 0, 0),) * 2, ((0, 256, 0), (128, 0, 128)), ((1, 254, 1), (2, 252, 2))]
    conv_cases = [(shape, taps, amount) for shape in conv_shapes for taps in conv_taps
                  for amount in (None, 1.0, 0.5, -1.0, 100.0)]
    conv_cases += [((8, 1080, 1920), q8_taps(5, 0.0), amount) for amount in (None, 1.0)]
    conv_cases += [((8, 1080, 1920), q8_taps(7, 2.3), 0.5), ((8, 1080, 1920), q8_taps(3, 0.0), 1.0)]
    conv_routes = set()
    n_conv = 0
    for shape, (tv, th), amount in conv_cases:
        x = rand_u8(shape)
        conv_routes.add(kconv.conv_route(tv, th).describe())
        for luts in (None, rand_u8((shape[0], 256))):
            for xx in (x, misaligned(x)) if shape[1] < 1000 else (x,):
                what = (f"{shape} taps {tv} x {th} amount={amount} lut={luts is not None} "
                        f"offset {xx.storage_offset()}")
                check("sep_conv_u8", kconv.sep_conv_u8(xx, tv, th, amount, luts),
                      kconv.sep_conv_u8_plain(xx, tv, th, amount, luts), what)
                n_conv += 1
    print(f"sep_conv_u8 vs plain on the card: 0 LSB over {n_conv} cases, routes "
          f"{sorted(conv_routes)}")
    # a batch past 2^31 bytes: the kernels' flat offsets must be 64-bit;
    # the plain versions run on the last two planes only
    tv5, th5 = q8_taps(5, 0.0)
    big = rand_u8((1100, 1080, 1920))
    tail = big[-2:]
    hb = khist.hist256(big)
    check("hist256", hb[-2:], khist.hist256_plain(tail), "1100x1080x1920, last planes")
    lb = khist.equalize_lut256(hb, big[0].numel())
    check("apply_lut256", khist.apply_lut256(big, lb)[-2:],
          khist.apply_lut256_plain(tail, lb[-2:]), "1100x1080x1920, last planes")
    check("sep_conv_u8", kconv.sep_conv_u8(big, tv5, th5, 1.0, lb)[-2:],
          kconv.sep_conv_u8_plain(tail, tv5, th5, 1.0, lb[-2:]), "1100x1080x1920, last planes")
    check("median", kmedian.median_blur(big, 5)[-2:], kmedian.median_blur_plain(tail, 5),
          "1100x1080x1920 k=5, last planes")
    gbig = tclahe.tile_geometry(1080, 1920, (8, 8))
    tables_big = coord_tables(1080, 1920, gbig)
    ht = kclahe.hist256_tiles(big, *gbig)
    check("hist256_tiles", ht[-128:], kclahe.tile_hists_plain(tail, *gbig),
          "1100x1080x1920 grid 8x8, last planes")
    check("hist256_lut", khist.hist256_equalize_lut(big)[-2:],
          khist.hist256_equalize_lut_plain(tail), "1100x1080x1920, last planes")
    check("tile_luts256", kclahe.tile_luts256(big, *gbig, 2.0)[-128:],
          kclahe.tile_luts256_plain(tail, *gbig, 2.0), "1100x1080x1920 grid 8x8, last planes")
    lt = kclahe.clahe_lut(ht, gbig[2] * gbig[3], 2.0)
    check("clahe_blend", kclahe.clahe_blend(big, lt, 8, 8, *tables_big)[-2:],
          kclahe.clahe_blend_plain(tail, lt[-128:], 8, 8, *tables_big),
          "1100x1080x1920 grid 8x8, last planes")
    del big, tail, hb, lb, ht, lt
    torch.cuda.synchronize()

    # the config-5 kernels: median, and CLAHE's stages A, B and C, each on the
    # same input as its plain version; then the whole CLAHE op, kernel route
    # against plain route
    med_shapes = [(2, 64, 256), (1, 37, 131), (1, 2, 3), (1, 1, 1), (3, 5, 9), (2, 4, 70),
                  (1, 70, 3), (2, 1080, 1920)]
    n_med = 0
    for dtype in (np.uint8, np.uint16, np.int16):
        for shape in med_shapes:
            x = rand(shape, dtype)
            for xx in (x, misaligned(x)):
                for k in (3, 5):
                    check("median", kmedian.median_blur(xx, k), kmedian.median_blur_plain(xx, k),
                          f"{dtype.__name__} {shape} k={k} offset {xx.storage_offset()}")
                    n_med += 1

    n_clahe = 0

    def check_clahe(x: torch.Tensor, clip: float, grid, what: str) -> None:
        nonlocal n_clahe
        B, H, W = x.shape
        geo = tclahe.tile_geometry(H, W, grid)
        area = geo[2] * geo[3]
        hp = kclahe.tile_hists_plain(x, *geo)
        if x.dtype == torch.uint8:
            check("hist256_tiles", kclahe.hist256_tiles(x, *geo), hp, what)
        else:
            check("hist65536_tiles", kclahe.hist65536_tiles(x, *geo), hp, what)
        lut = kclahe.clahe_lut(hp, area, clip)
        check("clahe_lut", lut, kclahe.clahe_lut_plain(hp, area, clip), what)
        if x.dtype == torch.uint16:
            check("tile_luts65536", kclahe.tile_luts65536(x, *geo, clip), lut, what)
        tables = coord_tables(H, W, geo)
        check("clahe_blend", kclahe.clahe_blend(x, lut, geo[0], geo[1], *tables),
              kclahe.clahe_blend_plain(x, lut, geo[0], geo[1], *tables), what)
        check("clahe_blend", tclahe.clahe_planes(x, clip, grid), clahe_plain(x, clip, grid),
              what + ", whole op")
        n_clahe += 1

    clahe_geoms = [((2, 64, 256), (8, 2)), ((1, 30, 256), (2, 2)), ((1, 64, 384), (4, 3)),
                   ((1, 37, 131), (8, 8)), ((1, 20, 250), (2, 2)), ((1, 164, 164), (2, 2)),
                   ((1, 1, 1), (8, 8)), ((1, 2, 3), (2, 2)), ((2, 1080, 1920), (8, 8)),
                   ((1, 1079, 1917), (8, 8)),
                   # tiles of a few pixels: narrow chunks, one-row bands (the u8 blend's plan)
                   ((1, 8, 8), (8, 8)), ((2, 17, 33), (17, 33)), ((1, 40, 5000), (2, 4000)),
                   ((1, 64, 3840), (1, 64)), ((1, 100, 4000), (3, 64)),
                   # one tile column
                   ((1, 6, 1100), (2, 1)), ((1, 1000, 130), (2, 1))]
    for dtype in (np.uint8, np.uint16):
        for shape, grid in clahe_geoms:
            x = rand(shape, dtype)
            for xx in (x, misaligned(x)):
                for clip in (0.0, 2.0, 40.0):
                    check_clahe(xx, clip, grid, f"{dtype.__name__} {shape} grid {grid} "
                                f"clip {clip} offset {xx.storage_offset()}")
    # peaked random histograms straight into stage B, both table sizes
    for S, area in ((256, 37 * 131), (65536, 270 * 480)):
        hr = on_card(np.stack([rng.multinomial(area, p) for p in
                               rng.dirichlet(np.full(S, 0.02), size=16)]).astype(np.int32))
        for clip in (0.0, 2.0, 40.0):
            check("clahe_lut", kclahe.clahe_lut(hr, area, clip),
                  kclahe.clahe_lut_plain(hr, area, clip), f"random S={S} clip {clip}")
    # adversarial histograms into stage B at S = 65536 (one cluster a tile)
    for what, hs, area, clips in stage_b_cases(rng):
        hb = on_card(hs)
        for clip in clips:
            check("clahe_lut", kclahe.clahe_lut(hb, area, clip),
                  kclahe.clahe_lut_plain(hb, area, clip),
                  f"S=65536 {what}, T={hs.shape[0]}, area {area}, clip {clip}")
    del hb

    # more planes than a grid axis of 65535 holds: every kernel
    many = rand_u8((70000, 8, 8))
    hm = khist.hist256(many)
    check("hist256", hm, khist.hist256_plain(many), "70000x8x8")
    lm = khist.equalize_lut256(hm, 64)
    check("equalize_lut256", lm, khist.equalize_lut256_plain(hm, 64), "70000x8x8")
    check("hist256_lut", khist.hist256_equalize_lut(many), khist.hist256_equalize_lut_plain(many),
          "70000x8x8")
    check("tile_luts256", kclahe.tile_luts256(many, 2, 2, 4, 4, 2.0),
          kclahe.tile_luts256_plain(many, 2, 2, 4, 4, 2.0), "70000x8x8 grid 2x2")
    check("apply_lut256", khist.apply_lut256(many, lm), khist.apply_lut256_plain(many, lm),
          "70000x8x8")
    check("sep_conv_u8", kconv.sep_conv_u8(many, tv5, th5, 1.0, lm),
          kconv.sep_conv_u8_plain(many, tv5, th5, 1.0, lm), "70000x8x8")
    for k in (3, 5):
        check("median", kmedian.median_blur(many, k), kmedian.median_blur_plain(many, k),
              f"70000x8x8 k={k}")
    check_clahe(many, 2.0, (2, 2), "70000x8x8 grid 2x2 (280000 tiles)")
    # grid 8x8: 4.48 M tiles of one pixel; the plain versions run on slices
    hk = kclahe.hist256_tiles(many, 8, 8, 1, 1)
    lk = kclahe.clahe_lut(hk, 1, 40.0)
    fk = kclahe.tile_luts256(many, 8, 8, 1, 1, 40.0)
    bk = kclahe.clahe_blend(many, lk, 8, 8, *coord_tables(8, 8, (8, 8, 1, 1)))
    for sl in (slice(0, 3), slice(-3, None)):
        what = f"70000x8x8 grid 8x8, planes {sl.start}:{sl.stop}"
        h_sl, l_sl = hk.view(70000, 64, 256)[sl].reshape(-1, 256), lk.view(70000, 64, 256)[sl]
        check("hist256_tiles", h_sl, kclahe.tile_hists_plain(many[sl], 8, 8, 1, 1), what)
        check("clahe_lut", l_sl.reshape(-1, 256), kclahe.clahe_lut_plain(h_sl, 1, 40.0), what)
        check("tile_luts256", fk.view(70000, 64, 256)[sl].reshape(-1, 256),
              kclahe.tile_luts256_plain(many[sl], 8, 8, 1, 1, 40.0), what)
        check("clahe_blend", bk[sl], clahe_plain(many[sl], 40.0, (8, 8)), what)
    bil9 = tbil.bilateral_tables(9, 75.0, 75.0, 1, dev)
    taps11 = tthr.gaussian_taps(11, dev)
    check("bilateral", kbil.bilateral_gray(many, *bil9), kbil.bilateral_gray_plain(many, *bil9),
          "70000x8x8 d=9")
    check("athresh", kathr.adaptive_threshold_gaussian(many, taps11, 255, 2, False),
          kathr.adaptive_threshold_gaussian_plain(many, taps11, 255, 2, False), "70000x8x8 k=11")
    del many, hm, lm, hk, lk, bk, fk

    # the bilateral kernel family: every compile-time radius (1..5, d 3..11),
    # each also through the runtime instance, and the runtime instance alone
    # above (d 13, 51, sigma-derived radii); widths = 0, 1 and 7 mod 8 (a
    # thread's 8 outputs) and across a block's 64 columns, heights across its
    # 32 rows; tiny planes and planes smaller than the disc (reflected again);
    # random planes and one whose colour-table indices differ across the 32
    # lanes (rows) of each warp
    bil_shapes = [(2, 64, 256), (1, 37, 131), (1, 1, 1), (1, 2, 3), (1, 3, 4), (3, 5, 9),
                  (1, 33, 64), (1, 31, 65), (2, 40, 71), (1, 65, 127), (1, 7, 8), (1, 9, 9)]
    bil_params = [(d, sc, ss) for d in (3, 5, 7, 9, 11) for sc, ss in
                  ((75.0, 75.0), (30.0, 30.0), (10.0, 200.0))]
    bil_params += [(13, 30.0, 30.0), (51, 30.0, 30.0), (0, 10.0, 16.0), (0, 75.0, 3.0)]
    n_bil = 0

    def check_bilateral(x: torch.Tensor, params, what: str) -> None:
        nonlocal n_bil
        tables = tbil.bilateral_tables(*params[:3], 1, dev)
        want = kbil.bilateral_gray_plain(x, *tables)
        for runtime in (False, True) if tables[2] <= kbil.MAX_COMPILED_RADIUS else (False,):
            check("bilateral", kbil.bilateral_gray(x, *tables, _runtime=runtime), want,
                  f"{what} d={params[0]} sigma={params[1:]} runtime instance={runtime}")
            n_bil += 1

    for shape in bil_shapes:
        x = rand_u8(shape)
        for xx in (x, misaligned(x)):
            for params in bil_params:
                check_bilateral(xx, params, f"{tuple(xx.shape)} offset {xx.storage_offset()}")
    x = rand_u8((1, 1079, 1917))
    for params in ((9, 75.0, 75.0), (5, 10.0, 200.0)):
        check_bilateral(x, params, "1079x1917")
    yy, xc = np.ogrid[0:67, 0:1917]
    spread = on_card(((7 * yy * yy + 3 * xc + 11 * xc * yy) % 256).astype(np.uint8)[None])
    for d in (3, 5, 7, 9, 11, 13):
        check_bilateral(spread, (d, 30.0, 30.0), "lane-distinct table indices 67x1917")

    # the athresh kernel: every block size of the shared-memory route (3..51;
    # 3..11 also through the runtime instance) and the two-pass route (61,
    # 101), both types, C around 0; widths and heights across the 64 x 64
    # tile; the f64 recompute forced on every pixel (margin +inf) at 3, 11,
    # 31 and 51 and on 1079x1917
    ath_shapes = [(2, 64, 256), (1, 37, 131), (1, 1, 1), (1, 2, 3), (1, 5, 7), (1, 65, 129),
                  (1, 63, 64), (2, 64, 71)]
    ath_sizes = list(range(3, 52, 2)) + [61, 101]
    n_ath, n_forced = 0, 0

    def check_athresh(x: torch.Tensor, bs: int, C: float, inv: bool, mv: int, what: str,
                      forced: bool = False) -> None:
        nonlocal n_ath, n_forced
        taps = tthr.gaussian_taps(bs, dev)
        idelta = int(np.floor(C)) if inv else int(np.ceil(C))
        want = kathr.adaptive_threshold_gaussian_plain(x, taps, mv, idelta, inv)
        what = f"{what} block {bs} C={C} inv={inv} maxval {mv}"
        check("athresh", kathr.adaptive_threshold_gaussian(x, taps, mv, idelta, inv), want, what)
        n_ath += 1
        if bs <= 11:
            check("athresh", kathr.adaptive_threshold_gaussian(x, taps, mv, idelta, inv,
                                                               _runtime=True), want,
                  what + " runtime instance")
            n_ath += 1
        if forced:
            check("athresh", kathr.adaptive_threshold_gaussian(x, taps, mv, idelta, inv,
                                                               _margin=float("inf")), want,
                  what + " every pixel recomputed")
            n_forced += 1

    for shape in ath_shapes:
        x = rand_u8(shape)
        for xx in (x, misaligned(x)):
            for bs in ath_sizes:
                for C in (-3.5, 0.0, 2.0, 7.2):
                    for inv in (False, True):
                        check_athresh(xx, bs, C, inv, 255 if C else 200,
                                      f"{tuple(xx.shape)} offset {xx.storage_offset()}",
                                      forced=bs in (3, 11, 31, 51))
    x = rand_u8((1, 1079, 1917))
    for bs in (11, 51, 61):
        check_athresh(x, bs, 2.0, False, 255, "1079x1917", forced=bs <= 51)

    # P3: more row tiles than a grid axis of 65535 holds (16-row tiles for
    # median, bilateral and athresh; 32 for sep_conv_u8; 8-row bands for
    # clahe_blend)
    tall = rand_u8((1, 2_200_000, 8))
    what = "1x2200000x8"
    check("hist256", khist.hist256(tall), khist.hist256_plain(tall), what)
    check("hist256_lut", khist.hist256_equalize_lut(tall), khist.hist256_equalize_lut_plain(tall),
          what)
    gtall = tclahe.tile_geometry(2_200_000, 8, (8, 8))
    check("tile_luts256", kclahe.tile_luts256(tall, *gtall, 2.0),
          kclahe.tile_luts256_plain(tall, *gtall, 2.0), what + " grid 8x8")
    check("sep_conv_u8", kconv.sep_conv_u8(tall, tv5, th5, 1.0),
          kconv.sep_conv_u8_plain(tall, tv5, th5, 1.0), what)
    check("median", kmedian.median_blur(tall, 5), kmedian.median_blur_plain(tall, 5), what)
    check_clahe(tall, 2.0, (8, 8), what + " grid 8x8")
    check_bilateral(tall, (9, 75.0, 75.0), what)
    check_athresh(tall, 11, 2.0, False, 255, what)
    check_athresh(tall, 61, 2.0, True, 255, what)
    del tall, x

    # u16 CLAHE's stage A (hist65536_tiles) and blend on each kind of plane
    # (random, smooth, constant, 12-bit, two-extreme): divisible and not,
    # tiles of a few pixels, one tile column, the R2 geometry, 4K; each also
    # at a storage offset of one element
    n_u16 = 0

    def check_u16(x: torch.Tensor, grid, what: str) -> None:
        nonlocal n_u16
        B, H, W = x.shape
        geo = tclahe.tile_geometry(H, W, grid)
        hp = kclahe.tile_hists_plain(x, *geo)
        check("hist65536_tiles", kclahe.hist65536_tiles(x, *geo), hp, what)
        lut = kclahe.clahe_lut_plain(hp, geo[2] * geo[3], 2.0)
        for clip in (0.0, 2.0):
            check("tile_luts65536", kclahe.tile_luts65536(x, *geo, clip),
                  lut if clip else kclahe.clahe_lut_plain(hp, geo[2] * geo[3], clip), what)
        tables = coord_tables(H, W, geo)
        check("clahe_blend", kclahe.clahe_blend(x, lut, geo[0], geo[1], *tables),
              kclahe.clahe_blend_plain(x, lut, geo[0], geo[1], *tables), what)
        n_u16 += 1

    urng = np.random.default_rng(21)
    u16_geoms = [((2, 64, 256), (8, 2)), ((1, 37, 131), (8, 8)), ((1, 164, 164), (2, 2)),
                 ((2, 17, 33), (17, 33)), ((1, 8, 8), (8, 8)), ((1, 6, 1100), (2, 1)),
                 ((1, 1000, 130), (2, 1)), ((1, 40, 5000), (2, 4000)), ((1, 3, 1), (2, 2)),
                 ((1, 1079, 1917), (8, 8)), ((2, 2160, 3840), (8, 8))]
    for kind in U16_PLANES:
        for shape, grid in u16_geoms:
            x = on_card(u16_planes(shape, kind, urng))
            for xx in (x, misaligned(x)):
                check_u16(xx, grid, f"{kind} u16 {shape} grid {grid} offset {xx.storage_offset()}")
    # tiles of one value: 65535 pixels (the most a 16-bit counter would hold)
    # and 153600, on an even bin, an odd bin and both ends of the range
    for v in (40000, 40001, 65535, 0):
        for shape in ((132, 255, 257), (2, 300, 512)):
            x = torch.full(shape, v, dtype=torch.uint16, device=dev)
            geo = (1, 1, shape[1], shape[2])
            check("hist65536_tiles", kclahe.hist65536_tiles(x, *geo),
                  kclahe.tile_hists_plain(x, *geo), f"{shape} all {v}: one bin per tile")
            check("tile_luts65536", kclahe.tile_luts65536(x, *geo, 2.0),
                  kclahe.tile_luts65536_plain(x, *geo, 2.0), f"{shape} all {v}: one bin per tile")
    # more planes than a grid axis holds (grid 1x1: 70000 tiles; the plain
    # versions on slices), and more rows
    many = on_card(u16_planes((70000, 8, 8), "random", urng))
    tables_many = coord_tables(8, 8, (1, 1, 8, 8))
    hk = kclahe.hist65536_tiles(many, 1, 1, 8, 8)
    lk = kclahe.clahe_lut(hk, 64, 2.0)
    fk = kclahe.tile_luts65536(many, 1, 1, 8, 8, 2.0)
    bk = kclahe.clahe_blend(many, lk, 1, 1, *tables_many)
    for sl in (slice(0, 3), slice(-3, None)):
        what = f"u16 70000x8x8 grid 1x1, planes {sl.start}:{sl.stop}"
        check("hist65536_tiles", hk[sl], kclahe.tile_hists_plain(many[sl], 1, 1, 8, 8), what)
        check("tile_luts65536", fk[sl], kclahe.tile_luts65536_plain(many[sl], 1, 1, 8, 8, 2.0),
              what)
        check("clahe_blend", bk[sl], kclahe.clahe_blend_plain(many[sl], lk[sl], 1, 1, *tables_many),
              what)
    del many, hk, lk, bk, fk
    check_u16(on_card(u16_planes((1, 2_200_000, 8), "random", urng)), (8, 8),
              "u16 1x2200000x8 grid 8x8")
    torch.cuda.synchronize()
    print(f"hist65536_tiles, tile_luts65536 (clip 0 and 2) and the u16 blend vs plain on the "
          f"card: 0 LSB over {n_u16} cases "
          f"({', '.join(U16_PLANES)} planes; offset 0 and 1), tiles of 65535 and 153600 equal "
          "pixels, [70000, 8, 8] and [1, 2200000, 8]")
    for name in KERNELS + U16_KERNELS:
        if launch_counts[name] <= before[name]:
            raise AssertionError(f"{name}: the comparison phase launched no kernel")
    print("kernels vs plain on the card: 0 LSB over "
          f"{len(planes_cases)} plane cases, {n_k1} K1 plane-kind cases, {n_fold} fused "
          f"count + LUT cases, {n_conv} conv cases, "
          f"{n_med} median cases, {n_clahe} CLAHE cases (each stage and the whole op), "
          f"{n_bil} bilateral and {n_ath} athresh cases ({n_forced} more with every athresh "
          f"pixel recomputed in f64), the 70000x8x8 batch through every "
          "kernel, the 1x2200000x8 plane through hist256, sep_conv_u8, median, CLAHE, bilateral and "
          "athresh, and the 1100x1080x1920 batch")

    # per-kernel time at the main paths' shapes, kernel vs plain: the first
    # four at equalize_unsharp's 8x1080x1920, the config-5 kernels at its
    # 2x2160x3840 (CLAHE grid 8x8: 128 tiles of 270x480), bilateral (d 9,
    # sigma 75/75) and athresh (block 11, C 2) at their paths' 2x2160x3840
    x8 = planes_cases[4]
    total8 = x8[0].numel()
    h8 = khist.hist256(x8)
    l8 = khist.equalize_lut256(h8, total8)
    g5 = rand_u8((2, 2160, 3840))
    geo5 = tclahe.tile_geometry(2160, 3840, (8, 8))
    area5 = geo5[2] * geo5[3]
    tables5 = coord_tables(2160, 3840, geo5)
    h5 = kclahe.hist256_tiles(g5, *geo5)
    l5 = kclahe.clahe_lut(h5, area5, 2.0)
    # name -> (kernel, plain, shape label, plain runs and calls per run)
    timed = {
        "hist256": (lambda: khist.hist256(x8), lambda: khist.hist256_plain(x8),
                    tuple(x8.shape), (TIMED_RUNS, CALLS_PER_RUN)),
        "equalize_lut256": (lambda: khist.equalize_lut256(h8, total8),
                            lambda: khist.equalize_lut256_plain(h8, total8),
                            tuple(h8.shape), (TIMED_RUNS, CALLS_PER_RUN)),
        "apply_lut256": (lambda: khist.apply_lut256(x8, l8),
                         lambda: khist.apply_lut256_plain(x8, l8),
                         tuple(x8.shape), (TIMED_RUNS, CALLS_PER_RUN)),
        "sep_conv_u8": (lambda: kconv.sep_conv_u8(x8, tv5, th5, 1.0, l8),
                        lambda: kconv.sep_conv_u8_plain(x8, tv5, th5, 1.0, l8),
                        tuple(x8.shape), (TIMED_RUNS, CALLS_PER_RUN)),
        "median": (lambda: kmedian.median_blur(g5, 5), lambda: kmedian.median_blur_plain(g5, 5),
                   tuple(g5.shape) + ("k=5",), (10, 3)),
        "hist256_tiles": (lambda: kclahe.hist256_tiles(g5, *geo5),
                          lambda: kclahe.tile_hists_plain(g5, *geo5),
                          tuple(g5.shape) + ("grid 8x8",), (10, 3)),
        "hist256_lut": (lambda: khist.hist256_equalize_lut(x8),
                        lambda: khist.hist256_equalize_lut_plain(x8),
                        tuple(x8.shape), (TIMED_RUNS, CALLS_PER_RUN)),
        "tile_luts256": (lambda: kclahe.tile_luts256(g5, *geo5, 2.0),
                         lambda: kclahe.tile_luts256_plain(g5, *geo5, 2.0),
                         tuple(g5.shape) + ("grid 8x8 clip 2.0",), (10, 3)),
        "clahe_lut": (lambda: kclahe.clahe_lut(h5, area5, 2.0),
                      lambda: kclahe.clahe_lut_plain(h5, area5, 2.0),
                      tuple(h5.shape) + ("clip 2.0",), (TIMED_RUNS, CALLS_PER_RUN)),
        "clahe_blend": (lambda: kclahe.clahe_blend(g5, l5, 8, 8, *tables5),
                        lambda: kclahe.clahe_blend_plain(g5, l5, 8, 8, *tables5),
                        tuple(g5.shape) + ("grid 8x8",), (10, 3)),
        "bilateral": (lambda: kbil.bilateral_gray(g5, *bil9),
                      lambda: kbil.bilateral_gray_plain(g5, *bil9),
                      tuple(g5.shape) + ("d=9 sigma 75/75",), (5, 2)),
        "athresh": (lambda: kathr.adaptive_threshold_gaussian(g5, taps11, 255, 2, False),
                    lambda: kathr.adaptive_threshold_gaussian_plain(g5, taps11, 255, 2, False),
                    tuple(g5.shape) + ("block 11 C=2",), (10, 3)),
    }
    ms = {}
    for name, (kfn, pfn, label, (runs, calls)) in timed.items():
        (k_ms, k_iqr), (p_ms, p_iqr) = time_ms(kfn), time_ms(pfn, runs, calls)
        ms[name] = (k_ms, p_ms)
        print(f"  {name} at {label}: kernel {k_ms:.4f} ms (IQR {k_iqr:.4f}), "
              f"plain {p_ms:.4f} ms (IQR {p_iqr:.4f})  [{smi}]")
    # K1's counting and the fused kernels on each kind of plane at the timed
    # shapes (random: above)
    for kind in FOLD_PLANES[1:]:
        xk = on_card(fold_planes(tuple(x8.shape), kind, rng))
        gk = on_card(fold_planes(tuple(g5.shape), kind, rng))
        for name, fn, want, label in (
                ("hist256", lambda: khist.hist256(xk), khist.hist256_plain(xk), tuple(x8.shape)),
                ("hist256_tiles", lambda: kclahe.hist256_tiles(gk, *geo5),
                 kclahe.tile_hists_plain(gk, *geo5), tuple(g5.shape) + ("grid 8x8",)),
                ("hist256_lut", lambda: khist.hist256_equalize_lut(xk),
                 khist.hist256_equalize_lut_plain(xk), tuple(x8.shape)),
                ("tile_luts256", lambda: kclahe.tile_luts256(gk, *geo5, 2.0),
                 kclahe.tile_luts256_plain(gk, *geo5, 2.0),
                 tuple(g5.shape) + ("grid 8x8 clip 2.0",))):
            check(name, fn(), want, f"{kind} {label}")
            k_ms, k_iqr = time_ms(fn)
            print(f"  {name} at {label}, {kind} plane: kernel {k_ms:.4f} ms (IQR {k_iqr:.4f}); "
                  f"random {ms[name][0]:.4f} ms  [{smi}]")
    del xk, gk
    # one torch.bincount over tile offsets made beforehand computes stage A
    T5 = h5.shape[0]
    rows5 = torch.arange(2160, device=dev) // geo5[2]
    cols5 = torch.arange(3840, device=dev) // geo5[3]
    tile5 = (torch.arange(2, device=dev)[:, None, None] * 64 + rows5[None, :, None] * 8
             + cols5[None, None, :])
    idx_t = (tile5 * 256 + g5.long()).view(-1)
    if not torch.equal(torch.bincount(idx_t, minlength=T5 * 256).view(T5, 256).int(), h5):
        raise AssertionError("torch.bincount over tile offsets differs from hist256_tiles")
    tiles_library_ms = time_ms(lambda: torch.bincount(idx_t, minlength=T5 * 256))[0]
    del tile5, idx_t
    print(f"  clahe_blend u8 plan at (2, 2160, 3840) grid 8x8: "
          f"{kclahe.blend_chunk(tables5[2].cpu().numpy(), 8)} columns and "
          f"{kclahe.blend_band(tables5[0].cpu().numpy())} rows per block")
    # u16 CLAHE's stage A (hist65536_tiles), stages A and B in one launch
    # (tile_luts65536), stage B alone and the blend at the same geometry on
    # each kind of u16 plane, beside their bytes bounds (stage A: 2 B/px and
    # the int32 tables written once; stages A and B: 2 B/px and the u16 LUTs
    # written once; the blend: 4 B/px and the LUTs read once); stage A's
    # library call: one torch.bincount over tile offsets made beforehand
    n16, T16 = 2 * 2160 * 3840, 2 * geo5[0] * geo5[1]
    b16_hist, b16_blend = bound_ms(2 * n16 + T16 * 65536 * 4), bound_ms(4 * n16 + T16 * 65536 * 2)
    b16_fused = bound_ms(2 * n16 + T16 * 65536 * 2)
    b16_lut = bound_ms(T16 * 65536 * (4 + 2))  # stage B: the histograms read, the LUTs written
    for kind in U16_PLANES:
        g16 = on_card(u16_planes((2, 2160, 3840), kind, urng))
        h16 = kclahe.hist65536_tiles(g16, *geo5)
        what = f"{kind} u16 (2, 2160, 3840) grid 8x8"
        check("hist65536_tiles", h16, kclahe.tile_hists_plain(g16, *geo5), what)
        l16 = kclahe.clahe_lut(h16, area5, 2.0)
        check("tile_luts65536", kclahe.tile_luts65536(g16, *geo5, 2.0),
              kclahe.clahe_lut_plain(h16, area5, 2.0), what)
        h_ms, h_iqr = time_ms(lambda: kclahe.hist65536_tiles(g16, *geo5))
        f_ms, f_iqr = time_ms(lambda: kclahe.tile_luts65536(g16, *geo5, 2.0))
        l_ms, l_iqr = time_ms(lambda: kclahe.clahe_lut(h16, area5, 2.0))
        b_ms, b_iqr = time_ms(lambda: kclahe.clahe_blend(g16, l16, 8, 8, *tables5))
        print(f"  u16 at (2, 2160, 3840) grid 8x8, {kind} plane: hist65536_tiles {h_ms:.4f} ms "
              f"(IQR {h_iqr:.4f}), bound {b16_hist[0]:.4f} ms ({b16_hist[1]}); tile_luts65536 "
              f"{f_ms:.4f} ms (IQR {f_iqr:.4f}), bound {b16_fused[0]:.4f} ms ({b16_fused[1]}); "
              f"clahe_lut S=65536 {l_ms:.4f} ms (IQR {l_iqr:.4f}), bound {b16_lut[0]:.4f} ms "
              f"({b16_lut[1]}); clahe_blend u16 {b_ms:.4f} ms (IQR {b_iqr:.4f}), bound "
              f"{b16_blend[0]:.4f} ms ({b16_blend[1]})  [{smi}]")
        if kind == "random":
            ms["hist65536_tiles"] = (h_ms, time_ms(lambda: kclahe.tile_hists_plain(g16, *geo5),
                                                   10, 3)[0])
            ms["tile_luts65536"] = (f_ms, time_ms(
                lambda: kclahe.tile_luts65536_plain(g16, *geo5, 2.0), 10, 3)[0])
            idx16 = ((torch.arange(2, device=dev)[:, None, None] * 64
                      + (torch.arange(2160, device=dev) // geo5[2])[None, :, None] * 8
                      + (torch.arange(3840, device=dev) // geo5[3])[None, None, :]) * 65536
                     + g16.long()).view(-1)
            if not torch.equal(torch.bincount(idx16, minlength=T16 * 65536).view(T16, 65536)
                               .int(), h16):
                raise AssertionError("torch.bincount over tile offsets differs from "
                                     "hist65536_tiles")
            u16_library_ms = time_ms(lambda: torch.bincount(idx16, minlength=T16 * 65536))[0]
            print(f"  library call for hist65536_tiles: {u16_library_ms:.4f} ms (one "
                  f"torch.bincount on int64 tile offsets made beforehand)  [{smi}]")
            del idx16
            # the u16 blend's plain version at the timed shape (the kernels
            # line's plain_ms for clahe_blend is the u8 one)
            blend16_plain_ms = time_ms(lambda: kclahe.clahe_blend_plain(g16, l16, 8, 8, *tables5),
                                       5, 2)[0]
            print(f"  clahe_blend u16 plain version at (2, 2160, 3840) grid 8x8, random plane: "
                  f"{blend16_plain_ms:.4f} ms  [{smi}]")
    del g16, h16, l16
    # the document kernels beside their issue floors; the share of pixels the
    # athresh screen hands to the f64 recompute, from the plain mirror of the
    # screen on the timed input
    _, recomputed = kathr.adaptive_threshold_screened_plain(g5, taps11, 255, 2, False)
    ath_recomputed = int(recomputed.sum())
    bil_floor, ath_floor = doc_issue_floors_ms(bil9[0].shape[0] * g5.numel(), 11, g5.numel(),
                                               sm_clock_max_mhz())
    print(f"  bilateral at {tuple(g5.shape)} d=9: kernel {ms['bilateral'][0]:.4f} ms, issue floor "
          f"{bil_floor:.4f} ms ({bil9[0].shape[0]} visits per pixel); athresh block 11: kernel "
          f"{ms['athresh'][0]:.4f} ms, issue floor {ath_floor:.4f} ms; the screen recomputes "
          f"{ath_recomputed} of {g5.numel()} pixels ({ath_recomputed / g5.numel():.3e}, plain "
          f"mirror, margin {kathr.screen_margin(taps11.cpu().numpy()):.6g})  [{smi}]")
    del recomputed
    print(f"  sep_conv_u8 at {tuple(x8.shape)} k=5 sigma 0, LUT, amount 1: instance and route "
          f"{kconv.conv_route(tv5, th5).describe()}, epilogue mode {kconv.epilogue_mode(1.0)}")
    del g5, h5, l5

    # -- 4. the main path through the public functions -------------------------
    def drive(label: str, fn, expect: dict[str, int]):
        """Run one path with every launch counter set to 0 just before and
        read just after; fail unless each kernel was launched exactly as
        often as ``expect`` says (a kernel not named there: never).  Returns
        the path's output and its counts."""
        torch.cuda.synchronize()
        reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        got = dict(launch_counts)
        want = {n: expect.get(n, 0) for n in got}
        print(f"{label} launches: { {n: c for n, c in got.items() if c} }")
        if got != want:
            raise AssertionError(f"{label}: launches {got}, expected {want}")
        return out, got

    x1080 = np.random.default_rng(0).integers(0, 256, (8, 1080, 1920), dtype=np.uint8)
    x4k = np.random.default_rng(0).integers(0, 256, (2, 2160, 3840), dtype=np.uint8)
    g1080, g4k = on_card(x1080), on_card(x4k)
    eu_launches = {"hist256_lut": 1, "sep_conv_u8": 1}
    out1080, c1 = drive("equalize_unsharp 8x1080x1920", lambda: port.equalize_unsharp(
        g1080, 1.0, 5, 0.0), eu_launches)
    out4k, c2 = drive("equalize_unsharp 2x2160x3840", lambda: port.equalize_unsharp(
        g4k, 1.0, 5, 0.0), eu_launches)
    eq1080, c3 = drive("equalize_hist 8x1080x1920", lambda: port.equalize_hist(g1080),
                       {"hist256_lut": 1, "apply_lut256": 1})
    launches = {n: c1[n] + c2[n] + c3[n] for n in MAIN_KERNELS}

    def plain_equalize_unsharp(planes: torch.Tensor) -> torch.Tensor:
        luts = khist.equalize_lut256_plain(khist.hist256_plain(planes), planes[0].numel())
        return kconv.sep_conv_u8_plain(planes, tv5, th5, 1.0, luts)

    for out, x in ((out1080, g1080), (out4k, g4k)):
        if out.shape != x.shape or out.dtype != torch.uint8 or out.device != x.device:
            raise AssertionError(f"equalize_unsharp output {tuple(out.shape)} {out.dtype} {out.device}")
        e = max_err(out, plain_equalize_unsharp(x))
        print(f"equalize_unsharp {tuple(x.shape)}: kernel path vs plain path on the card, max abs err {e}")
        if e:
            raise AssertionError("equalize_unsharp kernel path differs from the plain path")
    eq_plain = khist.apply_lut256_plain(g1080, khist.equalize_lut256_plain(
        khist.hist256_plain(g1080), g1080[0].numel()))
    if max_err(eq1080, eq_plain):
        raise AssertionError("equalize_hist kernel path differs from the plain path")
    cpu_frame = port.equalize_unsharp(torch.from_numpy(x1080[:1]), 1.0, 5, 0.0)
    e = max_err(out1080[:1].cpu(), cpu_frame)
    print(f"equalize_unsharp one 1080p frame: card vs plain path on the CPU, max abs err {e}")
    if e:
        raise AssertionError("equalize_unsharp on the card differs from the CPU plain path")
    if out1080.float().std() == 0:
        raise AssertionError("equalize_unsharp output is constant")

    for label, x in (("8x1080x1920", g1080), ("2x2160x3840", g4k)):
        k_ms, k_iqr = time_ms(lambda: port.equalize_unsharp(x, 1.0, 5, 0.0))
        p_ms, p_iqr = time_ms(lambda: plain_equalize_unsharp(x))
        gpix = x.numel() / 1e9
        print(f"equalize_unsharp {label} u8: kernel path {k_ms:.4f} ms (IQR {k_iqr:.4f}) = "
              f"{gpix / (k_ms / 1e3):.3f} GPix/s, plain path {p_ms:.4f} ms (IQR {p_iqr:.4f}) = "
              f"{gpix / (p_ms / 1e3):.3f} GPix/s, max abs err 0  [{smi}]")

    # -- 5. config 5 through the public functions -------------------------------
    del g1080, out1080, out4k, eq1080, eq_plain
    pipe = port.get_preset("denoise_clahe_sharpen")
    frames = [np.random.default_rng(10 + i).integers(0, 256, (2, 2160, 3840), dtype=np.uint8)
              for i in range(8)]
    x_rgb = np.random.default_rng(1).integers(0, 256, (1, 2160, 3840, 3), dtype=np.uint8)
    x_u16 = np.random.default_rng(2).integers(0, 65536, (2, 2160, 3840)).astype(np.uint16)
    x_i16 = np.random.default_rng(3).integers(-32768, 32768, (2, 2160, 3840)).astype(np.int16)
    g_rgb, g_u16, g_i16 = on_card(x_rgb), on_card(x_u16), on_card(x_i16)
    # the median schedules against the plain networks, before the paths
    nrng = np.random.default_rng(20)
    n_net = 0
    for dtype in (np.uint8, np.uint16, np.int16):
        for shape in NETWORK_SHAPES:
            for planes in NETWORK_PLANES:
                x = on_card(network_planes(dtype, shape, planes, nrng))
                for xx in (x, misaligned(x)):
                    for k in (3, 5):
                        check("median", kmedian.median_blur(xx, k), kmedian.median_blur_plain(xx, k),
                              f"{dtype.__name__} {shape} {planes} k={k} offset {xx.storage_offset()}")
                        n_net += 1
        for shape in ((70000, 8, 8), (1, 2_200_000, 8)):
            for planes in ("random", "extremes"):
                x = on_card(network_planes(dtype, shape, planes, nrng))
                for k in (3, 5):
                    check("median", kmedian.median_blur(x, k), kmedian.median_blur_plain(x, k),
                          f"{dtype.__name__} {shape} {planes} k={k}")
                    n_net += 1
    del x, xx
    torch.cuda.synchronize()
    print(f"median schedules vs plain networks on the card: 0 LSB over {n_net} cases (k 3 and 5; "
          "u8, u16, i16; 1x1, 2x3, 5x7, 37x131, 1079x1917; random, {0, 1}, constant, ramp and "
          "two-extreme planes; offset 1; [70000, 8, 8]; [1, 2200000, 8])")
    # each path with counters of its own: one launch of each of its kernels
    # per call, 8 over 8 batches
    out5, launches5 = drive("config 5 get_preset 2x2160x3840 u8", lambda: pipe(g4k),
                            dict.fromkeys(CONFIG5_KERNELS, 1))
    streamed, _ = drive("config 5 stream_frames 8x(2x2160x3840) u8",
                        lambda: list(port.stream_frames(pipe, frames, 2, device=dev)),
                        dict.fromkeys(CONFIG5_KERNELS, len(frames)))
    clahe_rgb, _ = drive("clahe 1x2160x3840x3 RGB u8", lambda: port.clahe(g_rgb, 2.0, (8, 8)),
                         {"tile_luts256": 1, "clahe_blend": 1})
    geo4k = tclahe.tile_geometry(2160, 3840, (8, 8))
    tiles4k, launches_tiles = drive("hist256_tiles (stage A alone) 2x2160x3840 u8",
                                    lambda: kclahe.hist256_tiles(g4k, *geo4k),
                                    {"hist256_tiles": 1})
    if max_err(tiles4k, kclahe.tile_hists_plain(g4k, *geo4k)):
        raise AssertionError("hist256_tiles alone differs from its plain version")
    del tiles4k
    clahe_u16, launches_u16 = drive("clahe 2x2160x3840 u16", lambda: port.clahe(g_u16, 2.0, (8, 8)),
                                    {"tile_luts65536": 1, "clahe_blend": 1})
    # u16 stages A and B alone, on no path since tile_luts65536
    hists16, launches_h16 = drive("hist65536_tiles (stage A alone) 2x2160x3840 u16",
                                  lambda: kclahe.hist65536_tiles(g_u16, *geo4k),
                                  {"hist65536_tiles": 1})
    if max_err(hists16, kclahe.tile_hists_plain(g_u16, *geo4k)):
        raise AssertionError("hist65536_tiles alone differs from its plain version")
    luts16, launches_l16 = drive("clahe_lut S=65536 (stage B alone) 2x2160x3840 u16 tiles",
                                 lambda: kclahe.clahe_lut(hists16, geo4k[2] * geo4k[3], 2.0),
                                 {"clahe_lut": 1})
    if max_err(luts16, kclahe.tile_luts65536_plain(g_u16, *geo4k, 2.0)):
        raise AssertionError("clahe_lut alone differs from its plain version")
    del hists16, luts16
    med_u16, _ = drive("median_blur(5) 2x2160x3840 u16", lambda: port.median_blur(g_u16, 5),
                       {"median": 1})
    med_i16, _ = drive("median_blur(5) 2x2160x3840 i16", lambda: port.median_blur(g_i16, 5),
                       {"median": 1})

    def plain_config5(planes: torch.Tensor) -> torch.Tensor:
        return kconv.sep_conv_u8_plain(
            clahe_plain(kmedian.median_blur_plain(planes, 5), 2.0, (8, 8)), tv5, th5, 1.0)

    def plain_clahe_rgb(img: torch.Tensor) -> torch.Tensor:
        planes = img[0].permute(2, 0, 1).contiguous()
        return clahe_plain(planes, 2.0, (8, 8)).permute(1, 2, 0)[None]

    results = [("config 5 get_preset 2x2160x3840 u8", out5, g4k, plain_config5(g4k)),
               ("clahe 1x2160x3840x3 RGB u8", clahe_rgb, g_rgb, plain_clahe_rgb(g_rgb)),
               ("clahe 2x2160x3840 u16", clahe_u16, g_u16, clahe_plain(g_u16, 2.0, (8, 8))),
               ("median_blur(5) 2x2160x3840 u16", med_u16, g_u16,
                kmedian.median_blur_plain(g_u16, 5)),
               ("median_blur(5) 2x2160x3840 i16", med_i16, g_i16,
                kmedian.median_blur_plain(g_i16, 5))]
    for label, out, x, want in results:
        if out.shape != x.shape or out.dtype != x.dtype or out.device != x.device:
            raise AssertionError(f"{label}: output {tuple(out.shape)} {out.dtype} {out.device}")
        if out.float().std() == 0:
            raise AssertionError(f"{label}: output is constant")
        e = max_err(out, want)
        print(f"{label}: kernel path vs plain path on the card, max abs err {e}")
        if e:
            raise AssertionError(f"{label}: kernel path differs from the plain path")
    del results, want
    if len(streamed) != len(frames):
        raise AssertionError(f"stream_frames yielded {len(streamed)} of {len(frames)} batches")
    for i, (out, f) in enumerate(zip(streamed, frames)):
        e = max_err(out, pipe(on_card(f)))
        if e or out.device != dev:
            raise AssertionError(f"stream_frames batch {i}: {e} LSB from the direct call on {out.device}")
    print(f"stream_frames: {len(streamed)} batches equal the direct calls at 0 LSB")
    del streamed
    cpu_frame = pipe(torch.from_numpy(x4k[:1]))
    e = max_err(out5[:1].cpu(), cpu_frame)
    print(f"config 5 one 4K frame: card vs plain path on the CPU, max abs err {e}")
    if e:
        raise AssertionError("config 5 on the card differs from the CPU plain path")

    def stream_run() -> tuple[float, float]:
        """Device ms (CUDA events) and host ms for 8 batches through
        stream_frames from host NumPy, the H2D copies inside the window."""
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in port.stream_frames(pipe, frames, 2, device=dev):
            pass
        end.record()
        end.synchronize()
        return start.elapsed_time(end), (time.perf_counter() - t0) * 1e3

    stream_run()  # warm-up: pinned buffers, copy stream
    runs = sorted(stream_run() for _ in range(5))
    s_dev, s_host = runs[2]
    gpix = g4k.numel() / 1e9
    print(f"config 5 stream_frames 8x(2x2160x3840) u8 from host NumPy, depth 2: "
          f"{s_dev / len(frames):.4f} ms per batch on the device clock "
          f"({gpix * len(frames) / (s_dev / 1e3):.3f} GPix/s), {s_host / len(frames):.4f} ms "
          f"per batch on the host clock; median of 5 runs  [{smi}]")
    paths = [("config 5 get_preset 2x2160x3840 u8", g4k, lambda: pipe(g4k),
              lambda: plain_config5(g4k)),
             ("clahe 1x2160x3840x3 RGB u8", g_rgb, lambda: port.clahe(g_rgb, 2.0, (8, 8)),
              lambda: plain_clahe_rgb(g_rgb)),
             ("clahe 2x2160x3840 u16", g_u16, lambda: port.clahe(g_u16, 2.0, (8, 8)),
              lambda: clahe_plain(g_u16, 2.0, (8, 8))),
             ("median_blur(5) 2x2160x3840 u16", g_u16, lambda: port.median_blur(g_u16, 5),
              lambda: kmedian.median_blur_plain(g_u16, 5)),
             ("median_blur(5) 2x2160x3840 i16", g_i16, lambda: port.median_blur(g_i16, 5),
              lambda: kmedian.median_blur_plain(g_i16, 5))]
    for label, x, kfn, pfn in paths:
        (k_ms, k_iqr), (p_ms, p_iqr) = time_ms(kfn), time_ms(pfn, 5, 2)
        gpix = x.numel() / 1e9
        print(f"{label}: kernel path {k_ms:.4f} ms (IQR {k_iqr:.4f}) = "
              f"{gpix / (k_ms / 1e3):.3f} GPix/s, plain path {p_ms:.4f} ms (IQR {p_iqr:.4f}) = "
              f"{gpix / (p_ms / 1e3):.3f} GPix/s, max abs err 0  [{smi}]")
    clock = sm_clock_max_mhz()
    for name, g in (("u8", g4k), ("u16", g_u16), ("i16", g_i16)):
        for k in (3, 5):
            k_ms, k_iqr = time_ms(lambda: kmedian.median_blur(g, k))
            print(f"  median_blur({k}) {tuple(g.shape)} {name}: kernel {k_ms:.4f} ms (IQR "
                  f"{k_iqr:.4f}), bytes bound {bound_ms(2 * g.numel() * g.element_size())[0]:.4f} "
                  f"ms, issue floor {issue_floor_ms(k, g.numel(), clock):.4f} ms (SM clock "
                  f"{clock:.0f} MHz)  [{smi}]")

    # -- 6. bilateral and thresholds through the public functions ---------------
    del frames, g_rgb, g_u16, g_i16, out5, clahe_rgb, clahe_u16, med_u16, med_i16
    doc_pipe = port.make_pipeline([
        ("bilateral", {"d": 9, "sigma_color": 75.0, "sigma_space": 75.0}),
        ("adaptive_threshold", {"method": "gaussian", "block_size": 11, "C": 2.0}),
    ])

    def plain_bilateral(planes: torch.Tensor) -> torch.Tensor:
        return kbil.bilateral_gray_plain(planes, *tbil.bilateral_tables(9, 75.0, 75.0, 1,
                                                                        planes.device))

    def plain_athresh(planes: torch.Tensor) -> torch.Tensor:
        return kathr.adaptive_threshold_gaussian_plain(
            planes, tthr.gaussian_taps(11, planes.device), 255, 2, False)

    def plain_otsu(planes: torch.Tensor):
        hists = khist.hist256_plain(planes).cpu().numpy()
        ts = np.array([otsu_threshold(h, planes[0].numel()) for h in hists], dtype=np.int32)
        return ts.astype(np.float64), tthr.threshold_planes(planes, torch.from_numpy(ts))

    slice3 = [  # label, public call, expected launches, plain path
        ("bilateral_filter(9, 75, 75)", lambda x: port.bilateral_filter(x, 9, 75.0, 75.0),
         {"bilateral": 1}, plain_bilateral),
        ("adaptive_threshold(gaussian, binary, 11, 2)",
         lambda x: port.adaptive_threshold(x, 255.0, "gaussian", "binary", 11, 2.0),
         {"athresh": 1}, plain_athresh),
        ("threshold(otsu)", lambda x: port.threshold(x, method="otsu"), {"hist256": 1},
         plain_otsu),
        ("make_pipeline(bilateral -> adaptive_threshold)", doc_pipe,
         {"bilateral": 1, "athresh": 1}, lambda x: plain_athresh(plain_bilateral(x))),
    ]
    launches3, otsu_launches = {}, {}
    for label, fn, expect, plain in slice3:
        label = f"{label} 2x2160x3840 u8"
        out, got = drive(label, lambda: fn(g4k), expect)
        want = plain(g4k)
        cpu_out = fn(torch.from_numpy(x4k[:1]))
        if label.startswith("threshold"):
            (ret, out), (want_ret, want), (cpu_ret, cpu_out) = out, want, cpu_out
            if not np.array_equal(ret, want_ret) or cpu_ret[0] != want_ret[0]:
                raise AssertionError(f"{label}: thresholds {ret} (card), {cpu_ret} (CPU frame), "
                                     f"plain {want_ret}")
            print(f"{label}: Otsu thresholds {ret.tolist()} equal the plain path's")
        if out.shape != g4k.shape or out.dtype != torch.uint8 or out.device != dev:
            raise AssertionError(f"{label}: output {tuple(out.shape)} {out.dtype} {out.device}")
        if out.float().std() == 0:
            raise AssertionError(f"{label}: output is constant")
        e, e_cpu = max_err(out, want), max_err(out[:1].cpu(), cpu_out)
        print(f"{label}: kernel path vs plain path on the card, max abs err {e}; one 4K frame "
              f"vs the plain path on the CPU, max abs err {e_cpu}")
        if e or e_cpu:
            raise AssertionError(f"{label}: kernel path differs from the plain path")
        if "make_pipeline" in label:
            launches3 = got
        if label.startswith("threshold"):
            otsu_launches = got
    for label, fn, _, plain in slice3:
        (k_ms, k_iqr), (p_ms, p_iqr) = time_ms(lambda: fn(g4k)), time_ms(lambda: plain(g4k), 5, 2)
        gpix = g4k.numel() / 1e9
        print(f"{label} 2x2160x3840 u8: kernel path {k_ms:.4f} ms (IQR {k_iqr:.4f}) = "
              f"{gpix / (k_ms / 1e3):.3f} GPix/s, plain path {p_ms:.4f} ms (IQR {p_iqr:.4f}) = "
              f"{gpix / (p_ms / 1e3):.3f} GPix/s, max abs err 0  [{smi}]")

    # -- 7. the warp family -----------------------------------------------------
    import torch.nn.functional as F
    from imageenhancement_mp_tpu_torch.kernels import warp as kwarp
    from imageenhancement_mp_tpu_torch.ops import warp as twarp
    from imageenhancement_mp_tpu_torch.utils import warp_coords as wc

    before = dict(launch_counts)
    gen = torch.Generator(device=dev).manual_seed(0)
    n_warp, n_fields = 0, 0
    warp_borders = [("constant", bv) for bv in (9.0, 300.0)] + [("replicate", 0.0)]

    def check_warp(x: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor, what: str,
                   modes=(False, True)) -> None:
        """The kernel against its plain version: both modes, both borders
        (border values saturated as the ops saturate them)."""
        nonlocal n_warp
        for nearest in modes:
            for border, bv in warp_borders:
                b8 = int(twarp._border_value(torch.uint8, bv))
                check("warp_gather_u8", kwarp.warp_gather_u8(x, sx, sy, nearest, border, b8),
                      kwarp.warp_gather_u8_plain(x, sx, sy, nearest, border, b8),
                      f"{what} nearest={nearest} {border} {bv}")
                n_warp += 1

    def check_matrix(x: torch.Tensor, Mi, oh: int, ow: int, perspective: bool, what: str) -> None:
        """The matrix route (coordinates computed in the kernel) against the
        plain gather at the field built by torch: both modes, both borders."""
        nonlocal n_warp
        field = (twarp.perspective_field if perspective else twarp.affine_field)(Mi, oh, ow, dev)
        for nearest in (False, True):
            for border, bv in warp_borders:
                b8 = int(twarp._border_value(torch.uint8, bv))
                check("warp_gather_u8",
                      kwarp.warp_matrix_u8(x, Mi, oh, ow, perspective, nearest, border, b8),
                      kwarp.warp_gather_u8_plain(x, *field, nearest, border, b8),
                      f"matrix route {what} nearest={nearest} {border} {bv}")
                n_warp += 1

    def check_field(got, want_np, what: str) -> None:
        """A field built on the card against the host NumPy field, bit for bit."""
        nonlocal n_fields
        for g, w in zip(got, want_np):
            w = np.clip(w, -2e9, 2e9)
            if not np.array_equal(g.cpu().numpy(), w):
                bad = int((g.cpu().numpy() != w).sum())
                raise AssertionError(f"{what}: {bad} coordinates differ from the host field")
        n_fields += 1

    def rot(center, angle, scale):
        return wc.invert_affine(wc.get_rotation_matrix_2d(center, angle, scale))

    xw = rand_u8((2, 240, 320))
    oh, ow = 224, 300  # ow % 16 = 12: both the body and the tail of the field
    affines = {f"rot{a} x{s}": rot((160.0, 120.0), a, s)
               for a in (15.0, 31.0, -23.0) for s in (0.9, 1.1, 0.125)}
    affines["shear-translate"] = wc.invert_affine(np.array([[1.0, 0.3, -10.0], [0.1, 0.9, 5.5]]))
    homographies = {
        "homography mild": wc.invert_perspective(
            np.array([[1.0, 0.05, -5.0], [0.02, 0.98, 3.0], [2e-4, 1e-4, 1.0]])),
        "homography strong": wc.invert_perspective(
            np.array([[0.9, -0.2, 4.0], [0.15, 1.1, -2.0], [3e-3, -2e-3, 1.0]])),
        "homography zero denominator": np.array([[1.0, 0.0, 2.0], [0.0, 1.0, 1.0],
                                                 [1.0, 0.0, -5.0]]),
    }
    for name, Mi in affines.items():
        sx, sy = twarp.affine_field(Mi, oh, ow, dev)
        check_field((sx, sy), wc.warp_affine_coords_f32(Mi, oh, ow), f"affine field {name}")
        check_warp(xw, sx, sy, f"{name} 2x240x320 -> {oh}x{ow}")
        check_matrix(xw, Mi, oh, ow, False, f"{name} 2x240x320 -> {oh}x{ow}")
    for name, Mi in homographies.items():
        sx, sy = twarp.perspective_field(Mi, oh, ow, dev)
        check_field((sx, sy), wc.warp_perspective_coords_f32(Mi, oh, ow), f"field {name}")
        check_warp(xw, sx, sy, f"{name} 2x240x320 -> {oh}x{ow}")
        check_matrix(xw, Mi, oh, ow, True, f"{name} 2x240x320 -> {oh}x{ow}")
    # the matrix route's adversarial cases: corners past +-2e9, zero
    # denominators on a row and on a column, ow % 16 in {0, 1, 7, 15} (the
    # field's tail law), rows and columns across its 64 x 16 tiles
    far = {"far corners": (np.array([[3e6, 1e5, -1e9], [-2e5, 4e6, 7e8]]), False),
           "past the clip": (np.array([[2.5e8, -3e8, 1.9e9], [1e9, 2e9, -2.1e9]]), False),
           "far homography": (np.array([[3e6, 1e5, -1e9], [-2e5, 4e6, 7e8],
                                        [1e-3, -2e-3, 0.5]]), True),
           "zero denominator row": (np.array([[1.0, 0.0, 2.0], [0.0, 1.0, 1.0],
                                              [0.0, 1.0, -30.0]]), True)}
    for name, (Mi, persp) in far.items():
        check_matrix(xw, Mi, oh, ow, persp, f"{name} 2x240x320 -> {oh}x{ow}")
    for moh, mow in ((17, 16), (33, 17), (15, 23), (16, 31), (65, 47), (1, 1), (2, 95)):
        check_matrix(xw, affines["rot-23.0 x1.1"], moh, mow, False, f"rot-23 -> {moh}x{mow}")
        check_matrix(xw, homographies["homography strong"], moh, mow, True,
                     f"homography strong -> {moh}x{mow}")
    # the 4K rot15 field of the main path, and a 4K perspective field
    M15 = wc.get_rotation_matrix_2d((1920.0, 1080.0), 15.0, 1.0)
    Mi15 = wc.invert_affine(M15)
    check_field(twarp.affine_field(Mi15, 2160, 3840, dev),
                wc.warp_affine_coords_f32(Mi15, 2160, 3840), "affine field rot15 2160x3840")
    Mp4k = homographies["homography mild"]
    check_field(twarp.perspective_field(Mp4k, 2160, 3840, dev),
                wc.warp_perspective_coords_f32(Mp4k, 2160, 3840), "perspective field 2160x3840")
    for inverse in (False, True):
        for log in (False, True):
            dsize = (320, 240) if inverse else (200, 360)
            mx, my = twarp.polar_maps(240, 320, dsize, (150.0, 110.0), 140.0, log, inverse, dev)
            src = torch.cat([xw[:, -1:], xw, xw[:, :1]], dim=1).contiguous() if inverse else xw
            check_warp(src, mx, my, f"polar inverse={inverse} log={log}")
    mx = torch.rand((oh, ow), generator=gen, device=dev) * 328 - 4
    my = torch.rand((oh, ow), generator=gen, device=dev) * 248 - 4
    far = torch.rand((oh, ow), generator=gen, device=dev) < 0.05
    mx = torch.where(far, torch.where(my > 120, 3e9, -3e9), mx).contiguous()
    my = torch.where(torch.rand((oh, ow), generator=gen, device=dev) < 0.05,
                     torch.where(mx > 160, -3e9, 3e9), my).contiguous()
    check_warp(xw, mx, my, "random remap maps with +-3e9")
    for shape, out_hw in (((2, 1, 1), (3, 4)), ((2, 2, 3), (4, 5))):
        xs = rand_u8(shape)
        Mi = rot(((shape[2] - 1) / 2, (shape[1] - 1) / 2), 20.0, 0.7)
        check_warp(xs, *twarp.affine_field(Mi, *out_hw, dev), f"{shape} plane")
        check_matrix(xs, Mi, *out_hw, False, f"{shape} plane")
        check_matrix(xs, homographies["homography mild"], *out_hw, True, f"{shape} plane")
    xm = misaligned(xw)
    check_warp(xm, *twarp.affine_field(affines["rot31.0 x1.1"], oh, ow, dev), "offset 1")
    check_matrix(xm, affines["rot31.0 x1.1"], oh, ow, False, "offset 1")
    many = rand_u8((70000, 8, 8))
    check_warp(many, *twarp.affine_field(rot((3.5, 3.5), 31.0, 1.1), 8, 8, dev), "70000x8x8")
    check_matrix(many, rot((3.5, 3.5), 31.0, 1.1), 8, 8, False, "70000x8x8")
    check_matrix(many, homographies["homography strong"], 8, 8, True, "70000x8x8")
    tall = rand_u8((1, 2_200_000, 8))
    ty, tx = torch.meshgrid(torch.arange(2_200_000, dtype=torch.float32, device=dev),
                            torch.arange(8, dtype=torch.float32, device=dev), indexing="ij")
    tx, ty = tx.contiguous(), ty.contiguous()
    eye = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    for nearest in (False, True):
        got = kwarp.warp_gather_u8(tall, tx, ty, nearest, "constant", 0)
        check("warp_gather_u8", got, kwarp.warp_gather_u8_plain(tall, tx, ty, nearest), "1x2200000x8")
        check("warp_gather_u8", got, tall, "1x2200000x8 identity map against the input")
        got = kwarp.warp_matrix_u8(tall, eye, 2_200_000, 8, False, nearest, "constant", 0)
        check("warp_gather_u8", got, tall, "1x2200000x8 identity matrix against the input")
        n_warp += 2
    check_matrix(tall[:, :300_000], rot((3.5, 150_000.0), 0.5, 1.0), 300_000, 8, False,
                 "1x300000x8 rot0.5")
    del many, tall, tx, ty, xm
    big = torch.randint(0, 256, (1100, 1080, 1920), generator=gen, device=dev, dtype=torch.uint8)
    fb = twarp.affine_field(rot((960.0, 540.0), 15.0, 1.0), 1080, 1920, dev)
    Mb = rot((960.0, 540.0), 15.0, 1.0)
    Hb = homographies["homography mild"]
    fh = twarp.perspective_field(Hb, 1080, 1920, dev)
    for nearest in (False, True):
        check("warp_gather_u8", kwarp.warp_gather_u8(big, *fb, nearest)[-2:],
              kwarp.warp_gather_u8_plain(big[-2:], *fb, nearest), "1100x1080x1920, last planes")
        for border, bv in warp_borders:
            b8 = int(twarp._border_value(torch.uint8, bv))
            check("warp_gather_u8",
                  kwarp.warp_matrix_u8(big, Mb, 1080, 1920, False, nearest, border, b8)[-2:],
                  kwarp.warp_gather_u8_plain(big[-2:], *fb, nearest, border, b8),
                  f"matrix route 1100x1080x1920 rot15, last planes, {border} {bv}")
            check("warp_gather_u8",
                  kwarp.warp_matrix_u8(big, Hb, 1080, 1920, True, nearest, border, b8)[-2:],
                  kwarp.warp_gather_u8_plain(big[-2:], *fh, nearest, border, b8),
                  f"matrix route 1100x1080x1920 homography, last planes, {border} {bv}")
            n_warp += 2
        n_warp += 1
    del big, fb, fh
    torch.cuda.synchronize()
    if launch_counts["warp_gather_u8"] <= before["warp_gather_u8"]:
        raise AssertionError("warp_gather_u8: the comparison phase launched no kernel")
    print(f"warp_gather_u8 vs plain on the card: 0 LSB over {n_warp} cases (maps and matrix "
          f"routes); {n_fields} fields built on the card equal the host NumPy fields bit for bit")

    # the main paths through the public functions, each with counters of its own
    H4, W4 = 2160, 3840
    polar_args = ((1920, 2160), (1920.0, 1080.0), 1900.0)
    mx4 = (torch.rand((H4, W4), generator=gen, device=dev) * (W4 + 4) - 2).contiguous()
    my4 = (torch.rand((H4, W4), generator=gen, device=dev) * (H4 + 4) - 2).contiguous()
    twarp._polar_maps_cached.cache_clear()
    warp_paths = [  # label, public call, plain path on the card
        ("warp_affine rot15", lambda x: port.warp_affine(x, M15, (H4, W4)),
         lambda x: kwarp.warp_gather_u8_plain(x, *twarp.affine_field(Mi15, H4, W4, x.device))),
        ("warp_perspective", lambda x: port.warp_perspective(x, Mp4k, (H4, W4), inverse_map=True),
         lambda x: kwarp.warp_gather_u8_plain(x, *twarp.perspective_field(Mp4k, H4, W4, x.device))),
        ("warp_polar((1920, 2160), (1920, 1080), 1900)", lambda x: port.warp_polar(x, *polar_args),
         lambda x: kwarp.warp_gather_u8_plain(x, *twarp.polar_maps(
             H4, W4, *polar_args, False, False, x.device))),
        ("remap linear, random maps", lambda x: port.remap(x, mx4.to(x.device), my4.to(x.device)),
         lambda x: kwarp.warp_gather_u8_plain(x, mx4, my4)),
    ]
    warp_launches = None
    for label, fn, plain in warp_paths:
        label = f"{label} 2x2160x3840 u8"
        out, got = drive(label, lambda: fn(g4k), {"warp_gather_u8": 1})
        if warp_launches is None:
            warp_launches = got
        want = plain(g4k)
        if out.dtype != torch.uint8 or out.device != dev or out.shape[0] != 2:
            raise AssertionError(f"{label}: output {tuple(out.shape)} {out.dtype} {out.device}")
        if out.float().std() == 0:
            raise AssertionError(f"{label}: output is constant")
        e, e_cpu = max_err(out, want), max_err(out[:1].cpu(), fn(torch.from_numpy(x4k[:1])))
        print(f"{label}: kernel path vs plain path on the card, max abs err {e}; one 4K frame "
              f"vs the plain path on the CPU, max abs err {e_cpu}")
        if e or e_cpu:
            raise AssertionError(f"{label}: kernel path differs from the plain path")

    # time: the kernel alone on the main path's matrix route (rot15) and on
    # the maps route at the same field, the map build alone, each path
    f15 = twarp.affine_field(Mi15, H4, W4, dev)
    (k_ms, k_iqr) = time_ms(lambda: kwarp.warp_matrix_u8(g4k, Mi15, H4, W4))
    (p_ms, p_iqr) = time_ms(lambda: kwarp.warp_matrix_u8_plain(g4k, Mi15, H4, W4), 5, 2)
    ms["warp_gather_u8"] = (k_ms, p_ms)
    print(f"  warp_gather_u8 at (2, 2160, 3840) rot15 linear, matrix route: kernel {k_ms:.4f} ms "
          f"(IQR {k_iqr:.4f}), plain {p_ms:.4f} ms (IQR {p_iqr:.4f}), bound "
          f"{bound_ms(2 * 2 * H4 * W4)[0]:.4f} ms (bytes)  [{smi}]")
    for label, fn in (("matrix route, nearest", lambda: kwarp.warp_matrix_u8(
                          g4k, Mi15, H4, W4, False, True)),
                      ("matrix route, mild homography", lambda: kwarp.warp_matrix_u8(
                          g4k, Mp4k, H4, W4, True)),
                      ("maps route at the rot15 field", lambda: kwarp.warp_gather_u8(g4k, *f15))):
        t_ms, t_iqr = time_ms(fn)
        print(f"  warp_gather_u8 at (2, 2160, 3840) {label}: kernel {t_ms:.4f} ms (IQR "
              f"{t_iqr:.4f})  [{smi}]")
    b_ms, b_iqr = time_ms(lambda: twarp.affine_field(Mi15, H4, W4, dev))
    print(f"  affine field build rot15 2160x3840 on the card: {b_ms:.4f} ms (IQR {b_iqr:.4f})"
          f"  [{smi}]")
    firsts = []
    for _ in range(3):
        twarp._polar_maps_cached.cache_clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        port.warp_polar(g4k, *polar_args)
        torch.cuda.synchronize()
        firsts.append((time.perf_counter() - t0) * 1e3)
    print(f"  warp_polar first call (host map build, copy, kernel): median of 3 "
          f"{statistics.median(firsts):.4f} ms on the host clock {[round(t, 4) for t in firsts]}"
          f"  [{smi}]")
    xf = g4k.float()[:, None]
    grid = torch.stack((f15[0] * (2 / (W4 - 1)) - 1, f15[1] * (2 / (H4 - 1)) - 1), -1)
    grid = grid[None].expand(2, H4, W4, 2).contiguous()
    gs_ms, gs_iqr = time_ms(lambda: F.grid_sample(xf, grid, mode="bilinear",
                                                  padding_mode="zeros", align_corners=True))
    print(f"  yardstick, not the same function: torch grid_sample bilinear on f32 "
          f"[2, 1, 2160, 3840] at the rot15 grid (no cv2 rounding, f32 in and out) "
          f"{gs_ms:.4f} ms (IQR {gs_iqr:.4f})  [{smi}]")
    del xf, grid
    out_px = {"warp_affine rot15": 2 * H4 * W4, "warp_perspective": 2 * H4 * W4,
              "warp_polar": 2 * 2160 * 1920, "remap": 2 * H4 * W4}
    path_bounds = {"warp_affine rot15": bound_ms(2 * 2 * H4 * W4)[0],
                   "warp_perspective": bound_ms(2 * 2 * H4 * W4)[0],
                   "warp_polar": bound_ms(2160 * 1920 * (8 + 2) + 2 * H4 * W4)[0],
                   "remap": bound_ms(6 * 2 * H4 * W4)[0]}
    for (label, fn, plain), key in zip(warp_paths, out_px):
        (k_ms, k_iqr), (p_ms, p_iqr) = time_ms(lambda: fn(g4k)), time_ms(lambda: plain(g4k), 5, 2)
        gpix = out_px[key] / 1e9
        print(f"{label} 2x2160x3840 u8: kernel path {k_ms:.4f} ms (IQR {k_iqr:.4f}) = "
              f"{gpix / (k_ms / 1e3):.3f} GPix/s (output pixels), plain path {p_ms:.4f} ms "
              f"(IQR {p_iqr:.4f}) = {gpix / (p_ms / 1e3):.3f} GPix/s, bound "
              f"{path_bounds[key]:.4f} ms (bytes), max abs err 0; " + busy_share(lambda: fn(g4k))
              + f"  [{smi}]")

    # -- 8. bounds and library calls at the timed shapes ------------------------
    B8, n8, n5 = x8.shape[0], x8.numel(), 2 * H4 * W4
    T5 = 2 * geo5[0] * geo5[1]
    tab5 = sum(t.numel() * t.element_size() for t in tables5)
    n_off = bil9[0].shape[0]
    bounds = {
        "hist256": bound_ms(n8 + B8 * 256 * 4),
        "equalize_lut256": bound_ms(B8 * 256 * 4 + B8 * 256),
        "apply_lut256": bound_ms(2 * n8 + B8 * 256),
        # the integer conv has no rate in the table; the f32 epilogue is 2 FMAs
        "sep_conv_u8": bound_ms(2 * n8 + B8 * 256, 4.0 * n8),
        "median": bound_ms(2 * n5),  # integer min/max only
        "hist256_tiles": bound_ms(n5 + T5 * 256 * 4),
        "clahe_lut": bound_ms(T5 * 256 * 4 + T5 * 256),
        "clahe_blend": bound_ms(2 * n5 + T5 * 256 + tab5, 9.0 * n5),
        # per disc offset a weight product, num += w*v (2) and den += w; one divide
        "bilateral": bound_ms(2 * n5 + n_off * 12 + 256 * 4, (4.0 * n_off + 1) * n5),
        # block 11: the f32 screen's 11 FFMAs in each of the two passes, and the
        # f64 recompute (2k^2 + 2k operations) of the pixels this run's data needs
        "athresh": max(bound_ms(2 * n5 + 11 * 8),
                       ((44.0 * n5 / PEAK_OPS_PER_S["f32"]
                         + 264.0 * ath_recomputed / PEAK_OPS_PER_S["f64"]) * 1e3, "operations")),
        # the main path's matrix route: source once, output once (the maps
        # route adds 8 B of map per output pixel: 0.0297 ms); 9 f32 ops per
        # output pixel
        "warp_gather_u8": bound_ms(2 * n5, 9.0 * n5),
        "hist65536_tiles": b16_hist,
        "tile_luts65536": b16_fused,
        # the fused kernels: the planes read once, the LUT rows written once
        "hist256_lut": bound_ms(n8 + B8 * 256),
        "tile_luts256": bound_ms(n5 + T5 * 256),
    }
    for name, floor in (("bilateral", bil_floor), ("athresh", ath_floor)):
        print(f"  {name} at 2x2160x3840: kernel {ms[name][0]:.4f} ms, bound {bounds[name][0]:.4f} ms "
              f"({bounds[name][1]}), issue floor {floor:.4f} ms  [{smi}]")
    library = dict.fromkeys(ALL_KERNELS)
    idx_h = (x8.view(B8, -1).long() + 256 * torch.arange(B8, device=dev)[:, None]).view(-1)
    if not torch.equal(torch.bincount(idx_h, minlength=256 * B8).view(B8, 256).int(), h8):
        raise AssertionError("torch.bincount over plane-offset indices differs from hist256")
    library["hist256"] = time_ms(lambda: torch.bincount(idx_h, minlength=256 * B8))[0]
    idx_l = x8.view(B8, -1).long()
    if not torch.equal(torch.gather(l8, 1, idx_l).view_as(x8), khist.apply_lut256(x8, l8)):
        raise AssertionError("torch.gather with the LUTs differs from apply_lut256")
    library["apply_lut256"] = time_ms(lambda: torch.gather(l8, 1, idx_l))[0]
    library["hist256_tiles"] = tiles_library_ms
    library["hist65536_tiles"] = u16_library_ms
    # no one PyTorch call builds an equalize or CLAHE LUT (library_ms null
    # for the fused kernels); a yardstick: torch.bincount and the plain LUT
    yard_ms = time_ms(lambda: khist.equalize_lut256_plain(
        torch.bincount(idx_h, minlength=256 * B8).view(B8, 256).int(), n8 // B8))[0]
    print(f"  yardstick for hist256_lut, not a kernel of the port: torch.bincount on int64 "
          f"indices made beforehand and the plain equalize LUT {yard_ms:.4f} ms  [{smi}]")
    del idx_h, idx_l
    for name in ("hist256", "hist256_tiles", "apply_lut256"):
        print(f"  library call for {name}: {library[name]:.4f} ms (one torch call on int64 "
              f"indices made beforehand)  [{smi}]")

    # -- 9. colour conversion and non-local means: take_table ------------------
    take_launches = colour_and_nlmeans(port, dev, smi, gen, on_card, misaligned, check, drive,
                                       clahe_plain, ms, bounds, library)

    # -- 10. the LUT family, config 2 and the fused median -> unsharp ----------
    lut_launches = lut_family_and_fused(port, dev, smi, gen, on_card, misaligned, check, drive,
                                        ms, bounds, library)

    # -- 11. the filters, sep_conv_u8's wide instance and config 3 ------------
    config3_launches = filters_and_config3(port, dev, smi, on_card, misaligned, check, drive)
    print(f"config 3's four paths launched sep_conv_u8 {config3_launches['sep_conv_u8']} times")

    # -- 12. morphology, filter2D, pyramids, resize, Canny, matching, the
    # point functions; median_unsharp past 31 taps; the inspection chain
    geometry_and_inspection(port, dev, smi, on_card, misaligned, check, drive)

    # -- 13. arithmetic, statistics, corners, optical flow, CamShift and
    # mean-shift segmentation
    arith_stats_and_tracking(port, dev, smi, on_card, drive)

    # -- 14. the photo module: domain-transform filters, the HDR bracket,
    # decolor, TV-L1, phase correlation, seamless clone, inpaint
    photo_and_hdr(port, dev, smi, on_card, drive)

    # -- 15. distanceTransform, floodFill, the Hough transforms, findContours
    # and the shape descriptors
    contours_and_shapes(port, dev, smi, on_card, drive)

    # -- 16. the entry points: the selftest, the CLI's batch and single-image
    # modes, card against CPU
    entry_points(smi, drive)

    # -- 17. the mesh: batch and row sharding, the pooled hist-eq, the spatial
    # twins (the geometry twins too) and stream_frames(mesh=), four shards on
    # the one card
    row0_err, mesh_launches = mesh_sharding(smi, drive, dev)
    err["warp_gather_u8"] = max(err["warp_gather_u8"], row0_err)

    # -- 18. the port's clock (profiling.py): CUDA-graph chains held to eager
    # and CPU chains, and every clock of the four main paths beside the bound
    the_clock(smi, dev)

    # each kernel's launches from the path that runs it: the first main path's
    # three calls for its three kernels, get_preset's config 5 call for the
    # config 5 kernels, the bilateral -> adaptive_threshold pipeline for
    # bilateral and athresh, Otsu for hist256, the mesh's pooled equalize_hist
    # (four shards) for equalize_lut256, u16 clahe for tile_luts65536,
    # hist256_tiles, hist65536_tiles and clahe_lut driven alone, the
    # warp_affine rot15 call for warp_gather_u8, cvt_color rgb2lab for
    # take_table, phase 10's paths for its three kernels
    path_launches = {**{n: launches5[n] for n in CONFIG5_KERNELS},
                     **launches, **{n: launches3[n] for n in SLICE3_KERNELS},
                     "hist256": otsu_launches["hist256"],
                     "hist256_tiles": launches_tiles["hist256_tiles"],
                     "clahe_lut": launches_l16["clahe_lut"],
                     "hist65536_tiles": launches_h16["hist65536_tiles"],
                     "tile_luts65536": launches_u16["tile_luts65536"],
                     **{n: warp_launches[n] for n in WARP_KERNELS},
                     **{n: take_launches[n] for n in TAKE_KERNELS}, **lut_launches,
                     "equalize_lut256": mesh_launches["equalize_lut256"]}
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    summary = {"kernels": [
        {"name": n, "route": "cuda", "source": SOURCES[n], "replaces": REPLACES[n],
         "launches": path_launches[n], "max_abs_err": err[n], "ms": ms[n][0],
         "plain_ms": ms[n][1], "bound_ms": bounds[n][0], "bound_by": bounds[n][1],
         "library_ms": library[n]}
        for n in ALL_KERNELS]}
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()}}))

if __name__ == "__main__":
    main()
