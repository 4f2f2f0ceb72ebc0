#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (iqwaveform_torch) on one card.

    python3 chip_smoke.py

It builds the CUDA kernels from iqwaveform_torch/csrc (into
build/iqwaveform_torch/), then, at the flagship WidebandMonitor design
(bench.py:83-109: 122.88 -> 61.44 MS/s, 40 MHz passband, hamming COLA
16384 -> 8192, 16 x 256-point channelizer, 2048-edge APD with navg 16):

1. holds each kernel against its plain PyTorch version on the card, at the
   shapes the step gives it (OLA on 2^24 samples, channelizer statistics
   on the 2^23 resampled samples, the histogram on the 524,288 binned
   samples); the 2:1 OLA kernel of this pair (the register-resident
   ``fused_ola_reg_kernel``) also against the radix-2 ``fused_ola_kernel``
   it replaces here, and both, on the first 512 frames, against the plain
   version in complex128 (its error at most twice the radix-2 kernel's);
   the same for the channelizer statistics kernel of this size
   (``chan_stats_reg_kernel``) against the radix-2 ``chan_stats_kernel``,
   on each of its four outputs; the histogram through its bucket-table
   kernel (``hist_bucket_kernel``); ptxas must report no spill in the
   register-resident channelizer, levels and dB kernels, the column-pair
   counter, the bucket-table histogram, the cluster frame kernel, the
   channel-only channelizer, the mixed-size and cluster channelizer
   statistics kernels or the CP correlation's ring kernel, at any of their
   instances;
2. drives the full ``step`` on 2^24 complex64 samples: each kernel's
   launch count must rise, the OLA, channelizer and histogram route counts
   must name ``fused_ola_reg_kernel``, ``chan_stats_reg_kernel`` and
   ``hist_bucket_kernel``, the profile must hold those and no
   ``fused_ola_kernel``, ``chan_stats_kernel`` or older ``hist_kernel``,
   no cuFFT or cuBLAS kernel may run, and the outputs must match the
   plain-version step on the card and the CPU step on a short input;
3. times the step and each kernel with CUDA events (median of REPS runs
   after warm-up), beside the kernel's bound, its plain version and, where
   one exists, the PyTorch call that computes the same function; the OLA,
   channelizer and histogram rows also time the older kernels
   (``generic_ms``), the histogram's also their device times and both
   wrappers' host times;

then, at BASELINE config #3 (bench.py:312-325: streaming persistence
spectrum + detector-binned APD, nfft 1024 'hann', 1024 histogram bins over
(-150, 50) dB, chunks of 2^24 samples, apd_navg 16, 512 APD edges):

4. over 2^30 samples of (2, n) float32 planes made on the card (64
   distinct chunks): (a) on chunk 0, the levels, column-count and APD
   kernels against their plain versions, the column counter of this size
   (``colhist_reg_kernel``) also against the older ``colhist_kernel``
   (equal counts), and on its first 512 frames the
   levels kernel of this size (the register-resident
   ``spectrogram_levels_reg_kernel``) and the radix-2 body it replaces
   here against the plain version in float64 (its RMS error of mean and
   max of dB at most twice the radix-2 body's); (b) the fold of the first
   4 chunks against the plain-version fold; (c) the fold of all 64 chunks
   through ``persistence_apd_fold``, which must launch each of those three
   kernels exactly 64 times, the levels kernel, the column counter and the
   histogram on their new routes each time, then
   ``persistence_finalize``; (d) a profile of one chunk's fold, which must
   hold ``spectrogram_levels_reg_kernel``, ``colhist_reg_kernel`` and
   ``hist_bucket_kernel`` and no radix-2 ``spectrogram_kernel``, older
   ``colhist_kernel`` or older ``hist_kernel`` and may show
   no cuFFT / cuBLAS / CUTLASS kernel, and the fold's host time per chunk
   split by wrapper and by the carry's torch ops; (e) the 1 GS time, and
   the device-busy share of one chunk; the levels kernel, the column
   counter and the histogram are timed beside the older kernels
   (``generic_ms``);
5. the public ``streaming_persistence_spectrum`` on 4 chunks plus a
   131072-multiple tail and 3072 samples that its rules drop, against the
   plain path, and the public ``streaming_apd`` on the same capture (one
   launch of ``hist_bucket_kernel`` a chunk and the tail), equal to the
   plain path;
6. the unfused path (2048 histogram bins: ``spectrogram_dB`` through the
   register-resident ``spectrogram_db_reg_kernel`` at nfft 1024, within
   1e-3 dB of the plain version and of the radix-2 body, its float64 error
   on the first 512 frames at most twice the radix-2 body's; the column
   counter on float values, equal to bincount and to the older counter) on
   one chunk, against the plain path; the unfused fold of the chunk timed
   through this route and, in turns, through the radix-2 body, and
   profiled;
7. the stats-only design (BASELINE config #1, hist_bins=0) on one chunk,
   against the plain path;

then the filtering path of BASELINE config #2 (bench.py:457-555: a 100 Ms
capture at 61.44 MS/s) and the monitor beyond 2:1 overlap:

8. the public ``ola_filter`` (nfft 16384 -> 8192, hamming, passband
   +-10 MHz) on 99,999,744 complex64 samples of noise made on the card: one
   launch of the frame-batch OLA kernel, through its register-resident
   instance for this size (``fused_ola_frames_reg_kernel``), the output
   against the plain route on the card and, on its first 2^22 samples, the
   torch.fft stage chain; timed (median of 10 calls, MS/s) and profiled
   (that kernel, and no generic frame kernel, cuFFT, cuBLAS or cuDNN
   kernel); the frame kernel alone against its plain version, and on the
   first 512 frames, with the generic ``fused_ola_frames_kernel``, against
   the plain chain in complex128 (its error at most twice the generic
   kernel's), each timed;
9. the public ``upfirdn`` with the 4001-tap ``design_fir_lpf(20e6,
   61.44e6)`` at up/down 1/2 and 2/3 on 10^8 samples: one launch each, of
   the register-windowed ``upfirdn_reg_kernel`` (route counts), against
   the plain float32 conv1d (TF32 off), its first 2^20 outputs against a
   float64 conv on the card (its error at most twice that of the generic
   ``upfirdn_kernel`` it replaces there), the kernel, the generic kernel
   and the conv timed;
10. ``WidebandMonitor.step`` at the blackman COLA design (30.72 -> 15.36
   MS/s, nfft 12288 -> 6144, R=3) on 16,785,408 samples: launches (the
   register-resident frame kernel, ``chan_stats_reg_kernel`` and
   ``hist_bucket_kernel``, no ``chan_stats_kernel`` or older ``hist_kernel``
   in the profile), the step against ``reference_step`` with phase 3's
   gates, timed, profiled; the frame kernel as in phase 8; the histogram
   at the step's shape (8,392,704 samples, 2048 edges) against its plain
   version, timed beside its bound and the older kernel, and on a row of
   one bin;

then the OFDM path on 1 s of a 20 MHz LTE / 5G-NR (15 kHz) capture at
30.72 MS/s made on the card (QPSK on 1201 subcarriers, CP 160 / 144, noise
20 dB below the signal), and ``channelize_power`` at BASELINE config #4:

11. ``corr_at_indices`` at ``Phy3GPP(20e6).index_cyclic_prefix(frames=
   range(100))`` (14,000 rows of 144) on the capture delayed by 700
   samples: one kernel launch per call, through the ring kernel
   (``corr_ring_kernel``, its partials folded by ``corr_fold_kernel``),
   the table's structure checked at its first call and never again, norm
   on and off within 2e-5 of the plain version, the peak at the planted
   lag, the ring kernel also on ``x[1:]`` and on captures cut short of
   their last windows against the plain version, no library kernel in its
   profile, timed, with the host time a call; with ``--parent DIR`` (a
   tree of an earlier commit, such as a ``git archive`` of it), the same
   call through DIR's package timed in turns with this one (``generic_*``
   of the kernels-line row; ``corr_times``);
12. ``BasebandClockSynchronizer(20e6)`` on that capture squeezed by 31
   samples: it converges and corrects 31 +- 1 samples, timed;
13. ``SymbolDecoder(20e6)`` on the clean capture: the card's decode
   against the CPU's and against the planted QPSK, MS/s;
14. ``CellSearch(30.72e6, 15e3)`` on 20 ms with a PSS / SSS planted for
   cell 635: the cell and offset found exactly, timed;
15. ``channelize_power`` on 4 x 9,994,240 samples of noise, 64 channels of
   192 of 256 bins, hamming: one launch of the channel-only channelizer
   kernel at 16384 points (``chan_power_reg_kernel``, alone in its
   profile, with no ``chan_stats_kernel``), within 1e-5 of its plain
   version and of the radix-2 kernel, its complex128 error on the first
   512 frames at most twice the radix-2 kernel's, the per-capture
   statistics of bench.py, no library kernel in its profile, timed beside
   the radix-2 kernel;

then the monitor at frames above one block's shared memory, on the frame
kernel's cluster route (``fused_ola_frames_cluster_kernel``: one frame on
a thread-block cluster of C blocks):

16. (a) the cluster kernel at each compiled pair (32768 -> 8192 and
   16384, 40960 -> 40960, 49152 -> 24576,
   81920 -> 40960, 98304 -> 24576 on 6 blocks, and the two of 24576) on
   64 frames: one launch on its route, within 1e-5 of the plain chain, its
   complex128 error at most twice the plain chain's, and the clusters of
   it the card holds at once (``cudaOccupancyMaxActiveClusters``);
   (b) ``WidebandMonitor.step`` at the blackmanharris design of the
   flagship rates (81920 -> 40960, R = 5) on 16,793,600 samples: one
   cluster launch, the step gates of phase 3 against ``reference_step``;
   (c) the path: ``WidebandMonitor.step`` at the blackman design of the
   flagship rates (``design_wideband_monitor(122.88e6, 61.44e6, bw=40e6,
   fs_sdr=122.88e6, window='blackman')``: 49152 -> 24576 at R = 3, a 16 x
   256 channelizer at navg 1, 2048 APD edges) on 2^24 samples: one launch
   each of the cluster kernel, ``chan_stats_reg_kernel`` and
   ``hist_bucket_kernel`` (route counts), no other frame kernel and no
   cuFFT / cuBLAS / cuDNN kernel in its profile, phase 3's gates against
   ``reference_step`` and the CPU step on a short input, timed (median of
   20 after 3 warm-ups) with the device time by kernel; the cluster kernel
   on the step's 1024 frames against the plain chain, its first 512 frames
   against complex128 (at most twice the plain chain's error), timed
   beside its bound, the plain chain and the torch.fft chain (its library
   call); (d) ``WidebandMonitor.step`` at the blackman design of 122.88 ->
   30.72 MS/s (98304 -> 24576 on clusters of 6 blocks) on 16,809,984
   samples (171 min_input_multiple()s): launches and routes, phase 3's
   gates against ``reference_step``, timed and profiled, the kernel on the
   step's frames as in (c) (kernels-line row ``fused_ola_frames_cluster6``;
   the blackmanharris design there, 163840 -> 40960, runs on the split
   route since it beat the cluster of 10 blocks: phase 22b);

then the channelizer statistics at every frame size of ``CHAN_SIZES``
(1024-65536 points, 2^a 3^b 5^c with 2^a >= 1024 and b, c <= 1):

17. (a) each size on 2^23 samples of noise, 24 channels, in the monitor's
   statistics mode (navg 16) and the channel-only mode: one launch on its
   route (``chan_stats_mixed_kernel`` at one block's sizes,
   ``chan_stats_cluster_kernel`` on a cluster above them and for 15360's
   statistics, ``chan_power_reg_kernel`` channel-only at one block's
   sizes, ``chan_stats_reg_kernel`` at 4096 / navg 16), every output
   within 1e-5 of the plain version, the channel power's complex128 error
   at most twice the plain version's (the other outputs' reported), timed
   beside the torch.fft formulation, the radix-2 kernel at the powers of
   two and, at 4096, the mixed-size kernel; (b) ``WidebandMonitor.step``
   of the flagship rates at 48, 96 and 64 x 512 channels (12288-, 24576-
   and 32768-point channelizers) on whole min_input_multiple()s near 2^24:
   launches and routes, phase 3's gates against ``reference_step``, the
   profile (the 2:1 OLA, channelizer and histogram kernels, no radix-2 or
   library kernel), timed; the channelizer on the 48- and 96-channel
   steps' streams (kernels-line rows ``chan_stats_mixed`` and
   ``chan_stats_cluster``); (c) ``channelize_power`` at 48 channels of 192
   of 256 bins (12288 points) on 610 frames: one launch of the channel-only
   kernel (``chan_power_reg_kernel<12288>``), within 1e-5 of the plain
   version, timed (row ``chan_power_reg_12288``).

then the monitor's long-capture path on row 1's full contract
(``fused_ola_strided``: (2, N) planes of float32, int16 or bfloat16, a
halo, the tail), at the flagship design:

18. (a) ``fused_ola_strided`` on 2^24 samples (2048 frames) with a halo:
   float32 planes against ``fused_ola`` on the same complex64 samples
   (no halo), int16 counts against float32 planes of the same integers
   (2e-5 of the largest value); (b) ``step_planes`` at the float32, 'i16'
   and 'bf16' tiers (input_scale 2^-15) on 2^24 samples of planes made on
   the card: one launch each of the register 2:1 kernel on that input
   type, the channelizer and the histogram, phase 3's gates against
   ``reference_step`` on the same values, timed; the 'i16' step profiled
   (the register kernel, no radix-2 or library kernel); each tier's kernel
   against its plain version with the output and tail, timed beside its
   bound (rows ``fused_ola_strided_f32``, ``_i16``, ``_bf16``); (c)
   ``accumulate_step`` / ``flush`` over 8 chunks of 2^24 complex64 samples
   against one ``step`` on their 2^27 samples (apd_counts equal, the JAX
   stream test's bar on every bin), then 64 chunks (2^30 samples) timed,
   one launch of rows 1, 5 and 6 a chunk, one chunk profiled (its idle
   share; row ``fused_ola_strided``); (d) the same stream from a 1 GiB
   ci16 file written with numpy under ``build/`` (deleted after) through
   ``io.CapturePrefetcher`` in plane mode, each chunk unpacked on the card:
   MS/s with the reads, the host ms a chunk, the idle share, and equal
   statistics to the same samples streamed from the card; (e)
   ``apd_kernel='packed'`` at the blackman step (8,392,704 binned samples,
   2049 levels): one ``colhist_reg_kernel`` launch and no histogram
   kernel, totals equal to ``hist``'s, cumulative counts within 2 of
   ``hist``'s on the first 2^19 samples (the JAX bar at its test's size)
   and, on all, within three times the drift of the JAX package's float32
   rule run in numpy on the same samples, the route equal to its plain
   version, timed beside ``hist_bucket_kernel``
   (row ``colhist_packed_apd``); (f) ``profile_step`` on the flagship
   step, its report printed. ptxas must report no spill in
   ``fused_ola_reg_kernel`` at any input type;

then BASELINE config #1 (bench.py:212-251 and :399-455) on 2^24 complex64
samples of a tone + noise 10 dB below it at 122.88 MS/s, made on the card,
nfft 1024 hann:

19. (a) ``spectrogram`` against a float64 numpy / scipy spectrogram of the
   same samples (1e-5 relative RMS; freqs and times exactly),
   ``iq_to_bin_power`` (Tbin = 1024 Ts; mean, peak, 0.5) against float64,
   ``sample_ccdf`` on the envelope power with 513 edges: one launch of
   ``hist_bucket_kernel``, counts equal to ``hist_plain``'s and summing to
   n; (b) ``power_spectral_density`` at its default (statistics mean, max,
   0.5, 0.95, 0.99): one launch of ``spectrogram_db_reg_kernel``, held
   against float64, the 'xla' route and the CPU on the first 2^20 samples
   (1e-3 dB within 40 dB of the spectrum's level, the float32 FFT bound in
   linear power below it), its peak device memory; (c)
   ``quantile_method='histogram'`` at 1024 bins (one launch each of
   ``spectrogram_levels_reg_kernel`` and ``colhist_reg_kernel``) and 2048
   bins (``spectrogram_db_reg_kernel`` and ``colhist_reg_kernel`` on
   values): the named rows at (b)'s gate, the quantiles within 2 bins of
   (b)'s and 1 bin of the CPU's; (d) each call timed (MS/s against the
   122.88 MS/s real-time rate), four profiled (no library FFT and no older
   kernel; idle shares), the largest capture the default PSD holds on the
   card; rows 6-10 of the kernels line gain ``baseline1``: this path's
   launches a call and its kernel at this path's shapes against its plain
   version, timed beside its bound and profiled.

then the sharded layer (``iqwaveform_torch.parallel``: ``time_mesh``, the
sharded entry points, ``WidebandMonitor.sharded_step``) on a one-rank NCCL
process group and a one-rank time mesh:

21. (a) ``sharded_step`` at the flagship design, at the blackman design of
   the flagship rates (49152 -> 24576 on clusters of 3) and with
   ``apd_kernel='packed'`` on 2^24 samples: ``torch.equal`` to ``step`` on
   the same block on every output (no exchange on one rank, three
   all-reduces, no all-gather), one launch each of the step's kernels,
   timed beside ``step``; (b) the flagship rank body (``_shard_body``) on
   4 contiguous shards of that capture in one process, each shard's halo
   and incoming tail cut from its neighbours, the statistics combined as
   the collectives merge them: phase 3's gates against ``step``; (c)
   ``sharded_psd_stats`` on phase 19's capture (mean, max, 0.5, 0.95, 0.99)
   with and without ``exact_quantiles``: one ``spectrogram_db_reg_kernel``
   launch, the named rows ``torch.equal`` to the same dB's and within the
   PSD gate of ``power_spectral_density``, the exact quantiles
   ``torch.equal`` to ``_quantile`` of the same dB, the histogram's within 2
   bins, timed; (d) ``sharded_ola_filter`` at BASELINE #2 (99,999,744
   samples), 'xla' (no kernel) and 'mxu' (one launch of the frame kernel),
   within 1e-5 of ``ola_filter`` and, on the first 2^22 outputs, of the
   plain chain in complex128, timed beside ``ola_filter``; (e)
   ``sharded_apd_histogram`` on 2^24 samples x 513 edges: one
   ``hist_bucket_kernel`` launch, counts and CCDF equal to
   ``sample_ccdf``'s, timed; (f) the monitor at the designs an older kernel
   refused (135168 -> 24576 frames, 48 x 768 channels, 40,000 APD edges):
   it constructs and steps, the stage on its phase-25 route (the split
   frames, the channelizer's split route, the histogram's slices) with one
   launch of its kernel, and at one the JAX kernel refuses too (navg 256
   at 12288 points) the stage's route is 'plain' and its kernel never
   launches; each within phase 3's gates of ``reference_step`` and of the
   CPU step on one ``min_input_multiple()``. Each
   kernel these paths launch gains a ``sharded`` entry on its kernels-line
   row (launches and ms by path).

then the frames of the 122.88 MS/s monitor grid above one block that no
cluster pair takes, and the grid's pairs that ran the older bodies:

22. (d) the OLA route of each of the grid's 36 designs (output rate 61.44,
   40.96, 30.72 or 15.36 MS/s; hamming, blackman or blackmanharris;
   ``min_fft_size`` 4095, 8191 or 16383; bw = inf and 0.66 of the output
   rate) on the card: every one 'reg', 'cluster' or 'split', the 25 split
   pairs among them; the ptxas lines of the split kernels and the new
   instances, each source's nvcc seconds; (a) the split route
   (``csrc/ola_split.cu``) at each split pair on 8 frames of a strided
   capture: one 'split' launch, within 1e-5 of the plain chain, its
   complex128 error at most twice the chain's, timed beside the
   ``torch.fft`` chain and its bound at 65536 -> 16384, 196608 -> 24576
   and 655360 -> 81920; (b) the monitor step at hamming 122.88 -> 30.72
   MS/s (65536 -> 16384), blackman and blackmanharris 122.88 -> 15.36 MS/s
   (196608 -> 24576, 655360 -> 81920), blackmanharris 122.88 -> 30.72 MS/s
   (163840 -> 40960) near 2^24 samples: one split
   launch, within the step gates of ``reference_step``, timed beside the
   same step through the plain frames, profiled (the idle share, each
   split kernel's device time), and the split kernels alone on the step's
   frames (rows ``split_hamming_65536``, ``split_blackman_196608``,
   ``split_blackmanharris_655360``, ``split_blackmanharris_163840``); (c)
   ``fused_ola_reg_kernel`` at 8192
   -> 4096 and 16384 -> 4096, ``fused_ola_frames_reg_kernel`` at 12288 ->
   4096 and the cluster kernel on 2 blocks at 24576 -> 12288 and 24576 ->
   8192, each on its design's step input against the plain version, the
   older body it replaces and complex128 (at most twice the older body's
   error), timed beside the older body and the ``torch.fft`` chain, with
   a monitor step at each design, whose launches the row carries; (e) the
   split route beside the cluster kernel at each cluster pair above one
   block, on 2^24 samples at hop nfft / 3;

then the host layer on the card (the machine has no matplotlib or pandas,
so nothing is drawn: the figures' drawing is held on the CPU by the tests),
and row 3's split route through ola_filter:

23. (a) ``io.write_sigmf(datatype='npy')`` of two captures of 2^24 samples
   at 122.88 MS/s made on the card (tone + noise from seed 0, two center
   frequencies, an NTIA CalibrationAnnotation at a preselector gain of 30
   dB), ``io.read_sigmf(stack=True, ntia_extensions=True)`` and
   ``utils.to_device_array`` back onto the card (equal to the capture
   scaled in memory), then the flagship ``WidebandMonitor.step`` on the
   (2, 2^24) batch: ``torch.equal`` to the step on the arrays scaled in
   memory on every output, the same launches, rows 1, 5 and 6 each
   launched, no library FFT in its profile; the write and read times (host
   clock) and the step's (CUDA events); (b) what ``plot_power_ccdf`` and
   ``plot_spectrogram_heatmap_from_iq`` compute, on one capture: the
   power averaged over 16 samples in dB (within 1e-4 dB of the
   ``device='cpu'`` run), its 0.01 dB bin grid and ``sample_ccdf`` (one
   ``hist_bucket_kernel`` launch, counts equal to the plain CPU call's),
   the spectrogram at a 1024-point hann window (within 1e-5 relative RMS of
   the CPU's), each timed; (c) ``fourier.fft`` of a (4096, 16384) complex64
   batch whole and under ``set_max_cupy_fft_chunk(2**24)``: within 1e-6
   relative RMS, each call's peak device memory above its input (cuFFT's
   workspace) and time; (d) ``sliding_window_view`` of card tensors of 2^24
   samples is a view (its pointer, numpy's strides, no allocation),
   ``binned_mean`` and ``grouped_views_along_axis`` equal to the same calls
   on the CPU; (e) ``ola_filter`` at 131072 -> 16384 (hamming) on
   99,999,744 samples: one launch on the split route, within 1e-5 of the
   plain route and of the torch.fft stage chain, the split kernels a call
   from its profile, timed beside both, and the split frames alone beside
   their bound and plain version (kernels-line row
   ``split_ola_filter_131072``). Rows 1, 5 and 6 gain ``host_layer``.

then rows 2-3's storage tiers and radix-7 frames:

24. (a) each frame kernel's plane instances (int16, bfloat16 and float32
   planes of integer counts near 2^24 samples, read at the hop): the
   register kernel at 16384 -> 8192 (and 12288 -> 6144), the cluster of 3
   at 49152 -> 24576, the split route at 131072 -> 16384, the two-block
   plan kernel at 19200 -> 5120 (above the plan kernel's 16384 points) and
   the generic kernel at 18225 -> 6075 (an odd size, where it routes); one
   launch each on its element type, within
   1e-6 relative RMS of the complex64 instance on the dequantized frames
   and 1e-5 of the plain chain, the instance named in its profile, timed
   beside the complex64 instance and beside the rounding pass into
   complex64 plus that instance, its bound at the planes' bytes (rows
   ``frames_reg_i16`` ... ``frames_generic_f32``); (b) ``ola_filter`` at
   'i16' and 'bf16' on BASELINE #2's 99,999,744 samples of integer counts:
   one launch of the plane instance, named in the profile, within 1e-6 of
   the complex64 route on the stored values and 1e-5 of the plain route
   and the stage chain, timed beside 'highest'; (c) the blackman monitor of
   the flagship rates (49152 -> 24576) at 'i16', ``step_planes`` on 2^24
   int16 counts: one launch of the cluster kernel's int16 instance, no
   PyTorch op that makes a float32 or complex copy of the input (a dispatch
   mode records them), within phase 3's step gates of 'high' on the scaled
   counts, profiled, timed; (d) the monitor at 107.52 -> 15.36 MS/s,
   hamming, blackman and blackmanharris (57344 -> 8192, 172032 -> 24576,
   286720 -> 40960: radix-7 steps of 7, 14 and 28) near 2^24 samples: one
   split launch, within the step gates of ``reference_step``, 8 frames
   within 1e-6 of the plain chain and against complex128 (at most twice
   the chain's error), profiled, timed beside the plain frames (rows
   ``split_radix7_hamming_57344``, ``split_radix7_blackman_172032``,
   ``split_radix7_blackmanharris_286720``).

25. Rows 4-6 at every shape the JAX kernels take: (a) the channelizer's
   split route (``csrc/chan_split.cu`` on the radix step of
   ``csrc/split_radix.cuh``) at 36864, 11264, 81920 and 131072 points in
   the statistics mode (navg 16) and the channel-only mode, and at 2^21
   points binned by 128 (the bin kernel), on 2^23 samples, held as phase
   17a holds ``CHAN_SIZES`` (1e-5 of the plain version, each output's
   complex128 error within ``CHAN_F64_LIMIT`` of the plain version's),
   timed beside its bound and the ``torch.fft`` chain; (b) the monitor of
   the flagship rates at 48 x 768, 22 x 512, 80 x 1024 and 128 x 1024
   channels, navg 1 and 16, near 2^24 samples: routes, one launch of each
   kernel, phase 3's gates against ``reference_step``, the step and the
   plain step timed, the 48 x 768 step profiled (row
   ``chan_stats_split``); (c) ``channelize_power`` at 48 channels of 576
   of 768 bins (36864 points): one split launch, against the plain version
   and the CPU port (row ``chan_stats_split_channels``); (d) the monitor
   with 40,000 and 100,000 APD edges on the histogram's slices, against
   ``reference_step``, the slices equal to the plain version on its binned
   stream and on 2^24 samples, timed beside the sort (row
   ``hist_slices``); a row of 2^31 float32 samples (8 GiB) through
   ``hist`` at 513 and 40,000 edges, ``sample_ccdf`` and ``apd_fold``:
   int64 counts equal to the plain version's summed over pieces of 2^27;
   (e) the blackman monitor at 135.168 -> 24.576 MS/s (135168 -> 24576, 11
   x 12288: the split frame route's radix-11 step through its prime pass)
   near 2^24 samples against ``reference_step``, 8 frames against the
   plain chain and complex128 (row ``split_blackman_135168``); (f) the
   flagship 2:1 step at 'i16' and 'bf16': one launch of
   ``fused_ola_strided`` on the tier's planes, against ``reference_step``,
   timed in turns beside the same step through ``fused_ola`` on the planes
   widened to complex64 (the stage before this phase's change; in rows
   ``fused_ola_strided_i16`` / ``_bf16``).

26. Rows 1-3 at every monitor design the JAX kernels take: (a) the 2:1
   route on the frame kernels (``fused_ola_strided``, route '<frame
   route>+add': a frame kernel of ``csrc/ola_frames.cuh`` or
   ``csrc/ola_split.cu`` reads the frames straight from the capture and the
   samples past its end from the halo, ``ola_add_kernel`` of
   ``csrc/ola_add.cu`` overlap-adds and forms the tail) at the 21 hamming
   pairs of the 122.88 MS/s grid the older 2:1 kernels do not take, on 8
   frames with a halo and the tail: one launch each, within 1e-5 of
   ``fused_ola_strided_plain``, its complex128 error at most twice the
   plain chain's; int16 and bfloat16 planes at one pair a frame route; (b)
   the monitor step near 2^24 samples at 12288 -> 4096 (reg), 32768 ->
   16384 (cluster), 20480 -> 4096 (split, one block: phase 28e) and 65536
   -> 16384 (split):
   routes, one launch of the route and of ``ola_add``, no frame wrapper,
   no concatenation kernel in the profile, phase 3's gates against
   ``reference_step``, timed beside the same step through ``ola_grouped``
   on the same frame kernel (the route before, ``_fused_ola_grouped``) and
   through the plain OLA, profiled (rows ``ola_2to1_reg_12288`` ...
   ``ola_2to1_split_65536``; ``ola_add``, equal to ``ola_add_plain``,
   beside ``torch.nn.functional.fold``); (c) at 12288 -> 4096 the stream
   of 8 chunks against one step and ``reference_step``, 16 chunks (2^28
   samples) timed, and ``sharded_step`` on one NCCL rank ``torch.equal`` to
   ``step`` and within phase 3's gates of ``reference_step``; (d) the four
   grid designs that took the plain frames (1310720 -> 81920, 1572864 ->
   49152, 1310720 -> 40960, 2621440 -> 81920: radix steps of 80, 96 and
   160 parts) near 2^24 samples: one split launch, against
   ``reference_step``, the frames against the plain chain and complex128,
   profiled, timed beside the plain frames (rows ``split_c80_1310720_81920``
   ... ``split_c160_2621440``).

27. The plan frame kernel of rows 1-3 (``fused_ola_frames_plan_kernel`` on
   the run-time plans of ``csrc/fft_plan.cuh``; routes 'plan' and
   'plan+add') at every one-block pair the generic frame kernel and the
   radix-2 2:1 kernel took: ptxas's registers and spills of its four
   instances (none may spill); (a) the 52 monitor pairs that ran an
   older body on 8 frames against the plain chain (1e-5) and complex128
   (twice the chain's error), int16 and bfloat16 planes at one pair a size
   class, the 27 2:1 pairs through 'plan+add' with a halo and the tail;
   the pairs it does not hold listed (frames above 16384 points: the two-block
   plan kernel or the split route, phase 28); the plan kernel forced at
   9216 -> 3072, which the split route takes (28e); (b) ten pairs on a
   step's frames near 2^24 samples
   (rows ``plan_4096_2048`` ... ``plan_16384_8192``; ``plan_cluster_20480_4096``
   and the like at the pairs it does not hold, on the two-block plan kernel
   forced),
   each beside its older body (``generic_ms``:
   the radix-2 kernel, 'generic+add' or the generic frame kernel), the
   plain version and the ``torch.fft`` chain, the frame kernels alone
   (``plan_frames_ms``, ``generic_frames_ms``; at 16384 -> 8192 also the
   compile-time register instance, ``reg_frames_ms``), profiled; (c) the
   monitor step near 2^24 samples at the example's 61.44 -> 30.72 MS/s
   hamming design (4096 -> 2048), 122.88 -> 40.96 MS/s hamming at
   min_fft_size 2047 (6144 -> 2048), blackman 122.88 -> 40.96 MS/s (9216 ->
   3072, the split route since 28e) and blackmanharris 30.72 -> 15.36 MS/s
   at 1023 (10240 -> 5120): routes, one launch of the route, its kernel
   and no generic frame kernel or radix-2 2:1 kernel in the profile,
   phase 3's gates against ``reference_step`` and against the same step
   through the older body, timed beside it; (d) the stream at the example
   design (8 chunks against one step and ``reference_step``, 16 chunks,
   2^28 samples, timed) and ``ola_filter`` at 8192 -> 4096 on BASELINE #2's
   capture against its plain route (row ``fused_ola_frames_plan``: the
   example pair's times, the launches of (c)'s steps), and ``ola_filter`` at
   row 3's split pair 1310720 -> 40960 (80 parts) near BASELINE #2's
   capture, timed beside its plain route and the stage chain, with its
   bound (the row's ``split_ola_filter_1310720``).

28. The two-block plan frame kernel of rows 1-3
   (``fused_ola_frames_plan_cluster_kernel``: one frame on a cluster of two
   blocks, a radix-2 step across their shared memory, each block on the
   run-time plan passes of ``csrc/fft_plan.cuh``; routes 'plan_cluster' and
   'plan_cluster+add') at the even one-block pairs above 16384 points no
   other route takes (of the monitor's, 19200 -> 5120, 20480 -> 20480 and
   24576 -> 24576; the split route takes the rest, (e)):
   (d) ptxas's registers and spills of its eight instances (four element
   types, blocks of 256 and 512 threads; none may spill);
   (a) the 20 pairs of 18432-28672 points on 8 frames against the plain
   chain (1e-5) and complex128 (twice the chain's error), the kernel forced
   where the split route takes the pair, and at 9216 -> 3072 and 16384 ->
   1024; int16, bfloat16 and float32 planes at one pair a size class; the
   pair's own 2:1 route with a halo and the tail at 20480 -> 4096 and 24576
   -> 16384 (split+add), 19200 -> 5120 and 24576 -> 24576 (plan_cluster+add);
   (b) 25600 -> 5120, 20480 -> 10240, 20480 -> 4096, 24576 -> 4096, 9216 ->
   3072, 16384 -> 1024, 19200 -> 5120, 20480 -> 20480 and 24576 -> 24576 on
   a step's frames near 2^24 samples, the two-block kernel (the 2:1 route at the 2:1 pairs) beside
   the generic kernel, the one-block plan kernel where it holds the pair
   (in turns at the class pairs), the split route where it has a shape and
   the ``torch.fft`` chain, back to back and single calls, with its bound
   and ``cudaOccupancyMaxActiveClusters`` (rows
   ``plan_cluster_<nfft>_<nfft_out>``); (e) at the 34 monitor pairs above
   8192 points with a split shape, the split route beside the plan kernel
   that holds the pair, frames alone and at the 2:1 pairs through the
   '+add' routes, in turns (the times behind ``split_takes``' one-block
   pairs); (c) the monitor step near 2^24 samples at blackmanharris 122.88
   -> 61.44 MS/s (20480 -> 10240), 122.88 -> 24.576 MS/s at 1023 (25600 ->
   5120) and 122.88 -> 32.768 MS/s at 1023 (19200 -> 5120), hamming 122.88
   -> 24.576 MS/s at 4095 (20480 -> 4096, 2:1) and blackman 9216 -> 3072:
   routes, launches, ``reference_step``'s gates, timed beside the same step
   through the generic kernel and through each plan kernel that holds the
   pair where the route is another, profiled with the route's kernel and
   no generic one (row ``fused_ola_frames_plan_cluster``: 19200 -> 5120's
   times, the launches of (c)'s steps, (e)'s turns).

30. Rows 9-10 at every nfft 64-16384 the JAX kernels take (the frame-group
   kernels ``spectrogram_levels_reg_kernel`` / ``spectrogram_db_reg_kernel``
   at 64-1024, ``spectrogram_block_kernel`` at 2048-16384) and rows 4-5 at
   64-512 points (``chan_stats_small_kernel``), none of which may spill:
   (a) on phase 19's capture, row 9 at every size and row 10 in the levels
   and stats modes above 1024 points (apd_navg 0, 16) and at 1024 (32-128),
   held to the plain version and the radix-2 body (dB and min of dB within
   the float32 FFT bound of a value, mean and max of dB by ``psd_gate``,
   the levels by phase 4's rule, the binned power 1e-5, float64 at most
   twice the radix-2 body's error, both input layouts and the levels and
   stats modes bit-equal), timed beside the body, the ``torch.fft`` chain
   and the bound, each profiled (a trace without its kernel retaken in a
   fresh process, ``--traces spg30_<mode>_<nfft>_<navg>_<route>``), and
   held untimed at six more sizes below 1024; (c) the channelizer at
   64-512 points channel-only and at navg 1 and 16 (17a's gates, timed
   beside the radix-2 kernel, profiled), four more modes held; (b)
   ``power_spectral_density`` at fs / 256, fs / 2048 and fs / 4096 and the
   persistence fold at nfft 2048 against the CPU (20d's ``psd_gate``),
   their launches on the new routes and profiles with no radix-2 body;
   then the small blackman monitor (4 x 64-point channelizer frames)
   against ``reference_step`` (phase 3's gates, the psd 26d's), one launch
   of the small-frame channelizer, timed and profiled (rows
   ``spectrogram_block``, ``spectrogram_db_small``, ``chan_stats_small``).

``python3 chip_smoke.py --parent DIR`` adds phase 11's comparison with
DIR's package; ``--step-times DIR`` times the flagship step through DIR's
package alone (run in turns on two trees to compare them); ``--ranks N``
runs the sharded layer across N cards, one NCCL rank a card (the flagship
and blackman ``sharded_step`` on 2^24 samples a rank, held on rank 0 to
phase 3's gates against ``step`` on the whole capture; the exact
``sharded_psd_stats`` ``torch.equal`` to ``_quantile`` of the whole
capture's dB; ``sharded_apd_histogram`` equal to its counts; each timed).
It prints the card's name and power limit, one JSON line ``{"kernels":
[...]}``, and as its last line ``{"ok": true, "device": {...}}``. Any failed
check raises, and the script exits nonzero without that line; so does a
machine without CUDA, or a directory without the package.
"""

from __future__ import annotations

import itertools
import json
import math
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
N_STEP = 1 << 24
N_SMALL = 4 * 16384
SEED = 0
REPS = 20
WARMUP = 3

FLAGSHIP = dict(
    bw=40e6,
    fs_sdr=122.88e6,
    channel_count=16,
    fft_size_per_channel=256,
    window='hamming',
    apd_bins=2048,
    apd_navg=16,
    min_fft_size=8191,
)

# device memory rate (bytes/s) and float32 non-tensor-core peak (FLOP/s)
# by card name, from the vendor data sheets; SXM H100 when unknown
_RATES = (
    ('H200', 4.8e12, 67e12),
    ('H100 NVL', 3.9e12, 60e12),
    ('H100 PCIe', 2.0e12, 51e12),
    ('H100', 3.35e12, 67e12),
)
FORBIDDEN = ('fft', 'cublas', 'gemm', 'cutlass', 'xmma')

MONITOR_KERNELS = ('fused_ola', 'chan_stats', 'hist')
KERNEL_INFO = {
    'fused_ola': ('iqwaveform_torch/csrc/fused_ola.cu',
                  'iqwaveform_tpu/ops/pallas/fused_ola_pallas.py:571'),
    'chan_stats': ('iqwaveform_torch/csrc/chan_stats.cu',
                   'iqwaveform_tpu/ops/pallas/chan_stats_pallas.py:301'),
    'hist': ('iqwaveform_torch/csrc/hist.cu',
             'iqwaveform_tpu/ops/pallas/hist_pallas.py:51'),
    'spectrogram_dB': ('iqwaveform_torch/csrc/spectrogram.cu',
                       'iqwaveform_tpu/ops/pallas/spectrogram_pallas.py:258'),
    'spectrogram_levels': ('iqwaveform_torch/csrc/spectrogram.cu',
                           'iqwaveform_tpu/ops/pallas/spectrogram_pallas.py:414'),
    'colhist': ('iqwaveform_torch/csrc/colhist.cu',
                'iqwaveform_tpu/ops/pallas/colhist_pallas.py:309'),
    # the same kernel on float values (its colhist_kernel<true> instance),
    # reported inside the colhist row
    'colhist_values': ('iqwaveform_torch/csrc/colhist.cu',
                       'iqwaveform_tpu/ops/pallas/colhist_pallas.py:106'),
    'fused_ola_frames': ('iqwaveform_torch/csrc/ola_frames.cuh',
                         'iqwaveform_tpu/ops/pallas/fused_ola_pallas.py:394'),
    # the same wrapper's cluster route (fused_ola_frames_cluster_kernel), as
    # the monitor's grouped overlap-add runs it at R = 3
    'fused_ola_frames_cluster': ('iqwaveform_torch/csrc/ola_frames.cuh',
                                 'iqwaveform_tpu/ops/pallas/fused_ola_pallas.py:492'),
    # its instance on clusters of 6 blocks (98304 -> 24576), as the
    # monitor at 122.88 -> 30.72 MS/s runs it
    'fused_ola_frames_cluster6': ('iqwaveform_torch/csrc/ola_frames.cuh',
                                  'iqwaveform_tpu/ops/pallas/fused_ola_pallas.py:492'),
    # the channelizer statistics at the other frame sizes of one block
    # (chan_stats_mixed_kernel) and above one block (chan_stats_cluster_kernel),
    # and the channel-only kernel at a size that is no power of two
    'chan_stats_mixed': ('iqwaveform_torch/csrc/chan_mixed.cu',
                         'iqwaveform_tpu/ops/pallas/chan_stats_pallas.py:301'),
    'chan_stats_cluster': ('iqwaveform_torch/csrc/chan_cluster.cu',
                           'iqwaveform_tpu/ops/pallas/chan_stats_pallas.py:301'),
    'chan_power_reg_12288': ('iqwaveform_torch/csrc/chan_stats.cu',
                             'iqwaveform_tpu/ops/pallas/chan_stats_pallas.py:248'),
    'upfirdn': ('iqwaveform_torch/csrc/upfirdn.cu',
                'iqwaveform_tpu/ops/pallas/upfirdn_pallas.py:210'),
    'corr_at_indices': ('iqwaveform_torch/csrc/corr.cu',
                        'iqwaveform_tpu/ops/pallas/corr_pallas.py:97'),
    # the channelizer kernel in its channel-only mode (emit_psd=False,
    # emit_pbin=False), as channelize_power launches it
    'chan_stats_channels': ('iqwaveform_torch/csrc/chan_stats.cu',
                            'iqwaveform_tpu/ops/pallas/chan_stats_pallas.py:248'),
    # the 2:1 kernels through fused_ola_strided (a halo, the tail): on the
    # stream's complex64 chunks, and on (2, N) planes of float32, int16 and
    # bfloat16 (step_planes at the storage tiers)
    'fused_ola_strided': ('iqwaveform_torch/csrc/fused_ola.cu',
                          'iqwaveform_tpu/ops/pallas/fused_ola_pallas.py:571'),
    'fused_ola_strided_f32': ('iqwaveform_torch/csrc/fused_ola.cu',
                              'iqwaveform_tpu/ops/pallas/fused_ola_pallas.py:571'),
    'fused_ola_strided_i16': ('iqwaveform_torch/csrc/fused_ola.cu',
                              'iqwaveform_tpu/ops/pallas/fused_ola_pallas.py:571'),
    'fused_ola_strided_bf16': ('iqwaveform_torch/csrc/fused_ola.cu',
                               'iqwaveform_tpu/ops/pallas/fused_ola_pallas.py:571'),
    # the column counter on the packed APD route's int levels
    # (columnwise_histogram_packed_raw with its column-sum readout)
    'colhist_packed_apd': ('iqwaveform_torch/csrc/colhist.cu',
                           'iqwaveform_tpu/ops/pallas/colhist_pallas.py:309'),
}

# BASELINE config #2 (bench.py:457-555): the largest multiple of the output
# overlap (4096) not above 10^8 samples, and the ola_filter call
N_OLA = 24414 * 4096
OLA_KW = dict(fs=61.44e6, nfft=16384, nfft_out=8192, window='hamming',
              passband=(-10e6, 10e6))
N_OLA_CHAIN = 1 << 22  # output samples held against the stage chain
N_F64_FRAMES = 512  # frames held against the plain chain in complex128
# the frame kernel's instances: the one its paths run at their sizes, and
# the generic one, which their profiles may not show
REG_KERNEL = 'fused_ola_frames_reg_kernel'
GENERIC_KERNEL = 'fused_ola_frames_kernel'
# the 2:1 OLA kernel the flagship step runs at 16384 -> 8192, and the
# radix-2 one it replaces there, which the step's profile may not show;
# likewise the channel-only channelizer of channelize_power at 16384
OLA_REG_KERNEL = 'fused_ola_reg_kernel'
OLA_GENERIC_KERNEL = 'fused_ola_kernel'
CHAN_REG_KERNEL = 'chan_power_reg_kernel'
STATS_REG_KERNEL = 'chan_stats_reg_kernel'
STATS_GENERIC_KERNEL = 'chan_stats_kernel'
COLHIST_REG_KERNEL = 'colhist_reg_kernel'
COLHIST_GENERIC_KERNEL = 'colhist_kernel'
# the histogram kernel every APD of the paths runs, and the older one it
# replaces there, which no path's profile may show
HIST_KERNEL = 'hist_bucket_kernel'
HIST_GENERIC_KERNEL = 'hist_kernel'
# the dB spectrogram kernel of the unfused persistence path at nfft 1024
DB_REG_KERNEL = 'spectrogram_db_reg_kernel'
N_UPFIRDN = 10**8
UPFIRDN_PAIRS = ((1, 2), (2, 3))
N_UPFIRDN_F64 = 1 << 20  # outputs held against float64
# the upfirdn kernel both pairs run
UPFIRDN_REG_KERNEL = 'upfirdn_reg_kernel'
# the levels kernel the persistence fold runs at nfft 1024, and the radix-2
# body it replaces there, which the fold's profile may not show
LEVELS_REG_KERNEL = 'spectrogram_levels_reg_kernel'
LEVELS_GENERIC_KERNEL = 'spectrogram_kernel'
# the frame kernel of frames above one block's shared memory, one frame a
# thread-block cluster
CLUSTER_KERNEL = 'fused_ola_frames_cluster_kernel'
# one frame on a two-block cluster, on run-time plans (phase 28)
PLAN_CLUSTER_KERNEL = 'fused_ola_frames_plan_cluster_kernel'
# chan_stats' route counts after one launch of a register-resident kernel
# (chan_stats_reg_kernel or chan_power_reg_kernel)
CHAN_REG_ROUTE = {'reg': 1, 'mixed': 0, 'cluster': 0, 'split_block': 0, 'split': 0,
                  'split_older': 0, 'small': 0, 'generic': 0}
# kernels whose ptxas report must show no spill
# the channelizer statistics at the other sizes of one block and above it
MIXED_KERNEL = 'chan_stats_mixed_kernel'
CHAN_CLUSTER_KERNEL = 'chan_stats_cluster_kernel'
# the CP correlation's ring kernel and the kernels after it
CORR_KERNEL = 'corr_ring_kernel'
CORR_KERNELS = (CORR_KERNEL, 'corr_fold_kernel', 'corr_finish_kernel')
NO_SPILL = (STATS_REG_KERNEL, COLHIST_REG_KERNEL, HIST_KERNEL, DB_REG_KERNEL, LEVELS_REG_KERNEL,
            CLUSTER_KERNEL, CHAN_REG_KERNEL, MIXED_KERNEL, CHAN_CLUSTER_KERNEL, CORR_KERNEL,
            OLA_REG_KERNEL, 'split_radix_kernel', 'split_fwd_passes_kernel',
            'split_inv_passes_kernel', PLAN_CLUSTER_KERNEL, 'spectrogram_block_kernel',
            'chan_stats_small_kernel', 'fused_ola_frames_plan_kernel', 'split_plan_passes_kernel')
FILTER_REPS = 10
# the monitor beyond 2:1: blackman COLA, R = 3 (tests/test_monitor.py:440-460)
BLACKMAN = dict(fs_sdr=30.72e6, min_fft_size=2047, window='blackman')
N_MONITOR_R3 = 683 * 24576  # whole min_input_multiple()s, at least 2^24

# the monitor at the blackman design of the flagship rates: 122.88 -> 61.44
# MS/s, 40 MHz, frames of 49152 -> 24576 at R = 3 on the cluster kernel, a
# 16 x 256 channelizer (navg 1), 2048 APD edges; 2^24 samples a step
CLUSTER_MONITOR = dict(bw=40e6, fs_sdr=122.88e6, window='blackman')
N_CLUSTER_STEP = 1 << 24
# the blackmanharris design of the same rates (81920 -> 40960, R = 5): one
# step on whole min_input_multiple()s, about 2^24 samples
CLUSTER_MONITOR_BH = dict(bw=40e6, fs_sdr=122.88e6, window='blackmanharris')
N_CLUSTER_STEP_BH = 205 * 81920
# the blackman design at 122.88 -> 30.72 MS/s (20 MHz): frames of 98304 ->
# 24576 on clusters of 6 blocks; a step on whole min_input_multiple()s near
# N_CLUSTER_STEP
WIDE_CLUSTER_MONITOR = dict(bw=20e6, fs_sdr=122.88e6)
# the channelizer at the frame sizes of CHAN_SIZES: each on 2^23 samples
# of noise in whole frames (the length of the flagship step's resampled
# stream), in the monitor's statistics mode and the channel-only mode
CHAN_SIZE_SAMPLES = 1 << 23
CHAN_SIZE_MODES = {'stats': dict(emit_psd=True, emit_pbin=True, navg=16),
                   'channels': dict(emit_psd=False, emit_pbin=False, navg=1)}
# the monitor of the flagship rates (hamming, 16384 -> 8192, navg 1) at the
# channelizer designs the slice adds: name -> (design arguments, route,
# kernel, kernels-line row or None)
CHAN_MONITOR = dict(bw=40e6, fs_sdr=122.88e6)
CHAN_DESIGNS = {
    'channels48': (dict(channel_count=48), 'mixed', 'chan_stats_mixed_kernel', 'chan_stats_mixed'),
    'channels96': (dict(channel_count=96), 'cluster', 'chan_stats_cluster_kernel',
                   'chan_stats_cluster'),
    'channels64x512': (dict(channel_count=64, fft_size_per_channel=512), 'cluster',
                       'chan_stats_cluster_kernel', None),
}
# each output's complex128 error in phase 17a at most this many times the
# plain version's (psd_log_sum: the kernels' fixed-order sums of ln over
# frames read 1.4-2.2x the plain version's), and below the error of the
# plain version on the input rounded to float16 (the gate's control)
CHAN_F64_LIMIT = {'channel_power': 2, 'psd_log_sum': 3, 'psd_max': 2, 'p_binned': 2}
# the two 4096-point statistics kernels by device time: the calls in one
# trace, and the binnings (navg 1: the blackman designs; 16: the flagship)
STATS_CMP_CALLS = 10
STATS_CMP_NAVG = (1, 16)
# chan_stats' route counts before a launch
CHAN_NO_ROUTE = {'reg': 0, 'mixed': 0, 'cluster': 0, 'split_block': 0, 'split': 0,
                 'split_older': 0, 'small': 0, 'generic': 0}
# each compiled pair on a few frames against the plain chain and complex128
N_CLUSTER_FRAMES = 64

# the OFDM path: 1 s of a 20 MHz LTE / 5G-NR (15 kHz) capture at 30.72 MS/s
LTE_BW = 20e6
LTE_SLOTS = 1000  # 1 ms each
LTE_SNR_DB = 20
CORR_DELAY = 700  # samples the capture is delayed by for the CP correlation
CLOCK_SLIP = 31  # samples the capture slips over its length (about 1 ppm)
# one SSB period with a planted PSS / SSS
CELL_PERIOD = 20e-3
CELL_ID = 635
CELL_OFFSET = 123457
CELL_NOISE = 0.05
CELL_GAIN = 100.0
# BASELINE config #4 (bench.py:558-600): 4 captures of 610 frames of
# 64 x 256 points, 192 analysis bins per channel
CHANNELIZE = dict(fft_size_per_channel=256, analysis_bins_per_channel=192, window='hamming',
                  channel_count=64)
CHANNELIZE_TS = 1 / 122.88e6
CHANNELIZE_CAPTURES = 4
CHANNELIZE_FRAMES = 610

# BASELINE config #3 (bench.py:312-325)
PERSISTENCE = dict(
    nfft=1024, window='hann', hist_bins=1024, hist_range_dB=(-150.0, 50.0),
    fft_backend='pallas', fft_precision='high',
)
CHUNK = 1 << 24
N_CHUNKS = 64
APD_NAVG = 16
N_FOLD_CHECK = 4
N_HOST_SPLIT = 16  # chunks whose fold's host time is split by part
# device_kernels: traces taken in this process before the trace is taken
# in a fresh one, and the host wait inside each trace before the call and
# after its synchronize
PROFILE_TRIES = 3
HOST_CALLS = 1000  # calls whose host time host_ms averages
CORR_HOST_CALLS = 100  # corr_at_indices calls (three launches each) host_ms averages
HOST_ROUNDS = 6  # turns of the two wrappers whose host times hist_times compares
PROFILE_SETTLE_S = 0.05
FRESH_TRACE_TIMEOUT_S = 300
FRESH_TRACE_PROCESSES = 2  # fresh processes fresh_traces takes at most


class CheckFailed(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def _wide(a):
    return a.to(torch.complex128 if a.is_complex() else torch.float64)


def rel_rms(a, b) -> float:
    a, b = _wide(a), _wide(b)
    return float(((a - b).abs() ** 2).mean().sqrt() / (b.abs() ** 2).mean().sqrt())


def max_abs(a, b) -> float:
    return float((_wide(a) - _wide(b)).abs().max())


def short_name(kernel: str) -> str:
    """a device kernel's name without its parameter list"""
    name = kernel.replace('void ', '').replace('(anonymous namespace)::', '')
    return name.split('(')[0][:80]


def card_rates(name: str):
    for key, mem, fp32 in _RATES:
        if key in name:
            return mem, fp32
    return 3.35e12, 67e12


def timed_ms(fn, reps=REPS, warmup=WARMUP) -> float:
    """median of ``reps`` single-call CUDA-event times after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(sorted(times)[len(times) // 2])


def check_step(out, ref, label: str, psd: bool = True) -> None:
    """the slice's tolerances: channel power 1e-5 relative RMS; psd within
    0.01 dB where the reference is above -100 dB (``psd=False``: the caller
    holds the psd itself, as 26d does against complex128); APD totals equal
    and L1 within max(2, total // 1000)."""
    for key in ('channel_power', 'channel_power_mean', 'channel_power_max'):
        if key not in out:  # a stream's flush holds no channel_power series
            continue
        err = rel_rms(out[key], ref[key])
        require(err <= 1e-5, f'{label} {key}: relative RMS {err:.3g} > 1e-5')
    for key in ('psd_mean', 'psd_max') if psd else ():
        band = ref[key] > -100
        require(int(band.sum()) > 0, f'{label} {key}: no bin above -100 dB')
        err = max_abs(out[key][band], ref[key][band])
        require(err <= 0.01, f'{label} {key}: {err:.4g} dB > 0.01 dB')
    a, b = out['apd_counts'].long(), ref['apd_counts'].long()
    total = int(b.sum())
    require(int(a.sum()) == total, f'{label} apd_counts: totals differ')
    l1 = int((a - b).abs().sum())
    require(l1 <= max(2, total // 1000), f'{label} apd_counts: L1 {l1}')
    for key, v in out.items():
        require(v.shape == ref[key].shape, f'{label} {key}: shape {tuple(v.shape)}')
        if v.is_floating_point():
            require(bool(torch.isfinite(v).all()), f'{label} {key}: not finite')


def kernel_row(kname, result, nbytes, nops, kernel_fn, plain_fn, library_fn,
               mem_rate, fp32_rate, reps=REPS, warmup=WARMUP) -> dict:
    """one entry of the kernels line: the bound from this run's shapes, and
    the kernel, its plain version and the library call timed here."""
    t_bytes = nbytes / mem_rate * 1e3
    t_ops = nops / fp32_rate * 1e3
    timed = lambda fn: timed_ms(fn, reps, warmup)  # noqa: E731
    return {
        'name': kname,
        'route': 'cuda',
        'source': KERNEL_INFO[kname][0],
        'replaces': KERNEL_INFO[kname][1],
        'launches': result['launches'],
        'max_abs_err': result['max_abs_err'],
        'ms': timed(kernel_fn),
        'plain_ms': timed(plain_fn),
        'bound_ms': max(t_bytes, t_ops),
        'bound_by': 'bytes' if t_bytes >= t_ops else 'operations',
        'library_ms': None if library_fn is None else timed(library_fn),
    }


EARLIER_KEYS = ('launches', 'ms', 'bound_ms', 'plain_ms', 'generic_ms', 'profiled_device_ms',
                'generic_profiled_device_ms', 'host_ms', 'generic_host_ms')


def merge_rows(first: list, later: list) -> list:
    """the kernels line: a kernel of several paths keeps the row of the
    newest path's run, with the earlier path's numbers beside it."""
    rows = {r['name']: r for r in first}
    for r in later:
        if r['name'] in rows:
            r['earlier_path'] = {k: v for k, v in rows[r['name']].items() if k in EARLIER_KEYS}
        rows[r['name']] = r
    return list(rows.values())


def fft_ops(n: int) -> float:
    return 5 * n * math.log2(n)


def min_gate(got_min, ref_min, ref_mean) -> tuple:
    """min of dB is each bin's deepest value. Per value a float32 FFT's
    error is relative to the frame's energy, so two FFTs agree in dB the
    less the deeper the value: over 2^16 frames of white noise the mins lie
    some 45 dB below the mean and differ by up to ~1e-2 dB. The gate holds
    them in linear power against the bin's mean power:
    |10^(a/10) - 10^(b/10)| <= 1e-6 * 10^(mean/10). Returns (largest dB
    difference, largest power difference over the mean power)."""
    band = ref_min > -100
    require(int(band.sum()) > 0, 'no min above -100 dB')
    a, b, m = (v[band].double() for v in (got_min, ref_min, ref_mean))
    lin = float(((10 ** (a / 10) - 10 ** (b / 10)).abs() / 10 ** (m / 10)).max())
    return float((a - b).abs().max()), lin


def check_persistence(got: dict, ref: dict, label: str, frames: int) -> dict:
    """a finalized persistence result against the plain path's: mean and max
    of dB within 1e-3 dB where above -100 dB (the JAX package's bar,
    tests/test_parallel.py:423-506), min by min_gate; histogram per-column
    totals equal, L1 within 2e-3 of the counted entries (a level that moves
    by one bin changes two cells; the kernel gate allows 1e-3 of the levels
    to move), quantiles within one bin width. Returns the largest
    differences."""
    errs = {}
    for key in ('mean_dB', 'max_dB', 'min_dB'):
        a, b = got[key], ref[key]
        require(a.shape == b.shape, f'{label} {key}: shape {tuple(a.shape)}')
        require(bool(torch.isfinite(a).all()), f'{label} {key}: not finite')
    for key in ('mean_dB', 'max_dB'):
        band = ref[key] > -100
        require(int(band.sum()) > 0, f'{label} {key}: no bin above -100 dB')
        errs[key] = max_abs(got[key][band], ref[key][band])
        require(errs[key] <= 1e-3, f'{label} {key}: {errs[key]:.4g} dB > 1e-3 dB')
    errs['min_dB'], errs['min_power_over_mean'] = min_gate(
        got['min_dB'], ref['min_dB'], ref['mean_dB'])
    require(errs['min_power_over_mean'] <= 1e-6,
            f'{label} min_dB: power differs by {errs["min_power_over_mean"]:.3g} of the mean')
    if 'hist' in ref:
        g, r = got['hist'].long(), ref['hist'].long()
        require(bool((g.sum(dim=1) == frames).all()), f'{label} hist: a column total is not {frames}')
        require(torch.equal(g.sum(dim=1), r.sum(dim=1)), f'{label} hist: totals differ')
        l1 = int((g - r).abs().sum())
        require(l1 <= 2e-3 * g.shape[0] * frames,
                f'{label} hist: L1 {l1} above 2e-3 of {frames * g.shape[0]} entries')
        width = float(ref['hist_edges_dB'][1] - ref['hist_edges_dB'][0])
        dq = max_abs(got['quantiles_dB'], ref['quantiles_dB'])
        require(dq <= width, f'{label} quantiles: {dq:.4g} dB > one bin ({width:.4g} dB)')
        errs['hist_L1'] = l1
        errs['quantiles_dB'] = dq
    else:
        require('hist' not in got, f'{label}: a stats-only design returned a histogram')
    return errs


def levels_f64(planes, w, nfft: int, quant) -> tuple:
    """RMS over bins of the dB error of the mean (psum / frames) and of
    the max of dB over the first N_F64_FRAMES frames of ``planes``,
    against the plain version in float64: (the levels kernel of this
    size's route, the radix-2 body)."""
    from iqwaveform_torch.ops import kernels
    from iqwaveform_torch.ops.kernels.spectrogram import _spectrogram_levels_generic

    head = planes[:, : N_F64_FRAMES * nfft]
    ref = kernels.spectrogram_levels_plain(head.double(), w.to(torch.complex128), nfft, quant=quant)

    def errs(out):
        return {'mean_dB': float(((out['psum'].double() - ref['psum']) / N_F64_FRAMES)
                                 .pow(2).mean().sqrt()),
                'max_dB': float((out['pmax'].double() - ref['pmax']).pow(2).mean().sqrt())}

    return (errs(kernels.spectrogram_levels(head, w, nfft, quant=quant)),
            errs(_spectrogram_levels_generic(head, w, nfft, quant=quant)))


def fold_host_split(fold_chunk) -> dict:
    """the host time per chunk of ``fold_chunk(i)`` (the fold of chunk
    i) by part, in ms: the three kernel wrappers (``spectrogram_levels``,
    ``colhist``, ``hist``) and the carry's torch ops (``_merge``, the
    histogram's ``h.clone()``, ``_edges_on``), each by the host clock
    around its calls with no synchronize inside; ``other`` is the rest of
    the fold's own host work, ``total`` the whole, ``unwrapped`` the same
    chunks' host time with no part timed (what the timing costs is their
    difference). Mean over N_HOST_SPLIT chunks after one warm-up."""
    from iqwaveform_torch.parallel import streaming as S

    spent = {}

    def timed(name, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
        return call

    saved = S._CUDA, S._merge, S._edges_on
    own_clone = 'clone' in torch.Tensor.__dict__
    clone = torch.Tensor.clone
    S._CUDA = S._Kernels(**{f: timed(f, getattr(S._CUDA, f)) for f in S._Kernels._fields})
    S._merge = timed('_merge', S._merge)
    S._edges_on = timed('_edges_on', S._edges_on)
    torch.Tensor.clone = timed('h.clone()', clone)
    try:
        fold_chunk(0)
        torch.cuda.synchronize()
        spent.clear()
        t0 = time.perf_counter()
        for i in range(N_HOST_SPLIT):
            fold_chunk(i % N_CHUNKS)
        total = time.perf_counter() - t0
        torch.cuda.synchronize()
    finally:
        S._CUDA, S._merge, S._edges_on = saved
        if own_clone:
            torch.Tensor.clone = clone
        else:
            del torch.Tensor.clone
    t0 = time.perf_counter()
    for i in range(N_HOST_SPLIT):
        fold_chunk(i % N_CHUNKS)
    unwrapped = time.perf_counter() - t0
    torch.cuda.synchronize()
    split = {k: v * 1e3 / N_HOST_SPLIT for k, v in spent.items()}
    split['other'] = total * 1e3 / N_HOST_SPLIT - sum(split.values())
    split['total'] = total * 1e3 / N_HOST_SPLIT
    split['unwrapped'] = unwrapped * 1e3 / N_HOST_SPLIT
    return split


def check_apd(got, ref, label: str, total: int) -> int:
    a, b = got.long(), ref.long()
    require(int(a.sum()) == int(b.sum()) == total, f'{label} apd: totals differ from {total}')
    l1 = int((a - b).abs().sum())
    require(l1 <= max(2, total // 1000), f'{label} apd: L1 {l1}')
    return l1


def persistence_phases(dev, smi: str, mem_rate: float, fp32_rate: float) -> list:
    """phases 4-7; returns the kernels line's rows of this path."""
    from iqwaveform_torch import parallel as P
    from iqwaveform_torch.ops import kernels
    from iqwaveform_torch.ops.kernels.colhist import _colhist_generic, quantize_uniform
    from iqwaveform_torch.ops.kernels.spectrogram import (
        _spectrogram_dB_generic,
        _spectrogram_levels_generic,
    )
    from iqwaveform_torch.parallel import streaming as S

    design = P.design_persistence(**PERSISTENCE)
    nfft = design['nfft']
    quant = design['quant']
    w = torch.from_numpy(design['kernel_window']).to(dev)
    apd_edges = torch.from_numpy(
        (10 ** (np.linspace(-120.0, 30.0, 513) / 10.0)).astype('float32')
    ).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((2, N_CHUNKS * CHUNK), device=dev, generator=gen)
    n_total = x.shape[1]

    def chunk(i):
        return x[:, i * CHUNK:(i + 1) * CHUNK]

    def fold(carry, apd, i, plain=False):
        return P.persistence_apd_fold(carry, apd, chunk(i), design, apd_edges=apd_edges,
                                      apd_navg=APD_NAVG, plain=plain)

    def apd_zeros():
        return torch.zeros(apd_edges.numel() + 1, dtype=torch.int32, device=dev)

    results = {}
    frames = CHUNK // nfft
    c0 = chunk(0)

    # ---- phase 4a: the path's kernels against their plain versions, chunk 0
    lv = kernels.spectrogram_levels(c0, w, nfft, quant=quant, apd_navg=APD_NAVG)
    lv_ref = kernels.spectrogram_levels_plain(c0, w, nfft, quant=quant, apd_navg=APD_NAVG)
    diff = (lv['levels'] - lv_ref['levels']).abs()
    moved = float((diff > 0).float().mean())
    print(f'spectrogram_levels: {tuple(c0.shape)} -> levels {tuple(lv["levels"].shape)}, '
          f'{moved:.3g} of levels differ (max {int(diff.max())})')
    require(int(diff.max()) <= 1 and moved <= 1e-3,
            f'spectrogram_levels: {moved:.3g} of levels differ, by up to {int(diff.max())}')
    errs = {
        'mean_dB': max_abs(lv['psum'] / frames, lv_ref['psum'] / frames),
        'max_dB': max_abs(lv['pmax'], lv_ref['pmax']),
    }
    errs['min_dB'], min_lin = min_gate(lv['pmin'], lv_ref['pmin'], lv_ref['psum'] / frames)
    pb_err = rel_rms(lv['p_binned'], lv_ref['p_binned'])
    print(f'spectrogram_levels: stats vs plain {json.dumps(errs)} (min power differs by '
          f'{min_lin:.3g} of the mean), p_binned {tuple(lv["p_binned"].shape)} relative '
          f'RMS {pb_err:.3g}')
    for key in ('mean_dB', 'max_dB'):
        require(errs[key] <= 1e-3, f'spectrogram_levels {key}: {errs[key]:.4g} dB > 1e-3 dB')
    require(min_lin <= 1e-6, f'spectrogram_levels min_dB: power differs by {min_lin:.3g} of the mean')
    require(pb_err <= 1e-5, f'spectrogram_levels p_binned relative RMS {pb_err:.3g} > 1e-5')
    results['spectrogram_levels'] = {'max_abs_err': max(errs.values())}
    # the register-resident kernel (this route) and the radix-2 body it
    # replaces here against the plain version in float64, first frames
    lv64, lv64_generic = levels_f64(c0, w, nfft, quant)
    print(f'spectrogram_levels: first {N_F64_FRAMES} frames vs float64, RMS dB error of mean / max: '
          f'{json.dumps(lv64)}, radix-2 body {json.dumps(lv64_generic)}')
    for key in lv64:
        require(lv64[key] <= 2 * lv64_generic[key],
                f'spectrogram_levels {key} float64 error {lv64[key]:.4g} > 2 x the radix-2 '
                f'body\'s {lv64_generic[key]:.4g}')

    levels = lv['levels']
    kernels.colhist.route_launches.update(reg=0, generic=0)
    ch = kernels.colhist(levels, torch.zeros((nfft, quant[2]), dtype=torch.int32, device=dev))
    ch_routes = dict(kernels.colhist.route_launches)
    ch_ref = kernels.colhist_plain(levels, torch.zeros_like(ch))
    ch_l1 = int((ch.long() - ch_ref.long()).abs().sum())
    ch_old = _colhist_generic(levels, torch.zeros_like(ch))
    print(f'colhist: levels {tuple(levels.shape)} -> {tuple(ch.shape)} L1 vs plain {ch_l1}, '
          f'equal to the older {COLHIST_GENERIC_KERNEL}: {torch.equal(ch, ch_old)}; '
          f'kernels {json.dumps(ch_routes)}')
    require(ch_routes == {'reg': 1, 'generic': 0}, f'colhist kernels {ch_routes}')
    require(ch_l1 == 0, 'colhist differs from bincount on the same levels')
    require(torch.equal(ch, ch_old), f'colhist differs from the older {COLHIST_GENERIC_KERNEL}')
    require(bool((ch.sum(dim=1) == frames).all()), 'colhist: a column total is not the frame count')
    del ch_old
    results['colhist'] = {'max_abs_err': float(ch_l1)}

    pbin = lv['p_binned']
    kernels.hist.route_launches.update(bucket=0, generic=0, slices=0)
    ac = kernels.hist(pbin, apd_edges)
    hist_routes = dict(kernels.hist.route_launches)
    ac_l1 = int((ac.long() - kernels.hist_plain(pbin, apd_edges).long()).abs().sum())
    print(f'hist: {tuple(pbin.shape)} -> {tuple(ac.shape)} L1 vs plain {ac_l1}; '
          f'kernels {json.dumps(hist_routes)}')
    require(hist_routes == {'bucket': 1, 'generic': 0, 'slices': 0}, f'hist kernels {hist_routes}')
    require(ac_l1 == 0 and int(ac.sum()) == pbin.numel(), 'hist differs from sort + searchsorted')
    results['hist'] = {'max_abs_err': float(ac_l1)}
    torch.cuda.synchronize()

    # ---- phase 4b: the fold of the first chunks against the plain fold
    runs = []
    for plain in (False, True):
        c, a = P.persistence_init(design, dev), apd_zeros()
        for i in range(N_FOLD_CHECK):
            c, a = fold(c, a, i, plain=plain)
        runs.append((P.persistence_finalize(c, design, fs=1.0), a))
    errs = check_persistence(runs[0][0], runs[1][0], f'fold of {N_FOLD_CHECK} chunks',
                             N_FOLD_CHECK * frames)
    errs['apd_L1'] = check_apd(runs[0][1], runs[1][1], f'fold of {N_FOLD_CHECK} chunks',
                               N_FOLD_CHECK * CHUNK // APD_NAVG)
    print(f'fold of {N_FOLD_CHECK} chunks vs plain fold: {json.dumps(errs)}')
    del runs

    # ---- phase 4c/e: the full 1 GS through the kernels, timed
    kset = {k.__name__: k for k in kernels.KERNELS}
    carry, apd = P.persistence_init(design, dev), apd_zeros()
    carry, apd = fold(carry, apd, 0)  # warm-up: allocator, first-use setup
    carry, apd = P.persistence_init(design, dev), apd_zeros()
    torch.cuda.synchronize()
    for k in kernels.KERNELS:
        k.launches = 0
    kernels.spectrogram_levels.route_launches.update(reg=0, block=0, generic=0)
    kernels.colhist.route_launches.update(reg=0, generic=0)
    kernels.hist.route_launches.update(bucket=0, generic=0, slices=0)
    t0 = time.perf_counter()
    for i in range(N_CHUNKS):
        carry, apd = fold(carry, apd, i)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launched = {name: k.launches for name, k in kset.items()}
    routes = dict(kernels.spectrogram_levels.route_launches)
    ch_routes = dict(kernels.colhist.route_launches)
    hist_routes = dict(kernels.hist.route_launches)
    print(f'launches over {N_CHUNKS} chunks: ' + json.dumps(launched)
          + f'; levels kernels {json.dumps(routes)}; column counters {json.dumps(ch_routes)}'
          + f'; histogram kernels {json.dumps(hist_routes)}')
    require(routes == {'reg': N_CHUNKS, 'block': 0, 'generic': 0},
            f'levels kernels over {N_CHUNKS} chunks {routes}, not {LEVELS_REG_KERNEL} alone')
    require(ch_routes == {'reg': N_CHUNKS, 'generic': 0},
            f'column counters over {N_CHUNKS} chunks {ch_routes}, not {COLHIST_REG_KERNEL} alone')
    require(hist_routes == {'bucket': N_CHUNKS, 'generic': 0, 'slices': 0},
            f'histogram kernels over {N_CHUNKS} chunks {hist_routes}, not {HIST_KERNEL} alone')
    for kname in ('spectrogram_levels', 'colhist', 'hist'):
        require(launched[kname] == N_CHUNKS,
                f'{kname} launched {launched[kname]} times over {N_CHUNKS} chunks')
        results[kname]['launches'] = launched[kname]
    require(launched['spectrogram_dB'] == 0, 'the fused path launched spectrogram_dB')
    out = P.persistence_finalize(carry, design, fs=1.0)
    all_frames = n_total // nfft
    require(carry.count == all_frames, f'folded {carry.count} frames, not {all_frames}')
    require(bool((out['hist'].sum(dim=1) == all_frames).all()), '1 GS hist: column totals')
    require(int(apd.sum()) == n_total // APD_NAVG, '1 GS apd: total')
    for key in ('mean_dB', 'max_dB', 'min_dB', 'quantiles_dB'):
        require(bool(torch.isfinite(out[key]).all()), f'1 GS {key}: not finite')
    # white noise of unit variance per plane through the unit-power window:
    # E|Y|^2 = 2 / nfft, and the mean of 10 log10 of an exponential variate
    # lies 10 * euler_gamma / ln 10 dB below 10 log10 of its mean
    theory = 10 * math.log10(2 / nfft) - 10 * 0.5772156649015329 / math.log(10)
    dev_mean = float((out['mean_dB'] - theory).abs().max())
    print(f'1 GS mean_dB: {float(out["mean_dB"].mean()):.5f} dB, theory {theory:.5f} dB, '
          f'largest bin deviation {dev_mean:.5f} dB')
    require(dev_mean <= 0.05, f'1 GS mean_dB deviates {dev_mean:.4g} dB from white noise')
    ms_chunk = dt * 1e3 / N_CHUNKS
    print(f'1 GS fold: {n_total} samples in {dt:.4f} s = {n_total / dt / 1e9:.4f} GS/s, '
          f'{ms_chunk:.4f} ms per {CHUNK}-sample chunk ({smi})')

    # ---- phase 4d: one chunk's fold under the profiler
    fold_kernels = (LEVELS_REG_KERNEL, COLHIST_REG_KERNEL, HIST_KERNEL)
    names, device_us = device_kernels(lambda: fold(carry, apd, 1), *fold_kernels)
    print('chunk fold device kernels: ' + json.dumps(names))
    for k in fold_kernels:
        require(any(k in n for n in names), f'profiler shows no {k} in the fold')
    require_hist_kernel(names, 'the fold')
    radix2 = [n for n in names if LEVELS_GENERIC_KERNEL in n]
    require(not radix2, f'the radix-2 levels body ran in the fold: {radix2}')
    old_ch = [n for n in names if COLHIST_GENERIC_KERNEL in n]
    require(not old_ch, f'the older column counter ran in the fold: {old_ch}')
    bad = [n for n in names if any(f in n.lower() for f in FORBIDDEN)]
    require(not bad, f'library FFT / GEMM kernels in the fold: {bad}')
    busy_ms = sum(device_us.values()) / 1e3
    levels_device_ms = sum(us for k, us in device_us.items() if LEVELS_REG_KERNEL in k) / 1e3
    colhist_device_ms = sum(us for k, us in device_us.items() if COLHIST_REG_KERNEL in k) / 1e3
    hist_device_ms = device_ms(device_us, HIST_KERNEL)
    print('chunk fold device time by kernel (us): ' + json.dumps(
        dict(sorted(device_us.items(), key=lambda kv: -kv[1]))))
    print(f'chunk fold device busy: {busy_ms:.4f} ms of {ms_chunk:.4f} ms per chunk '
          f'(busy share {min(1.0, busy_ms / ms_chunk):.3f})')
    split = fold_host_split(lambda i: fold(carry, apd, i))
    print(f'chunk fold host time per chunk by part (ms, mean of {N_HOST_SPLIT} chunks, no '
          f'synchronize inside): ' + json.dumps(split))
    del carry, apd, out

    # ---- phase 5: the public entry point, against the plain path
    n5 = N_FOLD_CHECK * CHUNK + 5 * 131072 + 3 * 1024
    xc = torch.randn(n5, dtype=torch.complex64, device=dev, generator=gen)
    kw = dict(fs=1.0, window='hann', nfft=nfft, chunk_frames=CHUNK // nfft, hist_bins=1024,
              hist_range_dB=(-150.0, 50.0), device=dev)
    for k in kernels.KERNELS:
        k.launches = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        got = P.streaming_persistence_spectrum(xc, **kw)
    launched = {name: k.launches for name, k in kset.items()}
    ref = P.streaming_persistence_spectrum(xc, **kw, plain=True)
    dropped = [str(m.message) for m in caught if 'dropping' in str(m.message)]
    require(dropped == ['dropping 3072 trailing samples (shorter than one pallas slab)'],
            f'entry point: expected one warning for 3072 dropped samples, got {dropped}')
    frames5 = (N_FOLD_CHECK * CHUNK + 5 * 131072) // nfft
    require(got['_carry'].count == frames5, f'entry point folded {got["_carry"].count} frames')
    require(launched['spectrogram_levels'] == N_FOLD_CHECK + 1 == launched['colhist'],
            f'entry point launches {launched}')
    errs = check_persistence(got, ref, 'entry point', frames5)
    print(f'entry point: {n5} samples, {frames5} frames folded, launches {json.dumps(launched)}, '
          f'vs plain path {json.dumps(errs)}')
    # the APD's entry point on the same capture: chunks of CHUNK samples and
    # the tail, each binned by APD_NAVG and counted by the histogram kernel
    for k in kernels.KERNELS:
        k.launches = 0
    kernels.hist.route_launches.update(bucket=0, generic=0, slices=0)
    apd5 = P.streaming_apd(xc, edges=apd_edges, chunk_size=CHUNK, navg=APD_NAVG, device=dev)
    apd_launches = kernels.hist.launches
    hist_routes = dict(kernels.hist.route_launches)
    apd5_ref = P.streaming_apd(xc, edges=apd_edges, chunk_size=CHUNK, navg=APD_NAVG, device=dev,
                               plain=True)
    print(f'streaming_apd: {n5} samples, {apd_launches} histogram launches, kernels '
          f'{json.dumps(hist_routes)}, equal to the plain path: {torch.equal(apd5, apd5_ref)}')
    require(hist_routes == {'bucket': N_FOLD_CHECK + 1, 'generic': 0, 'slices': 0},
            f'streaming_apd histogram kernels {hist_routes}')
    require(torch.equal(apd5, apd5_ref), 'streaming_apd differs from the plain path')
    require(int(apd5.sum()) == n5 // APD_NAVG, 'streaming_apd: total')
    del xc, got, ref, apd5, apd5_ref

    # ---- phase 6: the unfused path (2048 bins), one chunk
    d6 = P.design_persistence(**dict(PERSISTENCE, hist_bins=2048))
    kernels.spectrogram_dB.route_launches.update(reg=0, block=0, generic=0)
    db = kernels.spectrogram_dB(c0, w, nfft)
    db_routes = dict(kernels.spectrogram_dB.route_launches)
    db_ref = kernels.spectrogram_dB_plain(c0, w, nfft)
    db_generic = _spectrogram_dB_generic(c0, w, nfft)
    band = db_ref > -100
    mean_p = torch.log10((10 ** (db_ref.double() / 10)).mean(dim=1, keepdim=True)) * 10
    shallow = band & (db_ref > mean_p - 40)
    err_db = max_abs(db[shallow], db_ref[shallow])
    err_generic = max_abs(db[shallow], db_generic[shallow])
    print(f'spectrogram_dB: {tuple(c0.shape)} -> {tuple(db.shape)}, kernels {json.dumps(db_routes)}, '
          f'|dB diff| {err_db:.3g} on the {float(shallow.double().mean()):.6f} of values above '
          f'-100 dB and within 40 dB of their frame mean, {max_abs(db[band], db_ref[band]):.3g} on '
          f'all above -100 dB; vs the radix-2 body {err_generic:.3g} on the first')
    require(db_routes == {'reg': 1, 'block': 0, 'generic': 0}, f'spectrogram_dB kernels {db_routes}')
    require(err_db <= 1e-3, f'spectrogram_dB: {err_db:.4g} dB > 1e-3 dB')
    require(err_generic <= 1e-3, f'spectrogram_dB vs the radix-2 body: {err_generic:.4g} dB > 1e-3 dB')
    results['spectrogram_dB'] = {'max_abs_err': err_db}
    # the register-resident kernel (this route) and the radix-2 body it
    # replaces here against the plain version in float64, first frames, on
    # the values of the gate above: RMS of the dB error
    head = c0[:, : N_F64_FRAMES * nfft]
    db64 = kernels.spectrogram_dB_plain(head.double(), w.to(torch.complex128), nfft)
    sel = shallow[:N_F64_FRAMES]
    db64_err = float((db[:N_F64_FRAMES].double() - db64)[sel].pow(2).mean().sqrt())
    db64_err_generic = float((db_generic[:N_F64_FRAMES].double() - db64)[sel].pow(2).mean().sqrt())
    print(f'spectrogram_dB: first {N_F64_FRAMES} frames vs float64, RMS dB error {db64_err:.4g}, '
          f'radix-2 body {db64_err_generic:.4g} (ratio {db64_err / db64_err_generic:.3f})')
    require(db64_err <= 2 * db64_err_generic,
            f'spectrogram_dB float64 error {db64_err:.4g} > 2 x the radix-2 body\'s '
            f'{db64_err_generic:.4g}')
    del db_generic, db64
    lo, scale, b6 = d6['quant']
    chf = kernels.colhist(db, torch.zeros((nfft, b6), dtype=torch.int32, device=dev),
                          lo=lo, scale=scale)
    chf_ref = kernels.colhist_plain(db, torch.zeros_like(chf), lo=lo, scale=scale)
    require(torch.equal(chf, chf_ref), 'colhist on float values differs from bincount')
    require(torch.equal(chf, _colhist_generic(db, torch.zeros_like(chf), lo=lo, scale=scale)),
            f'colhist on float values differs from the older {COLHIST_GENERIC_KERNEL}')
    require(bool((chf.sum(dim=1) == frames).all()), 'colhist on float values: column totals')
    results['colhist_values'] = {'max_abs_err': 0.0}
    for k in kernels.KERNELS:
        k.launches = 0
    kernels.spectrogram_dB.route_launches.update(reg=0, block=0, generic=0)
    c6_init = P.persistence_init(d6, dev)
    c6 = P.persistence_fold(c6_init, c0, d6)
    torch.cuda.synchronize()
    launched = {name: k.launches for name, k in kset.items()}
    db_routes = dict(kernels.spectrogram_dB.route_launches)
    require(launched['spectrogram_dB'] == 1 == launched['colhist']
            and launched['spectrogram_levels'] == 0, f'unfused fold launches {launched}')
    require(db_routes == {'reg': 1, 'block': 0, 'generic': 0},
            f'unfused fold dB kernels {db_routes}, not {DB_REG_KERNEL} alone')
    results['spectrogram_dB']['launches'] = launched['spectrogram_dB']
    results['colhist_values']['launches'] = launched['colhist']
    ref6 = P.persistence_fold(P.persistence_init(d6, dev), c0, d6, plain=True)
    errs = check_persistence(P.persistence_finalize(c6, d6, fs=1.0),
                             P.persistence_finalize(ref6, d6, fs=1.0), 'unfused fold', frames)
    print(f'unfused fold (2048 bins): launches {json.dumps(launched)}, dB kernels '
          f'{json.dumps(db_routes)}, vs plain {json.dumps(errs)}')
    del c6, ref6, chf, chf_ref
    # the unfused fold of one chunk timed (from the same empty carry, which
    # a fold leaves as it was) through this route and, in turns, through
    # the radix-2 body, then profiled
    fold6 = lambda: P.persistence_fold(c6_init, c0, d6)  # noqa: E731
    cuda_kernels = S._CUDA
    generic_kernels = cuda_kernels._replace(spectrogram_dB=_spectrogram_dB_generic)
    unfused = {'reg': [], 'generic': []}
    for route in ('generic', 'reg', 'reg', 'generic'):
        S._CUDA = generic_kernels if route == 'generic' else cuda_kernels
        try:
            unfused[route].append(timed_ms(fold6))
        finally:
            S._CUDA = cuda_kernels
    names6, device_us6 = device_kernels(fold6, DB_REG_KERNEL, COLHIST_REG_KERNEL)
    for k in (DB_REG_KERNEL, COLHIST_REG_KERNEL):
        require(any(k in n for n in names6), f'profiler shows no {k} in the unfused fold')
    radix2 = [n for n in names6 if LEVELS_GENERIC_KERNEL in n]
    require(not radix2, f'the radix-2 body ran in the unfused fold: {radix2}')
    bad = library_kernels(names6)
    require(not bad, f'library FFT / GEMM kernels in the unfused fold: {bad}')
    unfused_ms = sum(unfused['reg']) / 2
    busy6 = sum(device_us6.values()) / 1e3
    db_device_ms = device_ms(device_us6, DB_REG_KERNEL)
    print('unfused fold device time by kernel (us): ' + json.dumps(
        dict(sorted(device_us6.items(), key=lambda kv: -kv[1]))))
    print(f'unfused fold of one chunk: {unfused_ms:.4f} ms (the radix-2 dB body: '
          f'{sum(unfused["generic"]) / 2:.4f} ms; in turns generic, reg, reg, generic '
          f'{json.dumps(unfused)}); device busy {busy6:.4f} ms (idle share '
          f'{max(0.0, 1 - busy6 / unfused_ms):.3f}) ({smi})')

    # ---- phase 7: stats only (BASELINE config #1), one chunk
    d7 = P.design_persistence(**dict(PERSISTENCE, hist_bins=0))
    for k in kernels.KERNELS:
        k.launches = 0
    c7 = P.persistence_fold(P.persistence_init(d7, dev), c0, d7)
    torch.cuda.synchronize()
    launched = {name: k.launches for name, k in kset.items()}
    require(launched['spectrogram_levels'] == 1 and launched['colhist'] == 0
            and launched['spectrogram_dB'] == 0, f'stats-only fold launches {launched}')
    require(c7.hist is None, 'stats-only fold carried a histogram')
    ref7 = P.persistence_fold(P.persistence_init(d7, dev), c0, d7, plain=True)
    errs = check_persistence(P.persistence_finalize(c7, d7, fs=1.0),
                             P.persistence_finalize(ref7, d7, fs=1.0), 'stats-only fold', frames)
    print(f'stats-only fold: launches {json.dumps(launched)}, vs plain {json.dumps(errs)}')

    # ---- times of this path's kernels at the shapes it gives them
    scratch = torch.zeros((nfft, quant[2]), dtype=torch.int32, device=dev)
    cols = torch.arange(nfft, device=dev, dtype=torch.int64)
    flat = (levels.long() + cols * quant[2]).reshape(-1)
    scratch6 = torch.zeros((nfft, b6), dtype=torch.int32, device=dev)
    flat6 = (quantize_uniform(db, lo, scale, b6).long() + cols * b6).reshape(-1)
    n = CHUNK
    per_frame = fft_ops(nfft) + 12 * nfft
    work = {
        'spectrogram_levels': (8 * n + 4 * n + 4 * n // APD_NAVG + 8 * nfft + 12 * nfft,
                               frames * per_frame + 3 * n),
        'spectrogram_dB': (8 * n + 4 * n + 8 * nfft, frames * per_frame),
        'colhist': (4 * levels.numel() + 2 * 4 * scratch.numel(), levels.numel()),
        'colhist_values': (4 * db.numel() + 2 * 4 * scratch6.numel(), 4 * db.numel()),
        'hist': (4 * pbin.numel() + 4 * apd_edges.numel() + 4 * ac.numel(),
                 pbin.numel() * math.ceil(math.log2(apd_edges.numel() + 1))),
    }
    spg_levels = lambda: kernels.spectrogram_levels(c0, w, nfft, quant=quant,  # noqa: E731
                                                    apd_navg=APD_NAVG)
    spg_levels_plain = lambda: kernels.spectrogram_levels_plain(  # noqa: E731
        c0, w, nfft, quant=quant, apd_navg=APD_NAVG)
    spg_db_plain = lambda: kernels.spectrogram_dB_plain(c0, w, nfft)  # noqa: E731
    calls = {
        # library: the torch.fft formulation (the plain version) for the
        # spectrogram rows, one torch.bincount for the column counts; no
        # single PyTorch call counts fixed-edge histograms
        'spectrogram_levels': (spg_levels, spg_levels_plain, spg_levels_plain),
        'spectrogram_dB': (lambda: kernels.spectrogram_dB(c0, w, nfft), spg_db_plain,
                           spg_db_plain),
        'colhist': (lambda: kernels.colhist(levels, scratch),
                    lambda: kernels.colhist_plain(levels, scratch),
                    lambda: torch.bincount(flat, minlength=scratch.numel())),
        'colhist_values': (lambda: kernels.colhist(db, scratch6, lo=lo, scale=scale),
                           lambda: kernels.colhist_plain(db, scratch6, lo=lo, scale=scale),
                           lambda: torch.bincount(flat6, minlength=scratch6.numel())),
        'hist': (lambda: kernels.hist(pbin, apd_edges),
                 lambda: kernels.hist_plain(pbin, apd_edges), None),
    }
    rows = {}
    for kname, (kernel_fn, plain_fn, library_fn) in calls.items():
        nbytes, nops = work[kname]
        row = kernel_row(kname, results[kname], nbytes, nops, kernel_fn, plain_fn,
                         library_fn, mem_rate, fp32_rate)
        rows[kname] = row
        print(f'{kname}: {row["ms"]:.4f} ms (bound {row["bound_ms"]:.4f} ms by '
              f'{row["bound_by"]}, plain {row["plain_ms"]:.4f} ms, library '
              f'{row["library_ms"]}) on {smi}')
    levels_row = rows['spectrogram_levels']
    levels_row['generic_ms'] = timed_ms(lambda: _spectrogram_levels_generic(
        c0, w, nfft, quant=quant, apd_navg=APD_NAVG))
    levels_row['f64_rms_dB'] = lv64
    levels_row['generic_f64_rms_dB'] = lv64_generic
    levels_row['profiled_device_ms'] = levels_device_ms
    rows['colhist']['generic_ms'] = timed_ms(lambda: _colhist_generic(levels, scratch))
    rows['colhist']['profiled_device_ms'] = colhist_device_ms
    rows['colhist_values']['generic_ms'] = timed_ms(
        lambda: _colhist_generic(db, scratch6, lo=lo, scale=scale))
    rows['colhist_values']['profiled_device_ms'] = sum(device_kernels(
        lambda: kernels.colhist(db, scratch6, lo=lo, scale=scale), COLHIST_REG_KERNEL)[1].values()) / 1e3
    print(f'colhist: the older {COLHIST_GENERIC_KERNEL} {rows["colhist"]["generic_ms"]:.4f} ms '
          f'({colhist_device_ms:.4f} ms of device time in the profiled chunk fold); on float '
          f'values {rows["colhist_values"]["profiled_device_ms"]:.4f} ms of device time, the '
          f'older kernel {rows["colhist_values"]["generic_ms"]:.4f} ms, on {smi}')
    print(f'spectrogram_levels: radix-2 body {levels_row["generic_ms"]:.4f} ms; '
          f'{levels_device_ms:.4f} ms of device time in the profiled chunk fold, on {smi}')
    hist_row = rows['hist']
    hist_row.update(hist_times(pbin, apd_edges, hist_device_ms))
    print(f'hist: {hist_device_ms:.4f} ms of device time in the profiled chunk fold; the older '
          f'{HIST_GENERIC_KERNEL} {hist_row["generic_ms"]:.4f} ms, '
          f'{hist_row["generic_profiled_device_ms"]:.4f} ms of device time alone; host time a '
          f'call {hist_row["host_ms"]:.4f} ms, the older wrapper {hist_row["generic_host_ms"]:.4f} '
          f'ms, on {smi}')
    db_row = rows['spectrogram_dB']
    db_row['generic_ms'] = timed_ms(lambda: _spectrogram_dB_generic(c0, w, nfft))
    _, generic_us = device_kernels(lambda: _spectrogram_dB_generic(c0, w, nfft),
                                   LEVELS_GENERIC_KERNEL)
    db_row.update({
        'profiled_device_ms': db_device_ms,
        'generic_profiled_device_ms': device_ms(generic_us, LEVELS_GENERIC_KERNEL),
        'f64_rms_dB': db64_err,
        'generic_f64_rms_dB': db64_err_generic,
        'unfused_fold_ms': unfused_ms,
        'unfused_fold_generic_ms': sum(unfused['generic']) / 2,
        'unfused_fold_busy_ms': busy6,
    })
    print(f'spectrogram_dB: {db_device_ms:.4f} ms of device time in the profiled unfused fold; '
          f'the radix-2 body {db_row["generic_ms"]:.4f} ms, '
          f'{db_row["generic_profiled_device_ms"]:.4f} ms of device time alone, on {smi}')
    # one kernel, one row: its float-value instance rides along in it
    rows['colhist']['float_values'] = rows.pop('colhist_values')
    return list(rows.values())


def library_kernels(names) -> list:
    """the device kernels among ``names`` that come from a library: cuFFT,
    cuBLAS, CUTLASS or cuDNN (by name without the parameter list: the
    frame kernel's own takes iqt::FftPlan)."""
    return [n for n in names if any(f in short_name(n).lower() for f in FORBIDDEN + ('cudnn',))]


def device_kernels(fn, *expect: str, fresh: str | None = None, counts: dict | None = None) -> tuple:
    """run ``fn`` once under the profiler: (sorted device kernel names,
    device microseconds by short name); ``counts``, where given, gets the
    trace's device events by short name.

    On an H100 (torch 2.11, CUDA 12.8) a trace of a call made only of the
    port's kernels (``corr_at_indices``, ``channelize_power``) late in this
    script now and then holds no device event, though the wrapper counted
    the launch; in some processes every such trace does, however often it
    is taken, while a fresh process traces the same call. A trace that
    lacks a kernel whose name holds one of ``expect`` is therefore taken
    again, up to ``PROFILE_TRIES`` times, and then, where ``fresh`` names
    the call (see ``trace_call``), in a fresh process. Each retake is
    printed.
    """
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_SETTLE_S)
            fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_SETTLE_S)
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        missing = [k for k in expect if not any(k in e.name for e in events)]
        if not missing:
            device_us = {}
            for e in events:
                key = short_name(e.name)
                device_us[key] = device_us.get(key, 0.0) + e.time_range.elapsed_us()
                if counts is not None:
                    counts[key] = counts.get(key, 0) + 1
            return sorted({e.name for e in events}), device_us
        host = sorted({e.name for e in prof.events() if e.name.startswith('cuda')})
        print(f'profiler: trace {attempt + 1} of {PROFILE_TRIES} holds no {missing} '
              f'({len(events)} device events; host CUDA calls {host})')
    if fresh is None:
        return [], {}
    print(f'profiler: taking the trace of {fresh} in a fresh process')
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), '--trace', fresh],
                          capture_output=True, text=True, timeout=FRESH_TRACE_TIMEOUT_S)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(f'profiler ({fresh}, fresh process): {line}')
    if proc.returncode or not lines:
        print(f'profiler: the fresh process exited {proc.returncode}: {proc.stderr[-2000:]}')
        return [], {}
    got = json.loads(lines[-1])
    if counts is not None:
        counts.update(got.get('counts', {}))
    return got['names'], got['device_us']


def trace_call(name: str) -> int:
    """``python3 chip_smoke.py --trace corr|channelize|cluster|cluster6|
    channels48|channels96|channels64x512|stats4096|planes_i16|stream|
    psd_default|psd_histogram_1024|psd_histogram_2048|sample_ccdf|
    psd_sort_2e28|psd_refined_2e28|split_hamming_65536|split_blackman_196608|
    split_blackmanharris_655360|split_blackmanharris_163840|split_ola_filter|
    tier_<row of 24a>|tier_ola_filter_i16|tier_ola_filter_bf16|tier_step_planes_i16|
    radix7_hamming|radix7_blackman|radix7_blackmanharris|host_step|
    ola_2to1_<route>_<nfft> (ADD_STEPS)|split_c<C>_<nfft>... (WIDE_SPLIT)|
    plan_<design> (PLAN_STEPS)|plan_frames_<nfft>_<nfft_out> (PLAN_TIMED)|
    plan_cluster_<design> (PC_STEPS)|splitcall_<n>_<mode>_<route>|
    splitstep_<design>_navg<navg> (split_call_trace)|prime_ola_filter_<nfft>
    (PRIME_FILTERS)|prime_step_<window> (PRIME_STEPS)``:
    make the call of phase 11, 15, 16c, 16d, 17b, 18b-c, 19d, 20a, 22b,
    23a, 23e, 24, 25b, 26b, 26d, 27b, 27c, 28c, 29b, 29c, 31b or 31c at its shapes, on noise from ``SEED``
    (phases 19-20's on their tone + noise; the kernels' work does not
    depend on the values), warm it up, trace it with
    ``device_kernels`` and print (names, device us and events by kernel)
    as the last line, a JSON object (``--trace split_ola_filter``: the launches by
    kernel, ``device_launches``). Exits 1 if the trace lacks a kernel. ``--trace
    stats4096`` prints ``stats4096_device_ms`` instead (phase 17a)."""
    sys.path.insert(0, str(ROOT))
    from iqwaveform_torch import WidebandMonitor, channelize_power, design_wideband_monitor, ofdm

    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(SEED)
    if name == 'corr':
        phy, inds, x = corr_noise(ofdm, gen, dev)

        def fn():
            return ofdm.corr_at_indices(inds, x, phy.nfft)

        expect = CORR_KERNELS
    elif name in ('cluster', 'cluster6'):
        if name == 'cluster':
            mon = WidebandMonitor(design_wideband_monitor(122.88e6, 61.44e6, **CLUSTER_MONITOR))
        else:
            mon = WidebandMonitor(design_wideband_monitor(122.88e6, 30.72e6, window='blackman',
                                                          **WIDE_CLUSTER_MONITOR))
        n = (N_CLUSTER_STEP if name == 'cluster'
             else round(N_CLUSTER_STEP / mon.min_input_multiple()) * mon.min_input_multiple())
        x = torch.randn(n, dtype=torch.complex64, device=dev, generator=gen)

        def fn():
            return mon.step(x)

        expect = (CLUSTER_KERNEL, STATS_REG_KERNEL, HIST_KERNEL)
    elif name in CHAN_DESIGNS:
        extra, _, kernel, _ = CHAN_DESIGNS[name]
        mon = WidebandMonitor(design_wideband_monitor(122.88e6, 61.44e6, **CHAN_MONITOR, **extra))
        n = (N_STEP // mon.min_input_multiple()) * mon.min_input_multiple()
        x = torch.randn(n, dtype=torch.complex64, device=dev, generator=gen)

        def fn():
            return mon.step(x)

        expect = (OLA_REG_KERNEL, kernel, HIST_KERNEL)
    elif name in ('planes_i16', 'stream'):
        import dataclasses

        mon = WidebandMonitor(design_wideband_monitor(122.88e6, 61.44e6, **FLAGSHIP))
        if name == 'planes_i16':
            mon = WidebandMonitor(dataclasses.replace(mon.design, fft_precision='i16',
                                                      input_scale=I16_INPUT_SCALE))
            p = (PLANES_SCALE * torch.randn((2, N_PLANES), device=dev, generator=gen)).round()
            p = p.to(torch.int16)

            def fn():
                return mon.step_planes(p)
        else:
            chunks = torch.randn(3 * STREAM_CHUNK, dtype=torch.complex64, device=dev,
                                 generator=gen).split(STREAM_CHUNK)
            carry = mon.accumulate_step(mon.accumulate_step(mon.init_carry(STREAM_CHUNK),
                                                            chunks[0]), chunks[1])

            def fn():
                return mon.accumulate_step(carry, chunks[2])

        expect = (OLA_REG_KERNEL, STATS_REG_KERNEL, HIST_KERNEL)
    elif name == 'stats4096':
        got = stats4096_device_ms(dev, fresh=False)
        print(json.dumps(got))
        return 0 if got else 1
    elif name in PSD_TRACES:
        import iqwaveform_torch as it

        x = psd_capture(dev)
        fn = psd_calls(it, x, it.envtopow(x), ccdf_edges())[name]
        expect = PSD_TRACES[name]
    elif name in REFINE_TRACES:
        import iqwaveform_torch as it

        x = long_capture(dev, N_REFINE_BOTH)
        fn = ((lambda: it.power_spectral_density(x, **psd_kwargs())) if name == 'psd_sort_2e28'
              else (lambda: refined_psd(x)))
        expect = REFINE_TRACES[name]
    elif name in SPLIT_STEPS:
        fo, kw, _ = SPLIT_STEPS[name]
        mon = split_design(fo, kw['window'], kw['min_fft_size'])
        x, _ = split_step_frames(mon, N_SPLIT_STEP, gen, dev)

        def fn():
            return mon.step(x)

        expect = SPLIT_KERNELS
    elif name == 'host_step':
        # 23a's step on the (2, N_HOST) capture (the recording's samples, as
        # read back from its SigMF file, are these)
        mon = WidebandMonitor(design_wideband_monitor(122.88e6, 61.44e6, **FLAGSHIP))
        x = host_captures(dev)

        def fn():
            return mon.step(x)

        expect = (OLA_REG_KERNEL, STATS_REG_KERNEL, HIST_KERNEL)
    elif name in ADD_STEPS:
        (fo, m), _, _, frame_kernels = ADD_STEPS[name]
        mon = split_design(fo, 'hamming', m)
        x = add_step_input(mon, gen, dev)

        def fn():
            return mon.step(x)

        expect = (ADD_KERNEL,) + frame_kernels
    elif name in PLAN_STEPS or name in PC_STEPS:
        mon = plan_design(name) if name in PLAN_STEPS else pc_design(name)
        x = plan_step_input(mon, gen, dev)

        def fn():
            return mon.step(x)

        expect = (route_kernel(mon.routes['ola']),)
    elif name.startswith('plan_frames_'):
        fn, kernel = plan_frames_trace(name, gen, dev)
        expect = (kernel,)
    elif name in WIDE_SPLIT:
        (fo, w, m), _ = WIDE_SPLIT[name]
        mon = split_design(fo, w, m)
        x = add_step_input(mon, gen, dev)

        def fn():
            return mon.step(x)

        expect = SPLIT_KERNELS
    elif name == 'split_ola_filter':
        import iqwaveform_torch as it

        xs = torch.randn(N_SPLIT_FILTER, dtype=torch.complex64, device=dev, generator=gen)
        it.ola_filter(xs, **SPLIT_FILTER_KW)
        torch.cuda.synchronize()
        counts = device_launches(lambda: it.ola_filter(xs, **SPLIT_FILTER_KW), SPLIT_KERNELS)
        print(json.dumps({'counts': counts}))
        return 0 if counts else 1
    elif name.startswith(('tier_', 'radix7_')):
        fn, expect = tier_trace(name, dev, gen)
    elif name.startswith(('splitcall_', 'splitstep_')):
        fn, expect = split_call_trace(name, gen, dev)
    elif name.startswith('prime_'):
        fn, expect = prime_trace(name, gen, dev)
    elif name == 'channelize':
        per = CHANNELIZE['fft_size_per_channel']
        n_use = CHANNELIZE_FRAMES * per * CHANNELIZE['channel_count']
        x = torch.randn(CHANNELIZE_CAPTURES * n_use, dtype=torch.complex64, device=dev,
                        generator=gen)
        kw = {k: v for k, v in CHANNELIZE.items() if k != 'fft_size_per_channel'}

        def fn():
            return channelize_power(x, CHANNELIZE_TS, per, **kw)

        expect = (CHAN_REG_KERNEL,)
    else:
        raise ValueError(f'no call named {name!r} to trace')
    fn()
    torch.cuda.synchronize()
    counts = {}
    names, device_us = device_kernels(fn, *expect, counts=counts)
    print(json.dumps({'names': names, 'device_us': device_us, 'counts': counts}))
    return 0 if names else 1


def upfirdn_flop(len_h, n_in, n_out, up, down, per_tap, dev) -> float:
    """the flop this call's data needs: per output, the taps that meet a
    sample inside the row, times the flop of one product."""
    total = 0
    for start in range(0, n_out, 1 << 26):
        n = torch.arange(start, min(n_out, start + (1 << 26)), device=dev, dtype=torch.int64)
        t = n * down
        p, i0 = t % up, t // up
        taps = (len_h - p + up - 1) // up
        hi = torch.minimum(taps - 1, i0)
        lo = torch.clamp(i0 - n_in + 1, min=0)
        total += int((hi - lo + 1).clamp(min=0).sum())
    return float(total * per_tap)


def f64_errors(inp, kw, kernel_fn, generic_fn, plain_fn, pick=lambda out: out) -> tuple:
    """relative RMS of ``kernel_fn`` (the kernel its route runs) and of
    ``generic_fn`` (the older kernel it replaces there) against
    ``plain_fn`` in complex128 on ``inp``, the arguments widened;
    ``pick`` takes the compared tensor from a call's result."""
    wide = {k: v.to(torch.complex128) if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
    ref = pick(plain_fn(inp.to(torch.complex128), **wide))
    return rel_rms(pick(kernel_fn(inp, **kw)), ref), rel_rms(pick(generic_fn(inp, **kw)), ref)


def frames_f64(frames, kw) -> tuple:
    """the frame kernel's errors (``f64_errors``) on the first
    N_F64_FRAMES frames."""
    from iqwaveform_torch.ops import kernels
    from iqwaveform_torch.ops.kernels.fused_ola import _fused_ola_frames_generic

    return f64_errors(frames[:N_F64_FRAMES], kw, kernels.fused_ola_frames,
                      _fused_ola_frames_generic, kernels.fused_ola_frames_plain)


def ola_f64(x, kw) -> tuple:
    """the 2:1 OLA kernel's errors (``f64_errors``) on the output span of
    the first N_F64_FRAMES frames (a prefix of that many hops)."""
    from iqwaveform_torch.ops import kernels
    from iqwaveform_torch.ops.kernels.fused_ola import _fused_ola_generic

    return f64_errors(x[: N_F64_FRAMES * (kw['nfft'] - kw['noverlap_in'])], kw, kernels.fused_ola,
                      _fused_ola_generic, kernels.fused_ola_plain)


def chan_f64(y, kw) -> tuple:
    """the channelizer kernel's errors (``f64_errors``) in channel power
    on the first N_F64_FRAMES frames."""
    from iqwaveform_torch.ops import kernels
    from iqwaveform_torch.ops.kernels.chan_stats import _chan_stats_generic

    return f64_errors(y[: N_F64_FRAMES * kw['nfft_big']], kw, kernels.chan_stats,
                      _chan_stats_generic, kernels.chan_stats_plain,
                      pick=lambda out: out['channel_power'])


def require_frame_kernel(names, label: str) -> None:
    """the profile of ``label`` holds the register-resident frame kernel and
    no generic one."""
    require(any(REG_KERNEL in n for n in names), f'profiler shows no {REG_KERNEL} in {label}')
    generic = [n for n in names if GENERIC_KERNEL in n]
    require(not generic, f'the generic frame kernel ran in {label}: {generic}')


def require_stats_kernel(names, label: str) -> None:
    """the profile of ``label`` holds the register-resident channelizer
    statistics kernel and no radix-2 one."""
    require(any(STATS_REG_KERNEL in n for n in names),
            f'profiler shows no {STATS_REG_KERNEL} in {label}')
    old = [n for n in names if STATS_GENERIC_KERNEL in n or 'chan_reduce_kernel' in n]
    require(not old, f'the radix-2 channelizer kernel ran in {label}: {old}')


def require_hist_kernel(names, label: str) -> None:
    """the profile of ``label`` holds the bucket-table histogram kernel
    and not the older one (by its name without the parameter list:
    ``colhist_kernel`` holds ``hist_kernel`` too)."""
    require(any(HIST_KERNEL in n for n in names), f'profiler shows no {HIST_KERNEL} in {label}')
    old = [n for n in names if short_name(n) == HIST_GENERIC_KERNEL]
    require(not old, f'the older histogram kernel ran in {label}: {old}')


def device_ms(device_us: dict, kernel: str) -> float:
    """the device milliseconds of the kernels named ``kernel`` (exactly,
    without the parameter list) in a device_kernels breakdown."""
    return sum(us for k, us in device_us.items() if k.split('<')[0] == kernel) / 1e3


def host_ms(fn, calls: int = HOST_CALLS) -> float:
    """the host milliseconds a call of ``fn`` takes to return, by the host
    clock around ``calls`` calls with no synchronize inside (the device
    runs behind)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e3 / calls


def hist_times(p, edges, profiled_ms: float) -> dict:
    """the bucket-table kernel's profiled device time in the path's run
    beside the older kernel's, timed by events and profiled alone, on the
    path's samples ``p`` and ``edges``; and the host time of a call of
    :func:`hist` and of the older kernel's wrapper, taken in HOST_ROUNDS
    turns (older first, then new first, ...), the median of each."""
    from iqwaveform_torch.ops import kernels
    from iqwaveform_torch.ops.kernels.hist import _hist_generic

    _, generic_us = device_kernels(lambda: _hist_generic(p, edges), HIST_GENERIC_KERNEL)
    host = {kernels.hist: [], _hist_generic: []}
    for turn in range(HOST_ROUNDS):
        for fn in (_hist_generic, kernels.hist)[::1 if turn % 2 == 0 else -1]:
            host[fn].append(host_ms(lambda: fn(p, edges)))
    return {
        'profiled_device_ms': profiled_ms,
        'generic_ms': timed_ms(lambda: _hist_generic(p, edges)),
        'generic_profiled_device_ms': device_ms(generic_us, HIST_GENERIC_KERNEL),
        'host_ms': float(np.median(host[kernels.hist])),
        'generic_host_ms': float(np.median(host[_hist_generic])),
    }


def require_no_spill(report: str) -> None:
    """ptxas reports 0 bytes of spill for every instance of the kernels
    in NO_SPILL."""
    lines = report.splitlines()
    seen = 0
    for i, line in enumerate(lines):
        if 'Compiling entry' in line and any(k in line for k in NO_SPILL):
            props = next((ln for ln in lines[i + 1:i + 4] if 'spill stores' in ln), '')
            seen += 1
            require('0 bytes spill stores, 0 bytes spill loads' in props,
                    f'ptxas: {line.strip()[:120]} spills: {props.strip()}')
    require(seen > 0, f'ptxas reports no instance of {NO_SPILL}')


def filtering_phases(dev, smi: str, mem_rate: float, fp32_rate: float) -> tuple:
    """phases 8-10; returns the kernels line's rows of this path, and the
    histogram's numbers at the blackman step's shape (for its row)."""
    import iqwaveform_torch as it
    from iqwaveform_torch.ops import filtering as TF
    from iqwaveform_torch.ops import kernels
    from iqwaveform_torch.ops.kernels.fused_ola import _fused_ola_frames_generic
    from iqwaveform_torch.ops.kernels.upfirdn import _upfirdn_generic, upfirdn_output_len

    kset = {k.__name__: k for k in kernels.KERNELS}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    nfft, nfft_out = OLA_KW['nfft'], OLA_KW['nfft_out']
    hop = nfft // 2

    reset = reset_counts

    def counts():
        return {name: k.launches for name, k in kset.items() if k.launches}

    def frame_routes(label):
        routes = dict(kernels.fused_ola_frames.route_launches)
        print(f'{label} frame kernels: {json.dumps(routes)}')
        require(routes == {'reg': 1, 'cluster': 0, 'split': 0, 'plan': 0, 'plan_cluster': 0, 'generic': 0},
                f'{label} frame kernels {routes}')

    torch.cuda.reset_peak_memory_stats(dev)

    # ---- phase 8: ola_filter at BASELINE config #2
    x = torch.randn(N_OLA, dtype=torch.complex64, device=dev, generator=gen)
    it.ola_filter(x[: 4 * nfft], **OLA_KW)  # warm-up: build, first-use setup
    torch.cuda.synchronize()
    reset()
    y = it.ola_filter(x, **OLA_KW)
    torch.cuda.synchronize()
    launched = counts()
    print(f'ola_filter launches: {json.dumps(launched)}')
    require(launched == {'fused_ola_frames': 1}, f'ola_filter launches {launched}')
    frame_routes('ola_filter')
    ref = it.ola_filter(x, **OLA_KW, plain=True)
    require(y.shape == ref.shape == (N_OLA * nfft_out // nfft,), f'ola_filter shape {tuple(y.shape)}')
    require(bool(torch.isfinite(torch.view_as_real(y)).all()), 'ola_filter output not finite')
    err_route = rel_rms(y, ref)
    n_pre = 2 * N_OLA_CHAIN + nfft // 2  # a prefix whose frames cover the first samples
    chain = it.ola_filter(x[:n_pre], **OLA_KW, fft_backend='xla')
    err_chain = rel_rms(y[:N_OLA_CHAIN], chain[:N_OLA_CHAIN])
    print(f'ola_filter: {N_OLA} -> {y.numel()} samples, vs plain route relative RMS '
          f'{err_route:.3g}, first {N_OLA_CHAIN} vs the torch.fft stage chain {err_chain:.3g}')
    require(err_route <= 1e-5, f'ola_filter vs plain route: relative RMS {err_route:.3g} > 1e-5')
    require(err_chain <= 1e-5, f'ola_filter vs stage chain: relative RMS {err_chain:.3g} > 1e-5')
    del ref, chain
    ola_ms = timed_ms(lambda: it.ola_filter(x, **OLA_KW), reps=FILTER_REPS, warmup=1)
    names, device_us = device_kernels(lambda: it.ola_filter(x, **OLA_KW), REG_KERNEL)
    print('ola_filter device kernels: ' + json.dumps(names))
    require_frame_kernel(names, 'ola_filter')
    bad = library_kernels(names)
    require(not bad, f'library FFT / GEMM / cuDNN kernels in ola_filter: {bad}')
    busy = sum(device_us.values()) / 1e3
    print('ola_filter device time by kernel (us): ' + json.dumps(
        dict(sorted(device_us.items(), key=lambda kv: -kv[1]))))
    print(f'ola_filter: {ola_ms:.4f} ms for {N_OLA} samples = {N_OLA / ola_ms / 1e3:.1f} MS/s; '
          f'device busy {busy:.4f} ms (idle share {max(0.0, 1 - busy / ola_ms):.3f}) ({smi})')

    # the frame kernel alone at this path's shapes
    enbw = it.equivalent_noise_bandwidth('hamming', nfft_out, fftbins=False)
    zero_lo, zero_hi, b_in, b_out = TF._ola_bin_bounds(
        nfft, nfft_out, OLA_KW['fs'], OLA_KW['passband'], enbw, True)
    w_in, w_out = TF._ola_windows('hamming', nfft, nfft_out, hop, dev)
    fkw = dict(w_in=w_in, w_shift_out=w_out, nfft=nfft, nfft_out=nfft_out, zero_lo=zero_lo,
               zero_hi=zero_hi, bounds_in=b_in, bounds_out=b_out)
    frames = x.unfold(-1, nfft, hop)
    got_f = kernels.fused_ola_frames(frames, **fkw)
    ref_f = kernels.fused_ola_frames_plain(frames, **fkw)
    err = rel_rms(got_f, ref_f)
    print(f'fused_ola_frames: frames {tuple(frames.shape)} -> {tuple(got_f.shape)} relative RMS {err:.3g}')
    require(err <= 1e-5, f'fused_ola_frames relative RMS {err:.3g} > 1e-5')
    err64, err64_generic = frames_f64(frames, fkw)
    print(f'fused_ola_frames: first {N_F64_FRAMES} frames vs the complex128 chain: relative RMS '
          f'{err64:.4g}, generic kernel {err64_generic:.4g}')
    require(err64 <= 2 * err64_generic,
            f'fused_ola_frames complex128 error {err64:.4g} > 2 x the generic kernel\'s {err64_generic:.4g}')
    n_frames = frames.shape[0]
    frames_row = kernel_row(
        'fused_ola_frames', {'launches': launched.get('fused_ola_frames', 0),
                             'max_abs_err': max_abs(got_f, ref_f)},
        8 * x.numel() + 8 * got_f.numel() + 8 * (nfft + nfft_out),
        n_frames * (fft_ops(nfft) + fft_ops(nfft_out) + 6 * (nfft + nfft_out)),
        lambda: kernels.fused_ola_frames(frames, **fkw),
        lambda: kernels.fused_ola_frames_plain(frames, **fkw),
        lambda: kernels.fused_ola_frames_plain(frames, **fkw),
        mem_rate, fp32_rate, reps=FILTER_REPS, warmup=1,
    )
    frames_row['generic_ms'] = timed_ms(lambda: _fused_ola_frames_generic(frames, **fkw),
                                        reps=FILTER_REPS, warmup=1)
    frames_row['f64_rel_rms'] = err64
    frames_row['generic_f64_rel_rms'] = err64_generic
    frames_row['path'] = 'ola_filter, BASELINE config #2'
    frames_row['path_ms'] = ola_ms
    print(f'fused_ola_frames: {frames_row["ms"]:.4f} ms (bound {frames_row["bound_ms"]:.4f} ms by '
          f'{frames_row["bound_by"]}, plain {frames_row["plain_ms"]:.4f} ms, generic kernel '
          f'{frames_row["generic_ms"]:.4f} ms) on {smi}')
    del x, y, got_f, ref_f, frames
    torch.cuda.empty_cache()

    # ---- phase 9: upfirdn at 4001 taps on 10^8 samples
    h = torch.from_numpy(it.design_fir_lpf(20e6, 61.44e6)).to(dev)
    x9 = torch.randn(N_UPFIRDN, dtype=torch.complex64, device=dev, generator=gen)
    it.upfirdn(h, x9[:65536], 1, 2)  # warm-up
    torch.cuda.synchronize()
    pairs = {}
    for up, down in UPFIRDN_PAIRS:
        reset()
        y9 = it.upfirdn(h, x9, up, down)
        torch.cuda.synchronize()
        launched = counts()
        require(launched == {'upfirdn_cuda': 1}, f'upfirdn {up}/{down} launches {launched}')
        routes = dict(kernels.upfirdn_cuda.route_launches)
        require(routes == {'reg': 1, 'generic': 0},
                f'upfirdn {up}/{down} kernels {routes}, not one of {UPFIRDN_REG_KERNEL}')
        n_out = upfirdn_output_len(h.numel(), N_UPFIRDN, up, down)
        ref9 = it.upfirdn(h, x9, up, down, backend='xla')
        require(y9.shape == ref9.shape == (n_out,), f'upfirdn shape {tuple(y9.shape)}')
        require(bool(torch.isfinite(torch.view_as_real(y9)).all()), 'upfirdn output not finite')
        err = rel_rms(y9, ref9)
        # the outputs below N_UPFIRDN_F64 read no sample past this prefix,
        # and neither kernel's order of summation depends on the blocking,
        # so a call on the prefix gives the full call's first outputs
        prefix = x9[: (N_UPFIRDN_F64 * down) // up + 1]
        y64 = kernels.upfirdn_plain(h.double(), prefix[None].to(torch.complex128), up,
                                    down)[0, :N_UPFIRDN_F64]
        err64 = rel_rms(y9[:N_UPFIRDN_F64], y64)
        generic64 = rel_rms(_upfirdn_generic(h, prefix[None], up, down)[0, :N_UPFIRDN_F64], y64)
        print(f'upfirdn {up}/{down}: {N_UPFIRDN} -> {n_out} samples, {h.numel()} taps, vs plain '
              f'conv1d relative RMS {err:.3g}, first {N_UPFIRDN_F64} vs float64 {err64:.4g} '
              f'(generic kernel {generic64:.4g}), launches {json.dumps(launched)}, kernels '
              f'{json.dumps(routes)}')
        require(err <= 1e-5, f'upfirdn {up}/{down} vs plain: relative RMS {err:.3g} > 1e-5')
        require(err64 <= 1e-5, f'upfirdn {up}/{down} vs float64: relative RMS {err64:.3g} > 1e-5')
        require(err64 <= 2 * generic64,
                f'upfirdn {up}/{down} float64 error {err64:.4g} > 2 x the generic kernel\'s '
                f'{generic64:.4g}')
        row = kernel_row(
            'upfirdn', {'launches': launched.get('upfirdn_cuda', 0), 'max_abs_err': max_abs(y9, ref9)},
            8 * N_UPFIRDN + 4 * h.numel() + 8 * n_out,
            upfirdn_flop(h.numel(), N_UPFIRDN, n_out, up, down, 4, dev),
            lambda: kernels.upfirdn_cuda(h, x9[None], up, down),
            lambda: kernels.upfirdn_plain(h, x9[None], up, down),
            lambda: kernels.upfirdn_plain(h, x9[None], up, down),
            mem_rate, fp32_rate, reps=5, warmup=1,
        )
        row['generic_ms'] = timed_ms(lambda: _upfirdn_generic(h, x9[None], up, down),
                                     reps=5, warmup=1)
        row['f64_rel_rms'] = err64
        row['generic_f64_rel_rms'] = generic64
        row['up_down'] = [up, down]
        row['MS_per_s'] = N_UPFIRDN / row['ms'] / 1e3
        print(f'upfirdn {up}/{down}: {row["ms"]:.4f} ms = {row["MS_per_s"]:.1f} MS/s in '
              f'(bound {row["bound_ms"]:.4f} ms by {row["bound_by"]}, generic kernel '
              f'{row["generic_ms"]:.4f} ms, plain conv1d {row["plain_ms"]:.4f} ms, library '
              f'conv1d {row["library_ms"]:.4f} ms) on {smi}')
        pairs[(up, down)] = row
        del y9, ref9, y64, prefix
    up_row = pairs[UPFIRDN_PAIRS[0]]
    up_row['other_pairs'] = [
        {k: r[k] for k in ('up_down', 'launches', 'max_abs_err', 'ms', 'generic_ms', 'plain_ms',
                           'bound_ms', 'bound_by', 'library_ms', 'f64_rel_rms',
                           'generic_f64_rel_rms')}
        for pair, r in pairs.items() if pair != UPFIRDN_PAIRS[0]
    ]
    del x9
    torch.cuda.empty_cache()

    # ---- phase 10: the monitor at the blackman design (R = 3)
    mon = it.WidebandMonitor(it.design_wideband_monitor(30.72e6, 15.36e6, **BLACKMAN))
    d = mon.design
    require((d.nfft, d.nfft_out) == (12288, 6144), f'blackman design {d.nfft} -> {d.nfft_out}')
    x10 = torch.randn(N_MONITOR_R3, dtype=torch.complex64, device=dev, generator=gen)
    mon.step(x10[: 4 * mon.min_input_multiple()])  # warm-up
    torch.cuda.synchronize()
    reset()
    out = mon.step(x10)
    torch.cuda.synchronize()
    launched = counts()
    print(f'blackman step launches: {json.dumps(launched)}')
    require(launched == {'fused_ola_frames': 1, 'chan_stats': 1, 'hist': 1},
            f'blackman step launches {launched}')
    frame_routes('blackman step')
    chan_routes = dict(kernels.chan_stats.route_launches)
    hist_routes = dict(kernels.hist.route_launches)
    print(f'blackman step channelizer kernels: {json.dumps(chan_routes)}; histogram kernels '
          f'{json.dumps(hist_routes)}')
    require(chan_routes == CHAN_REG_ROUTE, f'blackman step channelizer kernels {chan_routes}')
    require(hist_routes == {'bucket': 1, 'generic': 0, 'slices': 0}, f'blackman step histogram kernels {hist_routes}')
    check_step(out, mon.reference_step(x10), 'blackman step vs plain-version step')
    step_ms = timed_ms(lambda: mon.step(x10))
    names, device_us = device_kernels(lambda: mon.step(x10), REG_KERNEL,
                                      STATS_REG_KERNEL, HIST_KERNEL)
    require_frame_kernel(names, 'the blackman step')
    require_stats_kernel(names, 'the blackman step')
    require_hist_kernel(names, 'the blackman step')
    bad = library_kernels(names)
    require(not bad, f'library FFT / GEMM / cuDNN kernels in the blackman step: {bad}')
    busy = sum(device_us.values()) / 1e3
    print('blackman step device time by kernel (us): ' + json.dumps(
        dict(sorted(device_us.items(), key=lambda kv: -kv[1]))))
    print(f'blackman step: {step_ms:.4f} ms for {N_MONITOR_R3} samples = '
          f'{N_MONITOR_R3 / step_ms / 1e3:.1f} MS/s; device busy {busy:.4f} ms (idle share '
          f'{max(0.0, 1 - busy / step_ms):.3f}) ({smi})')
    kw = {k: v for k, v in mon.ola_kwargs.items() if not k.startswith('noverlap')}
    n_fr = N_MONITOR_R3 // mon.hop_in
    xe = torch.cat([x10, x10.new_zeros(mon.noverlap_in)])
    fr = xe.unfold(-1, d.nfft, mon.hop_in)[:n_fr]
    got_f = kernels.fused_ola_frames(fr, **kw)
    err = rel_rms(got_f, kernels.fused_ola_frames_plain(fr, **kw))
    require(err <= 1e-5, f'fused_ola_frames at the blackman design: relative RMS {err:.3g}')
    err64, err64_generic = frames_f64(fr, kw)
    print(f'fused_ola_frames at the blackman design: first {N_F64_FRAMES} frames vs the complex128 '
          f'chain: relative RMS {err64:.4g}, generic kernel {err64_generic:.4g}')
    require(err64 <= 2 * err64_generic,
            f'fused_ola_frames (blackman) complex128 error {err64:.4g} > 2 x the generic kernel\'s '
            f'{err64_generic:.4g}')
    t_bytes = (8 * x10.numel() + 8 * got_f.numel()) / mem_rate * 1e3
    t_ops = n_fr * (fft_ops(d.nfft) + fft_ops(d.nfft_out) + 6 * (d.nfft + d.nfft_out)) / fp32_rate * 1e3
    blackman = {
        'launches': launched.get('fused_ola_frames', 0), 'relative_rms': err,
        'ms': timed_ms(lambda: kernels.fused_ola_frames(fr, **kw)),
        'plain_ms': timed_ms(lambda: kernels.fused_ola_frames_plain(fr, **kw)),
        'library_ms': timed_ms(lambda: kernels.fused_ola_frames_plain(fr, **kw)),
        'bound_ms': max(t_bytes, t_ops), 'step_ms': step_ms,
        'generic_ms': timed_ms(lambda: _fused_ola_frames_generic(fr, **kw)),
        'f64_rel_rms': err64, 'generic_f64_rel_rms': err64_generic,
    }
    frames_row['monitor_blackman'] = blackman
    print(f'fused_ola_frames at the blackman design: frames {tuple(fr.shape)} relative RMS '
          f'{err:.3g}, {blackman["ms"]:.4f} ms (bound {blackman["bound_ms"]:.4f} ms, plain '
          f'{blackman["plain_ms"]:.4f} ms, generic kernel {blackman["generic_ms"]:.4f} ms) on {smi}')
    # the histogram at this step's shape: the binned samples the step hands
    # it (its body with the histogram call captured), against its plain
    # version, timed beside its bound and the older kernel
    seen = {}

    def capture(p):
        seen['p'], seen['edges'] = p, mon.apd_edges
        return kernels.hist(p, mon.apd_edges)

    mon._outputs(mon._step_ola(mon._input(x10)), kernels.chan_stats, capture)
    pb, eb = seen['p'], seen['edges']
    cb = kernels.hist(pb, eb)
    require(torch.equal(cb, kernels.hist_plain(pb, eb)),
            'hist at the blackman design differs from sort + searchsorted')
    t_bytes = (4 * pb.numel() + 4 * eb.numel() + 4 * cb.numel()) / mem_rate * 1e3
    t_ops = pb.numel() * math.ceil(math.log2(eb.numel() + 1)) / fp32_rate * 1e3
    # the same row with every sample in one bin: the counters' contention
    one_bin = torch.full_like(pb, float(pb.median()))
    require(torch.equal(kernels.hist(one_bin, eb), kernels.hist_plain(one_bin, eb)),
            'hist of one bin differs from sort + searchsorted')
    hist_blackman = {
        'launches': launched.get('hist', 0), 'samples': pb.numel(), 'edges': eb.numel(),
        'ms': timed_ms(lambda: kernels.hist(pb, eb)),
        'plain_ms': timed_ms(lambda: kernels.hist_plain(pb, eb)),
        'bound_ms': max(t_bytes, t_ops), 'bound_by': 'bytes' if t_bytes >= t_ops else 'operations',
        **hist_times(pb, eb, device_ms(device_us, HIST_KERNEL)),
        'one_bin_profiled_device_ms': device_ms(device_kernels(
            lambda: kernels.hist(one_bin, eb), HIST_KERNEL)[1], HIST_KERNEL),
    }
    print(f'hist at the blackman design: {pb.numel()} samples x {eb.numel()} edges, '
          f'{hist_blackman["ms"]:.4f} ms (bound {hist_blackman["bound_ms"]:.5f} ms, plain '
          f'{hist_blackman["plain_ms"]:.4f} ms), {hist_blackman["profiled_device_ms"]:.4f} ms of '
          f'device time in the profiled step; the older {HIST_GENERIC_KERNEL} '
          f'{hist_blackman["generic_ms"]:.4f} ms, {hist_blackman["generic_profiled_device_ms"]:.4f} '
          f'ms of device time alone; all samples in one bin '
          f'{hist_blackman["one_bin_profiled_device_ms"]:.4f} ms of device time, on {smi}')
    del x10, xe, fr, got_f, out, mon, pb, cb, seen, one_bin
    torch.cuda.empty_cache()
    print(f'phases 8-10 peak device memory: {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB')
    return [frames_row, up_row], hist_blackman


def lte_waveform(phy, n_slots: int, gen, dev) -> tuple:
    """an LTE-like waveform for ``phy`` made on the card: QPSK on the
    ``phy.subcarriers`` middle subcarriers, each slot at its own power
    (uniform in [0.5, 2)), CPs copied per ``phy.cp_sizes`` as
    tests/_synth.py:27-38 does on the host. Returns the (n_slots *
    contiguous_size,) complex64 samples and the (14 n_slots, nfft)
    subcarrier values in fftshifted order, scaled as SymbolDecoder
    returns them."""
    nfft, sc, per_slot = phy.nfft, phy.subcarriers, len(phy.cp_sizes)
    n_sym = per_slot * n_slots
    bits = torch.randint(0, 4, (n_sym, sc), generator=gen, device=dev)
    qpsk = torch.complex(1 - 2 * (bits & 1).float(), 1 - 2 * (bits >> 1).float()) / math.sqrt(2)
    amp = torch.sqrt(0.5 + 1.5 * torch.rand(n_slots, generator=gen, device=dev))
    X = torch.zeros((n_sym, nfft), dtype=torch.complex64, device=dev)
    lo = nfft // 2 - sc // 2
    X[:, lo:lo + sc] = qpsk * amp.repeat_interleave(per_slot)[:, None]
    tdom = torch.fft.ifft(torch.fft.ifftshift(X, dim=-1), dim=-1) * math.sqrt(2 * nfft)
    # one slot's samples: symbol k's last cp_sizes[k] samples, then symbol k
    sym, pos = [], []
    for k, cp in enumerate(np.asarray(phy.cp_sizes)):
        sym += [k] * (cp + nfft)
        pos += list(range(nfft - cp, nfft)) + list(range(nfft))
    sym, pos = (torch.tensor(v, device=dev) for v in (sym, pos))
    wave = tdom.reshape(n_slots, per_slot, nfft)[:, sym, pos].reshape(-1)
    return wave, X


def corr_noise(ofdm, gen, dev) -> tuple:
    """phase 11's numerology, index table and a capture of its length of
    noise, through the ``ofdm`` module given: (phy, inds, x)."""
    phy = ofdm.Phy3GPP(LTE_BW)
    inds = phy.index_cyclic_prefix(frames=range(LTE_SLOTS // 10))
    x = torch.randn(LTE_SLOTS * phy.contiguous_size, dtype=torch.complex64, device=dev,
                    generator=gen)
    return phy, inds, x


def corr_times(root: str) -> dict:
    """``python3 chip_smoke.py --corr-times DIR``: phase 11's call at its
    shapes on noise from ``SEED``, through the package under DIR (this
    checkout, or a tree of an earlier commit): the device microseconds by
    kernel of one profiled ``corr`` call (its kernels' work does not depend
    on the values), its time by events, and ``corr_at_indices``' time by
    events and host time a call. Prints them as the last line, a JSON
    object."""
    base = Path(root).resolve()
    sys.path.insert(0, str(base))
    import iqwaveform_torch
    from iqwaveform_torch import ofdm
    from iqwaveform_torch.ops import kernels

    require(Path(iqwaveform_torch.__file__).resolve().is_relative_to(base),
            f'imported {iqwaveform_torch.__file__}, not the package under {base}')
    dev = torch.device('cuda')
    phy, inds, x = corr_noise(ofdm, torch.Generator(device=dev).manual_seed(SEED), dev)
    ncp = inds.shape[-1]
    starts = inds.reshape(-1, ncp)[:, 0]
    module = sys.modules['iqwaveform_torch.ops.kernels.corr']
    # a start table kept across calls where the package has one
    table = module.StartTable(starts) if hasattr(module, 'StartTable') else starts

    def kernel():
        return kernels.corr(table, x, phy.nfft, ncp, True)

    def path():
        return ofdm.corr_at_indices(inds, x, phy.nfft)

    path()
    kernel()
    torch.cuda.synchronize()
    _, device_us = device_kernels(kernel, 'corr_finish_kernel')
    require(bool(device_us), f'no trace of the correlation kernels of {base}')
    return {'root': str(base), 'device_us': device_us,
            'device_ms': sum(device_us.values()) / 1e3, 'ms': timed_ms(kernel),
            'path_ms': timed_ms(path), 'host_ms': host_ms(path, calls=CORR_HOST_CALLS)}


def step_times(root: str) -> dict:
    """``python3 chip_smoke.py --step-times DIR``: the flagship
    ``WidebandMonitor.step`` on 2^24 samples of noise from ``SEED``, through
    the package under DIR (this checkout, or a tree of an earlier commit):
    its time by events (timed_ms) and the mean of HOST_ROUNDS x 40
    back-to-back calls by the host clock. Prints them as the last line, a
    JSON object; run it in turns on two trees to compare them on one
    card."""
    base = Path(root).resolve()
    sys.path.insert(0, str(base))
    import iqwaveform_torch as it

    require(Path(it.__file__).resolve().is_relative_to(base),
            f'imported {it.__file__}, not the package under {base}')
    dev = torch.device('cuda')
    mon = it.WidebandMonitor(it.design_wideband_monitor(122.88e6, 61.44e6, **FLAGSHIP))
    x = torch.randn(N_STEP, dtype=torch.complex64, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(SEED))
    ms = timed_ms(lambda: mon.step(x))
    calls = HOST_ROUNDS * 40
    t0 = time.perf_counter()
    for _ in range(calls):
        mon.step(x)
    torch.cuda.synchronize()
    return {'root': str(base), 'ms': ms, 'wall_ms': (time.perf_counter() - t0) * 1e3 / calls}


def corr_ab(parent: str, smi: str) -> dict:
    """phase 11's call through the package of ``parent`` (the older kernel)
    and of this checkout, each in a fresh process (:func:`corr_times`), in
    the turns parent, this, this, parent: the parent's means as the
    kernels-line row's ``generic_*`` numbers, every turn under ``ab``."""
    turns = []
    for root in (parent, ROOT, ROOT, parent):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), '--corr-times',
                               str(root)], capture_output=True, text=True,
                              timeout=FRESH_TRACE_TIMEOUT_S)
        lines = proc.stdout.strip().splitlines()
        require(proc.returncode == 0 and bool(lines),
                f'corr times of {root}: exit {proc.returncode}: {proc.stderr[-2000:]}')
        turns.append(json.loads(lines[-1]))
        print(f'corr turn {len(turns)} ({turns[-1]["root"]}): {json.dumps(turns[-1])}')
    older = turns[0::3]
    out = {f'generic_{k}': float(np.mean([t[k] for t in older]))
           for k in ('device_ms', 'ms', 'path_ms', 'host_ms')}
    out['ab'] = turns
    print(f'corr: the parent\'s kernels {out["generic_device_ms"]:.4f} ms of device time, '
          f'this tree\'s {np.mean([t["device_ms"] for t in turns[1:3]]):.4f} ms '
          f'(turns parent, this, this, parent) on {smi}')
    return out


def corr_ops(n_starts: int, span: int, n_lags: int, ncp: int, norm: bool) -> float:
    """the flop of one correlation: per start and acc position the lag
    product (6) and, with norm, both powers (6); the ncp-wide moving sums
    of the 2 or 4 rows and the normalization."""
    rows = 4 if norm else 2
    return n_starts * span * (12 if norm else 6) + n_lags * (rows * ncp + 4)


def ofdm_phases(dev, smi: str, mem_rate: float, fp32_rate: float, parent: str | None = None) -> list:
    """phases 11-15; returns the kernels line's rows of this path. With
    ``parent``, phase 11 times the same call through that tree's package
    too (:func:`corr_ab`)."""
    from iqwaveform_torch import channelize_power, ofdm
    from iqwaveform_torch.models import CellSearch
    from iqwaveform_torch.ops import kernels, spectral
    from iqwaveform_torch.ops.filtering import resample
    from iqwaveform_torch.ops.kernels import _build
    from iqwaveform_torch.ops.kernels.chan_stats import _chan_stats_generic
    from iqwaveform_torch.ops.kernels.corr import StartTable, corr_blocking

    kset = {k.__name__: k for k in kernels.KERNELS}
    gen = torch.Generator(device=dev).manual_seed(SEED)

    reset = reset_counts

    def counts():
        return {name: k.launches for name, k in kset.items() if k.launches}

    def frame_routes(label):
        routes = dict(kernels.fused_ola_frames.route_launches)
        print(f'{label} frame kernels: {json.dumps(routes)}')
        require(routes == {'reg': 1, 'cluster': 0, 'split': 0, 'plan': 0, 'plan_cluster': 0, 'generic': 0},
                f'{label} frame kernels {routes}')

    torch.cuda.reset_peak_memory_stats(dev)
    phy = ofdm.Phy3GPP(LTE_BW)
    nfft = phy.nfft
    clean, planted = lte_waveform(phy, LTE_SLOTS, gen, dev)
    n = clean.numel()
    p_sig = float((clean.real.square() + clean.imag.square()).mean())
    noise = torch.randn(n, dtype=torch.complex64, device=dev, generator=gen)
    capture = clean + math.sqrt(p_sig / 10 ** (LTE_SNR_DB / 10)) * noise
    del noise
    print(f'LTE capture: Phy3GPP({LTE_BW:g}) nfft {nfft}, CP {sorted(set(phy.cp_sizes.tolist()))}, '
          f'{phy.subcarriers} QPSK subcarriers, {n} samples = {n / phy.sample_rate:g} s, '
          f'noise {LTE_SNR_DB} dB below the signal')

    # ---- phase 11: corr_at_indices through the kernel
    inds = phy.index_cyclic_prefix(frames=range(LTE_SLOTS // 10))
    ncp = inds.shape[-1]
    starts = inds.reshape(-1, ncp)[:, 0]
    # the capture delayed by CORR_DELAY samples: the slot starts sit there,
    # clear of the wrap of the synchronizer's offsets (phase 12)
    delayed = torch.roll(capture, CORR_DELAY)
    del capture
    x11 = delayed
    checks = ofdm.corr_at_indices.structure_checks
    ofdm.corr_at_indices(inds, x11[: 4 * phy.contiguous_size], nfft)  # warm-up
    torch.cuda.synchronize()
    first_checks = ofdm.corr_at_indices.structure_checks - checks
    got, ref = {}, {}
    reset()
    checks = ofdm.corr_at_indices.structure_checks
    for norm in (True, False):
        got[norm] = ofdm.corr_at_indices(inds, x11, nfft, norm=norm)
    torch.cuda.synchronize()
    launched = counts()
    checks = ofdm.corr_at_indices.structure_checks - checks
    print(f'corr_at_indices: index set {inds.shape} ({starts.size} rows of {ncp}), '
          f'launches over 2 calls {json.dumps(launched)}; full structure checks of the table: '
          f'{first_checks} at its first call, {checks} in the next 2')
    require(launched == {'corr': 2}, f'corr_at_indices launches {launched}')
    require(first_checks == 1 and checks == 0,
            f'corr_at_indices checked the table {first_checks} times at its first call and '
            f'{checks} times in the next 2 (once, then never)')
    errs = {}
    for norm in (True, False):
        ref[norm] = kernels.corr_plain(starts, x11, nfft, ncp, norm)
        require(got[norm].shape == (nfft + ncp,) and bool(torch.isfinite(got[norm]).all()),
                f'corr norm={norm}: shape {tuple(got[norm].shape)} or not finite')
        errs[norm] = max_abs(got[norm], ref[norm])
        require(errs[norm] <= 2e-5, f'corr norm={norm}: max |diff| {errs[norm]:.3g} > 2e-5')
    peak = int(got[True].abs().argmax())
    print(f'corr_at_indices: max |diff| vs plain {errs[True]:.3g} (norm) {errs[False]:.3g} '
          f'(no norm); |corr| peaks at lag {peak} = {float(got[True][peak].abs()):.4f}, '
          f'planted {CORR_DELAY}')
    require(peak == CORR_DELAY, f'corr peak at lag {peak}, planted at {CORR_DELAY}')
    del got, ref
    # the ring kernel where x[0] sits 8 bytes above a 16-byte boundary and
    # where the capture ends inside the last windows (lags past it NaN)
    slot0 = inds[:, 0, 0, 0]  # the 14 symbols of the first slot
    edge_cases = {'x[1:]': (starts, x11[1:]), 'cut 3001 short': (starts, x11[: n - 3001]),
                  'x[1:] cut 3000 short': (starts, x11[1: n - 3000]),
                  'slot 0 on 2048 + 1001, x[1:]': (slot0, x11[1: 2048 + 1001])}
    for label, (rows_, xs) in edge_cases.items():
        for norm in (True, False):
            k_out = kernels.corr(rows_, xs, nfft, ncp, norm)
            p_out = kernels.corr_plain(rows_, xs, nfft, ncp, norm)
            nan = torch.isnan(p_out)
            require(torch.equal(torch.isnan(k_out), nan), f'corr {label} norm={norm}: NaN lags differ')
            err = max_abs(k_out[~nan], p_out[~nan])
            print(f'corr {label} norm={norm}: {xs.numel()} samples, {len(rows_)} rows, '
                  f'{int(nan.sum())} NaN lags, max |diff| vs plain {err:.3g}')
            require(err <= 2e-5, f'corr {label} norm={norm}: max |diff| {err:.3g} > 2e-5')
            errs[f'{label}, norm={norm}'] = err
    names, device_us = device_kernels(lambda: ofdm.corr_at_indices(inds, x11, nfft),
                                      *CORR_KERNELS, fresh='corr')
    corr_device_ms = sum(device_us.values()) / 1e3
    print('corr_at_indices device time by kernel (us): ' + json.dumps(device_us))
    require(any(CORR_KERNEL in nm for nm in names), f'profiler shows no {CORR_KERNEL}')
    bad = library_kernels(names)
    require(not bad, f'library FFT / GEMM / cuDNN kernels in corr_at_indices: {bad}')
    path_ms = timed_ms(lambda: ofdm.corr_at_indices(inds, x11, nfft))
    call_ms = host_ms(lambda: ofdm.corr_at_indices(inds, x11, nfft), calls=CORR_HOST_CALLS)
    blk = corr_blocking(starts.size, nfft, ncp, _build.sm_count(dev), _build.smem_optin(dev),
                        _build.smem_per_sm(dev))
    table = StartTable(starts)
    corr_row = kernel_row(
        'corr_at_indices', {'launches': launched.get('corr', 0), 'max_abs_err': max(errs.values())},
        8 * n + 8 * starts.size + 8 * blk['n_lags'],
        corr_ops(starts.size, blk['span'], blk['n_lags'], ncp, True),
        lambda: kernels.corr(table, x11, nfft, ncp, True),
        lambda: kernels.corr_plain(starts, x11, nfft, ncp, True),
        None, mem_rate, fp32_rate,
    )
    corr_row['library_note'] = 'no single PyTorch call computes a correlation at an index set'
    corr_row['path_ms'] = path_ms
    corr_row['host_ms'] = call_ms
    corr_row['profiled_device_ms'] = corr_device_ms
    corr_row['device_us'] = device_us
    corr_row['MS_per_s'] = n / corr_row['ms'] / 1e3
    corr_row['blocking'] = blk
    print(f'corr: blocking {json.dumps(blk)}')
    print(f'corr: {corr_row["ms"]:.4f} ms = {corr_row["MS_per_s"]:.1f} MS/s of capture (bound '
          f'{corr_row["bound_ms"]:.4f} ms by {corr_row["bound_by"]}, plain '
          f'{corr_row["plain_ms"]:.4f} ms; {corr_device_ms:.4f} ms of device time in the profiled '
          f'call); corr_at_indices {path_ms:.4f} ms by events, {call_ms:.4f} ms of host time a '
          f'call, on {smi}')
    if parent is not None:
        corr_row.update(corr_ab(parent, smi))

    # ---- phase 12: the clock synchronizer on a capture that slips: the
    # delayed capture squeezed by CLOCK_SLIP samples, which the synchronizer
    # corrects by resampling to CLOCK_SLIP more
    slipped = resample(delayed, n - CLOCK_SLIP)
    del x11, delayed
    sync = ofdm.BasebandClockSynchronizer(LTE_BW)
    sync(slipped[: 4 * sync.sync_size], max_passes=0, on_fail='ignore')  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out12 = sync(slipped)
    torch.cuda.synchronize()
    sync_s = time.perf_counter() - t0
    last = sync._regression_info['slipped_samples']
    print(f'BasebandClockSynchronizer: {slipped.numel()} samples ({slipped.numel() // sync.sync_size} '
          f'windows of {sync.sync_size}), {sync.passes} passes, total slip '
          f'{sync.total_sample_slip} (planted {-CLOCK_SLIP}), last pass {last}, {sync_s:.4f} s '
          f'({smi})')
    require(last == 0, f'synchronizer: the last pass slipped {last} samples')
    require(abs(sync.total_sample_slip + CLOCK_SLIP) <= 1,
            f'synchronizer: total slip {sync.total_sample_slip}, planted {CLOCK_SLIP}')
    require(out12.numel() > 0 and out12.numel() % (2 * phy.contiguous_size) == 0,
            f'synchronizer output of {out12.numel()} samples')
    require(bool(torch.isfinite(torch.view_as_real(out12)).all()), 'synchronizer output not finite')
    del slipped, out12

    # ---- phase 13: the symbol decoder, card against CPU
    dec = ofdm.SymbolDecoder(LTE_BW)
    syms = dec(clean)
    torch.cuda.synchronize()
    dec_ms = timed_ms(lambda: dec(clean), reps=5, warmup=1)
    cpu = ofdm.SymbolDecoder(LTE_BW, device='cpu')(clean.cpu())
    require(syms.shape == cpu.shape, f'decoder: card {tuple(syms.shape)}, CPU {tuple(cpu.shape)}')
    err = max_abs(syms.cpu(), cpu)
    print(f'SymbolDecoder: {n} samples -> {tuple(syms.shape)} symbols, card vs CPU max |diff| '
          f'{err:.3g}; {dec_ms:.4f} ms = {n / dec_ms / 1e3:.1f} MS/s ({smi})')
    require(err <= 1e-4, f'decoder: card vs CPU max |diff| {err:.3g} > 1e-4')
    # the decoder keeps the first slot of each pair (ofdm.py:1235) and the
    # middle 2 (subcarriers // 2) bins
    per_slot, half = len(phy.cp_sizes), phy.subcarriers // 2
    want = planted.reshape(LTE_SLOTS // 2, 2 * per_slot, nfft)[:, :per_slot].reshape(-1, nfft)
    err_sym = max_abs(dec._decode_symbols(clean), want[:, nfft // 2 - half:nfft // 2 + half])
    print(f'SymbolDecoder: decoded vs planted QPSK max |diff| {err_sym:.3g}')
    require(err_sym <= 1e-3, f'decoder: decoded vs planted QPSK max |diff| {err_sym:.3g} > 1e-3')
    del syms, cpu, clean, planted, want

    # ---- phase 14: the cell search on one SSB period
    fs, scs = phy.sample_rate, phy.subcarrier_spacing
    search = CellSearch(fs, scs)
    n14 = round(CELL_PERIOD * fs)
    x14 = CELL_NOISE * torch.randn(n14, dtype=torch.complex64, device=dev, generator=gen)
    pss = torch.from_numpy(np.asarray(ofdm.pss_5g_nr(fs, scs, pad_cp=False))).to(dev)
    sss = torch.from_numpy(np.asarray(ofdm.sss_5g_nr(fs, scs, pad_cp=False))).to(dev)
    x14[CELL_OFFSET:CELL_OFFSET + pss.shape[1]] += CELL_GAIN * pss[CELL_ID % 3]
    s0 = CELL_OFFSET + search.sss_stride
    x14[s0:s0 + sss.shape[1]] += CELL_GAIN * sss[CELL_ID]
    search(x14)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    found = search(x14)
    cell_ms = (time.perf_counter() - t0) * 1e3
    print(f'CellSearch({fs:g}, {scs:g}): {n14} samples, found {found}, planted n_id {CELL_ID} at '
          f'{CELL_OFFSET}; {cell_ms:.4f} ms for a {CELL_PERIOD * 1e3:g} ms capture ({smi})')
    require((found.n_id, found.n_id2, found.offset) == (CELL_ID, CELL_ID % 3, CELL_OFFSET),
            f'cell search found {found}')
    require(found.peak > 0.5 and found.sss_peak > 0.5, f'cell search peaks {found}')
    del x14

    # ---- phase 15: channelize_power at BASELINE config #4
    n_use = CHANNELIZE_FRAMES * CHANNELIZE['fft_size_per_channel'] * CHANNELIZE['channel_count']
    iq = torch.randn((CHANNELIZE_CAPTURES, n_use), dtype=torch.complex64, device=dev, generator=gen)
    flat = iq.reshape(-1)
    n_ch = CHANNELIZE['channel_count']
    nperseg = n_ch * CHANNELIZE['fft_size_per_channel']
    skip = n_ch * (CHANNELIZE['fft_size_per_channel'] - CHANNELIZE['analysis_bins_per_channel'])
    kw15 = {k: v for k, v in CHANNELIZE.items() if k != 'fft_size_per_channel'}

    def channelize():
        return channelize_power(flat, CHANNELIZE_TS, CHANNELIZE['fft_size_per_channel'], **kw15)

    channelize()  # warm-up
    torch.cuda.synchronize()
    reset()
    freqs, times, cp = channelize()
    torch.cuda.synchronize()
    launched = counts()
    print(f'channelize_power: {CHANNELIZE_CAPTURES} x {n_use} samples -> {tuple(cp.shape)}, '
          f'launches {json.dumps(launched)}')
    require(launched == {'chan_stats': 1}, f'channelize_power launches {launched}')
    routes15 = dict(kernels.chan_stats.route_launches)
    print(f'channelize_power channelizer kernels: {json.dumps(routes15)}')
    require(routes15 == CHAN_REG_ROUTE, f'channelize_power channelizer kernels {routes15}')
    n_frames = CHANNELIZE_CAPTURES * CHANNELIZE_FRAMES
    require(cp.shape == (n_frames, n_ch) and len(times) == n_frames
            and len(freqs) == CHANNELIZE['analysis_bins_per_channel'],
            f'channelize_power shapes {tuple(cp.shape)}, {len(times)} times, {len(freqs)} freqs')
    require(bool(torch.isfinite(cp).all()), 'channel power not finite')
    w15 = spectral._kernel_window(CHANNELIZE['window'], nperseg, dev)
    ckw = dict(nfft_big=nperseg, channel_count=n_ch, window=w15, skip_bins=skip,
               emit_psd=False, emit_pbin=False)
    cp_ref = kernels.chan_stats_plain(flat, **ckw)['channel_power']
    err15 = rel_rms(cp, cp_ref)
    # white noise of unit power through the unit-power window over nperseg:
    # each bin's expected power is 1 / nperseg
    expect = CHANNELIZE['analysis_bins_per_channel'] / nperseg
    mean15 = float(cp.double().mean())
    by_capture = cp.reshape(CHANNELIZE_CAPTURES, -1, n_ch)
    stats = torch.stack([by_capture.mean(dim=1), by_capture.amax(dim=1),
                         by_capture.square().mean(dim=1).sqrt()], dim=1)
    print(f'channelize_power: vs plain relative RMS {err15:.3g}; mean channel power {mean15:.6g} '
          f'(white noise: {expect:.6g}); per capture and channel mean / max / rms over time: '
          f'{tuple(stats.shape)}, capture 0 channel 0 {stats[0, :, 0].tolist()}')
    require(err15 <= 1e-5, f'channelize_power vs plain: relative RMS {err15:.3g} > 1e-5')
    require(abs(mean15 / expect - 1) <= 0.01, f'mean channel power {mean15:.6g}, expected {expect:.6g}')
    require(bool(torch.isfinite(stats).all()), 'channel statistics not finite')
    err_generic = rel_rms(cp, _chan_stats_generic(flat, **ckw)['channel_power'])
    chan64, chan64_generic = chan_f64(flat, ckw)
    print(f'channelize_power: {CHAN_REG_KERNEL} vs the radix-2 chan_stats_kernel relative RMS '
          f'{err_generic:.3g}; first {N_F64_FRAMES} frames vs the complex128 plain version '
          f'{chan64:.4g}, radix-2 kernel {chan64_generic:.4g}')
    require(err_generic <= 1e-5, f'channelize_power vs the radix-2 kernel: relative RMS {err_generic:.3g}')
    require(chan64 <= 2 * chan64_generic,
            f'channel power complex128 error {chan64:.4g} > 2 x the radix-2 kernel\'s {chan64_generic:.4g}')
    names, device_us = device_kernels(channelize, CHAN_REG_KERNEL, fresh='channelize')
    chan_device_ms = sum(device_us.values()) / 1e3
    print('channelize_power device time by kernel (us): ' + json.dumps(device_us))
    mode = [nm for nm in names if CHAN_REG_KERNEL in nm]
    require(len(mode) == 1
            and not any('chan_stats_kernel' in nm or 'chan_reduce_kernel' in nm for nm in names),
            f'channelize_power did not run the channel-only kernel alone: {names}')
    bad = library_kernels(names)
    require(not bad, f'library FFT / GEMM / cuDNN kernels in channelize_power: {bad}')
    path_ms = timed_ms(channelize)
    chan_row = kernel_row(
        'chan_stats_channels', {'launches': launched.get('chan_stats', 0), 'max_abs_err': max_abs(cp, cp_ref)},
        8 * flat.numel() + 8 * nperseg + 4 * cp.numel(),
        n_frames * (fft_ops(nperseg) + 6 * nperseg + 2 * (nperseg - skip)),
        lambda: kernels.chan_stats(flat, **ckw),
        lambda: kernels.chan_stats_plain(flat, **ckw),
        lambda: kernels.chan_stats_plain(flat, **ckw),
        mem_rate, fp32_rate,
    )
    chan_row['generic_ms'] = timed_ms(lambda: _chan_stats_generic(flat, **ckw))
    chan_row['f64_rel_rms'] = chan64
    chan_row['generic_f64_rel_rms'] = chan64_generic
    chan_row['path_ms'] = path_ms
    chan_row['profiled_device_ms'] = chan_device_ms
    chan_row['MS_per_s'] = flat.numel() / path_ms / 1e3
    print(f'chan_stats (channel-only): {chan_row["ms"]:.4f} ms (bound {chan_row["bound_ms"]:.4f} ms '
          f'by {chan_row["bound_by"]}, plain {chan_row["plain_ms"]:.4f} ms, radix-2 kernel '
          f'{chan_row["generic_ms"]:.4f} ms; {chan_device_ms:.4f} ms '
          f'of device time in the profiled call); channelize_power '
          f'{path_ms:.4f} ms = {chan_row["MS_per_s"]:.1f} MS/s on {smi}')
    del iq, flat, cp, cp_ref, by_capture
    torch.cuda.empty_cache()
    print(f'phases 11-15 peak device memory: {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB')
    return [corr_row, chan_row]


def reset_counts() -> None:
    """every kernel wrapper's launch count, and each of its route and
    input-layout counts, to 0."""
    from iqwaveform_torch.ops import kernels

    for k in kernels.KERNELS:
        k.launches = 0
        for counts in (getattr(k, 'route_launches', None), getattr(k, 'layout_launches', None)):
            if counts is not None:
                counts.update(dict.fromkeys(counts, 0))


def ola_routes(**counts) -> dict:
    """the 2:1 wrappers' route counts (fused_ola.route_launches): ``counts``
    and 0 on every other route of OLA_ROUTES."""
    from iqwaveform_torch.ops.kernels.fused_ola import OLA_ROUTES

    return {**dict.fromkeys(OLA_ROUTES, 0), **counts}


def cluster_kwargs(nfft: int, nfft_out: int, gen, dev) -> dict:
    """the frame kernel's arguments at a cluster pair: random windows and an
    offset trim (a nonzero zero_lo, an output range inside the spectrum,
    in_lo - out_lo no multiple of C); every bin kept where nothing is
    resampled."""
    if nfft_out == nfft:
        zero, b_in, b_out = (1203, nfft - 901), (0, nfft), (0, nfft)
    else:
        zero, b_in, b_out = (901, nfft - 1203), (1501, 1501 + nfft_out - 333), (111, nfft_out - 222)
    w = torch.randn(nfft + nfft_out, dtype=torch.complex64, device=dev, generator=gen)
    return dict(w_in=w[:nfft] / nfft, w_shift_out=w[nfft:], nfft=nfft, nfft_out=nfft_out,
                zero_lo=zero[0], zero_hi=zero[1], bounds_in=b_in, bounds_out=b_out)


def cluster_phases(dev, smi: str, mem_rate: float, fp32_rate: float) -> list:
    """phase 16; returns the kernels line's row of the cluster route."""
    import iqwaveform_torch as it
    from iqwaveform_torch.ops import kernels
    from iqwaveform_torch.ops.kernels.fused_ola import CLUSTER_PAIRS, _require_cluster_residency

    kset = {k.__name__: k for k in kernels.KERNELS}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats(dev)

    # ---- phase 16a: each compiled pair against the plain chain and
    # complex128: its error at most twice the plain chain's (float32 torch.fft)
    pairs = {}
    for (nfft, nfft_out), c in sorted(CLUSTER_PAIRS.items()):
        kw = cluster_kwargs(nfft, nfft_out, gen, dev)
        hop = nfft // 3
        capture = torch.randn(N_CLUSTER_FRAMES * hop + nfft, dtype=torch.complex64, device=dev,
                              generator=gen)
        frames = capture.unfold(-1, nfft, hop)[:N_CLUSTER_FRAMES]
        reset_counts()
        got = kernels.fused_ola_frames(frames, **kw)
        torch.cuda.synchronize()
        routes = dict(kernels.fused_ola_frames.route_launches)
        require(routes == {'reg': 0, 'cluster': 1, 'split': 0, 'plan': 0, 'plan_cluster': 0, 'generic': 0},
                f'fused_ola_frames at {nfft} -> {nfft_out}: kernels {routes}')
        ref = kernels.fused_ola_frames_plain(frames, **kw)
        ref64 = kernels.fused_ola_frames_plain(frames.to(torch.complex128), **_wide_kw(kw))
        err, err64, plain64 = rel_rms(got, ref), rel_rms(got, ref64), rel_rms(ref, ref64)
        clusters = _require_cluster_residency(nfft, nfft_out, dev)
        pairs[f'{nfft}->{nfft_out}'] = {'C': c, 'relative_rms': err, 'f64_rel_rms': err64,
                                         'plain_f64_rel_rms': plain64, 'max_active_clusters': clusters}
        print(f'{CLUSTER_KERNEL} {nfft} -> {nfft_out} (C = {c}, cudaOccupancyMaxActiveClusters '
              f'{clusters}), {N_CLUSTER_FRAMES} frames: vs plain relative RMS {err:.3g}; vs '
              f'complex128 {err64:.4g}, the plain chain {plain64:.4g}')
        require(err <= 1e-5, f'{CLUSTER_KERNEL} {nfft} -> {nfft_out}: relative RMS {err:.3g}')
        require(err64 <= 2 * plain64,
                f'{CLUSTER_KERNEL} {nfft} -> {nfft_out}: complex128 error {err64:.4g} > 2 x the '
                f'plain chain\'s {plain64:.4g}')
        del capture, frames, got, ref, ref64
    torch.cuda.empty_cache()

    # ---- phase 16b: the blackmanharris monitor (81920 -> 40960, R = 5)
    mon = it.WidebandMonitor(it.design_wideband_monitor(122.88e6, 61.44e6, **CLUSTER_MONITOR_BH))
    d = mon.design
    require((d.nfft, d.nfft_out) == (81920, 40960), f'blackmanharris design {d.nfft} -> {d.nfft_out}')
    x = torch.randn(N_CLUSTER_STEP_BH, dtype=torch.complex64, device=dev, generator=gen)
    reset_counts()
    out = mon.step(x)
    torch.cuda.synchronize()
    routes = dict(kernels.fused_ola_frames.route_launches)
    require(routes == {'reg': 0, 'cluster': 1, 'split': 0, 'plan': 0, 'plan_cluster': 0, 'generic': 0},
            f'blackmanharris step kernels {routes}')
    check_step(out, mon.reference_step(x), 'blackmanharris 81920 -> 40960 step vs plain-version step')
    print(f'blackmanharris step: {N_CLUSTER_STEP_BH} samples, 81920 -> 40960 frames, kernels '
          f'{json.dumps(routes)}, within the step gates of the plain-version step')
    del mon, x, out
    torch.cuda.empty_cache()

    # ---- phase 16c: the blackman step (49152 -> 24576, R = 3) on 2^24
    mon = it.WidebandMonitor(it.design_wideband_monitor(122.88e6, 61.44e6, **CLUSTER_MONITOR))
    d = mon.design
    require((d.nfft, d.nfft_out, mon.chan_kwargs['nfft_big'], d.apd_navg, d.apd_bins)
            == (49152, 24576, 4096, 1, 2048),
            f'blackman design {d.nfft} -> {d.nfft_out}, channelizer {mon.chan_kwargs["nfft_big"]}')
    x = torch.randn(N_CLUSTER_STEP, dtype=torch.complex64, device=dev, generator=gen)
    mon.step(x[: 4 * mon.min_input_multiple()])  # warm-up: first-use setup
    torch.cuda.synchronize()
    reset_counts()
    out = mon.step(x)
    torch.cuda.synchronize()
    launched = {name: k.launches for name, k in kset.items() if k.launches}
    routes = {'fused_ola_frames': dict(kernels.fused_ola_frames.route_launches),
              'chan_stats': dict(kernels.chan_stats.route_launches),
              'hist': dict(kernels.hist.route_launches)}
    print(f'cluster step launches: {json.dumps(launched)}; kernels by route {json.dumps(routes)}')
    require(launched == {'fused_ola_frames': 1, 'chan_stats': 1, 'hist': 1},
            f'cluster step launches {launched}')
    require(routes == {'fused_ola_frames': {'reg': 0, 'cluster': 1, 'split': 0, 'plan': 0,
                                            'plan_cluster': 0, 'generic': 0},
                       'chan_stats': CHAN_REG_ROUTE,
                       'hist': {'bucket': 1, 'generic': 0, 'slices': 0}},
            f'cluster step routes {routes}')
    n_fr = N_CLUSTER_STEP // mon.hop_in
    require(out['channel_power'].shape[-2] == n_fr * mon.hop_out // mon.chan_kwargs['nfft_big'],
            f'cluster step channel power {tuple(out["channel_power"].shape)}')
    check_step(out, mon.reference_step(x), 'cluster step vs plain-version step')
    small = x[: 4 * mon.min_input_multiple()].cpu()
    check_step({k: v.cpu() for k, v in mon.step(small).items()},
               it.WidebandMonitor(d, device='cpu').step(small),
               'cluster step: card vs CPU step (short input)')
    step_ms = timed_ms(lambda: mon.step(x))
    names, device_us = device_kernels(lambda: mon.step(x), CLUSTER_KERNEL, STATS_REG_KERNEL,
                                      HIST_KERNEL, fresh='cluster')
    print('cluster step device kernels: ' + json.dumps(names))
    require(any(CLUSTER_KERNEL in n for n in names), f'profiler shows no {CLUSTER_KERNEL} in the step')
    other = [n for n in names if REG_KERNEL in n or GENERIC_KERNEL in n]
    require(not other, f'another frame kernel ran in the cluster step: {other}')
    require_stats_kernel(names, 'the cluster step')
    require_hist_kernel(names, 'the cluster step')
    bad = library_kernels(names)
    require(not bad, f'library FFT / GEMM / cuDNN kernels in the cluster step: {bad}')
    busy = sum(device_us.values()) / 1e3
    print('cluster step device time by kernel (us): ' + json.dumps(
        dict(sorted(device_us.items(), key=lambda kv: -kv[1]))))
    print(f'cluster step: {step_ms:.4f} ms for {N_CLUSTER_STEP} samples = '
          f'{N_CLUSTER_STEP / step_ms / 1e3:.1f} MS/s; device busy {busy:.4f} ms (idle share '
          f'{max(0.0, 1 - busy / step_ms):.3f}) ({smi})')

    row = cluster_frame_row('fused_ola_frames_cluster', mon, x, launched, device_us, step_ms,
                            mem_rate, fp32_rate, smi)
    row['path'] = 'WidebandMonitor.step, blackman 122.88 -> 61.44 MS/s, 49152 -> 24576, R = 3'
    row['pairs'] = pairs
    rows = [row]
    del x, out, mon
    torch.cuda.empty_cache()

    # ---- phase 16d: the monitor at 122.88 -> 30.72 MS/s, frames on clusters
    # of 6 blocks: the blackman step (98304 -> 24576, C = 6) on whole
    # min_input_multiple()s near 2^24 samples, timed and profiled
    window, pair = 'blackman', (98304, 24576)
    mon = it.WidebandMonitor(it.design_wideband_monitor(122.88e6, 30.72e6, window=window,
                                                        **WIDE_CLUSTER_MONITOR))
    d = mon.design
    require((d.nfft, d.nfft_out) == pair, f'{window} design {d.nfft} -> {d.nfft_out}')
    n = round(N_CLUSTER_STEP / mon.min_input_multiple()) * mon.min_input_multiple()
    x = torch.randn(n, dtype=torch.complex64, device=dev, generator=gen)
    mon.step(x[: mon.min_input_multiple()])  # warm-up: first-use setup
    torch.cuda.synchronize()
    reset_counts()
    out = mon.step(x)
    torch.cuda.synchronize()
    launched = {name: k.launches for name, k in kset.items() if k.launches}
    routes = {'fused_ola_frames': dict(kernels.fused_ola_frames.route_launches),
              'chan_stats': dict(kernels.chan_stats.route_launches)}
    print(f'{window} 30.72 MS/s step ({n} samples, {pair[0]} -> {pair[1]}, C = '
          f'{CLUSTER_PAIRS[pair]}): launches {json.dumps(launched)}; routes {json.dumps(routes)}')
    require(launched == {'fused_ola_frames': 1, 'chan_stats': 1, 'hist': 1},
            f'{window} 30.72 MS/s step launches {launched}')
    require(routes == {'fused_ola_frames': {'reg': 0, 'cluster': 1, 'split': 0, 'plan': 0,
                                            'plan_cluster': 0, 'generic': 0},
                       'chan_stats': CHAN_REG_ROUTE}, f'{window} 30.72 MS/s step routes {routes}')
    check_step(out, mon.reference_step(x), f'{window} 30.72 MS/s step vs plain-version step')
    step_ms = timed_ms(lambda: mon.step(x))
    names, device_us = device_kernels(lambda: mon.step(x), CLUSTER_KERNEL, STATS_REG_KERNEL,
                                      HIST_KERNEL, fresh='cluster6')
    require(any(CLUSTER_KERNEL in nm for nm in names),
            f'profiler shows no {CLUSTER_KERNEL} in the {window} 30.72 MS/s step')
    bad = library_kernels(names)
    require(not bad, f'library FFT / GEMM / cuDNN kernels in the {window} step: {bad}')
    busy = sum(device_us.values()) / 1e3
    print(f'{window} 30.72 MS/s step device time by kernel (us): ' + json.dumps(
        dict(sorted(device_us.items(), key=lambda kv: -kv[1]))))
    print(f'{window} 30.72 MS/s step: {step_ms:.4f} ms for {n} samples = '
          f'{n / step_ms / 1e3:.1f} MS/s; device busy {busy:.4f} ms (idle share '
          f'{max(0.0, 1 - busy / step_ms):.3f}) ({smi})')
    row = cluster_frame_row(f'fused_ola_frames_cluster{CLUSTER_PAIRS[pair]}', mon, x, launched,
                            device_us, step_ms, mem_rate, fp32_rate, smi)
    row['path'] = (f'WidebandMonitor.step, {window} 122.88 -> 30.72 MS/s, {pair[0]} -> '
                   f'{pair[1]}, C = {CLUSTER_PAIRS[pair]}')
    row['max_active_clusters'] = _require_cluster_residency(*pair, dev)
    rows.append(row)
    del x, out, mon
    torch.cuda.empty_cache()
    print(f'phase 16 peak device memory: {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB')
    return rows


def _wide_kw(kw):
    return {k: v.to(torch.complex128) if isinstance(v, torch.Tensor) else v for k, v in kw.items()}


def cluster_frame_row(name, mon, x, launched, device_us, step_ms, mem_rate, fp32_rate,
                      smi, kernels_of=(CLUSTER_KERNEL,), launches=None) -> dict:
    """the cluster frame kernel (or the route of ``kernels_of``, by device
    kernel name) alone on the frames of ``mon``'s step on ``x``: within
    1e-5 of the plain chain, its first N_F64_FRAMES frames against
    complex128 (at most twice the plain chain's error), and its
    kernels-line row, timed beside its bound, the plain chain and the
    torch.fft chain (its library call). ``launches``: the row's launches in
    the step where they are not the frame wrapper's (the 2:1 route's frame
    kernel counts in fused_ola's)."""
    from iqwaveform_torch.ops import kernels

    label = '+'.join(kernels_of)

    d = mon.design
    kw = {k: v for k, v in mon.ola_kwargs.items() if not k.startswith('noverlap')}
    n_fr = x.numel() // mon.hop_in
    xe = torch.cat([x, x.new_zeros(mon.noverlap_in)])
    fr = xe.unfold(-1, d.nfft, mon.hop_in)[:n_fr]
    got = kernels.fused_ola_frames(fr, **kw)
    ref = kernels.fused_ola_frames_plain(fr, **kw)
    err = rel_rms(got, ref)
    ref64 = kernels.fused_ola_frames_plain(fr[:N_F64_FRAMES].to(torch.complex128), **_wide_kw(kw))
    err64, plain64 = rel_rms(got[:N_F64_FRAMES], ref64), rel_rms(ref[:N_F64_FRAMES], ref64)
    print(f'{label} on the step\'s frames {tuple(fr.shape)} -> {tuple(got.shape)}: vs '
          f'plain relative RMS {err:.3g}; first {N_F64_FRAMES} frames vs complex128 {err64:.4g}, '
          f'the plain chain {plain64:.4g}')
    require(err <= 1e-5, f'{label} on the step\'s frames: relative RMS {err:.3g}')
    require(err64 <= 2 * plain64,
            f'{label} on the step\'s frames: complex128 error {err64:.4g} > 2 x the '
            f'plain chain\'s {plain64:.4g}')
    row = kernel_row(
        name, {'launches': launched.get('fused_ola_frames', 0) if launches is None else launches,
               'max_abs_err': max_abs(got, ref)},
        8 * x.numel() + 8 * got.numel(),
        n_fr * (fft_ops(d.nfft) + fft_ops(d.nfft_out) + 6 * (d.nfft + d.nfft_out)),
        lambda: kernels.fused_ola_frames(fr, **kw),
        lambda: kernels.fused_ola_frames_plain(fr, **kw),
        lambda: kernels.fused_ola_frames_plain(fr, **kw),
        mem_rate, fp32_rate,
    )
    row['profiled_device_ms'] = (sum(device_ms(device_us, k) for k in kernels_of)
                                 if device_us else None)
    row['f64_rel_rms'] = err64
    row['plain_f64_rel_rms'] = plain64
    row['path_ms'] = step_ms
    profiled = ('not profiled' if row['profiled_device_ms'] is None
                else f'{row["profiled_device_ms"]:.4f} ms of device time in the profiled step')
    print(f'{name} ({d.nfft} -> {d.nfft_out}): {row["ms"]:.4f} ms (bound {row["bound_ms"]:.4f} ms '
          f'by {row["bound_by"]}, plain {row["plain_ms"]:.4f} ms, library (torch.fft chain) '
          f'{row["library_ms"]:.4f} ms), {profiled}, on {smi}')
    return row


def chan_size_input(n: int, mode: dict, gen, dev) -> tuple:
    """phase 17a's input at ``n`` points: CHAN_SIZE_SAMPLES of noise in
    whole frames, a random window over n, 24 channels with a trim of n / 4
    bins; (y, chan_stats keyword arguments)."""
    y = torch.randn((CHAN_SIZE_SAMPLES // n) * n, dtype=torch.complex64, device=dev,
                    generator=gen)
    w = torch.randn(n, dtype=torch.complex64, device=dev, generator=gen) / n
    return y, dict(nfft_big=n, channel_count=24, window=w, skip_bins=n // 4, **mode)


def chan_size_check(n: int, mode: dict, gen, dev, mem_rate: float, fp32_rate: float,
                    timed: bool = True) -> dict:
    """one channelizer frame size in one mode (``mode``: emit_psd,
    emit_pbin, navg) on CHAN_SIZE_SAMPLES of noise in whole frames, 24
    channels of (3 / 4) n / 24 bins: the kernel its route launches, once,
    within 1e-5 of the plain version in every output, each output's error
    against complex128 on the first N_F64_FRAMES frames within
    CHAN_F64_LIMIT of the plain version's (channel power at twice, as
    chan_f64 holds the flagship's), a limit below the plain version's error
    on that input rounded to float16; timed beside its bound, the torch.fft
    formulation (the plain version, its library call) and, at the powers
    of two, the radix-2 kernel (at 4096 also the mixed-size kernel beside
    the flagship's). ``timed`` False times nothing."""
    from iqwaveform_torch.ops import kernels
    from iqwaveform_torch.ops.kernels.chan_stats import (
        _chan_stats_generic,
        _chan_stats_mixed,
        chan_route,
    )

    frames = CHAN_SIZE_SAMPLES // n
    y, kw = chan_size_input(n, mode, gen, dev)
    route = chan_route(n, mode['emit_psd'], mode['emit_pbin'], mode['navg'])
    reset_counts()
    got = kernels.chan_stats(y, **kw)
    torch.cuda.synchronize()
    routes = dict(kernels.chan_stats.route_launches)
    require(routes == dict(CHAN_NO_ROUTE, **{route: 1}), f'chan_stats at {n} {mode}: routes {routes}')
    ref = kernels.chan_stats_plain(y, **kw)
    y64 = y[: min(frames, N_F64_FRAMES) * n]
    got64, plain64 = ((got, ref) if y64.numel() == y.numel()
                      else (kernels.chan_stats(y64, **kw), kernels.chan_stats_plain(y64, **kw)))
    ref64 = kernels.chan_stats_plain(y64.to(torch.complex128), **_wide_kw(kw))
    y16 = torch.complex(y64.real.half().double(), y64.imag.half().double())
    ctl64 = kernels.chan_stats_plain(y16, **_wide_kw(kw))
    out = {'route': route, 'frames': frames}
    for key in ref:
        err = rel_rms(got[key], ref[key])
        e64, p64 = rel_rms(got64[key], ref64[key]), rel_rms(plain64[key], ref64[key])
        c64, lim = rel_rms(ctl64[key], ref64[key]), CHAN_F64_LIMIT[key]
        require(err <= 1e-5, f'chan_stats {key} at {n} {mode}: relative RMS {err:.3g}')
        require(e64 <= lim * p64, f'chan_stats {key} at {n} {mode}: complex128 error {e64:.4g} '
                f'> {lim} x the plain version\'s {p64:.4g}')
        require(lim * p64 < c64, f'chan_stats {key} at {n} {mode}: the gate {lim} x {p64:.4g} '
                f'passes the float16-rounded input\'s error {c64:.4g}')
        out[key] = {'relative_rms': err, 'f64_rel_rms': e64, 'plain_f64_rel_rms': p64,
                    'f16_input_f64_rel_rms': c64}
    nbytes = 8 * y.numel() + 8 * n + 4 * sum(v.numel() for v in got.values())
    t_bytes, t_ops = nbytes / mem_rate * 1e3, frames * (fft_ops(n) + 12 * n) / fp32_rate * 1e3
    out['bound_ms'] = max(t_bytes, t_ops)
    out['bound_by'] = 'bytes' if t_bytes >= t_ops else 'operations'
    out['max_abs_err'] = max(max_abs(got[k], ref[k]) for k in ref)
    if not timed:
        return out
    out['ms'] = timed_ms(lambda: kernels.chan_stats(y, **kw))
    out['plain_ms'] = timed_ms(lambda: kernels.chan_stats_plain(y, **kw))
    if n & (n - 1) == 0 and n <= 16384:
        out['generic_ms'] = timed_ms(lambda: _chan_stats_generic(y, **kw))
    if route == 'reg' and mode['emit_psd']:
        out['mixed_ms'] = timed_ms(lambda: _chan_stats_mixed(y, **kw))
    return out


def stats4096_device_ms(dev, fresh: bool = True) -> dict:
    """the device milliseconds a call of each 4096-point statistics kernel
    takes, its fold included: ``chan_stats_reg_kernel`` (the route) and
    ``chan_stats_mixed_kernel`` (through the private ``_chan_stats_mixed``),
    on the flagship step's channelizer stream (2^23 samples of noise from
    SEED: 2048 frames of 4096 points, 16 channels of 256) at each navg of
    STATS_CMP_NAVG; each kernel traced twice, in the order reg, mixed,
    mixed, reg, STATS_CMP_CALLS calls a trace. Returns {'navg N': {'reg':
    [ms, ms], 'mixed': [ms, ms]}}, or {} where a trace lacks its kernel in
    this process and (with ``fresh``) in a fresh one (``python3
    chip_smoke.py --trace stats4096``)."""
    import iqwaveform_torch as it
    from iqwaveform_torch.ops import kernels
    from iqwaveform_torch.ops.kernels.chan_stats import _chan_stats_mixed, chan_route

    mon = it.WidebandMonitor(it.design_wideband_monitor(122.88e6, 61.44e6, **FLAGSHIP))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    y = torch.randn(CHAN_SIZE_SAMPLES, dtype=torch.complex64, device=dev, generator=gen)
    calls = {'reg': (kernels.chan_stats, STATS_REG_KERNEL),
             'mixed': (_chan_stats_mixed, MIXED_KERNEL)}
    out = {}
    for navg in STATS_CMP_NAVG:
        kw = dict(mon.chan_kwargs, navg=navg)
        require(chan_route(kw['nfft_big'], True, True, navg) == 'reg',
                f'chan_stats at {kw["nfft_big"]}, navg {navg} is not on chan_stats_reg_kernel')
        got = {'reg': [], 'mixed': []}
        for route in ('reg', 'mixed', 'mixed', 'reg'):
            call, kernel = calls[route]

            def fn():
                for _ in range(STATS_CMP_CALLS):
                    call(y, **kw)

            fn()
            torch.cuda.synchronize()
            _, device_us = device_kernels(fn, kernel)
            if not device_us:
                return _fresh_stats4096() if fresh else {}
            got[route].append(sum(device_us.values()) / 1e3 / STATS_CMP_CALLS)
        out[f'navg {navg}'] = got
    return out


def _fresh_stats4096() -> dict:
    """``stats4096_device_ms`` in a fresh process ({} if it fails)."""
    print('profiler: taking the 4096-point statistics comparison in a fresh process')
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), '--trace', 'stats4096'],
                          capture_output=True, text=True, timeout=FRESH_TRACE_TIMEOUT_S)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode or not lines:
        print(f'profiler: the fresh process exited {proc.returncode}: {proc.stderr[-2000:]}')
        return {}
    return json.loads(lines[-1])


def channelizer_phases(dev, smi: str, mem_rate: float, fp32_rate: float) -> list:
    """phase 17; returns the kernels line's rows of the channelizer at the
    sizes this slice adds."""
    import iqwaveform_torch as it
    from iqwaveform_torch.ops import kernels, spectral
    from iqwaveform_torch.ops.kernels.chan_stats import CHAN_SIZES

    kset = {k.__name__: k for k in kernels.KERNELS}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats(dev)

    # ---- phase 17a: every frame size of CHAN_SIZES in the statistics mode
    # the monitor runs (navg 16) and the channel-only mode
    sizes = {}
    for n in sorted(CHAN_SIZES):
        sizes[n] = {name: chan_size_check(n, mode, gen, dev, mem_rate, fp32_rate)
                    for name, mode in CHAN_SIZE_MODES.items()}
        print(f'chan_stats at {n}: ' + json.dumps(
            {name: {k: (v if not isinstance(v, dict) else
                        {e: f'{x:.3g}' for e, x in v.items() if 'f64' in e})
                    for k, v in r.items() if k not in ('frames', 'max_abs_err', 'bound_by')}
             for name, r in sizes[n].items()}) + f' ({smi})')
    torch.cuda.empty_cache()
    # the two kernels of the statistics mode at 4096 points by device time
    cmp4096 = stats4096_device_ms(dev)
    print('chan_stats at 4096, the flagship\'s 2048 frames, device ms a call with the fold '
          f'(traced reg, mixed, mixed, reg): {json.dumps(cmp4096) if cmp4096 else "not measured"} '
          f'({smi})')
    torch.cuda.empty_cache()

    # ---- phase 17b: the monitor of the flagship rates at 48, 96 and 64 x
    # 512 channels, a step each on whole min_input_multiple()s near 2^24
    # samples: launches and routes, phase 3's gates against reference_step,
    # the profile, the step timed; the channelizer alone on the step's
    # resampled stream
    rows = []
    for name, (extra, want_route, kernel, rname) in CHAN_DESIGNS.items():
        mon = it.WidebandMonitor(it.design_wideband_monitor(122.88e6, 61.44e6, **CHAN_MONITOR,
                                                            **extra))
        ckw = mon.chan_kwargs
        nb = ckw['nfft_big']
        n = (N_STEP // mon.min_input_multiple()) * mon.min_input_multiple()
        x = torch.randn(n, dtype=torch.complex64, device=dev, generator=gen)
        mon.step(x[: mon.min_input_multiple()])  # warm-up: first-use setup
        torch.cuda.synchronize()
        reset_counts()
        out = mon.step(x)
        torch.cuda.synchronize()
        launched = {k: v.launches for k, v in kset.items() if v.launches}
        routes = dict(kernels.chan_stats.route_launches)
        print(f'{name} step ({nb}-point channelizer, {n} samples): launches '
              f'{json.dumps(launched)}; channelizer kernels {json.dumps(routes)}')
        require(launched == {'fused_ola': 1, 'chan_stats': 1, 'hist': 1},
                f'{name} step launches {launched}')
        require(routes == dict(CHAN_NO_ROUTE, **{want_route: 1}), f'{name} step routes {routes}')
        check_step(out, mon.reference_step(x), f'{name} step vs plain-version step')
        step_ms = timed_ms(lambda: mon.step(x))
        names, device_us = device_kernels(lambda: mon.step(x), OLA_REG_KERNEL, kernel, HIST_KERNEL,
                                          fresh=name)
        for k in (OLA_REG_KERNEL, kernel, HIST_KERNEL):
            require(any(k in nm for nm in names), f'profiler shows no {k} in the {name} step')
        old = [nm for nm in names if STATS_GENERIC_KERNEL in nm or 'chan_reduce_kernel' in nm]
        require(not old, f'the radix-2 channelizer kernel ran in the {name} step: {old}')
        bad = library_kernels(names)
        require(not bad, f'library FFT / GEMM / cuDNN kernels in the {name} step: {bad}')
        busy = sum(device_us.values()) / 1e3
        print(f'{name} step device time by kernel (us): ' + json.dumps(
            dict(sorted(device_us.items(), key=lambda kv: -kv[1]))))
        print(f'{name} step: {step_ms:.4f} ms for {n} samples = {n / step_ms / 1e3:.1f} MS/s; '
              f'device busy {busy:.4f} ms (idle share {max(0.0, 1 - busy / step_ms):.3f}) ({smi})')
        if rname is not None:
            y = kernels.fused_ola(x, **mon.ola_kwargs)
            cs = kernels.chan_stats(y, **ckw)
            ref = kernels.chan_stats_plain(y, **ckw)
            for key in ref:
                err = rel_rms(cs[key], ref[key])
                require(err <= 1e-5, f'chan_stats {key} on the {name} stream: relative RMS {err:.3g}')
            row = kernel_row(
                rname,
                {'launches': launched.get('chan_stats', 0),
                 'max_abs_err': max(max_abs(cs[k], ref[k]) for k in ref)},
                8 * y.numel() + 8 * nb + 4 * sum(v.numel() for v in cs.values()),
                (y.shape[-1] // nb) * (fft_ops(nb) + 12 * nb),
                lambda: kernels.chan_stats(y, **ckw),
                lambda: kernels.chan_stats_plain(y, **ckw),
                lambda: kernels.chan_stats_plain(y, **ckw),
                mem_rate, fp32_rate,
            )
            row['profiled_device_ms'] = sum(
                us for k, us in device_us.items() if kernel in k or 'chan_fold' in k) / 1e3
            row['path'] = f'WidebandMonitor.step, {name}, {nb}-point channelizer'
            row['path_ms'] = step_ms
            row['idle_share'] = max(0.0, 1 - busy / step_ms)
            row['sizes'] = {str(sz): r for sz, r in sizes.items() if r['stats']['route'] == want_route}
            if want_route == 'mixed':
                row['device_ms_at_4096_vs_reg'] = cmp4096
            print(f'{rname} at {nb}: {row["ms"]:.4f} ms (bound {row["bound_ms"]:.4f} ms by '
                  f'{row["bound_by"]}, plain / library {row["plain_ms"]:.4f} ms), '
                  f'{row["profiled_device_ms"]:.4f} ms of device time in the profiled step, on {smi}')
            rows.append(row)
            del y, cs, ref
        del x, out, mon
        torch.cuda.empty_cache()

    # ---- phase 17c: channelize_power at a frame size that is no power of
    # two: 48 channels of 192 of 256 bins, 12288 points, hamming
    per, n_ch, abins = 256, 48, 192
    nperseg = per * n_ch
    iq = torch.randn(CHANNELIZE_FRAMES * nperseg, dtype=torch.complex64, device=dev, generator=gen)
    pkw = dict(analysis_bins_per_channel=abins, window='hamming', channel_count=n_ch)
    it.channelize_power(iq, CHANNELIZE_TS, per, **pkw)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    _, _, cp = it.channelize_power(iq, CHANNELIZE_TS, per, **pkw)
    torch.cuda.synchronize()
    launched = {k: v.launches for k, v in kset.items() if v.launches}
    routes = dict(kernels.chan_stats.route_launches)
    require(launched == {'chan_stats': 1} and routes == CHAN_REG_ROUTE,
            f'channelize_power at {nperseg}: launches {launched}, routes {routes}')
    skip = n_ch * (per - abins)
    ckw = dict(nfft_big=nperseg, channel_count=n_ch, skip_bins=skip, emit_psd=False,
               emit_pbin=False, window=spectral._kernel_window('hamming', nperseg, dev))
    cp_ref = kernels.chan_stats_plain(iq, **ckw)['channel_power']
    err = rel_rms(cp, cp_ref)
    print(f'channelize_power at {n_ch} x {per} = {nperseg} points: {tuple(cp.shape)}, kernels '
          f'{json.dumps(routes)}, vs the plain version relative RMS {err:.3g}')
    require(err <= 1e-5, f'channelize_power at {nperseg}: relative RMS {err:.3g}')
    require(cp.shape == (CHANNELIZE_FRAMES, n_ch), f'channelize_power at {nperseg}: {tuple(cp.shape)}')
    row = kernel_row(
        'chan_power_reg_12288',
        {'launches': launched.get('chan_stats', 0), 'max_abs_err': max_abs(cp, cp_ref)},
        8 * iq.numel() + 8 * nperseg + 4 * cp.numel(),
        CHANNELIZE_FRAMES * (fft_ops(nperseg) + 6 * nperseg + 2 * (nperseg - skip)),
        lambda: kernels.chan_stats(iq, **ckw),
        lambda: kernels.chan_stats_plain(iq, **ckw),
        lambda: kernels.chan_stats_plain(iq, **ckw),
        mem_rate, fp32_rate,
    )
    row['path'] = f'channelize_power, {n_ch} channels of {abins} of {per} bins ({nperseg} points)'
    row['path_ms'] = timed_ms(lambda: it.channelize_power(iq, CHANNELIZE_TS, per, **pkw))
    row['sizes'] = {str(sz): r['channels'] for sz, r in sizes.items()}
    print(f'chan_stats (channel-only) at {nperseg}: {row["ms"]:.4f} ms (bound {row["bound_ms"]:.4f} '
          f'ms by {row["bound_by"]}, plain / library {row["plain_ms"]:.4f} ms); channelize_power '
          f'{row["path_ms"]:.4f} ms on {smi}')
    rows.append(row)
    del iq, cp, cp_ref
    torch.cuda.empty_cache()
    print(f'phase 17 peak device memory: {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB')
    return rows



# the flagship pair's 2:1 kernel on (2, N) planes of each storage tier,
# 2^24 samples (2048 frames) with a halo and the tail
N_PLANES = 1 << 24
TIER_ROWS = {'highest': 'fused_ola_strided_f32', 'i16': 'fused_ola_strided_i16',
             'bf16': 'fused_ola_strided_bf16'}
TIER_LAYOUT = {'highest': 'float32', 'i16': 'int16', 'bf16': 'bfloat16'}
TIER_BYTES = {'highest': 4, 'i16': 2, 'bf16': 2}  # a value of a plane
# the planes' RMS in counts, and the scale to physical units at every tier
# (the SigMF ci16 convention)
PLANES_SCALE = 3000.0
I16_INPUT_SCALE = 2.0**-15
# the stream: chunks of 2^24 complex64 samples; N_STREAM_CHECK of them held
# against one step on their 2^27 samples, N_STREAM (2^30 samples, 8.7 s of
# capture at 122.88 MS/s) timed
STREAM_CHUNK = 1 << 24
N_STREAM_CHECK = 8
N_STREAM = 64
STREAM_RATE = 122.88e6  # the flagship capture's real-time rate
# the same stream read from a ci16 file of N_DISK samples (1 GiB)
N_DISK = 1 << 28
DISK_DEPTH = 2
# the packed APD route at the blackman step's shape (8,392,704 binned
# samples x 2049 edges, apd_navg 1); its cumulative counts are held to
# hist's within 2 (the JAX bar, tests/test_monitor.py:621-645) on the
# first PACKED_BAR_SAMPLES, the JAX test's binned samples (0.5 M), and on
# all of them to the JAX package's own float32 rule run in numpy on the
# same samples (packed_rule_host), within the rounding band of each level
# boundary (packed_band_host)
N_PACKED_APD = 8_392_704
PACKED_BAR_SAMPLES = 1 << 19
# the rounding of one float32 evaluation of the packed rule, ceil((10
# log10 p - lo) / w): log10 within PACKED_LOG10_ULP ulp (the card's log10f
# is within 2, numpy's vectorised float32 log10 within 4), half an ulp
# each for the product with 10 and the difference from lo, rounded up to
# one, and PACKED_LEVEL_ULP ulp of the level (the card multiplies by
# 1 / w, numpy divides by w)
PACKED_LOG10_ULP = 4
PACKED_LEVEL_ULP = 2


def packed_drift(a, b) -> int:
    """the largest difference of two histograms' cumulative counts."""
    a, b = torch.as_tensor(a).long().cpu(), torch.as_tensor(b).long().cpu()
    return int((a.cumsum(0) - b.cumsum(0)).abs().max())


def packed_rule_host(p, design) -> tuple:
    """the JAX package's packed APD levels in numpy float32
    (iqwaveform_tpu/models/monitor.py:603-636: ceil((10 log10 p - lo) / w)
    clipped to [0, B]) and the exact edge counts (searchsorted on the
    float32 edges), on the host: (packed counts, edge counts)."""
    lo, hi = design.apd_range_dB
    n_bins = design.apd_bins
    w = (hi - lo) / (n_bins - 1)
    ph = p.detach().cpu().numpy().astype(np.float32)
    v = (np.float32(10.0) * np.log10(ph)).astype(np.float32)
    idx = np.clip(np.ceil((v - np.float32(lo)) / np.float32(w)), 0, n_bins).astype(np.int64)
    e32 = (10 ** (np.linspace(lo, hi, n_bins) / 10.0)).astype(np.float32)
    ref = np.searchsorted(e32, ph, side='left')
    return (np.bincount(idx, minlength=n_bins + 1), np.bincount(ref, minlength=n_bins + 1))


def packed_band_host(p, design) -> np.ndarray:
    """(apd_bins,) counts: at each level boundary k (level <= k against
    level > k), the values of ``p`` whose exact level (10 log10 p - lo) / w,
    in float64, lies within two float32 evaluations' rounding of k
    (PACKED_LOG10_ULP, PACKED_LEVEL_ULP): the most by which the cumulative
    counts of two sound evaluations of the packed rule can differ at k, as
    only those values can fall on different sides of it."""
    lo, hi = design.apd_range_dB
    n_bins = design.apd_bins
    w = (hi - lo) / (n_bins - 1)
    ph = p.detach().cpu().numpy().astype(np.float32)
    ph = ph[np.isfinite(ph) & (ph > 0)]
    l32 = np.log10(ph)
    v32 = np.float32(10.0) * l32
    t64 = (10.0 * np.log10(ph.astype(np.float64)) - lo) / w

    def ulp(a):
        return np.spacing(np.abs(a).astype(np.float32)).astype(np.float64)

    one = ((10 * PACKED_LOG10_ULP * ulp(l32) + ulp(v32) + ulp(v32 - np.float32(lo))) / w
           + PACKED_LEVEL_ULP * ulp(t64))
    k = np.rint(t64)
    near = (np.abs(t64 - k) <= 2 * one) & (k >= 0) & (k < n_bins)
    return np.bincount(k[near].astype(np.int64), minlength=n_bins)[:n_bins]


def _stream(mon, chunks) -> tuple:
    """accumulate_step over ``chunks`` (an iterable of complex64 chunks on
    the card) and flush; returns (statistics, chunks folded)."""
    carry, n = None, 0
    for x in chunks:
        carry = mon.init_carry(x.numel()) if carry is None else carry
        carry = mon.accumulate_step(carry, x)
        n += 1
    return mon.flush(carry), n


def check_stream(got: dict, ref: dict, label: str) -> dict:
    """the JAX stream test's bar (tests/test_monitor.py:147-175) on every
    bin, and apd_counts equal: psd_mean rtol 1e-4 / atol 1e-3 dB, psd_max
    atol 1e-3 dB, channel_power_mean rtol 1e-4."""
    worst = {}
    for key, rtol, atol in (('psd_mean', 1e-4, 1e-3), ('psd_max', 0.0, 1e-3),
                            ('channel_power_mean', 1e-4, 0.0), ('channel_power_max', 1e-4, 0.0)):
        a, b = _wide(got[key]), _wide(ref[key])
        excess = float(((a - b).abs() - (atol + rtol * b.abs())).max())
        worst[key] = max_abs(a, b)
        require(excess <= 0, f'{label} {key}: max |diff| {worst[key]:.4g} beyond rtol {rtol} '
                             f'atol {atol}')
        require(bool(torch.isfinite(got[key]).all()), f'{label} {key}: not finite')
    require(torch.equal(got['apd_counts'].long(), ref['apd_counts'].long()),
            f'{label} apd_counts differ')
    return worst


def strided_row(name, kw, planes, halo, launches, mem_rate, fp32_rate, smi) -> dict:
    """the kernels-line row of one input layout of fused_ola_strided at the
    flagship pair: its output and tail against the plain version, timed
    beside its bound (the input's bytes once, the output's and tail's),
    the plain version and the torch.fft chain (the plain version: its
    library call)."""
    from iqwaveform_torch.ops import kernels

    n_frames = planes.shape[-1] // kw['hop_in']
    y, tail = kernels.fused_ola_strided(planes, halo, n_frames=n_frames, **kw)
    ry, rt = kernels.fused_ola_strided_plain(planes, halo, n_frames=n_frames, **kw)
    got, ref = torch.cat([y, tail]), torch.cat([ry, rt])
    err = rel_rms(got, ref)
    print(f'{name}: {tuple(planes.shape)} {planes.dtype} + halo -> {tuple(y.shape)} + tail '
          f'{tuple(tail.shape)}: relative RMS {err:.3g} vs the plain version')
    require(err <= 1e-5, f'{name}: relative RMS {err:.3g} > 1e-5')
    in_bytes = planes.element_size() * (planes.numel() + halo.numel())
    nfft, nfft_out = kw['nfft'], kw['nfft_out']
    row = kernel_row(
        name, {'launches': launches, 'max_abs_err': max_abs(got, ref)},
        in_bytes + 8 * got.numel() + 8 * (nfft + nfft_out),
        n_frames * (fft_ops(nfft) + fft_ops(nfft_out) + 6 * (nfft + nfft_out)),
        lambda: kernels.fused_ola_strided(planes, halo, n_frames=n_frames, **kw),
        lambda: kernels.fused_ola_strided_plain(planes, halo, n_frames=n_frames, **kw),
        lambda: kernels.fused_ola_strided_plain(planes, halo, n_frames=n_frames, **kw),
        mem_rate, fp32_rate,
    )
    row['relative_rms'] = err
    print(f'{name}: {row["ms"]:.4f} ms (bound {row["bound_ms"]:.4f} ms by {row["bound_by"]}, '
          f'plain {row["plain_ms"]:.4f} ms), on {smi}')
    return row


def stream_phases(dev, smi: str, mem_rate: float, fp32_rate: float) -> list:
    """phase 18; returns the kernels line's rows of fused_ola_strided (one
    per input layout) and of the packed APD route."""
    import dataclasses
    import tempfile

    import iqwaveform_torch as it
    from iqwaveform_torch.io import CapturePrefetcher, read_iq_planes
    from iqwaveform_torch.ops import kernels
    from iqwaveform_torch.utils import unpack_iq

    kset = {k.__name__: k for k in kernels.KERNELS}
    strided = kernels.fused_ola_strided
    gen = torch.Generator(device=dev).manual_seed(SEED)
    design = it.design_wideband_monitor(122.88e6, 61.44e6, **FLAGSHIP)
    mon = it.WidebandMonitor(design)
    hop = mon.hop_in
    rows = []

    # ---- 18a: row 1 on (2, N) planes of each tier, a halo and the tail
    noise = PLANES_SCALE * torch.randn((2, N_PLANES + hop), device=dev, generator=gen)
    counts = noise.round().clamp(-32768, 32767)
    sources = {'highest': noise, 'i16': counts.to(torch.int16), 'bf16': noise.to(torch.bfloat16)}
    # f32 planes against the complex-input fused_ola on the same samples
    # (no halo: the end zero-extended, the tail dropped)
    kw = mon.strided_kwargs
    x = noise[:, :N_PLANES].contiguous()
    y_planes, _ = strided(x, None, n_frames=N_PLANES // hop, **kw)
    y_complex = kernels.fused_ola(unpack_iq(x), **mon.ola_kwargs)
    err = rel_rms(y_planes, y_complex)
    print(f'fused_ola_strided on float32 planes vs fused_ola on the same complex64 samples: '
          f'relative RMS {err:.3g}, max |diff| {max_abs(y_planes, y_complex):.3g}')
    require(err <= 1e-6, f'float32 planes vs complex64: relative RMS {err:.3g}')
    # int16 counts against float32 planes holding the same integers (the
    # JAX bar of tests/test_monitor.py:603-609: 2e-5 of the largest value)
    x16, h16 = counts[:, :N_PLANES], counts[:, N_PLANES:]
    yi, ti = strided(x16.to(torch.int16), h16.to(torch.int16), n_frames=N_PLANES // hop,
                     **{**kw, 'precision': 'i16'})
    yf, tf = strided(x16.contiguous(), h16.contiguous(), n_frames=N_PLANES // hop, **kw)
    ref = torch.cat([yf, tf])
    diff = max_abs(torch.cat([yi, ti]), ref)
    print(f'fused_ola_strided int16 counts vs float32 planes of the same integers: max |diff| '
          f'{diff:.3g} ({diff / float(ref.abs().max()):.3g} of the largest value)')
    require(diff <= 2e-5 * float(ref.abs().max()), f'int16 vs float32 planes: {diff:.3g}')
    del y_planes, y_complex, yi, ti, yf, tf, ref
    torch.cuda.empty_cache()

    # ---- 18b: step_planes at the flagship design, each tier; 'i16' with
    # input_scale 2^-15 on 2^24 int16 counts: routes, profile, phase 3's
    # gates against reference_step on the same values, MS/s
    planes_ms = {}
    for tier, src in sources.items():
        tmon = it.WidebandMonitor(dataclasses.replace(design, fft_precision=tier,
                                                      input_scale=I16_INPUT_SCALE))
        p = src[:, :N_PLANES].contiguous()
        reset_counts()
        out = tmon.step_planes(p)
        torch.cuda.synchronize()
        launched = {k: v.launches for k, v in kset.items()}
        layouts = dict(strided.layout_launches)
        print(f'step_planes ({tier}): launches {json.dumps(launched)}; fused_ola_strided '
              f'routes {json.dumps(strided.route_launches)}, inputs {json.dumps(layouts)}')
        require(launched['fused_ola_strided'] == 1 and launched['chan_stats'] == 1
                and launched['hist'] == 1 and launched['fused_ola'] == 0,
                f'step_planes ({tier}) launches {launched}')
        require(strided.route_launches == ola_routes(reg=1),
                f'step_planes ({tier}): routes {strided.route_launches}')
        require(layouts[TIER_LAYOUT[tier]] == 1, f'step_planes ({tier}): inputs {layouts}')
        row_launches = launched['fused_ola_strided']
        ref = tmon.reference_step(unpack_iq(p.to(torch.float32)))
        check_step(out, ref, f'step_planes ({tier}) vs reference_step')
        planes_ms[tier] = timed_ms(lambda: tmon.step_planes(p))
        print(f'step_planes ({tier}): {planes_ms[tier]:.4f} ms for {N_PLANES} samples = '
              f'{N_PLANES / planes_ms[tier] / 1e3:.1f} MS/s ({smi})')
        if tier == 'i16':
            names, device_us = device_kernels(lambda: tmon.step_planes(p), OLA_REG_KERNEL,
                                              STATS_REG_KERNEL, HIST_KERNEL, fresh='planes_i16')
            print('step_planes (i16) device kernels: ' + json.dumps(names))
            require(any(OLA_REG_KERNEL in n for n in names),
                    f'the profile of step_planes shows no {OLA_REG_KERNEL}')
            require(not [n for n in names if OLA_GENERIC_KERNEL in n],
                    'the radix-2 OLA kernel ran in step_planes')
            bad = library_kernels(names)
            require(not bad, f'library kernels in step_planes: {bad}')
            busy = sum(device_us.values()) / 1e3
            print('step_planes (i16) device time by kernel (us): ' + json.dumps(
                dict(sorted(device_us.items(), key=lambda kv: -kv[1]))))
            print(f'step_planes (i16) device busy {busy:.4f} ms of {planes_ms[tier]:.4f} ms '
                  f'(idle share {max(0.0, 1 - busy / planes_ms[tier]):.3f})')
            i16_device_us = device_us
        kwt = {**mon.strided_kwargs, 'precision': tier}
        row = strided_row(TIER_ROWS[tier], kwt, p, src[:, N_PLANES:].contiguous(), row_launches,
                          mem_rate, fp32_rate, smi)
        row['path_ms'] = planes_ms[tier]
        if tier == 'i16':
            row['profiled_device_ms'] = device_ms(i16_device_us, OLA_REG_KERNEL)
        rows.append(row)
        del out, ref, tmon
    del noise, counts, sources
    torch.cuda.empty_cache()

    # ---- 18c: the stream on the card: N_STREAM_CHECK chunks against one
    # step on their samples, then N_STREAM chunks timed
    n_check = N_STREAM_CHECK * STREAM_CHUNK
    x = torch.randn(n_check, dtype=torch.complex64, device=dev, generator=gen)
    got, _ = _stream(mon, x.split(STREAM_CHUNK))
    one = mon.step(x)
    worst = check_stream(got, one, f'stream of {N_STREAM_CHECK} chunks vs one step')
    print(f'stream of {N_STREAM_CHECK} x {STREAM_CHUNK} samples vs one step on {n_check}: '
          f'apd_counts equal, max |diff| {json.dumps(worst)}')
    del x, one, got
    torch.cuda.empty_cache()

    capture = torch.randn(N_STREAM * STREAM_CHUNK, dtype=torch.complex64, device=dev,
                          generator=gen)
    chunks = capture.split(STREAM_CHUNK)
    _stream(mon, chunks[:2])  # warm up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    stats, n_chunks = _stream(mon, chunks)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    launched = {k: v.launches for k, v in kset.items()}
    print(f'stream launches over {n_chunks} chunks: {json.dumps(launched)}')
    for k in ('fused_ola_strided', 'chan_stats', 'hist'):
        require(launched[k] == n_chunks, f'the stream launched {launched[k]} {k} for {n_chunks}')
    require(launched['fused_ola'] == 0 and strided.route_launches['generic'] == 0,
            f'the stream took another OLA kernel: {launched}, {strided.route_launches}')
    stream_launches = launched['fused_ola_strided']
    require(int(stats['apd_counts'].sum()) == capture.numel() // 2 // design.apd_navg,
            'the stream\'s APD total differs from its binned samples')
    for key, v in stats.items():
        if v.is_floating_point():
            require(bool(torch.isfinite(v).all()), f'stream {key}: not finite')
    rate = capture.numel() / stream_s / 1e6
    print(f'stream: {n_chunks} chunks, {capture.numel()} samples in {stream_s:.4f} s = '
          f'{rate:.1f} MS/s, {rate * 1e6 / STREAM_RATE:.1f}x real time at 122.88 MS/s ({smi})')
    carry = mon.accumulate_step(mon.accumulate_step(mon.init_carry(STREAM_CHUNK), chunks[0]),
                                chunks[1])
    chunk_ms = timed_ms(lambda: mon.accumulate_step(carry, chunks[2]))
    names, chunk_us = device_kernels(lambda: mon.accumulate_step(carry, chunks[2]),
                                     OLA_REG_KERNEL, STATS_REG_KERNEL, HIST_KERNEL, fresh='stream')
    chunk_busy = sum(chunk_us.values()) / 1e3
    print('stream chunk device kernels (us): ' + json.dumps(
        dict(sorted(chunk_us.items(), key=lambda kv: -kv[1]))))
    print(f'stream chunk: {chunk_ms:.4f} ms by events, device busy {chunk_busy:.4f} ms (idle '
          f'share {max(0.0, 1 - chunk_busy / chunk_ms):.3f}), on {smi}')
    bad = library_kernels(names)
    require(not bad, f'library kernels in the stream: {bad}')
    row = strided_row('fused_ola_strided', mon.strided_kwargs, chunks[0],
                      chunks[1][: mon.noverlap_in], stream_launches, mem_rate, fp32_rate, smi)
    row['path_ms'] = stream_s * 1e3 / n_chunks
    row['profiled_device_ms'] = device_ms(chunk_us, OLA_REG_KERNEL)
    rows.append(row)
    del capture, chunks, carry, stats
    torch.cuda.empty_cache()

    # ---- 18d: the same stream from a ci16 file on disk
    (ROOT / 'build').mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / 'build') as tmp:
        path = Path(tmp) / 'capture.ci16.sigmf-data'
        rng = np.random.default_rng(SEED)
        t0 = time.perf_counter()
        with open(path, 'wb') as f:
            for _ in range(N_DISK // STREAM_CHUNK):
                (PLANES_SCALE * rng.standard_normal(2 * STREAM_CHUNK)).astype('<i2').tofile(f)
        print(f'disk: wrote {path.stat().st_size} bytes of ci16 in '
              f'{time.perf_counter() - t0:.1f} s')
        waits, moves, folds = [], [], []
        carry = mon.init_carry(STREAM_CHUNK)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with CapturePrefetcher(path, STREAM_CHUNK, 'ci16_le', planes=True,
                               depth=DISK_DEPTH) as feed:
            it_feed = iter(feed)
            while True:
                t1 = time.perf_counter()
                planes = next(it_feed, None)
                if planes is None:
                    break
                t2 = time.perf_counter()
                x = unpack_iq(torch.from_numpy(planes).to(dev))
                t3 = time.perf_counter()
                carry = mon.accumulate_step(carry, x)
                t4 = time.perf_counter()
                waits.append(t2 - t1)
                moves.append(t3 - t2)
                folds.append(t4 - t3)
        disk_stats = mon.flush(carry)
        torch.cuda.synchronize()
        disk_s = time.perf_counter() - t0
        n_disk = len(folds)
        # the same samples read in one piece and streamed from the card
        whole = unpack_iq(torch.from_numpy(read_iq_planes(path)).to(dev))
        ref, _ = _stream(mon, whole.split(STREAM_CHUNK))
        del whole
    for key in disk_stats:
        require(torch.equal(disk_stats[key], ref[key]),
                f'the stream from disk differs from the same samples on the card: {key}')
    disk_rate = N_DISK / disk_s / 1e6
    host = {'wait_ms': 1e3 * float(np.median(waits)), 'to_card_ms': 1e3 * float(np.median(moves)),
            'accumulate_ms': 1e3 * float(np.median(folds))}
    idle = max(0.0, 1 - n_disk * chunk_busy / (disk_s * 1e3))
    print(f'disk stream: {n_disk} chunks, {N_DISK} samples in {disk_s:.4f} s = {disk_rate:.1f} '
          f'MS/s with the reads, {disk_rate * 1e6 / STREAM_RATE:.2f}x real time (on the card: '
          f'{rate:.1f} MS/s); host ms a chunk (median) {json.dumps(host)}, '
          f'{disk_s * 1e3 / n_disk:.2f} ms a chunk in all; device idle share {idle:.3f} '
          f'({chunk_busy:.4f} ms busy a chunk); equal to the card-resident stream, on {smi}')
    torch.cuda.empty_cache()

    # ---- 18e: the packed APD route at the blackman step's shape
    bmon = it.WidebandMonitor(dataclasses.replace(
        it.design_wideband_monitor(30.72e6, 15.36e6, **BLACKMAN), apd_kernel='packed'))
    emon = it.WidebandMonitor(dataclasses.replace(bmon.design, apd_kernel='auto'))
    n_b = (N_MONITOR_R3 // bmon.min_input_multiple()) * bmon.min_input_multiple()
    xb = torch.randn(n_b, dtype=torch.complex64, device=dev, generator=gen)
    reset_counts()
    kernels.colhist.route_launches.update(reg=0, generic=0)
    out = bmon.step(xb)
    torch.cuda.synchronize()
    launched = {k: v.launches for k, v in kset.items()}
    print(f'blackman step, packed APD: launches {json.dumps(launched)}, colhist routes '
          f'{json.dumps(kernels.colhist.route_launches)}')
    require(launched['colhist'] == 1 and launched['hist'] == 0
            and kernels.colhist.route_launches == {'reg': 1, 'generic': 0},
            f'the packed APD route launched {launched}, {kernels.colhist.route_launches}')
    packed_launches = launched['colhist']
    edge = emon.step(xb)['apd_counts'].long()
    a = out['apd_counts'].long()
    require(int(a.sum()) == int(edge.sum()),
            f'packed APD vs hist: totals {int(a.sum())} / {int(edge.sum())}')
    p = kernels.chan_stats(emon._step_ola(xb), **emon.chan_kwargs)['p_binned']
    require(p.numel() == N_PACKED_APD, f'the blackman step bins {p.numel()} samples')
    got = bmon._packed_counts(p, counter=kernels.colhist)
    plain = bmon._packed_counts(p, counter=kernels.colhist_plain)
    require(torch.equal(got, plain), 'the packed APD route differs from its plain version')
    edges = bmon.apd_edges
    n_levels = bmon.design.apd_bins + 1
    library = torch.bincount(bmon._packed_levels(p), minlength=n_levels)
    require(torch.equal(library.int(), got),
            'the packed APD route differs from torch.bincount on the same levels')
    rule_counts, edge_host = packed_rule_host(p, bmon.design)
    band = packed_band_host(p, bmon.design)
    off = np.abs(np.cumsum(got.long().cpu().numpy()) - np.cumsum(rule_counts))[: len(band)]
    drift = packed_drift(got, kernels.hist(p, edges))
    rule = packed_drift(rule_counts, edge_host)
    head = packed_drift(bmon._packed_counts(p[:PACKED_BAR_SAMPLES], counter=kernels.colhist),
                        kernels.hist(p[:PACKED_BAR_SAMPLES], edges))
    print(f'packed APD on the blackman step ({p.numel()} binned samples): totals '
          f'{int(a.sum())} / {int(edge.sum())}; against the JAX package\'s float32 rule in '
          f'numpy on the same samples, cumulative counts within {int(off.max())} (boundaries '
          f'off: {int((off > 0).sum())} of {len(band)}; the rounding band holds {int(band.sum())} '
          f'values, at most {int(band.max())} at a boundary, and at the worst boundary '
          f'{int(off[np.argmax(off)])} of {int(band[np.argmax(off)])}); against hist within '
          f'{drift} (the numpy rule against exact edges: {rule}); on the first '
          f'{PACKED_BAR_SAMPLES} against hist within {head}')
    require(head <= 2, f'packed APD vs hist on {PACKED_BAR_SAMPLES} samples: drift {head} > 2')
    require(bool((off <= band).all()),
            f'packed APD vs the JAX rule in numpy: cumulative counts off by {int(off.max())}, '
            f'beyond the rounding band at {int((off > band).sum())} boundaries')
    row = kernel_row(
        'colhist_packed_apd', {'launches': packed_launches, 'max_abs_err': 0.0},
        4 * p.numel() + 4 * got.numel(), 8 * p.numel(),
        lambda: bmon._packed_counts(p, counter=kernels.colhist),
        lambda: bmon._packed_counts(p, counter=kernels.colhist_plain),
        lambda: torch.bincount(bmon._packed_levels(p), minlength=n_levels), mem_rate, fp32_rate,
    )
    row['hist_ms'] = timed_ms(lambda: kernels.hist(p, edges))
    _, packed_us = device_kernels(lambda: bmon._packed_counts(p, counter=kernels.colhist),
                                  COLHIST_REG_KERNEL)
    _, hist_us = device_kernels(lambda: kernels.hist(p, edges), HIST_KERNEL)
    row['profiled_device_ms'] = sum(packed_us.values()) / 1e3
    row['colhist_device_ms'] = device_ms(packed_us, COLHIST_REG_KERNEL)
    row['hist_device_ms'] = device_ms(hist_us, HIST_KERNEL)
    print(f'packed APD on {p.numel()} binned samples x {edges.numel() + 1} levels: '
          f'{row["ms"]:.4f} ms by events ({row["profiled_device_ms"]:.4f} ms of device time, '
          f'{COLHIST_REG_KERNEL} {row["colhist_device_ms"]:.4f}; by kernel '
          f'{json.dumps(packed_us)}), bound {row["bound_ms"]:.4f} ms by {row["bound_by"]}, '
          f'plain {row["plain_ms"]:.4f} ms; {HIST_KERNEL} {row["hist_ms"]:.4f} ms by events, '
          f'{row["hist_device_ms"]:.4f} ms of device time, on {smi}')
    rows.append(row)
    del xb, out, p, bmon, emon
    torch.cuda.empty_cache()

    # ---- 18f: profile_step on the flagship step
    x = torch.randn(N_STEP, dtype=torch.complex64, device=dev, generator=gen)
    timer = mon.profile_step(x)
    print('profile_step (flagship, 2^24 samples):\n' + timer.report())
    require(set(timer.durations) == {'ola_resample', 'chan_stats_apd'},
            f'profile_step stages {sorted(timer.durations)}')
    return rows


# BASELINE config #1 (bench.py:212-251 the spectrogram, :399-455
# power_spectral_density): 2^24 complex64 samples of a tone + noise at
# 122.88 MS/s made on the card, nfft 1024 hann, the statistics of
# bench.py; N_PSD_CPU samples of it held against the CPU (the kernels'
# plain versions), CCDF_EDGES power edges for sample_ccdf
N_PSD = 1 << 24
PSD_FS = 122.88e6
PSD_NFFT = 1024
PSD_STATS = ['mean', 'max', 0.5, 0.95, 0.99]
PSD_TONE_HZ = 10.1e6  # off every bin centre
PSD_SNR_DB = 10  # tests/_synth.make_tone_noise's
N_PSD_CPU = 1 << 20
CCDF_EDGES = 513
PSD_HIST_BINS = (1024, 2048)  # rows 10 + 7 up to 1024 bins, rows 9 + 8 above


def psd_capture(dev) -> torch.Tensor:
    """phase 19's capture: a tone at PSD_TONE_HZ plus complex white noise
    PSD_SNR_DB below it, N_PSD complex64 samples made on the card from
    SEED."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t = torch.arange(N_PSD, device=dev, dtype=torch.float64) / PSD_FS
    tone = torch.exp(2j * math.pi * PSD_TONE_HZ * t).to(torch.complex64)
    noise = torch.randn(N_PSD, dtype=torch.complex64, device=dev, generator=gen)
    return tone + 10 ** (-PSD_SNR_DB / 20) * noise


def psd_kwargs(**extra) -> dict:
    return dict(fs=PSD_FS, window='hann', resolution=PSD_FS / PSD_NFFT, statistics=PSD_STATS,
                **extra)


def ccdf_edges() -> np.ndarray:
    """sample_ccdf's power edges: CCDF_EDGES from -40 to 15 dB, float32."""
    return (10 ** (np.linspace(-40.0, 15.0, CCDF_EDGES) / 10)).astype('float32')


# phase 19's profiled calls and the kernels each must show
PSD_TRACES = {
    'psd_default': (DB_REG_KERNEL,),
    'psd_histogram_1024': (LEVELS_REG_KERNEL, COLHIST_REG_KERNEL),
    'psd_histogram_2048': (DB_REG_KERNEL, COLHIST_REG_KERNEL),
    'sample_ccdf': (HIST_KERNEL,),
}


def psd_calls(it, x, p, edges) -> dict:
    """phase 19's timed calls on the capture ``x`` and its power ``p``."""
    nfft = PSD_NFFT
    return {
        'spectrogram': lambda: it.spectrogram(x, fs=PSD_FS, window='hann', nperseg=nfft),
        'psd_default': lambda: it.power_spectral_density(x, **psd_kwargs()),
        'psd_xla': lambda: it.power_spectral_density(x, **psd_kwargs(fft_backend='xla')),
        'psd_histogram_1024': lambda: it.power_spectral_density(
            x, **psd_kwargs(quantile_method='histogram', hist_bins=1024)),
        'psd_histogram_2048': lambda: it.power_spectral_density(
            x, **psd_kwargs(quantile_method='histogram', hist_bins=2048)),
        'sample_ccdf': lambda: it.sample_ccdf(p, edges),
        'iq_to_bin_power': lambda: it.iq_to_bin_power(x, 1 / PSD_FS, nfft / PSD_FS),
    }


U32 = 2.0**-24  # float32 unit roundoff


def fft_power_bound(p_ref, level: float, nfft: int):
    """the most the power of one bin can differ between two float32 FFTs
    of an nfft frame, for a bin of (linear) power ``p_ref`` in a spectrum
    of mean power ``level`` (dB) a bin: each transform is within
    u log2(nfft) ||X|| of the exact one, with ||X||^2 = nfft 10^(level/10),
    so |dp| <= 2 * 2 sqrt(p) u log2(nfft) ||X||. Per value the error is
    relative to the frame's energy, not to the value."""
    lin = 10 ** (level / 10)
    return 4 * (p_ref * lin * nfft).sqrt() * U32 * math.log2(nfft)


def psd_gate(got, ref, level: float, label: str, nfft: int = PSD_NFFT) -> dict:
    """the persistence spectrum's gate (tests/test_torch_psd.py), on dB
    statistics: 1e-3 dB on values within 40 dB of the spectrum's ``level``
    (its mean power a bin, dB); below it, the values' linear powers within
    fft_power_bound. Returns the largest dB difference within the 40 dB,
    the deep values' largest share of their bound, and their share of all
    values."""
    got, ref = got.double(), ref.to(got.device).double()
    require(got.shape == ref.shape, f'{label}: shape {tuple(got.shape)} != {tuple(ref.shape)}')
    require(bool(torch.isfinite(got).all()), f'{label}: not finite')
    shallow = ref >= level - 40
    d = (got - ref).abs()
    err = float(d[shallow].max()) if bool(shallow.any()) else 0.0
    require(err <= 1e-3, f'{label}: {err:.4g} dB > 1e-3 dB within 40 dB of the level')
    p_ref = 10 ** (ref[~shallow] / 10)
    lin = (10 ** (got[~shallow] / 10) - p_ref).abs()
    deep = float((lin / fft_power_bound(p_ref, level, nfft)).max()) if lin.numel() else 0.0
    require(deep <= 1, f'{label}: deep values at {deep:.3g} x the float32 FFT bound')
    return {'dB': err, 'deep_over_bound': deep, 'deep_share': float((~shallow).double().mean())}


def value_gate(got, ref, level: float, nfft: int, label: str) -> dict:
    """a dB spectrogram against another, value by value: every value's
    linear power within fft_power_bound of the reference's. Returns the
    largest dB difference within 40 dB of the level and the largest share
    of the bound."""
    got, ref = got.double(), ref.double()
    p_ref = 10 ** (ref / 10)
    share = float(((10 ** (got / 10) - p_ref).abs() / fft_power_bound(p_ref, level, nfft)).max())
    require(share <= 1, f'{label}: a value at {share:.3g} x the float32 FFT bound')
    shallow = ref >= level - 40
    return {'dB': max_abs(got[shallow], ref[shallow]), 'over_bound': share}


def psd_float64(x, nfft: int, fs: float) -> tuple:
    """the spectrogram of ``x`` in float64 with numpy and scipy, on the
    host: (power (frames, nfft) with the bins centred, freqs, times)."""
    import scipy.signal

    xh = x.cpu().numpy().astype(np.complex128)
    w = scipy.signal.get_window('hann', nfft)
    w = w / np.sqrt(np.mean(w**2))
    Y = np.fft.fftshift(np.fft.fft(xh.reshape(-1, nfft) * w, axis=1) / nfft, axes=1)
    spg = Y.real**2 + Y.imag**2
    return spg, (np.arange(nfft) - nfft // 2) * (fs / nfft), np.arange(spg.shape[0]) * (nfft / fs)


def psd_launches(fn) -> tuple:
    """(result, {kernel: launches}, {kernel: launches by route}) of one call
    of ``fn``, every count set to 0 just before it."""
    from iqwaveform_torch.ops import kernels

    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    launched = {k.__name__: k.launches for k in kernels.KERNELS if k.launches}
    routes = {k.__name__: {r: c for r, c in k.route_launches.items() if c}
              for k in kernels.KERNELS if k.launches and hasattr(k, 'route_launches')}
    return out, launched, routes


def psd_phases(dev, smi: str, mem_rate: float, fp32_rate: float) -> dict:
    """phase 19; returns, by kernels-line row name (rows 6-10), the numbers
    of this path: launches per call, the kernel at this path's shapes
    against its plain version, timed beside its bound and profiled."""
    import iqwaveform_torch as it
    from iqwaveform_torch.ops import kernels
    from iqwaveform_torch.ops.kernels.colhist import quantize_uniform
    from iqwaveform_torch.parallel import streaming as S

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n, nfft, fs = N_PSD, PSD_NFFT, PSD_FS
    frames = n // nfft
    x = psd_capture(dev)
    spg64, freqs64, times64 = psd_float64(x, nfft, fs)
    level = float(10 * np.log10(spg64.mean()))
    print(f'phase 19: {n} samples of a {PSD_TONE_HZ / 1e6} MHz tone + noise {PSD_SNR_DB} dB below '
          f'it at {fs / 1e6} MS/s, nfft {nfft}: spectrum level {level:.3f} dB a bin ({smi})')

    # ---- 19a: spectrogram, iq_to_bin_power, sample_ccdf
    (f, tt, spg), launched, _ = psd_launches(
        lambda: it.spectrogram(x, fs=fs, window='hann', nperseg=nfft))
    spg64_t = torch.from_numpy(spg64).to(dev)
    err = rel_rms(spg, spg64_t)
    print(f'spectrogram: {tuple(spg.shape)} {spg.dtype}, relative RMS {err:.4g} against float64 '
          f'numpy / scipy; freqs and times equal: {np.array_equal(f, freqs64)}, '
          f'{np.array_equal(tt, times64)}; kernel launches {json.dumps(launched)}')
    require(err <= 1e-5, f'spectrogram vs float64: relative RMS {err:.4g} > 1e-5')
    require(np.array_equal(f, freqs64) and np.array_equal(tt, times64),
            'spectrogram freqs / times differ from the float64 axes')
    del spg
    p64 = (x.real.double() ** 2 + x.imag.double() ** 2).reshape(-1, nfft)
    s64 = p64.sort(dim=1).values
    bin_refs = {'mean': p64.mean(dim=1), 'peak': s64[:, -1],
                0.5: (s64[:, nfft // 2 - 1] + s64[:, nfft // 2]) / 2}
    bin_errs = {}
    for kind, ref in bin_refs.items():
        got = it.iq_to_bin_power(x, 1 / fs, nfft / fs, kind=kind)
        bin_errs[str(kind)] = rel_rms(got, ref)
        require(tuple(got.shape) == (frames,) and got.dtype == torch.float32,
                f'iq_to_bin_power {kind}: {tuple(got.shape)} {got.dtype}')
        require(bin_errs[str(kind)] <= 1e-5,
                f'iq_to_bin_power {kind} vs float64: relative RMS {bin_errs[str(kind)]:.4g}')
    print(f'iq_to_bin_power (Tbin = {nfft} Ts): relative RMS against float64 {json.dumps(bin_errs)}')
    del p64, s64, bin_refs

    p = it.envtopow(x)
    edges = ccdf_edges()
    ccdf, ccdf_launched, ccdf_routes = psd_launches(lambda: it.sample_ccdf(p, edges, density=False))
    counts_plain = kernels.hist_plain(p, torch.from_numpy(edges).to(dev)).long()
    counts = it.power_analysis.histogram_edge_counts(p, edges)
    ccdf_plain = (n - counts_plain.cumsum(0))[:-1]
    print(f'sample_ccdf: {n} samples x {CCDF_EDGES} edges, launches {json.dumps(ccdf_launched)}, '
          f'routes {json.dumps(ccdf_routes)}, counts equal to hist_plain: '
          f'{torch.equal(counts, counts_plain)}, total {int(counts.sum())}')
    require(ccdf_launched == {'hist': 1} and ccdf_routes == {'hist': {'bucket': 1}},
            f'sample_ccdf launches {ccdf_launched} {ccdf_routes}')
    require(torch.equal(counts, counts_plain), 'histogram_edge_counts differs from hist_plain')
    require(int(counts.sum()) == n, 'histogram_edge_counts total differs from the sample count')
    require(torch.equal(ccdf, ccdf_plain), 'sample_ccdf differs from the plain counts')
    del counts, ccdf_plain

    # ---- 19b: power_spectral_density at its default (exact quantiles)
    kw = psd_kwargs()
    torch.cuda.synchronize()
    peak_phase = torch.cuda.max_memory_allocated()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    psd, launched, routes = psd_launches(lambda: it.power_spectral_density(x, **kw))
    psd_peak = torch.cuda.max_memory_allocated() - before
    print(f'psd default: {tuple(psd.shape)}, launches {json.dumps(launched)}, routes '
          f'{json.dumps(routes)}; peak device memory above its input {psd_peak / 2**20:.1f} MiB '
          f'({psd_peak / n:.2f} B a sample)')
    require(launched == {'spectrogram_dB': 1} and routes == {'spectrogram_dB': {'reg': 1}},
            f'psd default launches {launched} {routes}')
    db64 = 10 * torch.log10(spg64_t + 1e-25)
    q = torch.tensor([s for s in PSD_STATS if isinstance(s, float)], dtype=torch.float64,
                     device=dev)
    ref64 = torch.cat([db64.mean(dim=0)[None], db64.amax(dim=0)[None],
                       torch.quantile(db64, q, dim=0)])
    del db64, spg64_t
    gates = {'float64': psd_gate(psd, ref64, level, 'psd default vs float64')}
    gates['xla'] = psd_gate(psd, it.power_spectral_density(x, fft_backend='xla', **kw), level,
                            'psd default vs xla')
    small = x[:N_PSD_CPU]
    level_small = float(10 * np.log10(spg64[: N_PSD_CPU // nfft].mean()))
    gates['cpu'] = psd_gate(it.power_spectral_density(small, **kw),
                            it.power_spectral_density(small.cpu(), device='cpu', **kw),
                            level_small, f'psd default vs the CPU on {N_PSD_CPU} samples')
    print(f'psd default gates (largest dB difference within 40 dB of the level, the deep '
          f'values\' largest share of the float32 FFT bound, their share): {json.dumps(gates)}')

    # ---- 19c: quantile_method='histogram' at 1024 and 2048 bins
    want = {1024: ({'spectrogram_levels': 1, 'colhist': 1},
                   {'spectrogram_levels': {'reg': 1}, 'colhist': {'reg': 1}}),
            2048: ({'spectrogram_dB': 1, 'colhist': 1},
                   {'spectrogram_dB': {'reg': 1}, 'colhist': {'reg': 1}})}
    hist_gates = {}
    for bins in PSD_HIST_BINS:
        hkw = psd_kwargs(quantile_method='histogram', hist_bins=bins)
        h, launched, routes = psd_launches(lambda: it.power_spectral_density(x, **hkw))
        require((launched, routes) == want[bins],
                f'psd histogram {bins} bins: launches {launched} {routes}')
        width = 200.0 / bins
        g = {'named_vs_default': psd_gate(h[:2], psd[:2], level, f'psd histogram {bins} named'),
             'quantiles_vs_default_bins': max_abs(h[2:], psd[2:]) / width}
        require(g['quantiles_vs_default_bins'] <= 2,
                f'psd histogram {bins}: quantiles {g["quantiles_vs_default_bins"]:.3g} bins '
                'from the exact ones')
        h_cpu = it.power_spectral_density(small.cpu(), device='cpu', **hkw)
        h_small = it.power_spectral_density(small, **hkw)
        g['named_vs_cpu'] = psd_gate(h_small[:2], h_cpu[:2], level_small,
                                     f'psd histogram {bins} vs the CPU')
        g['quantiles_vs_cpu_bins'] = max_abs(h_small[2:].cpu(), h_cpu[2:]) / width
        require(g['quantiles_vs_cpu_bins'] <= 1,
                f'psd histogram {bins} vs the CPU: quantiles {g["quantiles_vs_cpu_bins"]:.3g} bins')
        g['launches'] = launched
        hist_gates[bins] = g
        print(f'psd histogram {bins} bins: launches {json.dumps(launched)}, routes '
              f'{json.dumps(routes)}, gates {json.dumps(g)}')
    del h, h_small, h_cpu

    # ---- 19d: times, the profile, memory
    calls = psd_calls(it, x, p, edges)
    times = {}
    for name, fn in calls.items():
        times[name] = timed_ms(fn)
        rate = n / times[name] / 1e3
        print(f'{name}: {times[name]:.4f} ms for {n} samples = {rate:.1f} MS/s, '
              f'{rate / (PSD_FS / 1e6):.2f}x the {PSD_FS / 1e6} MS/s real-time rate ({smi})')
    traces = {}
    older = (LEVELS_GENERIC_KERNEL, COLHIST_GENERIC_KERNEL, HIST_GENERIC_KERNEL)
    for name, expect in PSD_TRACES.items():
        names, device_us = device_kernels(calls[name], *expect, fresh=name)
        for k in expect:
            require(any(k in n for n in names), f'profiler shows no {k} in {name}')
        bad = library_kernels(names)
        require(not bad, f'library FFT / GEMM kernels in {name}: {bad}')
        old = [k for k in names if short_name(k).split('<')[0] in older]
        require(not old, f'an older kernel ran in {name}: {old}')
        busy = sum(device_us.values()) / 1e3
        traces[name] = {'device_us': device_us, 'busy_ms': busy,
                        'idle_share': max(0.0, 1 - busy / times[name])}
        print(f'{name} device time by kernel (us): ' + json.dumps(
            dict(sorted(device_us.items(), key=lambda kv: -kv[1]))))
        print(f'{name}: device busy {busy:.4f} ms of {times[name]:.4f} ms (idle share '
              f'{traces[name]["idle_share"]:.3f}) ({smi})')
    torch.cuda.synchronize()
    peak_phase = max(peak_phase, torch.cuda.max_memory_allocated())
    total = torch.cuda.get_device_properties(dev).total_memory
    # the default PSD holds its input (8 B a sample) and psd_peak / n more
    largest = int(total / (8 + psd_peak / n)) // nfft * nfft
    print(f'phase 19 peak device memory {peak_phase / 2**30:.3f} GiB; the default PSD '
          f'(exact quantiles, one device sort) needs {8 + psd_peak / n:.2f} B a sample with its '
          f'input, so this card ({total / 2**30:.1f} GiB) holds a capture of at most {largest} '
          f'samples ({largest // nfft} frames of {nfft}: a {4 * largest / 2**30:.1f} GiB float32 '
          f'spectrogram) ({smi})')

    # ---- the kernels of this path at its shapes, against their plain
    # versions, beside their bounds
    d = S.design_persistence(nfft=nfft, window='hann', hist_bins=0, fft_backend='pallas',
                             fft_precision='highest')
    w = torch.from_numpy(d['kernel_window']).to(dev)
    db = kernels.spectrogram_dB(x, w, nfft)
    db_plain = kernels.spectrogram_dB_plain(x, w, nfft)
    db_gate = value_gate(db, db_plain, level, nfft, 'spectrogram_dB at phase 19')
    db_err = db_gate['dB']
    print(f'spectrogram_dB at phase 19 against its plain version: {json.dumps(db_gate)}')
    quants = {b: S.design_persistence(nfft=nfft, window='hann', hist_bins=b)['quant']
              for b in PSD_HIST_BINS}
    quant = quants[1024]
    lv = kernels.spectrogram_levels(x, w, nfft, quant=quant)
    lv_plain = kernels.spectrogram_levels_plain(x, w, nfft, quant=quant)
    moved = (lv['levels'] - lv_plain['levels']).abs()
    require(int(moved.max()) <= 1 and float((moved > 0).double().mean()) <= 1e-3,
            f'spectrogram_levels at phase 19: levels moved by up to {int(moved.max())}, '
            f'{float((moved > 0).double().mean()):.3g} of them')
    levels = lv['levels']
    scratch = torch.zeros((nfft, quant[2]), dtype=torch.int32, device=dev)
    ch = kernels.colhist(levels, scratch)
    require(torch.equal(ch, kernels.colhist_plain(levels, scratch)), 'colhist at phase 19')
    lo, scale, b2 = quants[2048]
    scratch2 = torch.zeros((nfft, b2), dtype=torch.int32, device=dev)
    chv = kernels.colhist(db, scratch2, lo=lo, scale=scale)
    require(torch.equal(chv, kernels.colhist_plain(db, scratch2, lo=lo, scale=scale)),
            'colhist on values at phase 19')
    e_t = torch.from_numpy(edges).to(dev)
    cols = torch.arange(nfft, device=dev, dtype=torch.int64)
    flat = (levels.long() + cols * quant[2]).reshape(-1)
    flat2 = (quantize_uniform(db, lo, scale, b2).long() + cols * b2).reshape(-1)
    per_frame = fft_ops(nfft) + 12 * nfft
    spec = {
        # name: (launches a call, max_abs_err, bytes, operations, kernel,
        # plain, library, trace, kernel name in it)
        'spectrogram_dB': (1, db_err, 8 * n + 4 * n + 8 * nfft, frames * per_frame,
                           lambda: kernels.spectrogram_dB(x, w, nfft),
                           lambda: kernels.spectrogram_dB_plain(x, w, nfft),
                           lambda: kernels.spectrogram_dB_plain(x, w, nfft),
                           'psd_default', DB_REG_KERNEL),
        'spectrogram_levels': (1, float(moved.max()), 8 * n + 4 * n + 8 * nfft + 12 * nfft,
                               frames * per_frame,
                               lambda: kernels.spectrogram_levels(x, w, nfft, quant=quant),
                               lambda: kernels.spectrogram_levels_plain(x, w, nfft, quant=quant),
                               lambda: kernels.spectrogram_levels_plain(x, w, nfft, quant=quant),
                               'psd_histogram_1024', LEVELS_REG_KERNEL),
        'colhist': (1, 0.0, 4 * levels.numel() + 2 * 4 * scratch.numel(), levels.numel(),
                    lambda: kernels.colhist(levels, scratch),
                    lambda: kernels.colhist_plain(levels, scratch),
                    lambda: torch.bincount(flat, minlength=scratch.numel()),
                    'psd_histogram_1024', COLHIST_REG_KERNEL),
        'colhist_values': (1, 0.0, 4 * db.numel() + 2 * 4 * scratch2.numel(), 4 * db.numel(),
                           lambda: kernels.colhist(db, scratch2, lo=lo, scale=scale),
                           lambda: kernels.colhist_plain(db, scratch2, lo=lo, scale=scale),
                           lambda: torch.bincount(flat2, minlength=scratch2.numel()),
                           'psd_histogram_2048', COLHIST_REG_KERNEL),
        'hist': (1, 0.0, 4 * n + 4 * e_t.numel() + 4 * (e_t.numel() + 1),
                 n * math.ceil(math.log2(e_t.numel() + 1)),
                 lambda: kernels.hist(p, e_t), lambda: kernels.hist_plain(p, e_t), None,
                 'sample_ccdf', HIST_KERNEL),
    }
    added = {}
    for kname, (per_call, kerr, nbytes, nops, kfn, pfn, lfn, trace, kernel) in spec.items():
        row = kernel_row(kname, {'launches': per_call, 'max_abs_err': kerr}, nbytes, nops,
                         kfn, pfn, lfn, mem_rate, fp32_rate)
        row = {k: v for k, v in row.items() if k not in ('name', 'route', 'source', 'replaces')}
        row['profiled_device_ms'] = device_ms(traces[trace]['device_us'], kernel)
        row['in_call'] = trace
        added[kname] = row
        print(f'{kname} on the phase 19 path ({trace}): {row["ms"]:.4f} ms by events, '
              f'{row["profiled_device_ms"]:.4f} ms of device time in the call, bound '
              f'{row["bound_ms"]:.4f} ms by {row["bound_by"]}, plain {row["plain_ms"]:.4f} ms, '
              f'library {row["library_ms"]} ({smi})')
    added['colhist']['float_values'] = added.pop('colhist_values')
    summary = {'times_ms': times, 'idle_share': {k: v['idle_share'] for k, v in traces.items()},
               'psd_peak_bytes': psd_peak, 'phase_peak_bytes': peak_phase,
               'largest_capture_samples': largest, 'gates': gates,
               'hist_gates': {str(k): v for k, v in hist_gates.items()},
               'bin_power_rel_rms': bin_errs}
    print('phase 19 summary: ' + json.dumps(summary))
    del x, p, db, db_plain, lv, lv_plain, levels, flat, flat2, psd
    torch.cuda.empty_cache()
    return added


# ---- phase 20: exact quantiles without the sort (the refinement), the
# carry's checkpoint, and the routes by shape
N_REFINE_BOTH = 1 << 28  # 20a: both PSD routes hold it
N_REFINE_BIG = 1 << 31  # 20b: the sort does not
N_EXACT_STREAM = 1 << 30  # 20c: BASELINE #3's capture
N_EXACT_ORACLE = 1 << 26  # 20c: where _quantile of row 9's dB fits beside it
N_CAPTURE_PIECE = 1 << 26  # long_capture makes its samples in pieces of this
ORACLE_BINS = 16
REFINE_REPS = 5
N_ROUTE = 1 << 24  # 20d: the calls at shapes the kernels do not take
N_ROUTE_CPU = 1 << 20
ROUTE_NFFT = (1000, 1536)
ROUTE_EDGES = 40000
ROUTE_TAPS = 40000
N_ROUTE_UPFIRDN = 1 << 16
SORT_FIXED_BYTES = 64 << 20  # 20a: the sort's bytes beside its 52 a sample
SORT_NEAR = 0.9  # 20a: the sort's run near the threshold, as a share of it
# the refinement's passes on the card: rows 10 + 7 (the fold), 9 + 7 (the
# narrowing), 9 (the collect)
REFINE_KERNELS = (LEVELS_REG_KERNEL, COLHIST_REG_KERNEL, DB_REG_KERNEL)
REFINE_TRACES = {'psd_sort_2e28': (DB_REG_KERNEL,), 'psd_refined_2e28': REFINE_KERNELS}


def long_capture(dev, n: int) -> torch.Tensor:
    """phase 19's tone + noise at n samples, made on the card in pieces of
    N_CAPTURE_PIECE (a float64 time axis of the whole would not fit beside
    2^31 samples), the noise of piece i from seed SEED + i."""
    x = torch.empty(n, dtype=torch.complex64, device=dev)
    for i, lo in enumerate(range(0, n, N_CAPTURE_PIECE)):
        m = min(N_CAPTURE_PIECE, n - lo)
        gen = torch.Generator(device=dev).manual_seed(SEED + i)
        t = torch.arange(lo, lo + m, device=dev, dtype=torch.float64) / PSD_FS
        x[lo:lo + m] = torch.exp(2j * math.pi * PSD_TONE_HZ * t).to(torch.complex64)
        x[lo:lo + m] += 10 ** (-PSD_SNR_DB / 20) * torch.randn(
            m, dtype=torch.complex64, device=dev, generator=gen)
    return x


def refined_psd(x, **kw):
    """the default PSD through the refinement whatever its size (the
    threshold set to 0 samples for the call)."""
    import iqwaveform_torch as it
    from iqwaveform_torch.ops import spectral

    saved = spectral._refine_above
    spectral._refine_above = lambda device: 0
    try:
        return it.power_spectral_density(x, **psd_kwargs(**kw))
    finally:
        spectral._refine_above = saved


def peak_call(fn) -> tuple:
    """(result, peak device bytes above what was allocated before, seconds
    by the host clock to the synchronize) of one call of ``fn``, every
    launch count set to 0 just before it; and {kernel: launches}."""
    from iqwaveform_torch.ops import kernels

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = {k.__name__: k.launches for k in kernels.KERNELS if k.launches}
    return out, torch.cuda.max_memory_allocated() - before, seconds, launched


def collect_capacity() -> list:
    """wrap the refinement's collect pass so that each call records its
    capacity C; returns the list it appends to (restore with
    ``unwrap_capacity``)."""
    from iqwaveform_torch.parallel import streaming as S

    seen = []
    inner = S._collect_pass

    def spy(*args):
        seen.append(args[-1])
        return inner(*args)

    spy.inner = inner
    S._collect_pass = spy
    return seen


def unwrap_capacity() -> None:
    from iqwaveform_torch.parallel import streaming as S

    S._collect_pass = S._collect_pass.inner


def narrow_labels_check(call) -> dict:
    """run ``call`` with the refinement's narrowing pass spied on, then
    hold ``colhist`` on the first chunk's stacked sub-bin labels (frames,
    nq * nfft) int32 of _B_SUB + 1 levels, the shape that pass launches it
    at, against ``colhist_plain``; fails unless they are equal. Returns
    the call's result and the comparison."""
    from iqwaveform_torch.ops import kernels
    from iqwaveform_torch.parallel import streaming as S

    seen = []
    inner = S._narrow_pass

    def spy(*args):
        seen.append(args)
        return inner(*args)

    S._narrow_pass = spy
    try:
        out = call()
    finally:
        S._narrow_pass = inner
    require(bool(seen), 'the refinement ran no narrowing pass')
    chunks, _, w, nfft, lo, hi, invw = seen[0]
    labels = S._sub_idx_map(kernels.spectrogram_dB(chunks[0], w, nfft), lo, hi, invw)
    labels = labels.reshape(labels.shape[0], -1)
    zeros = torch.zeros((labels.shape[1], S._B_SUB + 1), dtype=torch.int32, device=lo.device)
    got = kernels.colhist(labels, zeros.clone())
    ref = kernels.colhist_plain(labels, zeros.clone())
    err = int((got - ref).abs().max())
    require(torch.equal(got, ref) and bool((got.sum(dim=1) == labels.shape[0]).all()),
            f'colhist on the narrowing pass\'s labels {tuple(labels.shape)} differs from '
            f'colhist_plain by up to {err}')
    check = {'shape': list(labels.shape), 'levels': S._B_SUB + 1, 'max_abs_err': err,
             'ms': timed_ms(lambda: kernels.colhist(labels, zeros.clone())),
             'plain_ms': timed_ms(lambda: kernels.colhist_plain(labels, zeros.clone()))}
    del labels, zeros, got, ref
    return out, check


def quantile_columns(chunks, w, nfft: int, bins, qs) -> torch.Tensor:
    """_quantile over the columns ``bins`` of row 9's dB of ``chunks``,
    chunk by chunk, kept on the card: (len(qs), len(bins))."""
    from iqwaveform_torch.ops import kernels
    from iqwaveform_torch.ops.power import _quantile

    cols = torch.cat([kernels.spectrogram_dB(c, w, nfft)[:, bins] for c in chunks])
    return _quantile(cols, qs, axis=0)


def refinement_phases(dev, smi: str) -> dict:
    """phase 20; returns, by kernels-line row name (rows 7, 9, 10), the
    launches and device time of the refinement on this path."""
    import iqwaveform_torch as it
    from iqwaveform_torch import parallel as P
    from iqwaveform_torch.ops import kernels, spectral
    from iqwaveform_torch.parallel import streaming as S

    nfft, fs = PSD_NFFT, PSD_FS
    q_rows = [i for i, s in enumerate(PSD_STATS) if isinstance(s, float)]
    named = [i for i in range(len(PSD_STATS)) if i not in q_rows]
    qs = tuple(PSD_STATS[i] for i in q_rows)
    total = torch.cuda.get_device_properties(dev).total_memory
    limit = spectral._refine_above(dev)
    print(f'phase 20: the default PSD sorts up to {limit} samples on this card ({total} B, '
          f'{spectral._SORT_BYTES_PER_SAMPLE} + {spectral._INPUT_BYTES_PER_SAMPLE} B a sample, '
          f'{spectral._MEMORY_MARGIN} B kept back), and refines above ({smi})')
    summary = {'sort_limit_samples': limit}

    # ---- 20a: both routes of the default PSD at 2^28 samples, one call
    n = N_REFINE_BOTH
    x = long_capture(dev, n)
    level = float(10 * torch.log10((x[:1 << 24].abs() ** 2).double().mean() / nfft))
    sort, sort_peak, _, sort_launched = peak_call(
        lambda: it.power_spectral_density(x, **psd_kwargs()))
    (refined, refine_peak, _, refine_launched), narrow_check = narrow_labels_check(
        lambda: peak_call(lambda: refined_psd(x)))
    print(f'20a: colhist on the narrowing pass\'s labels of one chunk against colhist_plain: '
          f'{json.dumps(narrow_check)} ({smi})')
    require(sort_launched == {'spectrogram_dB': 1},
            f'20a: the sort route launched {sort_launched}')
    require(all(refine_launched.get(k, 0) > 0
                for k in ('spectrogram_levels', 'spectrogram_dB', 'colhist')),
            f'20a: the refinement launched {refine_launched}')
    equal = torch.equal(refined[q_rows], sort[q_rows])
    named_gate = psd_gate(refined[named], sort[named], level, '20a named rows, refined vs sort')
    require(equal, '20a: the refinement\'s quantile rows differ from the sort\'s')
    per_sample = sort_peak / n
    print(f'20a: {n} samples, quantile rows of the two routes torch.equal: {equal}; named rows '
          f'{json.dumps(named_gate)}; launches: sort {json.dumps(sort_launched)}, refinement '
          f'{json.dumps(refine_launched)}; peak above the input: sort {sort_peak / 2**20:.1f} MiB '
          f'({per_sample:.2f} B a sample), refinement {refine_peak / 2**20:.1f} MiB '
          f'({refine_peak / n:.3f} B a sample) ({smi})')
    # the threshold's margin covers what the sort holds beside its bytes a
    # sample; a growth with the capture would not be covered
    fixed = sort_peak - spectral._SORT_BYTES_PER_SAMPLE * n
    require(fixed <= SORT_FIXED_BYTES,
            f'20a: the sort holds {per_sample:.4f} B a sample ({fixed} B above the '
            f'{spectral._SORT_BYTES_PER_SAMPLE} B a sample the threshold assumes)')
    times = {'sort': timed_ms(lambda: it.power_spectral_density(x, **psd_kwargs()),
                              reps=REFINE_REPS, warmup=1),
             'refined': timed_ms(lambda: refined_psd(x), reps=REFINE_REPS, warmup=1)}
    for route, ms in times.items():
        print(f'20a {route}: {ms:.4f} ms for {n} samples = {n / ms / 1e3:.1f} MS/s '
              f'({smi})')
    traces = {}
    for name, expect in REFINE_TRACES.items():
        fn = ((lambda: it.power_spectral_density(x, **psd_kwargs())) if name == 'psd_sort_2e28'
              else (lambda: refined_psd(x)))
        names, device_us = device_kernels(fn, *expect, fresh=name)
        for k in expect:
            require(any(k in m for m in names), f'profiler shows no {k} in {name}')
        bad = library_kernels(names)
        require(not bad, f'library FFT / GEMM kernels in {name}: {bad}')
        busy = sum(device_us.values()) / 1e3
        traces[name] = {'device_us': device_us, 'busy_ms': busy}
        print(f'20a {name} device time by kernel (us): ' + json.dumps(
            dict(sorted(device_us.items(), key=lambda kv: -kv[1]))))
        print(f'20a {name}: device busy {busy:.4f} ms ({smi})')
    summary['20a'] = {'ms': times, 'MSps': {k: n / v / 1e3 for k, v in times.items()},
                      'peak_bytes': {'sort': sort_peak, 'refined': refine_peak},
                      'sort_bytes_per_sample': per_sample, 'named_gate': named_gate,
                      'launches': {'sort': sort_launched, 'refined': refine_launched},
                      'colhist_narrow_labels': narrow_check}
    del x, sort, refined

    # the sort's bytes a sample, measured above, set the threshold: the
    # default PSD sorts a capture near it within the card's memory less the
    # margin, by the allocator's reserve as well as by what it allocated
    n = int(limit * SORT_NEAR) // nfft * nfft
    x = long_capture(dev, n)
    psd, near_peak, near_s, near_launched = peak_call(
        lambda: it.power_spectral_density(x, **psd_kwargs()))
    allocated, reserved = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()
    require(near_launched == {'spectrogram_dB': 1},
            f'20a: the default PSD on {n} samples did not take the sort ({near_launched})')
    require(tuple(psd.shape) == (len(PSD_STATS), nfft) and bool(torch.isfinite(psd).all()),
            f'20a: the sort on {n} samples gave {tuple(psd.shape)}')
    room = total - spectral._MEMORY_MARGIN
    require(allocated <= room and reserved <= room,
            f'20a: the sort on {n} samples peaked at {allocated} B allocated, {reserved} B '
            f'reserved, beyond the {room} B the threshold allows')
    print(f'20a: the default PSD sorts {n} samples ({n / limit:.3f} of the threshold) in '
          f'{near_s * 1e3:.1f} ms: peak {allocated} B allocated ({near_peak / n:.4f} B a sample '
          f'above the input), {reserved} B reserved, of the {room} B the threshold allows '
          f'({smi})')
    summary['20a_near'] = {'samples': n, 'ms': near_s * 1e3, 'peak_allocated': allocated,
                           'peak_reserved': reserved, 'room': room,
                           'bytes_per_sample': near_peak / n}
    del x, psd

    # ---- 20b: the default PSD at 2^31 samples takes the refinement itself
    n = N_REFINE_BIG
    x = long_capture(dev, n)
    seen = collect_capacity()
    try:
        psd, peak, seconds, launched = peak_call(lambda: it.power_spectral_density(
            x, **psd_kwargs()))
    finally:
        unwrap_capacity()
    for k in ('spectrogram_levels', 'spectrogram_dB', 'colhist'):
        require(launched.get(k, 0) > 0, f'20b: the refinement launched no {k}: {launched}')
    require(len(seen) == 1, f'20b: the default PSD did not take the refinement ({seen})')
    require(tuple(psd.shape) == (len(PSD_STATS), nfft) and bool(torch.isfinite(psd).all()),
            f'20b: {tuple(psd.shape)}, finite {bool(torch.isfinite(psd).all())}')
    chunk_frames = spectral._FOLD_CHUNK_SAMPLES // nfft
    hist = it.power_spectral_density(x, **psd_kwargs(quantile_method='histogram',
                                                     hist_bins=1024))
    width = 200.0 / 1024
    off_bins = max_abs(psd[q_rows], hist[q_rows]) / width
    require(off_bins <= 1, f'20b: {off_bins:.3g} bins from the histogram quantiles')
    bins = torch.from_numpy(np.linspace(0, nfft - 1, ORACLE_BINS).round().astype('int64')).to(dev)
    w = torch.from_numpy(S.design_persistence(nfft=nfft, window='hann', hist_bins=0)
                         ['kernel_window']).to(dev)
    chunk = chunk_frames * nfft
    oracle = quantile_columns([x[i:i + chunk] for i in range(0, n, chunk)], w, nfft, bins, qs)
    exact = torch.equal(psd[q_rows][:, bins], oracle)
    require(exact, '20b: the refined quantiles differ from _quantile of row 9 on the sampled bins')
    del hist, oracle
    print(f'20b: {n} complex64 samples ({n * 8 / 2**30:.0f} GiB): {seconds * 1e3:.1f} ms = '
          f'{n / seconds / 1e6:.1f} MS/s ({n / PSD_FS:.2f} s of capture at {PSD_FS / 1e6} MS/s), '
          f'peak above the input {peak / 2**20:.1f} MiB, collect capacity C {seen}, launches '
          f'{json.dumps(launched)}; quantiles {off_bins:.3f} bins from the histogram ones; '
          f'bit for bit on {ORACLE_BINS} bins: {exact} ({smi})')
    summary['20b'] = {'ms': seconds * 1e3, 'MSps': n / seconds / 1e6, 'peak_bytes': peak,
                      'C': seen, 'launches': launched, 'hist_bins_off': off_bins}
    del x, psd

    # ---- 20c: streaming_persistence_spectrum(exact_quantiles=True) at
    # BASELINE #3, and a checkpoint halfway through its fold
    design = P.design_persistence(**PERSISTENCE)
    kw = dict(fs=1.0, window=PERSISTENCE['window'], nfft=nfft, chunk_frames=CHUNK // nfft,
              hist_bins=PERSISTENCE['hist_bins'], hist_range_dB=PERSISTENCE['hist_range_dB'],
              quantiles=qs, fft_backend=PERSISTENCE['fft_backend'],
              fft_precision=PERSISTENCE['fft_precision'])
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((2, N_EXACT_STREAM), device=dev, generator=gen)
    small = x[:, :N_EXACT_ORACLE]
    got = it.streaming_persistence_spectrum(small, exact_quantiles=True, **kw)
    oracle = quantile_columns([small[:, i:i + CHUNK] for i in range(0, N_EXACT_ORACLE, CHUNK)],
                              torch.from_numpy(design['kernel_window']).to(dev), nfft,
                              torch.arange(nfft, device=dev), qs)
    require(got.get('quantiles_exact') is True and torch.equal(got['quantiles_dB'], oracle),
            f'20c: exact quantiles on {N_EXACT_ORACLE} samples differ from _quantile of row 9')
    del got, oracle
    fold, _, fold_s, fold_launched = peak_call(
        lambda: it.streaming_persistence_spectrum(x, **kw))
    out, exact_peak, exact_s, exact_launched = peak_call(
        lambda: it.streaming_persistence_spectrum(x, exact_quantiles=True, **kw))
    require(fold_launched.get('spectrogram_levels', 0) == N_EXACT_STREAM // CHUNK,
            f'20c: the fold launched {fold_launched}')
    require(exact_launched.get('spectrogram_dB', 0) >= N_EXACT_STREAM // CHUNK,
            f'20c: the refinement launched {exact_launched}')
    width = 200.0 / PERSISTENCE['hist_bins']
    off_bins = max_abs(out['quantiles_dB'], fold['quantiles_dB']) / width
    require(off_bins <= 1, f'20c: {off_bins:.3g} bins from the histogram quantiles')
    # the checkpoint: fold half the chunks, save, load, fold the rest
    half = N_EXACT_STREAM // 2
    first = it.streaming_persistence_spectrum(x[:, :half], **kw)
    path = ROOT / 'build' / 'phase20_carry.npz'
    path.parent.mkdir(exist_ok=True)
    P.save_carry(path, first['_carry'])
    restored = P.load_carry(path, P.persistence_init(design, dev))
    path.unlink()
    resumed = it.streaming_persistence_spectrum(x[:, half:], init_carry=restored, **kw)
    same = all(torch.equal(a, b) for a, b in zip(
        (resumed['_carry'].hist, resumed['_carry'].psum, resumed['_carry'].pmax,
         resumed['_carry'].pmin, resumed['quantiles_dB']),
        (fold['_carry'].hist, fold['_carry'].psum, fold['_carry'].pmax, fold['_carry'].pmin,
         fold['quantiles_dB'])))
    require(same and resumed['_carry'].count == fold['_carry'].count,
            '20c: the fold resumed from a checkpoint differs from the uninterrupted one')
    print(f'20c: BASELINE #3 on {N_EXACT_STREAM} samples: the fold {fold_s * 1e3:.1f} ms, with '
          f'the exact quantiles {exact_s * 1e3:.1f} ms (the refinement '
          f'{(exact_s - fold_s) * 1e3:.1f} ms), peak {exact_peak / 2**20:.1f} MiB above the '
          f'input; quantiles {off_bins:.3f} bins from the histogram ones; bit for bit with '
          f'_quantile of row 9 on {N_EXACT_ORACLE} samples; resumed from a checkpoint at '
          f'{half} samples: torch.equal {same}; launches {json.dumps(exact_launched)} ({smi})')
    summary['20c'] = {'fold_ms': fold_s * 1e3, 'exact_ms': exact_s * 1e3,
                      'peak_bytes': exact_peak, 'hist_bins_off': off_bins,
                      'launches': exact_launched}
    del x, small, fold, out, first, restored, resumed

    # ---- 20d: shapes the kernels do not take route before any launch
    x = long_capture(dev, N_ROUTE)
    small = x[:N_ROUTE_CPU]
    routes = {}
    for route_nfft in ROUTE_NFFT:
        kw = dict(fs=fs, window='hann', resolution=fs / route_nfft, statistics=PSD_STATS)
        got, _, _, launched = peak_call(lambda: it.power_spectral_density(x, **kw))
        require(launched == {}, f'20d: the PSD at nfft {route_nfft} launched {launched}')
        lvl = float(10 * torch.log10((small.abs() ** 2).double().mean() / route_nfft))
        g = psd_gate(it.power_spectral_density(small, **kw),
                     it.power_spectral_density(small.cpu(), device='cpu', **kw), lvl,
                     f'20d PSD at nfft {route_nfft} vs the CPU', nfft=route_nfft)
        routes[f'psd_{route_nfft}'] = {'launches': launched, 'gate': g,
                                       'shape': list(got.shape)}
    fkw = dict(fs=fs, window='hann', nfft=1536, chunk_frames=N_ROUTE // 2 // 1536, hist_bins=1024,
               quantiles=qs, fft_backend='mxu')
    got, _, _, launched = peak_call(lambda: it.streaming_persistence_spectrum(x, **fkw))
    require(launched.get('colhist', 0) > 0 and set(launched) == {'colhist'},
            f'20d: the fold at nfft 1536 launched {launched}')
    small_kw = dict(fkw, chunk_frames=N_ROUTE_CPU // 1536)
    card = it.streaming_persistence_spectrum(small, **small_kw)
    cpu = it.streaming_persistence_spectrum(small.cpu(), device='cpu', **small_kw)
    lvl = float(10 * torch.log10((small.abs() ** 2).double().mean() / 1536))
    g = {k: psd_gate(card[k], cpu[k], lvl, f'20d fold at 1536 {k} vs the CPU', nfft=1536)
         for k in ('mean_dB', 'max_dB')}
    drift = int((card['hist'].cpu().long().cumsum(1) - cpu['hist'].long().cumsum(1)).abs().max())
    require(drift <= 2, f'20d fold at 1536: cumulative counts {drift} from the CPU\'s')
    routes['fold_1536'] = {'launches': launched, 'gate': g, 'hist_drift': drift}
    p = it.envtopow(x)
    edges = (10 ** (np.linspace(-40.0, 15.0, ROUTE_EDGES) / 10)).astype('float32')
    _, ccdf_launched, ccdf_routes = psd_launches(lambda: it.sample_ccdf(p, edges, density=False))
    got, _, _, launched = peak_call(lambda: it.sample_ccdf(p, edges, density=False))
    require(launched == {'hist': 1} and ccdf_routes == {'hist': {'slices': 1}},
            f'20d: sample_ccdf with {ROUTE_EDGES} edges launched {launched}, {ccdf_routes}')
    require(torch.equal(got.cpu(), it.sample_ccdf(p.cpu(), edges, density=False, device='cpu')),
            f'20d: sample_ccdf with {ROUTE_EDGES} edges differs from the CPU\'s')
    plain_counts = kernels.hist_plain(p, torch.from_numpy(edges).to(dev)).long()
    require(torch.equal(got, (p.numel() - plain_counts.cumsum(0))[:-1]),
            f'20d: sample_ccdf with {ROUTE_EDGES} edges differs from the plain path\'s')
    routes['sample_ccdf_40000'] = {'launches': launched, 'routes': ccdf_routes}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    xs = torch.randn((1, N_ROUTE_UPFIRDN), device=dev, generator=gen)
    h = torch.randn(ROUTE_TAPS, device=dev, generator=gen) / math.sqrt(ROUTE_TAPS)
    got, _, _, launched = peak_call(lambda: it.fourier.upfirdn(h, xs, 1, 1))
    require(launched == {}, f'20d: upfirdn at {ROUTE_TAPS} taps launched {launched}')
    err = rel_rms(got.cpu(), it.fourier.upfirdn(h.cpu(), xs.cpu(), 1, 1, device='cpu'))
    require(err <= 1e-5, f'20d: upfirdn at {ROUTE_TAPS} taps vs the CPU: {err:.3g}')
    routes['upfirdn_40000'] = {'launches': launched, 'rel_rms_vs_cpu': err}
    print('20d: the routes at shapes the kernels did not take (the PSD and fold as before; '
          'sample_ccdf at 40,000 edges on the histogram\'s slices, against the CPU port and the '
          'plain path): ' + json.dumps(routes))
    summary['20d'] = routes
    print('phase 20 summary: ' + json.dumps(summary))
    del x, small, p, xs, h, got
    torch.cuda.empty_cache()

    device_ms_of = {name: device_ms(traces['psd_refined_2e28']['device_us'], kernel)
                    for name, kernel in (('spectrogram_dB', DB_REG_KERNEL),
                                         ('spectrogram_levels', LEVELS_REG_KERNEL),
                                         ('colhist', COLHIST_REG_KERNEL))}
    rows = {name: {'launches': summary['20b']['launches'].get(name, 0),
                   'in_call': f'power_spectral_density on {N_REFINE_BIG} samples (refined)',
                   'profiled_device_ms_2e28': device_ms_of[name]}
            for name in device_ms_of}
    rows['colhist']['narrow_labels'] = narrow_check
    return rows


# ---- phase 21: the sharded layer (iqwaveform_torch.parallel's mesh,
# sharded entry points and WidebandMonitor.sharded_step) on one NCCL rank

N_SHARDS = 4  # the in-process shards of 21b
# the Step 0 designs (21f), each with the stage, its route and its kernel:
# the shapes no CUDA kernel took before phase 25's routes (135168 -> 24576
# at 135.168 -> 24.576 MS/s, 11 x 12288, on the split route's prime pass; a
# channelizer size outside CHAN_SIZES, 48 x 768 = 36864, on its split
# route; 40,000 APD edges, above one block's table, on the slices; the
# blackmanharris frames of 122.88 -> 3.84 MS/s, 1310720 -> 40960, on a
# radix step of 80 parts; 196608 -> 24576 and 172032 -> 24576 left this
# list earlier, phases 22 and 24d),
# and one the JAX kernel refuses too (navg 256 at a size no power of two:
# the plain version, chan_stats never launched)
REFUSED_DESIGNS = {
    'frames135168': ((135.168e6, 24.576e6), dict(bw=10e6, fs_sdr=135.168e6, window='blackman'),
                     'ola', 'split', 'fused_ola_frames'),
    # 80 x 16384 -> 4 x 10240, the grid's design (split_design's): the plain
    # frames until the split route's radix steps took up to 2048 parts
    # (phase 26d)
    'frames1310720': ((122.88e6, 3.84e6), dict(fs_sdr=122.88e6, window='blackmanharris',
                                               min_fft_size=8191),
                      'ola', 'split', 'fused_ola_frames'),
    'chan36864': ((122.88e6, 61.44e6), dict(FLAGSHIP, channel_count=48,
                                            fft_size_per_channel=768, apd_navg=1),
                  'chan', 'split', 'chan_stats'),
    'edges40000': ((122.88e6, 61.44e6), dict(FLAGSHIP, apd_bins=40000), 'apd', 'slices', 'hist'),
    'navg256': ((122.88e6, 61.44e6), dict(FLAGSHIP, channel_count=48, apd_navg=256),
                'chan', 'plain', 'chan_stats'),
}


def _launched() -> dict:
    from iqwaveform_torch.ops import kernels

    torch.cuda.synchronize()
    return {k.__name__: k.launches for k in kernels.KERNELS if k.launches}


def sharded_step_check(mon_s, mon, x, label: str, smi: str) -> dict:
    """21a: one sharded_step on the one rank's block against step on the
    same block (torch.equal on every output), its launches and collective
    calls, both timed."""
    from iqwaveform_torch.parallel import _collectives

    from iqwaveform_torch.ops import kernels
    from iqwaveform_torch.parallel.mesh import axis_of

    reset_counts()
    _collectives.reset_calls()
    out_s = mon_s.sharded_step(x)
    launched = _launched()
    frame_routes = dict(kernels.fused_ola_frames.route_launches)
    calls = dict(_collectives.calls)
    out = mon.step(x)
    equal = {k: torch.equal(out_s[k], v) for k, v in out.items()}
    print(f'21a {label}: sharded_step launches {json.dumps(launched)}, collectives '
          f'{json.dumps(calls)}, routes {json.dumps(mon_s.routes)}, torch.equal to step: '
          f'{json.dumps(equal)}')
    require(all(equal.values()), f'21a {label}: sharded_step differs from step: {equal}')
    require(calls == {'halo': 0, 'tail': 0, 'all_reduce': 3, 'all_gather': 0},
            f'21a {label}: collectives {calls}')
    step_ms = timed_ms(lambda: mon.step(x))
    sharded_ms = timed_ms(lambda: mon_s.sharded_step(x))
    # the merge alone (three all-reduces and their packing) on the step's
    # outputs, by events and by the host clock
    group, _, n_time = axis_of(mon_s.mesh, mon_s.time_axis)
    n_binned = out['channel_power'].shape[-2] * mon_s.chan_kwargs['nfft_big'] // mon_s.design.apd_navg
    merge_ms = timed_ms(lambda: mon_s._merge_time(out, group, n_time, n_binned))
    merge_host = host_ms(lambda: mon_s._merge_time(out, group, n_time, n_binned), calls=200)
    step_host = host_ms(lambda: mon.step(x), calls=50)
    sharded_host = host_ms(lambda: mon_s.sharded_step(x), calls=50)
    n = x.numel()
    print(f'21a {label}: step {step_ms:.4f} ms ({n / step_ms / 1e3:.1f} MS/s), sharded_step on '
          f'one NCCL rank {sharded_ms:.4f} ms ({n / sharded_ms / 1e3:.1f} MS/s) on {n} samples; '
          f'the merge alone {merge_ms:.4f} ms by events, {merge_host:.4f} ms of host time a call; '
          f'host time a call: step {step_host:.4f} ms, sharded_step {sharded_host:.4f} ms ({smi})')
    return {'launches': launched, 'frame_routes': frame_routes, 'ms': sharded_ms,
            'step_ms': step_ms, 'merge_ms': merge_ms, 'merge_host_ms': merge_host,
            'step_host_ms': step_host, 'host_ms': sharded_host, 'collectives': calls}


def four_shards(mon, x) -> tuple:
    """21b: the flagship rank body (``_shard_body``) on N_SHARDS contiguous
    shards of ``x`` in one process, in order: each shard's halo cut from the
    next shard's head, its incoming tail the previous shard's; the
    statistics combined as the collectives merge them (means averaged,
    maxima taken, counts summed). Returns (outputs, launches)."""
    s = x.shape[-1] // N_SHARDS
    nov = mon.noverlap_in
    reset_counts()
    outs, tail = [], None
    for i in range(N_SHARDS):
        halo = x[..., (i + 1) * s : (i + 1) * s + nov] if i < N_SHARDS - 1 else None
        out, tail = mon._shard_body(x[..., i * s : (i + 1) * s], halo, tail,
                                    tail=i < N_SHARDS - 1)
        outs.append(out)
    launched = _launched()
    merged = {
        'channel_power': torch.cat([o['channel_power'] for o in outs], dim=-2),
        'channel_power_mean': torch.stack([o['channel_power_mean'] for o in outs]).mean(0),
        'channel_power_max': torch.stack([o['channel_power_max'] for o in outs]).amax(0),
        'psd_mean': torch.stack([o['psd_mean'] for o in outs]).mean(0),
        'psd_max': torch.stack([o['psd_max'] for o in outs]).amax(0),
        'apd_counts': torch.stack([o['apd_counts'].long() for o in outs]).sum(0).int(),
    }
    return merged, launched


def sharded_phases(dev, smi: str) -> dict:
    """phase 21; returns, by kernels-line row name, the launches and times
    of the sharded paths that run the kernel (each row's ``sharded``
    entry)."""
    import os

    import torch.distributed as dist

    import iqwaveform_torch as it
    from iqwaveform_torch import parallel
    from iqwaveform_torch.ops import kernels
    from iqwaveform_torch.ops.kernels.fused_ola import ola_grouped
    from iqwaveform_torch.ops.power import _quantile, histogram_edge_counts
    rows = {}

    def note(row, path, launches, ms):
        rows.setdefault(row, {'launches': {}, 'ms': {}})
        rows[row]['launches'][path] = launches
        rows[row]['ms'][path] = ms

    store = ROOT / 'build' / 'nccl_rank0_store'
    store.parent.mkdir(parents=True, exist_ok=True)
    if store.exists():
        store.unlink()
    os.environ.setdefault('NCCL_SOCKET_IFNAME', 'lo')
    torch.cuda.set_device(dev.index or 0)
    dist.init_process_group('nccl', init_method=f'file://{store}', rank=0, world_size=1)
    try:
        mesh = parallel.time_mesh(1)
        require(parallel.mesh.mesh_device(mesh) == torch.device('cuda', torch.cuda.current_device()),
                'the mesh\'s device is not the current card')
        print(f'phase 21: one NCCL rank, {mesh} ({smi})')
        gen = torch.Generator(device=dev).manual_seed(SEED)

        # ---- 21a: sharded_step at the flagship, the blackman design of
        # the flagship rates (C = 3 clusters) and the packed APD, torch.equal
        # to step on the same 2^24 samples
        x = torch.randn((1, N_STEP), dtype=torch.complex64, device=dev, generator=gen)
        designs = {
            'flagship': it.design_wideband_monitor(122.88e6, 61.44e6, **FLAGSHIP),
            'blackman_c3': it.design_wideband_monitor(122.88e6, 61.44e6, **CLUSTER_MONITOR),
            'packed_apd': it.design_wideband_monitor(122.88e6, 61.44e6, **FLAGSHIP,
                                                     apd_kernel='packed'),
        }
        expect = {'flagship': ('fused_ola_strided', 'chan_stats', 'hist'),
                  'blackman_c3': ('fused_ola_frames', 'chan_stats', 'hist'),
                  'packed_apd': ('fused_ola_strided', 'chan_stats', 'colhist')}
        row_of = {'flagship': {'fused_ola_strided': 'fused_ola_strided', 'chan_stats': 'chan_stats',
                               'hist': 'hist'},
                  'blackman_c3': {'fused_ola_frames': 'fused_ola_frames_cluster',
                                  'chan_stats': 'chan_stats', 'hist': 'hist'},
                  'packed_apd': {'fused_ola_strided': 'fused_ola_strided',
                                 'chan_stats': 'chan_stats', 'colhist': 'colhist_packed_apd'}}
        for name, design in designs.items():
            mon_s = it.WidebandMonitor(design, mesh=mesh)
            mon = it.WidebandMonitor(design)
            res = sharded_step_check(mon_s, mon, x, name, smi)
            require(set(res['launches']) == set(expect[name])
                    and all(v == 1 for v in res['launches'].values()),
                    f'21a {name}: launches {res["launches"]}, not one each of {expect[name]}')
            if name == 'blackman_c3':
                require(res['frame_routes']['cluster'] == 1,
                        f'21a {name}: frame routes {res["frame_routes"]}')
            for kname, n in res['launches'].items():
                note(row_of[name][kname], f'sharded_step_{name}', n, res['ms'])
            del mon_s, mon
        torch.cuda.empty_cache()

        # ---- 21b: four shards of the flagship capture in one process
        mon = it.WidebandMonitor(designs['flagship'])
        merged, launched = four_shards(mon, x)
        print(f'21b: {N_SHARDS} shards of {N_STEP // N_SHARDS} samples through _shard_body, '
              f'halos and tails from their neighbours: launches {json.dumps(launched)}')
        require(launched == {'fused_ola_strided': N_SHARDS, 'chan_stats': N_SHARDS,
                             'hist': N_SHARDS}, f'21b launches {launched}')
        check_step(merged, mon.step(x), f'21b {N_SHARDS} shards vs step')
        shards_ms = timed_ms(lambda: four_shards(mon, x), reps=5, warmup=1)
        print(f'21b: {N_SHARDS} shards {shards_ms:.4f} ms for {N_STEP} samples; within phase 3\'s '
              f'gates of step ({smi})')
        for kname, n in launched.items():
            note(kname, 'four_shards', n, shards_ms)
        del x, merged, mon
        torch.cuda.empty_cache()

        # ---- 21c: sharded_psd_stats at BASELINE #1, with and without the
        # exact quantiles
        xp = psd_capture(dev)
        nfft, fs = PSD_NFFT, PSD_FS
        q_rows = [i for i, s in enumerate(PSD_STATS) if isinstance(s, float)]
        named = [i for i in range(len(PSD_STATS)) if i not in q_rows]
        qs = tuple(PSD_STATS[i] for i in q_rows)
        skw = dict(mesh=mesh, fs=fs, window='hann', nperseg=nfft, statistics=PSD_STATS)
        w = torch.from_numpy(it.get_window('hann', nfft, xp=np, dtype='complex64', norm=True,
                                           fftshift=True) / nfft).to(torch.complex64).to(dev)
        dB = kernels.spectrogram_dB(xp, w, nfft)
        oracle = _quantile(dB, np.asarray(qs, dtype='float32'), axis=0)
        named_ref = torch.stack([dB.mean(dim=0), dB.amax(dim=0)])
        psd = it.power_spectral_density(xp, **psd_kwargs())
        # the spectrum's level: its mean power a bin, dB
        level = float(10 * torch.log10((10 ** (dB.double() / 10)).mean()))
        width = 200.0 / 2048
        for exact in (False, True):
            label = 'exact' if exact else 'histogram'
            (stats, hist, _), launched, routes = psd_launches(
                lambda: parallel.sharded_psd_stats(xp, exact_quantiles=exact, **skw))
            require(launched.get('spectrogram_dB') == 1 and routes.get('spectrogram_dB') == {'reg': 1}
                    and launched.get('colhist', 0) >= 1,
                    f'21c {label}: launches {launched} {routes}')
            require(torch.equal(stats[named], named_ref), f'21c {label}: named rows differ from '
                    'the same dB\'s mean / max')
            require(int(hist.sum(dim=1).min()) == int(hist.sum(dim=1).max()) == N_PSD // nfft,
                    f'21c {label}: histogram totals')
            gate = psd_gate(stats[named], psd[named], level, f'21c {label} named vs psd default')
            if exact:
                require(torch.equal(stats[q_rows], oracle),
                        '21c exact: quantiles differ from _quantile of the same dB')
                q_err = 0.0
            else:
                q_err = max_abs(stats[q_rows], oracle) / width
                require(q_err <= 2, f'21c histogram: quantiles {q_err:.3g} bins from the exact')
            ms = timed_ms(lambda: parallel.sharded_psd_stats(xp, exact_quantiles=exact, **skw),
                          reps=5, warmup=1)
            print(f'21c sharded_psd_stats ({label}): launches {json.dumps(launched)}, routes '
                  f'{json.dumps(routes)}; named rows torch.equal to the same dB\'s, vs the PSD '
                  f'default {json.dumps(gate)}; quantiles {"torch.equal to _quantile" if exact else f"{q_err:.3f} bins from the exact"}; '
                  f'{ms:.4f} ms = {N_PSD / ms / 1e3:.1f} MS/s ({smi})')
            for kname, n in launched.items():
                note(kname, f'sharded_psd_stats_{label}', n, ms)
        psd_ms = timed_ms(lambda: it.power_spectral_density(xp, **psd_kwargs()), reps=5, warmup=1)
        print(f'21c power_spectral_density default on the same capture: {psd_ms:.4f} ms ({smi})')
        del xp, dB, psd, oracle, named_ref
        torch.cuda.empty_cache()

        # ---- 21d: sharded_ola_filter at BASELINE #2, 'xla' and 'mxu'
        xo = torch.randn(N_OLA, dtype=torch.complex64, device=dev, generator=gen)
        ref = it.ola_filter(xo, **OLA_KW)
        ola_out = {}
        for backend in ('xla', 'mxu'):
            y, launched, routes = psd_launches(
                lambda: parallel.sharded_ola_filter(xo, mesh=mesh, fft_backend=backend, **OLA_KW))
            want = {'fused_ola_frames': 1} if backend == 'mxu' else {}
            require(launched == want, f'21d {backend}: launches {launched}')
            if backend == 'mxu':
                require(routes.get('fused_ola_frames') == {'reg': 1}, f'21d mxu: routes {routes}')
            m = min(y.shape[0], ref.shape[0]) - OLA_KW['nfft_out']
            err = rel_rms(y[:m], ref[:m])
            require(y.shape[0] == N_OLA // 2 and err <= 1e-5,
                    f'21d {backend}: {tuple(y.shape)}, relative RMS {err:.3g} vs ola_filter')
            ms = timed_ms(lambda: parallel.sharded_ola_filter(xo, mesh=mesh, fft_backend=backend,
                                                              **OLA_KW), reps=5, warmup=1)
            ola_out[backend] = (y[:N_OLA_CHAIN], err, ms, launched)
            del y
        # the first N_OLA_CHAIN output samples against the plain chain in
        # complex128 on the same input
        d = OLA_KW
        hop_in = d['nfft'] // 2
        n_in = 2 * N_OLA_CHAIN + d['nfft']
        w_in, w_out = it.ops.filtering._ola_windows(d['window'], d['nfft'], d['nfft_out'], hop_in,
                                                    dev)
        enbw = float(it.equivalent_noise_bandwidth(d['window'], d['nfft_out'], fftbins=False))
        zero_lo, zero_hi, b_in, b_out = it.ops.filtering._ola_bin_bounds(
            d['nfft'], d['nfft_out'], d['fs'], d['passband'], enbw, True)
        y64 = ola_grouped(xo[:n_in].to(torch.complex128), frames_fn=kernels.fused_ola_frames_plain,
                          w_in=w_in.to(torch.complex128), w_shift_out=w_out.to(torch.complex128),
                          nfft=d['nfft'], nfft_out=d['nfft_out'], noverlap_in=hop_in,
                          noverlap_out=d['nfft_out'] // 2, zero_lo=zero_lo, zero_hi=zero_hi,
                          bounds_in=b_in, bounds_out=b_out)[:N_OLA_CHAIN]
        ola_ms = timed_ms(lambda: it.ola_filter(xo, **OLA_KW), reps=5, warmup=1)
        for backend, (y, err, ms, launched) in ola_out.items():
            err64 = rel_rms(y, y64)
            require(err64 <= 1e-5, f'21d {backend}: relative RMS {err64:.3g} vs complex128')
            print(f'21d sharded_ola_filter ({backend}) on {N_OLA} samples: launches '
                  f'{json.dumps(launched)}, relative RMS {err:.3g} vs ola_filter, {err64:.3g} vs '
                  f'complex128 on the first {N_OLA_CHAIN} outputs; {ms:.4f} ms = '
                  f'{N_OLA / ms / 1e3:.1f} MS/s; ola_filter {ola_ms:.4f} ms ({smi})')
            for kname, n in launched.items():
                note(kname, f'sharded_ola_filter_{backend}', n, ms)
        del xo, ref, ola_out, y64
        torch.cuda.empty_cache()

        # ---- 21e: sharded_apd_histogram beside sample_ccdf's counts
        xa = torch.randn(N_PSD, dtype=torch.complex64, device=dev, generator=gen)
        edges = ccdf_edges()
        counts, launched, routes = psd_launches(
            lambda: parallel.sharded_apd_histogram(xa, mesh=mesh, edges=edges))
        p = xa.real * xa.real + xa.imag * xa.imag
        ref = histogram_edge_counts(p, edges)
        ccdf = parallel.ccdf_from_counts(counts, N_PSD)
        ccdf_ref = it.sample_ccdf(p, edges)
        require(launched == {'hist': 1} and routes == {'hist': {'bucket': 1}},
                f'21e launches {launched} {routes}')
        require(counts.dtype == torch.int32 and torch.equal(counts.long(), ref),
                '21e: counts differ from histogram_edge_counts')
        require(torch.equal(ccdf, ccdf_ref), '21e: the CCDF differs from sample_ccdf')
        ms = timed_ms(lambda: parallel.sharded_apd_histogram(xa, mesh=mesh, edges=edges))
        ccdf_ms = timed_ms(lambda: it.sample_ccdf(p, edges))
        print(f'21e sharded_apd_histogram on {N_PSD} samples x {CCDF_EDGES} edges: launches '
              f'{json.dumps(launched)}, counts equal to sample_ccdf\'s, the CCDF equal; {ms:.4f} ms '
              f'= {N_PSD / ms / 1e3:.1f} MS/s; sample_ccdf {ccdf_ms:.4f} ms ({smi})')
        for kname, n in launched.items():
            note(kname, 'sharded_apd_histogram', n, ms)
        del xa, p, counts, ref
        torch.cuda.empty_cache()

        # ---- 21f: Step 0, the monitor where a kernel refuses the design
        for name, (rates, kw, stage, route, kname) in REFUSED_DESIGNS.items():
            mon = it.WidebandMonitor(it.design_wideband_monitor(*rates, **kw))
            m = mon.min_input_multiple()
            xs = torch.randn((N_STEP // m) * m, dtype=torch.complex64, device=dev, generator=gen)
            out, launched, routes = psd_launches(lambda: mon.step(xs))
            if route == 'plain':
                require(mon.routes[stage] == 'plain' and kname not in launched,
                        f'21f {name}: routes {mon.routes}, launches {launched}')
            else:
                require(mon.routes[stage] == route and launched.get(kname) == 1
                        and routes[kname].get(route) == 1,
                        f'21f {name}: routes {mon.routes}, launches {launched}, by route {routes}')
            check_step(out, mon.reference_step(xs), f'21f {name} vs reference_step')
            small = xs[:m]
            check_step({k: v.cpu() for k, v in mon.step(small).items()},
                       it.WidebandMonitor(mon.design, device='cpu').step(small.cpu()),
                       f'21f {name} card step vs CPU step (one min_input_multiple)')
            ms = timed_ms(lambda: mon.step(xs), reps=5, warmup=1)
            print(f'21f {name}: routes {json.dumps(mon.routes)}, launches {json.dumps(launched)}, '
                  f'by route {json.dumps(routes)} ({kname} {"not launched" if route == "plain" else "on its " + route + " route"}); '
                  f'within phase 3\'s gates of reference_step and of the CPU step; '
                  f'{ms:.4f} ms for {xs.numel()} samples ({smi})')
            del mon, xs, out
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return rows


# ---- phase 21 across several cards (``python3 chip_smoke.py --ranks N``):
# the exchanges between NCCL ranks, which one card cannot show

# ---- phase 22: the split frame route and the register / cluster
# instances of the remaining grid pairs
SPLIT_KERNELS = ('split_radix_kernel', 'split_fwd_passes_kernel', 'split_inv_passes_kernel')
# the monitor designs of the 122.88 MS/s grid (22d): output rate, window,
# min_fft_size, each at bw = inf and at 0.66 of the output rate
SPLIT_GRID = [(fo, w, m) for fo in (61.44e6, 40.96e6, 30.72e6, 15.36e6)
              for w in ('hamming', 'blackman', 'blackmanharris') for m in (4095, 8191, 16383)]
N_SPLIT_FRAMES = 8  # 22a: frames a pair, cut from a strided capture
SPLIT_TIMED = ((65536, 16384), (196608, 24576), (655360, 81920))  # 22a: pairs timed
N_SPLIT_STEP = 1 << 24  # 22b / 22c: the steps' samples, in whole min_input_multiple()s
# 22b: the monitor steps on the split route
SPLIT_STEPS = {
    'split_hamming_65536': (30.72e6, dict(window='hamming', min_fft_size=16383), (65536, 16384)),
    'split_blackman_196608': (15.36e6, dict(window='blackman', min_fft_size=8191),
                              (196608, 24576)),
    'split_blackmanharris_655360': (15.36e6, dict(window='blackmanharris', min_fft_size=16383),
                                    (655360, 81920)),
    # the pair the split route took from the cluster of 10 blocks (22e)
    'split_blackmanharris_163840': (30.72e6, dict(window='blackmanharris', min_fft_size=8191),
                                    (163840, 40960)),
}
# 22c: the five grid pairs of the new register and cluster instances, each
# by the design that runs it: (output rate, window, min_fft_size), the
# pair, the wrapper's route
NEW_INSTANCES = {
    'fused_ola_reg_8192_4096': ((61.44e6, 'hamming', 4095), (8192, 4096), 'reg'),
    'fused_ola_reg_16384_4096': ((30.72e6, 'hamming', 4095), (16384, 4096), 'reg'),
    'fused_ola_frames_reg_12288_4096': ((40.96e6, 'hamming', 4095), (12288, 4096), 'reg'),
    'fused_ola_frames_cluster2_12288': ((61.44e6, 'blackman', 4095), (24576, 12288), 'cluster'),
    'fused_ola_frames_cluster2_8192': ((40.96e6, 'hamming', 8191), (24576, 8192), 'cluster'),
}
for _name in NEW_INSTANCES:
    KERNEL_INFO[_name] = ('iqwaveform_torch/csrc/'
                          + ('fused_ola.cu' if _name.startswith('fused_ola_reg') else 'ola_frames.cuh'),
                          'iqwaveform_tpu/ops/pallas/fused_ola_pallas.py:'
                          + ('571' if _name.startswith('fused_ola_reg') else '492'))
for _name in SPLIT_STEPS:
    KERNEL_INFO[_name] = ('iqwaveform_torch/csrc/ola_split.cu',
                          'iqwaveform_tpu/ops/pallas/fused_ola_pallas.py:492')
del _name


def split_design(fs_out: float, window: str, min_fft: int, bw=math.inf, device='cuda'):
    """a monitor of the 122.88 MS/s grid on ``device``."""
    import iqwaveform_torch as it

    return it.WidebandMonitor(it.design_wideband_monitor(
        122.88e6, fs_out, fs_sdr=122.88e6, window=window, min_fft_size=min_fft, bw=bw),
        device=device)


def split_step_frames(mon, n: int, gen, dev):
    """``n`` samples of noise (whole min_input_multiple()s) and the step's
    frames (the capture zero-extended by noverlap_in)."""
    m = mon.min_input_multiple()
    x = torch.randn(max(1, round(n / m)) * m, dtype=torch.complex64, device=dev, generator=gen)
    xe = torch.cat([x, x.new_zeros(mon.noverlap_in)])
    return x, xe.unfold(-1, mon.design.nfft, mon.hop_in)[: x.numel() // mon.hop_in]


def split_phases(dev, smi: str, mem_rate: float, fp32_rate: float) -> list:
    """phase 22; returns the kernels line's rows of the split route and of
    the new register and cluster instances."""
    from iqwaveform_torch.ops import kernels
    from iqwaveform_torch.ops.kernels import _build
    from iqwaveform_torch.ops.kernels.fused_ola import (
        _fused_ola_frames_generic,
        CLUSTER_PAIRS,
        H100_SMEM_OPTIN,
        _fused_ola_generic,
        _fused_ola_frames_split,
        frames_route,
        ola_route,
        split_plan,
    )

    kset = {k.__name__: k for k in kernels.KERNELS}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    frames_k = kernels.fused_ola_frames
    torch.cuda.reset_peak_memory_stats(dev)
    no_split = {'reg': 0, 'cluster': 0, 'split': 1, 'plan': 0, 'plan_cluster': 0, 'generic': 0}

    # ---- 22d first (no launch): the routes of the 36 grid designs on the
    # card; the split pairs of 22a are the grid's
    table, split_pairs = {}, set()
    for fo, w, m in SPLIT_GRID:
        for bw in (math.inf, 0.66 * fo):
            mon = split_design(fo, w, m, bw)
            pair = (mon.design.nfft, mon.design.nfft_out)
            route, frame = mon.routes['ola'], frames_route(*pair)
            table[f'{fo / 1e6:g} {w} {m} {"inf" if bw == math.inf else "0.66"}'] = (
                f'{pair[0]}->{pair[1]} {route}')
            # the 2:1 (hamming) designs name their frame kernel through
            # ola_route ('<frame route>+add'), but the register 2:1 pairs
            require(route == (ola_route(*pair) if mon._strided else frame)
                    and (route == 'reg' or frame in ('reg', 'cluster', 'split')),
                    f'22d: {w} 122.88 -> {fo / 1e6:g} MS/s min_fft_size={m}: route {route}')
            if frame == 'split':
                split_pairs.add(pair)
    print('22d the OLA routes of the 36 grid designs (bw = inf, 0.66 of the output rate): '
          + json.dumps(table))
    require(len(split_pairs) == 25, f'22d: {len(split_pairs)} split pairs, not 25')
    report = _build.ptxas_report()
    lines = report.splitlines()
    for i, line in enumerate(lines):
        if 'Compiling entry' in line and (
                any(k in line for k in SPLIT_KERNELS)
                or any(f'ILi{a}ELi{b}E' in line for a, b in ((8192, 4096), (16384, 4096),
                                                               (12288, 4096), (24576, 12288),
                                                               (24576, 8192)))):
            name = line.split("'")[1] if "'" in line else line
            props = [ln.strip() for ln in lines[i + 1:i + 4] if 'registers' in ln or 'spill' in ln]
            print(f'22d ptxas {name[:110]}: {"; ".join(props)}')
    seconds = [ln for ln in lines if ln.startswith('== ')]
    print('22d nvcc per source (the build ran them in parallel): ' + '; '.join(seconds))

    # ---- 22a: each split pair against the plain chain and complex128
    pairs = {}
    for nfft, nfft_out in sorted(split_pairs):
        kw = cluster_kwargs(nfft, nfft_out, gen, dev)
        hop = nfft // 3
        capture = torch.randn(N_SPLIT_FRAMES * hop + nfft, dtype=torch.complex64, device=dev,
                              generator=gen)
        frames = capture.unfold(-1, nfft, hop)[:N_SPLIT_FRAMES]
        reset_counts()
        got = frames_k(frames, **kw)
        torch.cuda.synchronize()
        routes = dict(frames_k.route_launches)
        require(routes == no_split and frames_k.launches == 1,
                f'22a {nfft} -> {nfft_out}: kernels {routes}')
        ref = kernels.fused_ola_frames_plain(frames, **kw)
        ref64 = kernels.fused_ola_frames_plain(frames.to(torch.complex128), **_wide_kw(kw))
        err, err64, plain64 = rel_rms(got, ref), rel_rms(got, ref64), rel_rms(ref, ref64)
        (c1, m1), (c2, m2) = split_plan(nfft, nfft_out)
        entry = {'C1': c1, 'M1': m1, 'C2': c2, 'M2': m2, 'relative_rms': err,
                 'f64_rel_rms': err64, 'plain_f64_rel_rms': plain64}
        if (nfft, nfft_out) in SPLIT_TIMED:
            nbytes = 8 * capture.numel() + 8 * got.numel()
            nops = N_SPLIT_FRAMES * (fft_ops(nfft) + fft_ops(nfft_out) + 6 * (nfft + nfft_out))
            entry['ms'] = timed_ms(lambda: frames_k(frames, **kw))
            entry['library_ms'] = timed_ms(lambda: kernels.fused_ola_frames_plain(frames, **kw))
            entry['bound_ms'] = max(nbytes / mem_rate, nops / fp32_rate) * 1e3
        pairs[f'{nfft}->{nfft_out}'] = entry
        timed = ('' if 'ms' not in entry else
                 f'; {entry["ms"]:.4f} ms, torch.fft chain {entry["library_ms"]:.4f} ms, bound '
                 f'{entry["bound_ms"]:.4f} ms ({smi})')
        print(f'22a split {nfft} -> {nfft_out} ({c1} x {m1} -> {c2} x {m2}), {N_SPLIT_FRAMES} '
              f'frames: vs plain relative RMS {err:.3g}; vs complex128 {err64:.4g}, the plain '
              f'chain {plain64:.4g}{timed}')
        require(err <= 1e-5, f'22a split {nfft} -> {nfft_out}: relative RMS {err:.3g}')
        require(err64 <= 2 * plain64,
                f'22a split {nfft} -> {nfft_out}: complex128 error {err64:.4g} > 2 x the plain '
                f'chain\'s {plain64:.4g}')
        del capture, frames, got, ref, ref64
    torch.cuda.empty_cache()

    # ---- 22b: the monitor steps on the split route, against the plain
    # frames (the torch.fft chain on the card, the route before this one)
    rows = []
    for name, (fo, kw, pair) in SPLIT_STEPS.items():
        mon = split_design(fo, kw['window'], kw['min_fft_size'])
        # the hamming design's frames take the split kernels inside the 2:1
        # route (fused_ola, 'split+add': the frame wrapper not launched)
        add = kw['window'] == 'hamming'
        require((mon.design.nfft, mon.design.nfft_out) == pair
                and mon.routes['ola'] == ('split+add' if add else 'split'),
                f'22b {name}: {mon.design.nfft} -> {mon.design.nfft_out}, routes {mon.routes}')
        x, _ = split_step_frames(mon, N_SPLIT_STEP, gen, dev)
        mon.step(x[: mon.min_input_multiple()])  # warm-up: first-use setup
        torch.cuda.synchronize()
        reset_counts()
        out = mon.step(x)
        torch.cuda.synchronize()
        launched = {k: c.launches for k, c in kset.items() if c.launches}
        routes = dict(frames_k.route_launches)
        print(f'22b {name} ({x.numel()} samples, {pair[0]} -> {pair[1]}): launches '
              f'{json.dumps(launched)}; frame routes {json.dumps(routes)}')
        if add:
            add_routes = dict(kernels.fused_ola.route_launches)
            require(add_routes == ola_routes(**{'split+add': 1}) and launched.get('ola_add') == 1
                    and 'fused_ola_frames' not in launched,
                    f'22b {name}: launches {launched}, {add_routes}')
        else:
            require(routes == no_split and launched.get('fused_ola_frames') == 1
                    and 'fused_ola' not in launched, f'22b {name}: launches {launched}, {routes}')
        check_step(out, mon.reference_step(x), f'22b {name} vs reference_step')
        step_ms = timed_ms(lambda: mon.step(x))

        def plain_step(mon=mon, x=x):
            return mon._outputs(mon._step_ola(mon._input(x), plain=True), mon._chan, mon._counts)

        plain_step_ms = timed_ms(plain_step)
        names, device_us = device_kernels(lambda: mon.step(x), *SPLIT_KERNELS, fresh=name)
        require(all(any(k in n for n in names) for k in SPLIT_KERNELS[1:]),
                f'22b {name}: profiler shows no split passes kernels: {names}')
        bad = library_kernels(names) + [n for n in names if GENERIC_KERNEL in n]
        require(not bad, f'22b {name}: library or generic kernels in the step: {bad}')
        busy = sum(device_us.values()) / 1e3
        split_us = {k: v for k, v in device_us.items() if k.split('<')[0] in SPLIT_KERNELS}
        print(f'22b {name} device time by kernel (us): ' + json.dumps(
            dict(sorted(device_us.items(), key=lambda kv: -kv[1]))))
        print(f'22b {name}: {step_ms:.4f} ms for {x.numel()} samples = '
              f'{x.numel() / step_ms / 1e3:.1f} MS/s; through the plain frames {plain_step_ms:.4f} '
              f'ms; device busy {busy:.4f} ms (idle share {max(0.0, 1 - busy / step_ms):.3f}) '
              f'({smi})')
        row = cluster_frame_row(name, mon, x, launched, device_us, step_ms, mem_rate, fp32_rate,
                                smi, kernels_of=SPLIT_KERNELS,
                                launches=kernels.fused_ola.route_launches['split+add'] if add
                                else None)
        row['path'] = (f'WidebandMonitor.step, {kw["window"]} 122.88 -> {fo / 1e6:g} MS/s '
                       f'min_fft_size={kw["min_fft_size"]}, {pair[0]} -> {pair[1]}')
        row['plain_frames_path_ms'] = plain_step_ms
        row['idle_share'] = max(0.0, 1 - busy / step_ms)
        row['split_device_us'] = split_us
        if pair == SPLIT_TIMED[0]:
            row['pairs'] = pairs
        rows.append(row)
        del mon, x, out
        torch.cuda.empty_cache()

    # ---- 22c: the five pairs of the new register and cluster instances,
    # each against its plain version, the older body and complex128, timed
    # beside the older body and the torch.fft chain; the monitor step at
    # each design, whose launches the row carries
    for name, ((fo, w, m), pair, route) in NEW_INSTANCES.items():
        mon = split_design(fo, w, m)
        # a frame kernel's hamming (2:1) design steps through the 2:1 route
        # on that kernel ('<route>+add', counted in fused_ola's routes)
        via_add = w == 'hamming' and not name.startswith('fused_ola_reg')
        step_route = route + '+add' if via_add else route
        require((mon.design.nfft, mon.design.nfft_out) == pair and mon.routes['ola'] == step_route,
                f'22c {name}: {mon.design.nfft} -> {mon.design.nfft_out}, routes {mon.routes}')
        x, frames = split_step_frames(mon, N_SPLIT_STEP, gen, dev)
        strided = name.startswith('fused_ola_reg')
        if strided:
            require(ola_route(*pair) == 'reg', f'22c {name}: ola_route {ola_route(*pair)}')
            kw = mon.ola_kwargs
            call = lambda kw=kw, x=x: kernels.fused_ola(x, **kw)  # noqa: E731
            older = lambda kw=kw, x=x: _fused_ola_generic(x, **kw)  # noqa: E731
            plain = lambda kw=kw, x=x: kernels.fused_ola_plain(x, **kw)  # noqa: E731
            wrapper, inp = kernels.fused_ola, x[: N_F64_FRAMES * mon.hop_in]
            plain_fn, older_fn = kernels.fused_ola_plain, _fused_ola_generic
        else:
            require(frames_route(*pair) == route, f'22c {name}: frames_route {frames_route(*pair)}')
            kw = {k: v for k, v in mon.ola_kwargs.items() if not k.startswith('noverlap')}
            call = lambda kw=kw, f=frames: kernels.fused_ola_frames(f, **kw)  # noqa: E731
            older = lambda kw=kw, f=frames: _fused_ola_frames_generic(f, **kw)  # noqa: E731
            plain = lambda kw=kw, f=frames: kernels.fused_ola_frames_plain(f, **kw)  # noqa: E731
            wrapper, inp = frames_k, frames[:N_F64_FRAMES]
            plain_fn, older_fn = kernels.fused_ola_frames_plain, _fused_ola_frames_generic
        reset_counts()
        got = call()
        torch.cuda.synchronize()
        got_routes = dict(wrapper.route_launches)
        require(wrapper.launches == 1 and got_routes[route] == 1 and got_routes['generic'] == 0,
                f'22c {name}: {wrapper.__name__} routes {got_routes}')
        ref, old = plain(), older()
        err, err_old = rel_rms(got, ref), rel_rms(got, old)
        err64, old64 = f64_errors(inp, kw, wrapper, older_fn, plain_fn)
        print(f'22c {name}: {wrapper.__name__} {route} vs plain relative RMS {err:.3g}, vs the '
              f'older body {err_old:.3g}; first {N_F64_FRAMES} frames vs complex128 {err64:.4g}, '
              f'the older body {old64:.4g}')
        require(err <= 1e-5 and err_old <= 1e-5,
                f'22c {name}: relative RMS {err:.3g}, {err_old:.3g}')
        require(err64 <= 2 * old64,
                f'22c {name}: complex128 error {err64:.4g} > 2 x the older body\'s {old64:.4g}')
        reset_counts()
        out = mon.step(x)
        torch.cuda.synchronize()
        launched = {k: c.launches for k, c in kset.items() if c.launches}
        stepper = kernels.fused_ola if via_add else wrapper
        require(stepper.launches == 1 and stepper.route_launches[step_route] == 1
                and stepper.route_launches['generic'] == 0
                and (not via_add or 'fused_ola_frames' not in launched),
                f'22c {name} step: launches {launched}, {dict(stepper.route_launches)}')
        check_step(out, mon.reference_step(x), f'22c {name} step vs reference_step')
        d = mon.design
        n_fr = frames.shape[0]
        row = kernel_row(
            name, {'launches': stepper.route_launches[step_route], 'max_abs_err': max_abs(got, ref)},
            8 * x.numel() + 8 * got.numel(),
            n_fr * (fft_ops(d.nfft) + fft_ops(d.nfft_out) + 6 * (d.nfft + d.nfft_out)),
            call, plain, plain, mem_rate, fp32_rate,
        )
        row['generic_ms'] = timed_ms(older)
        row['f64_rel_rms'] = err64
        row['generic_f64_rel_rms'] = old64
        row['pair'] = f'{pair[0]}->{pair[1]}'
        row['path'] = f'WidebandMonitor.step, {w} 122.88 -> {fo / 1e6:g} MS/s min_fft_size={m}'
        row['path_ms'] = timed_ms(lambda mon=mon, x=x: mon.step(x))
        print(f'22c {name} step: launches {json.dumps(launched)}, within the step gates of '
              f'reference_step; {row["path_ms"]:.4f} ms for {x.numel()} samples ({smi})')
        print(f'22c {name} ({pair[0]} -> {pair[1]}): {row["ms"]:.4f} ms, the older body '
              f'{row["generic_ms"]:.4f} ms, torch.fft chain {row["library_ms"]:.4f} ms, bound '
              f'{row["bound_ms"]:.4f} ms by {row["bound_by"]} ({smi})')
        rows.append(row)
        del mon, x, frames, got, ref, old, out
        torch.cuda.empty_cache()

    # ---- 22e: the split route beside the cluster kernel at the cluster
    # pairs above one block, on the same frames (N_SPLIT_STEP samples at hop
    # nfft / 3): whether the cluster instances earn their build time
    versus = {}
    for nfft, nfft_out in sorted(p for p in CLUSTER_PAIRS if 8 * max(p) > H100_SMEM_OPTIN):
        kw = cluster_kwargs(nfft, nfft_out, gen, dev)
        hop = nfft // 3
        capture = torch.randn(N_SPLIT_STEP + nfft, dtype=torch.complex64, device=dev,
                              generator=gen)
        frames = capture.unfold(-1, nfft, hop)[: N_SPLIT_STEP // hop]
        require(frames_route(nfft, nfft_out) == 'cluster',
                f'22e {nfft} -> {nfft_out}: frames_route {frames_route(nfft, nfft_out)}')
        got = _fused_ola_frames_split(frames, **kw)
        ref = kernels.fused_ola_frames_plain(frames, **kw)
        err = rel_rms(got, ref)
        require(err <= 1e-5, f'22e split {nfft} -> {nfft_out}: relative RMS {err:.3g}')
        split_ms = timed_ms(lambda f=frames, kw=kw: _fused_ola_frames_split(f, **kw))
        cluster_ms = timed_ms(lambda f=frames, kw=kw: frames_k(f, **kw))
        (c1, m1), (c2, m2) = split_plan(nfft, nfft_out)
        versus[f'{nfft}->{nfft_out}'] = {
            'frames': frames.shape[0], 'split_ms': split_ms, 'cluster_ms': cluster_ms,
            'relative_rms': err}
        print(f'22e {nfft} -> {nfft_out}, {frames.shape[0]} frames: split ({c1} x {m1} -> {c2} x '
              f'{m2}) {split_ms:.4f} ms, cluster kernel {cluster_ms:.4f} ms '
              f'({split_ms / cluster_ms:.3f}x); split vs plain relative RMS {err:.3g} ({smi})')
        del capture, frames, got, ref
        torch.cuda.empty_cache()
    rows[0]['split_vs_cluster'] = versus
    print(f'phase 22 peak device memory: {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB')
    return rows


# ---- phase 23: the host layer on the card (SigMF recordings into the
# flagship step, the figures' computations, the FFT chunk bound, the framing
# helpers) and row 3's split route through ola_filter
N_HOST = 1 << 24  # samples a capture of 23a (two captures)
HOST_FS = 122.88e6
HOST_FREQS = (3.55e9, 3.65e9)  # the captures' center frequencies
HOST_STAMP = '2026-01-01T00:00:00+00:00'
# an NTIA CalibrationAnnotation with the fields that
# io.extract_ntia_calibration_metadata reads
HOST_CAL = {'ntia-core:annotation_type': 'CalibrationAnnotation',
            'ntia-sensor:temperature': 21.0, 'ntia-sensor:noise_figure_sensor': 4.5,
            'ntia-sensor:gain_preselector': 30.0}
HOST_DIR = ROOT / 'build' / 'host_layer'
CCDF_NAVG = 16  # 23b: samples a detector bin of plot_power_ccdf's averaged power
SPG_NFFT = 1024  # 23b: plot_spectrogram_heatmap_from_iq's window
FFT_BATCH = (4096, 16384)  # 23c: the batch transformed whole and chunked
FFT_CHUNK = 1 << 24  # 23c: the chunk bound, in samples
N_WINDOW = 1024  # 23d: sliding_window_view's span
BINNED_COUNT = 16  # 23d: binned_mean's bin
GROUP_MAX = 1 << 20  # 23d: grouped_views_along_axis's bound
# 23e: ola_filter at the pair of tests/test_torch_cuda.py
# test_ola_filter_takes_the_split_route, on the largest multiple of its
# noverlap (8192) at or below BASELINE #2's 99,999,744 samples
SPLIT_FILTER_KW = dict(fs=122.88e6, nfft=131072, nfft_out=16384, window='hamming',
                       passband=(-6e6, 6e6))
N_SPLIT_FILTER = 12207 * 8192
SPLIT_FILTER_ROW = 'split_ola_filter_131072'
KERNEL_INFO[SPLIT_FILTER_ROW] = ('iqwaveform_torch/csrc/ola_split.cu',
                                 'iqwaveform_tpu/ops/pallas/fused_ola_pallas.py:394')


def host_captures(dev) -> torch.Tensor:
    """23a's (2, N_HOST) complex64 capture: a tone at +PSD_TONE_HZ and one
    at -PSD_TONE_HZ / 2, each with complex white noise PSD_SNR_DB below
    it, made on the card from SEED."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t = torch.arange(N_HOST, device=dev, dtype=torch.float64) / HOST_FS
    tones = torch.stack([torch.exp(2j * math.pi * f * t) for f in (PSD_TONE_HZ, -PSD_TONE_HZ / 2)])
    noise = torch.randn((2, N_HOST), dtype=torch.complex64, device=dev, generator=gen)
    return tones.to(torch.complex64) + 10 ** (-PSD_SNR_DB / 20) * noise


def device_launches(fn, kernels_of, fresh: str | None = None) -> dict:
    """launches a call makes of each device kernel whose name holds one of
    ``kernels_of``, by short name, from one profiled call (retaken up to
    PROFILE_TRIES times while the trace holds none, then, where ``fresh``
    names the call, in a fresh process: see ``device_kernels``)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA and any(k in e.name for k in kernels_of):
                key = short_name(e.name)
                counts[key] = counts.get(key, 0) + 1
        if counts:
            return counts
    if fresh is None:
        return {}
    print(f'profiler: taking the launches of {fresh} in a fresh process')
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), '--trace', fresh],
                          capture_output=True, text=True, timeout=FRESH_TRACE_TIMEOUT_S)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode or not lines:
        print(f'profiler: the fresh process exited {proc.returncode}: {proc.stderr[-2000:]}')
        return {}
    return json.loads(lines[-1]).get('counts', {})


def host_phases(dev, smi: str, mem_rate: float, fp32_rate: float) -> tuple:
    """phase 23; returns the kernels line's row of row 3's split route
    through ola_filter, and the host-layer entries of rows 1, 5 and 6."""
    from scipy import signal

    import iqwaveform_torch as it
    from iqwaveform_torch import figures
    from iqwaveform_torch import io as tio
    from iqwaveform_torch.ops import filtering as TF
    from iqwaveform_torch.ops import kernels
    from iqwaveform_torch.utils import (
        binned_mean,
        grouped_views_along_axis,
        sliding_window_view,
        to_device_array,
    )

    kset = {k.__name__: k for k in kernels.KERNELS}

    def launched():
        return {name: k.launches for name, k in kset.items() if k.launches}

    host_layer = {}

    # ---- 23a: two captures through write_sigmf / read_sigmf (npy, the NTIA
    # gain) into the flagship step, against the step on the same scaled
    # arrays made in memory
    x = host_captures(dev)
    HOST_DIR.mkdir(parents=True, exist_ok=True)
    try:
        t0 = time.perf_counter()
        _, meta_path = tio.write_sigmf(HOST_DIR / 'two_captures', list(x), HOST_FS,
                                       center_frequency=HOST_FREQS, datatype='npy',
                                       timestamps=HOST_STAMP, annotations=[HOST_CAL])
        write_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        caps, freqs, Ts, cal = tio.read_sigmf(meta_path, stack=True, ntia_extensions=True)
        read_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for path in HOST_DIR.glob('two_captures*'):
            path.unlink()
    t0 = time.perf_counter()
    xf = to_device_array(caps.T, 'complex64')
    torch.cuda.synchronize()
    copy_ms = (time.perf_counter() - t0) * 1e3
    require(caps.shape == (N_HOST, 2) and tuple(freqs) == HOST_FREQS and Ts == 1 / HOST_FS,
            f'23a read_sigmf: {caps.shape}, {freqs}, {Ts}')
    require(cal == {'ambient temperature (K)': 21.0 + 273.15, 'noise figure (dB)': 4.5,
                    'gain (dB)': 30.0}, f'23a calibration {cal}')
    scale = tio._voltage_scale_from_cal(cal, True, 50)
    x_mem = (x.to(torch.complex128) * scale).to(torch.complex64)
    require(xf.device == x_mem.device and torch.equal(xf, x_mem),
            '23a the recording read back differs from the scaled capture made in memory')
    print(f'23a write_sigmf (npy, 2 x {N_HOST} samples from the card) {write_ms:.1f} ms, '
          f'read_sigmf(stack=True, ntia_extensions=True) {read_ms:.1f} ms, to_device_array '
          f'{copy_ms:.1f} ms (host clock; {smi}); voltage scale {scale:.6g}')

    mon = it.WidebandMonitor(it.design_wideband_monitor(122.88e6, 61.44e6, **FLAGSHIP))
    reset_counts()
    out = mon.step(xf)
    torch.cuda.synchronize()
    from_file = launched()
    reset_counts()
    ref = mon.step(x_mem)
    torch.cuda.synchronize()
    in_memory = launched()
    print(f'23a step on the (2, {N_HOST}) recording: launches {json.dumps(from_file)}; the '
          f'in-memory step {json.dumps(in_memory)}')
    require(from_file == in_memory, f'23a launches {from_file} differ from {in_memory}')
    for kname in MONITOR_KERNELS:
        require(from_file.get(kname, 0) > 0, f'23a the step launched no {kname} kernel')
    for key, v in out.items():
        require(v.shape == ref[key].shape and v.shape[0] == 2 and torch.equal(v, ref[key]),
                f'23a step {key} differs from the in-memory step')
        if v.is_floating_point():
            require(bool(torch.isfinite(v).all()), f'23a step {key} not finite')
    names, _ = device_kernels(lambda: mon.step(xf), OLA_REG_KERNEL, STATS_REG_KERNEL, HIST_KERNEL,
                              fresh='host_step')
    for k in (OLA_REG_KERNEL, STATS_REG_KERNEL, HIST_KERNEL):
        require(any(k in n for n in names), f'23a profiler shows no {k} in the step')
    bad = [n for n in names if any(f in n.lower() for f in FORBIDDEN)]
    require(not bad, f'23a library FFT / GEMM kernels in the step: {bad}')
    step_ms = timed_ms(lambda: mon.step(xf))
    print(f'23a step: {step_ms:.4f} ms for 2 x {N_HOST} samples = '
          f'{2 * N_HOST / step_ms / 1e3:.1f} MS/s ({smi})')
    for kname in MONITOR_KERNELS:
        host_layer[kname] = {'path': f'WidebandMonitor.step on the (2, {N_HOST}) SigMF recording',
                             'launches': from_file.get(kname, 0), 'path_ms': step_ms}
    host_layer['fused_ola'].update(write_ms=write_ms, read_ms=read_ms, copy_ms=copy_ms)
    del out, ref, x, x_mem, caps, mon

    # ---- 23b: what plot_power_ccdf and plot_spectrogram_heatmap_from_iq
    # compute, on the card, against device='cpu'
    x0 = xf[0]
    x0_cpu = x0.cpu()
    Tavg = CCDF_NAVG / HOST_FS
    reset_counts()
    navg, p_dB = figures._averaged_power_dB(x0, Ts, Tavg, False, device=dev)
    bins = figures._ccdf_bin_grid(p_dB, None)
    counts = it.sample_ccdf(p_dB, bins, density=False, device=dev)
    torch.cuda.synchronize()
    ccdf_calls = launched()
    ccdf_routes = dict(kernels.hist.route_launches)
    _, p_cpu = figures._averaged_power_dB(x0_cpu, Ts, Tavg, False, device='cpu')
    err_dB = max_abs(p_dB.cpu(), p_cpu)
    ref_counts = it.sample_ccdf(p_dB.cpu(), bins, density=False, device='cpu')
    print(f'23b plot_power_ccdf data: Navg {navg}, {p_dB.numel()} values in dB, {bins.size} edges '
          f'of 0.01 dB; launches {json.dumps(ccdf_calls)}, hist routes {json.dumps(ccdf_routes)}; '
          f'dB vs the CPU run max {err_dB:.3g} dB; counts equal to the CPU\'s '
          f'{torch.equal(counts.cpu(), ref_counts)}')
    require(ccdf_calls == {'hist': 1} and ccdf_routes == {'bucket': 1, 'generic': 0, 'slices': 0},
            f'23b launches {ccdf_calls}, routes {ccdf_routes}')
    require(err_dB <= 1e-4, f'23b averaged power {err_dB:.3g} dB from the CPU run')
    require(torch.equal(counts.cpu(), ref_counts), '23b CCDF counts differ from the plain CPU run')
    window = signal.get_window('hann', SPG_NFFT)
    freqs, times, spg = figures._spectrogram_from_iq(x0, window, Ts, device=dev)
    freqs_cpu, times_cpu, spg_cpu = figures._spectrogram_from_iq(x0_cpu, window, Ts, device='cpu')
    err_spg = rel_rms(spg.cpu(), spg_cpu)
    print(f'23b plot_spectrogram_heatmap_from_iq data: {tuple(spg.shape)} vs the CPU run relative '
          f'RMS {err_spg:.3g}')
    require(np.array_equal(freqs, freqs_cpu) and np.array_equal(times, times_cpu),
            '23b spectrogram axes differ from the CPU run')
    require(err_spg <= 1e-5, f'23b spectrogram relative RMS {err_spg:.3g} > 1e-5')
    power_ms = timed_ms(lambda: figures._averaged_power_dB(x0, Ts, Tavg, False, device=dev))
    ccdf_ms = timed_ms(lambda: it.sample_ccdf(p_dB, bins, density=False, device=dev))
    spg_ms = timed_ms(lambda: figures._spectrogram_from_iq(x0, window, Ts, device=dev))
    print(f'23b averaged power {power_ms:.4f} ms, sample_ccdf {ccdf_ms:.4f} ms, spectrogram '
          f'{spg_ms:.4f} ms on {N_HOST} samples ({smi})')
    host_layer['hist'].update(ccdf={
        'path': f'plot_power_ccdf data: sample_ccdf of {p_dB.numel()} averaged dB values, '
                f'{bins.size} edges', 'launches': ccdf_calls.get('hist', 0), 'ms': ccdf_ms,
        'power_ms': power_ms, 'spectrogram_ms': spg_ms})
    del p_dB, p_cpu, counts, spg, spg_cpu, x0_cpu

    # ---- 23c: fft of a batch whole and under set_max_cupy_fft_chunk
    gen = torch.Generator(device=dev).manual_seed(SEED)
    batch = torch.randn(FFT_BATCH, dtype=torch.complex64, device=dev, generator=gen)
    results, peaks, times_ms = {}, {}, {}
    for bound in (None, FFT_CHUNK):
        it.set_max_cupy_fft_chunk(bound)
        try:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            results[bound] = it.fourier.fft(batch)
            torch.cuda.synchronize()
            peaks[bound] = torch.cuda.max_memory_allocated(dev) - base
            times_ms[bound] = timed_ms(lambda: it.fourier.fft(batch))
        finally:
            it.set_max_cupy_fft_chunk(None)
    err = rel_rms(results[FFT_CHUNK], results[None])
    print(f'23c fft of {FFT_BATCH} complex64: whole {times_ms[None]:.4f} ms, peak '
          f'{peaks[None] / 2**20:.1f} MiB above the input; at {FFT_CHUNK} samples a call '
          f'{times_ms[FFT_CHUNK]:.4f} ms, peak {peaks[FFT_CHUNK] / 2**20:.1f} MiB; relative RMS '
          f'{err:.3g} ({smi})')
    require(err <= 1e-6, f'23c chunked fft relative RMS {err:.3g} > 1e-6')
    host_layer['fused_ola'].update(fft_chunk={
        'shape': list(FFT_BATCH), 'bound': FFT_CHUNK, 'ms': times_ms[None],
        'chunked_ms': times_ms[FFT_CHUNK], 'peak_bytes': peaks[None],
        'chunked_peak_bytes': peaks[FFT_CHUNK]})
    del batch, results

    # ---- 23d: the framing helpers on card tensors of N_HOST samples
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated(dev)
    v = sliding_window_view(x0, N_WINDOW)
    v2 = sliding_window_view(xf, (1, N_WINDOW), axis=(0, 1))
    mem1 = torch.cuda.memory_allocated(dev)
    require(v.data_ptr() == x0.data_ptr() and v.stride() == (1, 1)
            and tuple(v.shape) == (N_HOST - N_WINDOW + 1, N_WINDOW),
            f'23d sliding_window_view: {tuple(v.shape)}, strides {v.stride()}')
    require(v2.data_ptr() == xf.data_ptr() and v2.stride() == (N_HOST, 1, N_HOST, 1)
            and tuple(v2.shape) == (2, N_HOST - N_WINDOW + 1, 1, N_WINDOW),
            f'23d sliding_window_view 2-D: {tuple(v2.shape)}, strides {v2.stride()}')
    require(v._base is xf and v2._base is xf and mem1 <= mem0,
            f'23d sliding_window_view is no view of the capture (device memory {mem0} -> {mem1})')
    host_x0 = x0.cpu().numpy()
    for row in (0, N_HOST // 2 + 7, N_HOST - N_WINDOW):
        require(np.array_equal(v[row].cpu().numpy(), np.lib.stride_tricks.sliding_window_view(
            host_x0, N_WINDOW)[row]), f'23d sliding_window_view row {row}')
    p = x0.real * x0.real + x0.imag * x0.imag
    for kw in (dict(axis=0), dict(axis=0, reject_extrema=True, fft=False)):
        got = binned_mean(p, BINNED_COUNT, **kw)
        err = rel_rms(got.cpu(), binned_mean(p.cpu(), BINNED_COUNT, **kw))
        require(got.device.type == dev.type and err <= 1e-6,
                f'23d binned_mean {kw}: relative RMS {err:.3g} against the CPU')
    xr = x0.reshape(4096, N_HOST // 4096)
    views = list(grouped_views_along_axis(xr, GROUP_MAX, axis=1))
    views_cpu = list(grouped_views_along_axis(xr.cpu(), GROUP_MAX, axis=1))
    require(len(views) == len(views_cpu) > 1
            and all(g.data_ptr() >= xr.data_ptr() and torch.equal(g.cpu(), c)
                    for g, c in zip(views, views_cpu)),
            '23d grouped_views_along_axis differs from the CPU')
    print(f'23d sliding_window_view {tuple(v.shape)} and {tuple(v2.shape)}: views (device '
          f'memory {mem0} -> {mem1} bytes); binned_mean within 1e-6 of the CPU; grouped_views_along_axis '
          f'{len(views)} views of {views[0].numel()} samples equal to the CPU\'s')
    del v, v2, p, views, views_cpu, xf, x0

    # ---- 23e: row 3's split route through ola_filter (131072 -> 16384)
    kw = SPLIT_FILTER_KW
    nfft, nfft_out = kw['nfft'], kw['nfft_out']
    hop = nfft // 2
    frames_k = kernels.fused_ola_frames
    xs = torch.randn(N_SPLIT_FILTER, dtype=torch.complex64, device=dev, generator=gen)
    it.ola_filter(xs[: 4 * nfft], **kw)  # warm-up: first-use setup
    torch.cuda.synchronize()
    reset_counts()
    y = it.ola_filter(xs, **kw)
    torch.cuda.synchronize()
    calls = launched()
    routes = dict(frames_k.route_launches)
    print(f'23e ola_filter {nfft} -> {nfft_out} on {N_SPLIT_FILTER} samples: launches '
          f'{json.dumps(calls)}, frame routes {json.dumps(routes)}')
    require(calls == {'fused_ola_frames': 1}
            and routes == {'reg': 0, 'cluster': 0, 'split': 1, 'plan': 0, 'plan_cluster': 0, 'generic': 0},
            f'23e launches {calls}, routes {routes}')
    plain_y = it.ola_filter(xs, **kw, plain=True)
    chain_y = it.ola_filter(xs, **kw, fft_backend='xla')
    err_plain, err_chain = rel_rms(y, plain_y), rel_rms(y, chain_y)
    print(f'23e vs the plain route relative RMS {err_plain:.3g}, vs the torch.fft stage chain '
          f'{err_chain:.3g}')
    # the output covers the input's whole hops of nfft / 2, as the JAX
    # package's ola_filter gives it (1525 of 1525.875 here)
    require(y.shape == plain_y.shape == chain_y.shape == ((N_SPLIT_FILTER // hop) * nfft_out // 2,)
            and bool(torch.isfinite(torch.view_as_real(y)).all()), f'23e output {tuple(y.shape)}')
    require(err_plain <= 1e-5 and err_chain <= 1e-5,
            f'23e relative RMS {err_plain:.3g} (plain), {err_chain:.3g} (chain) > 1e-5')
    del plain_y, chain_y
    split_calls = device_launches(lambda: it.ola_filter(xs, **kw), SPLIT_KERNELS,
                                  fresh='split_ola_filter')
    print(f'23e device kernels of the split route in one call: {json.dumps(split_calls)}')
    require(all(any(k in n for n in split_calls) for k in SPLIT_KERNELS),
            f'23e the profile shows the split kernels {split_calls}')
    path_ms = timed_ms(lambda: it.ola_filter(xs, **kw), reps=FILTER_REPS, warmup=1)
    plain_path_ms = timed_ms(lambda: it.ola_filter(xs, **kw, plain=True), reps=FILTER_REPS,
                             warmup=1)
    chain_path_ms = timed_ms(lambda: it.ola_filter(xs, **kw, fft_backend='xla'),
                             reps=FILTER_REPS, warmup=1)
    enbw = it.equivalent_noise_bandwidth(kw['window'], nfft_out, fftbins=False)
    zero_lo, zero_hi, b_in, b_out = TF._ola_bin_bounds(nfft, nfft_out, kw['fs'], kw['passband'],
                                                       enbw, True)
    w_in, w_out = TF._ola_windows(kw['window'], nfft, nfft_out, hop, dev)
    fkw = dict(w_in=w_in, w_shift_out=w_out, nfft=nfft, nfft_out=nfft_out, zero_lo=zero_lo,
               zero_hi=zero_hi, bounds_in=b_in, bounds_out=b_out)
    frames = xs.unfold(-1, nfft, hop)
    got_f = frames_k(frames, **fkw)
    ref_f = kernels.fused_ola_frames_plain(frames, **fkw)
    err = rel_rms(got_f, ref_f)
    require(err <= 1e-5, f'23e the split frames vs plain: relative RMS {err:.3g}')
    row = kernel_row(
        SPLIT_FILTER_ROW, {'launches': calls.get('fused_ola_frames', 0),
                           'max_abs_err': max_abs(got_f, ref_f)},
        8 * xs.numel() + 8 * y.numel() + 8 * (nfft + nfft_out),
        frames.shape[0] * (fft_ops(nfft) + fft_ops(nfft_out) + 6 * (nfft + nfft_out)),
        lambda: frames_k(frames, **fkw),
        lambda: kernels.fused_ola_frames_plain(frames, **fkw),
        lambda: kernels.fused_ola_frames_plain(frames, **fkw),
        mem_rate, fp32_rate, reps=FILTER_REPS, warmup=1,
    )
    row.update(path=f'ola_filter {nfft} -> {nfft_out}, hamming, on {N_SPLIT_FILTER} samples '
                    '(the split route)',
               path_ms=path_ms, plain_path_ms=plain_path_ms, chain_path_ms=chain_path_ms,
               split_kernels_a_call=split_calls)
    print(f'23e ola_filter {path_ms:.4f} ms = {N_SPLIT_FILTER / path_ms / 1e3:.1f} MS/s, the plain '
          f'route {plain_path_ms:.4f} ms, the torch.fft stage chain {chain_path_ms:.4f} ms; the '
          f'split frames alone ({frames.shape[0]} frames) {row["ms"]:.4f} ms, bound '
          f'{row["bound_ms"]:.4f} ms by {row["bound_by"]}, plain {row["plain_ms"]:.4f} ms ({smi})')
    del xs, y, frames, got_f, ref_f
    torch.cuda.empty_cache()
    return [row], host_layer


# ---- phase 24: rows 2-3's storage tiers (the frame kernels' plane
# instances) and radix-7 frames
# 24a: each frame kernel at its pair and hop, on (2, n) planes of int16
# counts (their float32 and bfloat16 conversions too) near 2^24 samples:
# (name, nfft, nfft_out, hop, kernel name in the profile); the register
# kernel's second pair rides in its rows; the two-block plan kernel at the
# blackmanharris monitor pair it takes (122.88 -> 32.768 MS/s), the generic
# kernel at an odd size above 16384 points (3^6 5^2), where it still routes
TIER_KERNELS = {
    'frames_reg': (16384, 8192, 8192, 'fused_ola_frames_reg_kernel'),
    'frames_cluster3': (49152, 24576, 16384, CLUSTER_KERNEL),
    'frames_split': (131072, 16384, 65536, 'split_radix_kernel'),
    'frames_plan_cluster': (19200, 5120, 3840, PLAN_CLUSTER_KERNEL),
    'frames_generic': (18225, 6075, 6075, GENERIC_KERNEL),
}
TIER_REG_SECOND = (12288, 6144, 4096)
N_TIER = 1 << 24
# the plane types: the profile's name of each instance's element type, the
# row's suffix, and the bytes of a plane value
PLANE_TYPES = {torch.int16: ('short', 'i16', 2), torch.bfloat16: ('__nv_bfloat16', 'bf16', 2),
               torch.float32: ('float', 'f32', 4)}
TIER_SCALE = 3000.0  # the planes' RMS in counts
# 24c: the blackman monitor of the flagship rates at 'i16' (49152 -> 24576
# on the cluster of 3), step_planes on 2^24 int16 counts
TIER_STEP = dict(CLUSTER_MONITOR)
# 24d: the three designs at 107.52 -> 15.36 MS/s (7:1), 7 x 2^k frames on
# the split route's radix-7 steps: window -> (pair, kernels-line row)
RADIX7_STEPS = {
    'hamming': ((57344, 8192), 'split_radix7_hamming_57344'),
    'blackman': ((172032, 24576), 'split_radix7_blackman_172032'),
    'blackmanharris': ((286720, 40960), 'split_radix7_blackmanharris_286720'),
}
N_RADIX7_F64 = 8  # 24d: frames held against complex128
for _kname, (_n1, _n2, _hop, _kern) in TIER_KERNELS.items():
    for _dt, (_, _sfx, _) in PLANE_TYPES.items():
        KERNEL_INFO[f'{_kname}_{_sfx}'] = (
            'iqwaveform_torch/csrc/' + ('ola_split.cu' if _kname == 'frames_split'
                                        else 'ola_frames.cuh'),
            'iqwaveform_tpu/ops/pallas/fused_ola_pallas.py:492')
for _, _row in RADIX7_STEPS.values():
    KERNEL_INFO[_row] = ('iqwaveform_torch/csrc/ola_split.cu',
                         'iqwaveform_tpu/ops/pallas/fused_ola_pallas.py:492')
del _kname, _n1, _n2, _hop, _kern, _dt, _sfx, _row


def widening_mode(n: int):
    """a dispatch mode whose ``hits`` record every PyTorch op that reads an
    int16 or bfloat16 tensor of at least ``n`` elements and makes a float32
    or complex tensor of it: a dequantized (complex64 or float32) copy of
    the input. The kernels, called through ctypes, are no PyTorch op."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Widening(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            narrow = [a for a in tree_leaves((args, kwargs or {}))
                      if isinstance(a, torch.Tensor) and a.numel() >= n
                      and a.dtype in (torch.int16, torch.bfloat16)]
            wide = [o for o in tree_leaves(out) if isinstance(o, torch.Tensor)
                    and (o.is_complex() or o.dtype in (torch.float32, torch.float64))]
            if narrow and wide:
                self.hits.append(str(func))
            return out

    mode = Widening()
    mode.hits = []
    return mode


def tier_planes(n: int, dtype, gen, dev) -> torch.Tensor:
    """(2, n) planes of integer counts (RMS TIER_SCALE) in ``dtype``."""
    return (TIER_SCALE * torch.randn((2, n), device=dev, generator=gen)).round().to(dtype)


def tier_kwargs(nfft: int, nfft_out: int, gen, dev) -> dict:
    """the frame kernels' arguments: random windows (w_in scaled by 1 /
    (TIER_SCALE nfft)) and the centred trim with a band mask."""
    w = torch.randn(nfft + nfft_out, dtype=torch.complex64, device=dev, generator=gen)
    lo = (nfft - nfft_out) // 2
    return dict(w_in=w[:nfft] / (TIER_SCALE * nfft), w_shift_out=w[nfft:], nfft=nfft,
                nfft_out=nfft_out, zero_lo=lo + nfft_out // 16, zero_hi=lo + nfft_out - nfft_out // 16,
                bounds_in=(lo, lo + nfft_out), bounds_out=(0, nfft_out))


def tier_frames_input(kname: str, dtype, gen, dev) -> tuple:
    """24a's input of one frame kernel: (planes of integer counts in
    ``dtype`` near N_TIER samples, the kernel's arguments, the hop)."""
    nfft, nfft_out, hop, _ = TIER_KERNELS[kname]
    kw = tier_kwargs(nfft, nfft_out, gen, dev)
    n = (N_TIER // hop) * hop + nfft - hop
    return tier_planes(n, dtype, gen, dev), kw, hop


def tier_filter_input(gen, dev) -> torch.Tensor:
    """24b's input: BASELINE #2's N_OLA complex64 samples of integer counts
    (RMS TIER_SCALE)."""
    x = TIER_SCALE * torch.randn(N_OLA, dtype=torch.complex64, device=dev, generator=gen)
    return torch.complex(x.real.round(), x.imag.round())


def tier_step_monitors() -> tuple:
    """24c's monitors: the blackman design of the flagship rates at 'i16'
    (input_scale I16_INPUT_SCALE) and at 'high'."""
    import dataclasses

    import iqwaveform_torch as it

    base = it.design_wideband_monitor(122.88e6, 61.44e6, **TIER_STEP)
    return (it.WidebandMonitor(dataclasses.replace(base, fft_precision='i16',
                                                   input_scale=I16_INPUT_SCALE)),
            it.WidebandMonitor(dataclasses.replace(base, fft_precision='high')))


def radix7_monitor(window: str):
    """24d's monitor at 107.52 -> 15.36 MS/s (min_fft_size=8191)."""
    import iqwaveform_torch as it

    return it.WidebandMonitor(it.design_wideband_monitor(
        107.52e6, 15.36e6, fs_sdr=107.52e6, window=window, min_fft_size=8191))


def tier_trace(name: str, dev, gen) -> tuple:
    """(call, kernels its trace must hold) of phase 24's profiled call
    ``name`` (``trace_call``): 'tier_<24a row>', 'tier_ola_filter_<tier>',
    'tier_step_planes_i16' or 'radix7_<window>'."""
    import iqwaveform_torch as it
    from iqwaveform_torch.ops import kernels

    if name.startswith('radix7_'):
        mon = radix7_monitor(name[len('radix7_'):])
        x, _ = split_step_frames(mon, N_STEP, gen, dev)
        return (lambda: mon.step(x)), SPLIT_KERNELS
    if name == 'tier_step_planes_i16':
        mon, _ = tier_step_monitors()
        m8 = 8 * mon.min_input_multiple()
        counts = tier_planes((N_STEP // m8) * m8, torch.int16, gen, dev)
        return (lambda: mon.step_planes(counts)), (CLUSTER_KERNEL,)
    if name.startswith('tier_ola_filter_'):
        x, tier = tier_filter_input(gen, dev), name[len('tier_ola_filter_'):]
        return (lambda: it.ola_filter(x, fft_precision=tier, **OLA_KW)), (REG_KERNEL,)
    kname, sfx = name[len('tier_'):].rsplit('_', 1)
    dtype = next(d for d, (_, s, _) in PLANE_TYPES.items() if s == sfx)
    planes, kw, hop = tier_frames_input(kname, dtype, gen, dev)
    return (lambda: kernels.fused_ola_frames(planes, hop_in=hop, **kw)), (TIER_KERNELS[kname][3],)


def plane_check(planes, hop: int, kw: dict, label: str) -> tuple:
    """one frame kernel's plane instance on ``planes`` at ``hop``: one launch
    on its element type, within 1e-6 relative RMS of the complex64
    instance on the dequantized frames and within 1e-5 of the plain chain.
    Returns (output, its errors, the complex64 frames)."""
    from iqwaveform_torch.ops import kernels
    from iqwaveform_torch.ops.kernels.fused_ola import dequantize

    frames_k = kernels.fused_ola_frames
    name = str(planes.dtype).split('.')[-1]
    reset_counts()
    got = frames_k(planes, hop_in=hop, **kw)
    torch.cuda.synchronize()
    require(frames_k.launches == 1 and frames_k.layout_launches[name] == 1,
            f'{label}: launches {frames_k.launches}, by type {frames_k.layout_launches}')
    frames = dequantize(planes).unfold(-1, kw['nfft'], hop)
    err_c64 = rel_rms(got, frames_k(frames, **kw))
    plain = kernels.fused_ola_frames_plain(planes, hop_in=hop, **kw)
    err = rel_rms(got, plain)
    require(err_c64 <= 1e-6, f'{label}: vs the complex64 instance relative RMS {err_c64:.3g}')
    require(err <= 1e-5, f'{label}: vs the plain chain relative RMS {err:.3g}')
    return got, {'c64_rel_rms': err_c64, 'plain_rel_rms': err, 'max_abs_err': max_abs(got, plain)}


def tier_phases(dev, smi: str, mem_rate: float, fp32_rate: float) -> list:
    """phase 24; returns the kernels line's rows of the plane instances and
    of the radix-7 split steps."""
    import iqwaveform_torch as it
    from iqwaveform_torch.ops import kernels
    from iqwaveform_torch.ops.kernels.fused_ola import dequantize, frames_route, split_plan, stored

    gen = torch.Generator(device=dev).manual_seed(SEED)
    frames_k = kernels.fused_ola_frames
    kset = {k.__name__: k for k in kernels.KERNELS}
    torch.cuda.reset_peak_memory_stats(dev)
    rows = {}

    # ---- 24a: each frame kernel's plane instances against its complex64
    # instance and its plain version, timed beside the complex64 instance
    # and beside the rounding pass into complex64 plus that instance
    for kname, (nfft, nfft_out, hop, kernel) in TIER_KERNELS.items():
        route = kname[len('frames_'):].rstrip('0123456789')
        require(frames_route(nfft, nfft_out) == route,
                f'24a {kname}: frames_route {frames_route(nfft, nfft_out)}')
        counts, kw, _ = tier_frames_input(kname, torch.int16, gen, dev)
        n = counts.shape[-1]
        c64 = dequantize(counts).unfold(-1, nfft, hop)
        c64_ms = timed_ms(lambda: frames_k(c64, **kw))
        for dtype, (tname, sfx, width) in PLANE_TYPES.items():
            planes = counts.to(dtype)
            label = f'24a {kname} {sfx}'
            got, errs = plane_check(planes, hop, kw, label)
            m = got.shape[-2]
            names, _ = device_kernels(lambda: frames_k(planes, hop_in=hop, **kw), kernel,
                                      fresh=f'tier_{kname}_{sfx}')
            inst = [k for k in names if kernel in k and f'{tname}>' in short_name(k)]
            require(inst, f'{label}: the profile holds no {kernel} instance of {tname}: {names}')
            nbytes = 2 * width * n + 8 * got.numel()
            nops = m * (fft_ops(nfft) + fft_ops(nfft_out) + 6 * (nfft + nfft_out))
            row = kernel_row(
                f'{kname}_{sfx}', {'launches': 1, 'max_abs_err': errs['max_abs_err']},
                nbytes, nops, lambda: frames_k(planes, hop_in=hop, **kw),
                lambda: kernels.fused_ola_frames_plain(planes, hop_in=hop, **kw),
                lambda: kernels.fused_ola_frames_plain(planes, hop_in=hop, **kw),
                mem_rate, fp32_rate)
            row['c64_ms'] = c64_ms
            row['rounding_c64_ms'] = timed_ms(
                lambda: frames_k(dequantize(planes).unfold(-1, nfft, hop), **kw))
            row['pair'] = f'{nfft}->{nfft_out}'
            row['frames'] = m
            row['instance'] = (short_name(inst[0]) if inst else None)
            row.update({k: v for k, v in errs.items() if k != 'max_abs_err'})
            print(f'{label} ({nfft} -> {nfft_out}, {m} frames at hop {hop}, {row["instance"]}): '
                  f'vs complex64 instance {errs["c64_rel_rms"]:.3g}, vs plain '
                  f'{errs["plain_rel_rms"]:.3g}; {row["ms"]:.4f} ms, the complex64 instance '
                  f'{c64_ms:.4f} ms, rounding pass + complex64 instance {row["rounding_c64_ms"]:.4f} '
                  f'ms, plain {row["plain_ms"]:.4f} ms, bound {row["bound_ms"]:.4f} ms by '
                  f'{row["bound_by"]} ({smi})')
            if kname == 'frames_reg':
                n1, n2, h2 = TIER_REG_SECOND
                kw2 = tier_kwargs(n1, n2, gen, dev)
                p2 = tier_planes((N_TIER // h2) * h2 + n1 - h2, dtype, gen, dev)
                got2, errs2 = plane_check(p2, h2, kw2, f'{label} {n1} -> {n2}')
                c2 = dequantize(p2).unfold(-1, n1, h2)
                row['pairs'] = {f'{n1}->{n2}': {
                    **errs2, 'ms': timed_ms(lambda: frames_k(p2, hop_in=h2, **kw2)),
                    'c64_ms': timed_ms(lambda: frames_k(c2, **kw2)),
                    'rounding_c64_ms': timed_ms(
                        lambda: frames_k(dequantize(p2).unfold(-1, n1, h2), **kw2))}}
                print(f'{label} {n1} -> {n2}: ' + json.dumps(row['pairs'][f'{n1}->{n2}']))
                del p2, c2, got2
            rows[row['name']] = row
            del planes, got
        del counts, c64
        torch.cuda.empty_cache()

    # ---- 24b: ola_filter at 'i16' and 'bf16' on BASELINE #2
    nfft, nfft_out = OLA_KW['nfft'], OLA_KW['nfft_out']
    x = tier_filter_input(gen, dev)
    ref_ms = timed_ms(lambda: it.ola_filter(x, **OLA_KW), reps=10)
    for tier, dtype in (('i16', torch.int16), ('bf16', torch.bfloat16)):
        tname, sfx, _ = PLANE_TYPES[dtype]
        label = f'24b ola_filter {tier}'
        it.ola_filter(x[: 4 * nfft], fft_precision=tier, **OLA_KW)
        torch.cuda.synchronize()
        reset_counts()
        y = it.ola_filter(x, fft_precision=tier, **OLA_KW)
        torch.cuda.synchronize()
        launched = {k: c.launches for k, c in kset.items() if c.launches}
        by_type = dict(frames_k.layout_launches)
        require(launched == {'fused_ola_frames': 1} and by_type[str(dtype).split('.')[-1]] == 1,
                f'{label}: launches {launched}, by type {by_type}')
        xs = dequantize(stored(x, tier))
        err_c64 = rel_rms(y, it.ola_filter(xs, **OLA_KW))
        err_plain = rel_rms(y, it.ola_filter(x, fft_precision=tier, plain=True, **OLA_KW))
        err_chain = rel_rms(y, it.ola_filter(x, fft_precision=tier, fft_backend='xla', **OLA_KW))
        require(err_c64 <= 1e-6 and err_plain <= 1e-5 and err_chain <= 1e-5,
                f'{label}: vs complex64 {err_c64:.3g}, plain {err_plain:.3g}, chain '
                f'{err_chain:.3g}')
        names, _ = device_kernels(lambda: it.ola_filter(x, fft_precision=tier, **OLA_KW),
                                  REG_KERNEL, fresh=f'tier_ola_filter_{tier}')
        inst = [k for k in names if REG_KERNEL in k and f'{tname}>' in short_name(k)]
        require(inst and not library_kernels(names),
                f'{label}: the profile holds no {REG_KERNEL} of {tname}, or a library kernel: '
                f'{names}')
        ms = timed_ms(lambda: it.ola_filter(x, fft_precision=tier, **OLA_KW), reps=10)
        entry = {'launches': 1, 'ms': ms, 'highest_ms': ref_ms, 'c64_rel_rms': err_c64,
                 'plain_rel_rms': err_plain, 'chain_rel_rms': err_chain,
                 'instance': (short_name(inst[0]) if inst else None), 'samples': N_OLA}
        rows[f'frames_reg_{sfx}']['ola_filter'] = entry
        print(f'{label} on {N_OLA} samples ({nfft} -> {nfft_out}): one launch of '
              f'{entry["instance"]}; vs complex64 {err_c64:.3g}, plain route {err_plain:.3g}, '
              f'stage chain {err_chain:.3g}; {ms:.4f} ms, at \'highest\' {ref_ms:.4f} ms ({smi})')
        del y, xs
    del x
    torch.cuda.empty_cache()

    # ---- 24c: the blackman 'i16' step_planes on 2^24 int16 counts
    mon, high = tier_step_monitors()
    require(mon.routes['ola'] == 'cluster', f'24c routes {mon.routes}')
    m8 = 8 * mon.min_input_multiple()
    counts = tier_planes((N_STEP // m8) * m8, torch.int16, gen, dev)
    mon.step_planes(counts[:, :m8])
    torch.cuda.synchronize()
    reset_counts()
    with widening_mode(counts.shape[-1]) as mode:
        out = mon.step_planes(counts)
        torch.cuda.synchronize()
    launched = {k: c.launches for k, c in kset.items() if c.launches}
    by_type = dict(frames_k.layout_launches)
    require(launched.get('fused_ola_frames') == 1 and by_type['int16'] == 1
            and frames_k.route_launches['cluster'] == 1,
            f'24c launches {launched}, by type {by_type}, routes {frames_k.route_launches}')
    require(not mode.hits, f'24c: ops that widen the int16 input: {mode.hits}')
    scaled = counts.float() * I16_INPUT_SCALE
    ref = high.step_planes(scaled)
    check_step(out, ref, "24c step_planes 'i16' vs 'high' on the scaled counts")
    names, device_us = device_kernels(lambda: mon.step_planes(counts), CLUSTER_KERNEL,
                                      fresh='tier_step_planes_i16')
    inst = [k for k in names if CLUSTER_KERNEL in k and 'short>' in short_name(k)]
    require(inst and not library_kernels(names),
            f'24c: the profile holds no {CLUSTER_KERNEL} of short, or a library kernel: {names}')
    ms = timed_ms(lambda: mon.step_planes(counts), reps=10)
    high_ms = timed_ms(lambda: high.step_planes(scaled), reps=10)
    busy = sum(device_us.values()) / 1e3
    rows['frames_cluster3_i16']['step_planes'] = {
        'launches': launched, 'ms': ms, 'high_ms': high_ms, 'samples': counts.shape[-1],
        'instance': (short_name(inst[0]) if inst else None), 'widening_ops': mode.hits,
        'device_us': device_us, 'idle_share': max(0.0, 1 - busy / ms)}
    print(f'24c blackman step_planes \'i16\' on {counts.shape[-1]} int16 counts: launches '
          f'{json.dumps(launched)}, {(short_name(inst[0]) if inst else None)}, no op widens the input; within the '
          f'step gates of \'high\'; {ms:.4f} ms, \'high\' on float32 planes {high_ms:.4f} ms; '
          f'device busy {busy:.4f} ms ({smi})')
    print('24c device time by kernel (us): ' + json.dumps(
        dict(sorted(device_us.items(), key=lambda kv: -kv[1]))))
    del mon, high, counts, scaled, out, ref
    torch.cuda.empty_cache()

    # ---- 24d: the three 107.52 -> 15.36 MS/s designs on the split route
    for window, (pair, rname) in RADIX7_STEPS.items():
        mon = radix7_monitor(window)
        label = f'24d {window} 107.52 -> 15.36 MS/s'
        # the hamming design steps through the 2:1 route on the split frames
        add = window == 'hamming'
        require((mon.design.nfft, mon.design.nfft_out) == pair
                and mon.routes['ola'] == ('split+add' if add else 'split'),
                f'{label}: {mon.design.nfft} -> {mon.design.nfft_out}, routes {mon.routes}')
        (c1, m1), (c2, m2) = split_plan(*pair)
        x, frames = split_step_frames(mon, N_STEP, gen, dev)
        mon.step(x[: mon.min_input_multiple()])
        torch.cuda.synchronize()
        reset_counts()
        out = mon.step(x)
        torch.cuda.synchronize()
        launched = {k: c.launches for k, c in kset.items() if c.launches}
        if add:
            require(launched.get('fused_ola') == 1 and launched.get('ola_add') == 1
                    and kernels.fused_ola.route_launches['split+add'] == 1
                    and 'fused_ola_frames' not in launched,
                    f'{label}: launches {launched}, routes {kernels.fused_ola.route_launches}')
        else:
            require(launched.get('fused_ola_frames') == 1 and frames_k.route_launches['split'] == 1,
                    f'{label}: launches {launched}, routes {frames_k.route_launches}')
        check_step(out, mon.reference_step(x), f'{label} vs reference_step')
        kw = {k: v for k, v in mon.ola_kwargs.items() if not k.startswith('noverlap')}
        few = frames[:N_RADIX7_F64]
        got, ref = frames_k(few, **kw), kernels.fused_ola_frames_plain(few, **kw)
        ref64 = kernels.fused_ola_frames_plain(few.to(torch.complex128), **_wide_kw(kw))
        err, err64, plain64 = rel_rms(got, ref), rel_rms(got, ref64), rel_rms(ref, ref64)
        require(err <= 1e-6 and err64 <= 2 * plain64,
                f'{label}: {N_RADIX7_F64} frames vs plain {err:.3g}, vs complex128 {err64:.4g} '
                f'(the plain chain {plain64:.4g})')
        step_ms = timed_ms(lambda: mon.step(x), reps=10)

        def plain_step(mon=mon, x=x):
            return mon._outputs(mon._step_ola(mon._input(x), plain=True), mon._chan, mon._counts)

        plain_ms = timed_ms(plain_step, reps=10)
        names, device_us = device_kernels(lambda: mon.step(x), *SPLIT_KERNELS,
                                          fresh=f'radix7_{window}')
        require(all(any(k in n for n in names) for k in SPLIT_KERNELS)
                and not library_kernels(names),
                f'{label}: the profile lacks a split kernel or holds a library kernel: {names}')
        busy = sum(device_us.values()) / 1e3
        print(f'{label} ({pair[0]} -> {pair[1]}: {c1} x {m1} -> {c2} x {m2}), {x.numel()} '
              f'samples: launches {json.dumps(launched)}; within the step gates of '
              f'reference_step; {N_RADIX7_F64} frames vs plain {err:.3g}, vs complex128 '
              f'{err64:.4g}, the plain chain {plain64:.4g}; {step_ms:.4f} ms, through the plain '
              f'frames {plain_ms:.4f} ms; device busy {busy:.4f} ms (idle share '
              f'{max(0.0, 1 - busy / step_ms):.3f}) ({smi})')
        row = cluster_frame_row(rname, mon, x, launched, device_us, step_ms, mem_rate, fp32_rate,
                                smi, kernels_of=SPLIT_KERNELS,
                                launches=kernels.fused_ola.route_launches['split+add'] if add
                                else None)
        row.update({'path': f'WidebandMonitor.step, {window} 107.52 -> 15.36 MS/s '
                            f'min_fft_size=8191, {pair[0]} -> {pair[1]}',
                    'plan': f'{c1} x {m1} -> {c2} x {m2}', 'plain_frames_path_ms': plain_ms,
                    'idle_share': max(0.0, 1 - busy / step_ms),
                    'few_frames': {'frames': N_RADIX7_F64, 'relative_rms': err,
                                   'f64_rel_rms': err64, 'plain_f64_rel_rms': plain64}})
        rows[rname] = row
        del mon, x, frames, out, few, got, ref, ref64
        torch.cuda.empty_cache()
    print(f'phase 24 peak device memory: {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB')
    return list(rows.values())


# ---- phase 25: rows 4-6 at every shape the JAX kernels take: the
# channelizer's split route (csrc/chan_split.cu on csrc/split_radix.cuh),
# the edge histogram's slices and int64 rows (csrc/hist.cu), the frame
# route's prime radix steps, and the 2:1 step reading its storage tier

# the monitor of the flagship rates at the channelizer designs the split
# route takes: name -> (design arguments, channelizer frame size)
SPLIT_CHAN_DESIGNS = {
    'chan36864': (dict(channel_count=48, fft_size_per_channel=768), 36864),
    'chan11264': (dict(channel_count=22, fft_size_per_channel=512), 11264),
    'chan81920': (dict(channel_count=80, fft_size_per_channel=1024), 81920),
    'chan131072': (dict(channel_count=128, fft_size_per_channel=1024), 131072),
}
SPLIT_CHAN_NAVG = (1, 16)  # each design's steps
SPLIT_ROW_DESIGN = 'chan36864'  # the design whose step gives the kernels-line row
# 25a: the route's modes on CHAN_SIZE_SAMPLES, phase 17a's gates; 2^21
# points at navg 128 (128 parts, tiles of 16: since phase 29 the tiles' run
# partials, folded in the passes kernel's epilogue); 11264 on the one-block
# kernel since phase 29
SPLIT_SIZE_MODES = {'stats': CHAN_SIZE_MODES['stats'], 'channels': CHAN_SIZE_MODES['channels']}
SPLIT_WIDE = (1 << 21, dict(emit_psd=True, emit_pbin=True, navg=128))
SPLIT_CHAN_KERNELS = ('chan_split_step_kernel', 'chan_split_passes_kernel')
# 25c: channelize_power at 48 channels of 576 of 768 bins (36864 points)
CHANNELIZE_SPLIT = (768, 48, 576)
# 25d: APD edges above one block's table, the samples they are timed on,
# and the row of 2^31 samples (8 GiB) with its edges
SLICE_EDGES = (40000, 100000)
N_SLICES = 1 << 24
N_WIDE = 1 << 31
WIDE_PIECE = 1 << 27  # the plain version's pieces on the wide row
WIDE_EDGES = (CCDF_EDGES, 40000)
WIDE_REPS = 3
# 25e: the blackman design at 135.168 -> 24.576 MS/s: 135168 -> 24576 on
# the split route, its radix-11 step through the prime pass
PRIME_RATES = (135.168e6, 24.576e6)
PRIME_MONITOR = dict(bw=10e6, fs_sdr=135.168e6, window='blackman')
PRIME_ROW = 'split_blackman_135168'
# 25f: the flagship 2:1 step at the integer and bfloat16 tiers, before
# (fused_ola on the planes widened to complex64) and after (fused_ola_strided
# on the planes), timed in turns before, after, after, before
TIER_STEP_REPS = 10
STEP_TIERS = {'i16': 'fused_ola_strided_i16', 'bf16': 'fused_ola_strided_bf16'}
KERNEL_INFO.update({
    'chan_stats_split': ('iqwaveform_torch/csrc/chan_split.cu',
                         'iqwaveform_tpu/ops/pallas/chan_stats_pallas.py:301'),
    'chan_stats_split_channels': ('iqwaveform_torch/csrc/chan_split.cu',
                                  'iqwaveform_tpu/ops/pallas/chan_stats_pallas.py:248'),
    'hist_slices': ('iqwaveform_torch/csrc/hist.cu', 'iqwaveform_tpu/ops/pallas/hist_pallas.py:51'),
    PRIME_ROW: ('iqwaveform_torch/csrc/ola_split.cu',
                'iqwaveform_tpu/ops/pallas/fused_ola_pallas.py:492'),
})


def wide_row(dev, gen) -> torch.Tensor:
    """N_WIDE float32 samples of noise power, made on the card in pieces."""
    p = torch.empty(N_WIDE, device=dev)
    for i in range(0, N_WIDE, 1 << 28):
        p[i:i + (1 << 28)] = torch.randn(1 << 28, device=dev, generator=gen).square_()
    return p


def pieces_counts(p, edges) -> torch.Tensor:
    """the plain version's int64 counts of a long row, summed over pieces of
    WIDE_PIECE samples (each below 2^31: its sort fits the card)."""
    from iqwaveform_torch.ops import kernels

    total = None
    for i in range(0, p.numel(), WIDE_PIECE):
        c = kernels.hist_plain(p[i:i + WIDE_PIECE], edges).long()
        total = c if total is None else total + c
    return total


def hist_work(n: int, n_edges: int) -> tuple:
    """the histogram's bound work: each sample read once (4 B), the edges
    read and the counts written once; a binary search of the edges a
    sample."""
    return 4 * n + 4 * n_edges + 8 * (n_edges + 1), n * math.ceil(math.log2(n_edges + 1))


def split_route(n: int, mode: dict) -> str:
    """the split route chan_stats takes at ``n`` points in ``mode`` (since
    phase 29: 'split_block' where the one-block kernel holds it)."""
    from iqwaveform_torch.ops.kernels.chan_stats import block_plan

    return ('split_block' if block_plan(n, mode['emit_psd'], mode['emit_pbin'], mode['navg'])
            else 'split')


def rows46_phases(dev, smi: str, mem_rate: float, fp32_rate: float) -> tuple:
    """phase 25; returns the kernels line's rows of the channelizer's split
    route, the histogram's slices and the frame route's prime step, and the
    2:1 tier steps to attach to phase 18's rows."""
    import iqwaveform_torch as it
    from iqwaveform_torch.ops import kernels, spectral
    from iqwaveform_torch.ops.kernels import _build
    from iqwaveform_torch.ops.kernels.chan_stats import split_shape
    from iqwaveform_torch.ops.kernels.fused_ola import dequantize
    from iqwaveform_torch.ops.kernels.hist import hist_route, slice_edges
    from iqwaveform_torch.parallel import apd_fold

    kset = {k.__name__: k for k in kernels.KERNELS}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats(dev)
    rows = []

    # ---- 25a: the split route at each new size in the monitor's statistics
    # mode and the channel-only mode (phase 17a's gates: 1e-5 of the plain
    # version, CHAN_F64_LIMIT of its complex128 error), and at 2^21 points
    # binned by 128 in the separate bin kernel
    sizes = {}
    checks = [(nb, name, mode) for _, nb in SPLIT_CHAN_DESIGNS.values()
              for name, mode in SPLIT_SIZE_MODES.items()] + [(SPLIT_WIDE[0], 'stats128',
                                                            SPLIT_WIDE[1])]
    for nb, name, mode in checks:
        r = chan_size_check(nb, mode, gen, dev, mem_rate, fp32_rate)
        want = split_route(nb, mode)
        require(r['route'] == want, f'25a chan_stats at {nb} {name}: route {r["route"]}, not {want}')
        r['split_shape'] = list(split_shape(nb))
        sizes.setdefault(str(nb), {})[name] = r
        print(f'25a chan_stats at {nb} ({name}, C x M = {r["split_shape"]}): ' + json.dumps(
            {k: (v if not isinstance(v, dict) else
                 {e: f'{x:.3g}' for e, x in v.items() if 'f64' in e})
             for k, v in r.items() if k not in ('frames', 'max_abs_err', 'bound_by')}) + f' ({smi})')
        torch.cuda.empty_cache()

    # ---- 25b: the monitor at each design, navg 1 and 16, on whole
    # min_input_multiple()s near 2^24 samples: routes, launches, phase 3's
    # gates against reference_step, the step and the plain step timed; the
    # row's design profiled, its channelizer on the step's stream timed
    designs = {}
    for name, (extra, nb) in SPLIT_CHAN_DESIGNS.items():
        for navg in SPLIT_CHAN_NAVG:
            mon = it.WidebandMonitor(it.design_wideband_monitor(
                122.88e6, 61.44e6, **dict(FLAGSHIP, **extra, apd_navg=navg)))
            require(mon.chan_kwargs['nfft_big'] == nb, f'25b {name}: {mon.chan_kwargs["nfft_big"]}')
            want = split_route(nb, dict(emit_psd=True, emit_pbin=True, navg=navg))
            require(mon.routes == {'ola': 'reg', 'chan': want, 'apd': 'bucket'},
                    f'25b {name} navg {navg}: routes {mon.routes}')
            m = mon.min_input_multiple()
            x = torch.randn(max(1, N_STEP // m) * m, dtype=torch.complex64, device=dev,
                            generator=gen)
            mon.step(x[:m])  # warm-up: first-use setup
            torch.cuda.synchronize()
            reset_counts()
            out = mon.step(x)
            torch.cuda.synchronize()
            launched = {k: v.launches for k, v in kset.items() if v.launches}
            routes = dict(kernels.chan_stats.route_launches)
            require(launched == {'fused_ola': 1, 'chan_stats': 1, 'hist': 1},
                    f'25b {name} navg {navg}: launches {launched}')
            require(routes == dict(CHAN_NO_ROUTE, **{want: 1}), f'25b {name}: routes {routes}')
            check_step(out, mon.reference_step(x), f'25b {name} navg {navg} vs reference_step')
            step_ms = timed_ms(lambda: mon.step(x), reps=10)
            plain_ms = timed_ms(lambda: mon.reference_step(x), reps=5, warmup=1)
            key = f'{name}_navg{navg}'
            designs[key] = {'samples': x.numel(), 'launches': launched, 'step_ms': step_ms,
                            'plain_step_ms': plain_ms, 'split_shape': list(split_shape(nb))}
            print(f'25b {key}: launches {json.dumps(launched)}, chan_stats routes '
                  f'{json.dumps(routes)}; within phase 3\'s gates of reference_step; step '
                  f'{step_ms:.4f} ms for {x.numel()} samples = {x.numel() / step_ms / 1e3:.1f} MS/s, '
                  f'the plain step {plain_ms:.4f} ms ({smi})')
            if name == SPLIT_ROW_DESIGN and navg == 16:
                names, device_us = device_kernels(lambda: mon.step(x), *SPLIT_CHAN_KERNELS,
                                                  fresh=f'splitstep_{name}_navg{navg}')
                for k in SPLIT_CHAN_KERNELS:
                    require(any(k in nm for nm in names), f'25b: profiler shows no {k} in the step')
                bad = library_kernels(names)
                require(not bad, f'25b: library kernels in the {key} step: {bad}')
                busy = sum(device_us.values()) / 1e3
                print(f'25b {key} step device time by kernel (us): ' + json.dumps(
                    dict(sorted(device_us.items(), key=lambda kv: -kv[1]))))
                y = kernels.fused_ola(x, **mon.ola_kwargs)
                ckw = mon.chan_kwargs
                cs = kernels.chan_stats(y, **ckw)
                ref = kernels.chan_stats_plain(y, **ckw)
                for k in ref:
                    err = rel_rms(cs[k], ref[k])
                    require(err <= 1e-5, f'25b chan_stats {k} on the {key} stream: {err:.3g}')
                row = kernel_row(
                    'chan_stats_split',
                    {'launches': launched.get('chan_stats', 0),
                     'max_abs_err': max(max_abs(cs[k], ref[k]) for k in ref)},
                    8 * y.numel() + 8 * nb + 4 * sum(v.numel() for v in cs.values()),
                    (y.shape[-1] // nb) * (fft_ops(nb) + 12 * nb),
                    lambda: kernels.chan_stats(y, **ckw),
                    lambda: kernels.chan_stats_plain(y, **ckw),
                    lambda: kernels.chan_stats_plain(y, **ckw),
                    mem_rate, fp32_rate,
                )
                row['profiled_device_ms'] = sum(
                    us for k, us in device_us.items()
                    if 'chan_split' in k or 'chan_fold' in k) / 1e3
                row['path'] = (f'WidebandMonitor.step, 48 x 768 channels ({nb} points, C x M = '
                               f'{split_shape(nb)}), navg 16')
                row['path_ms'] = step_ms
                row['plain_path_ms'] = plain_ms
                row['idle_share'] = max(0.0, 1 - busy / step_ms)
                rows.append(row)
                print(f'chan_stats_split at {nb}: {row["ms"]:.4f} ms (bound {row["bound_ms"]:.4f} '
                      f'ms by {row["bound_by"]}, plain / torch.fft chain {row["plain_ms"]:.4f} ms), '
                      f'{row["profiled_device_ms"]:.4f} ms of device time in the profiled step; '
                      f'step idle share {row["idle_share"]:.3f} ({smi})')
                del y, cs, ref
            del mon, x, out
            torch.cuda.empty_cache()
    rows[-1]['sizes'] = sizes
    rows[-1]['designs'] = designs

    # ---- 25c: channelize_power at 36864 points (BASELINE #4's call at a
    # size outside CHAN_SIZES): one launch of the split route, against the
    # plain version and the CPU port
    per, n_ch, abins = CHANNELIZE_SPLIT
    nperseg = per * n_ch
    iq = torch.randn((CHANNELIZE_FRAMES * 16384 // nperseg) * nperseg, dtype=torch.complex64,
                     device=dev, generator=gen)
    pkw = dict(analysis_bins_per_channel=abins, window='hamming', channel_count=n_ch)
    it.channelize_power(iq, CHANNELIZE_TS, per, **pkw)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    _, _, cp = it.channelize_power(iq, CHANNELIZE_TS, per, **pkw)
    torch.cuda.synchronize()
    launched = {k: v.launches for k, v in kset.items() if v.launches}
    routes = dict(kernels.chan_stats.route_launches)
    require(launched == {'chan_stats': 1} and routes == dict(CHAN_NO_ROUTE, split=1),
            f'25c channelize_power at {nperseg}: launches {launched}, routes {routes}')
    skip = n_ch * (per - abins)
    ckw = dict(nfft_big=nperseg, channel_count=n_ch, skip_bins=skip, emit_psd=False,
               emit_pbin=False, window=spectral._kernel_window('hamming', nperseg, dev))
    cp_ref = kernels.chan_stats_plain(iq, **ckw)['channel_power']
    err = rel_rms(cp, cp_ref)
    short = iq[: 4 * nperseg]
    _, _, cp_cpu = it.channelize_power(short.cpu(), CHANNELIZE_TS, per, device='cpu', **pkw)
    _, _, cp_short = it.channelize_power(short, CHANNELIZE_TS, per, **pkw)
    err_cpu = rel_rms(cp_short.cpu(), cp_cpu)
    print(f'25c channelize_power at {n_ch} x {per} = {nperseg} points on {iq.numel()} samples: '
          f'{tuple(cp.shape)}, kernels {json.dumps(routes)}, vs the plain version relative RMS '
          f'{err:.3g}, vs the CPU port on 4 frames {err_cpu:.3g}')
    require(err <= 1e-5 and err_cpu <= 1e-5, f'25c channelize_power at {nperseg}: {err:.3g}, '
            f'{err_cpu:.3g}')
    n_frames = iq.numel() // nperseg
    row = kernel_row(
        'chan_stats_split_channels',
        {'launches': launched.get('chan_stats', 0), 'max_abs_err': max_abs(cp, cp_ref)},
        8 * iq.numel() + 8 * nperseg + 4 * cp.numel(),
        n_frames * (fft_ops(nperseg) + 6 * nperseg + 2 * (nperseg - skip)),
        lambda: kernels.chan_stats(iq, **ckw),
        lambda: kernels.chan_stats_plain(iq, **ckw),
        lambda: kernels.chan_stats_plain(iq, **ckw),
        mem_rate, fp32_rate,
    )
    row['path'] = f'channelize_power, {n_ch} channels of {abins} of {per} bins ({nperseg} points)'
    row['path_ms'] = timed_ms(lambda: it.channelize_power(iq, CHANNELIZE_TS, per, **pkw))
    print(f'chan_stats_split_channels at {nperseg}: {row["ms"]:.4f} ms (bound {row["bound_ms"]:.4f} '
          f'ms by {row["bound_by"]}, plain / torch.fft chain {row["plain_ms"]:.4f} ms); '
          f'channelize_power {row["path_ms"]:.4f} ms ({smi})')
    rows.append(row)
    del iq, cp, cp_ref, short
    torch.cuda.empty_cache()

    # ---- 25d: the histogram above one block's table: the flagship monitor
    # with 40,000 and 100,000 APD edges (routes, launches, reference_step),
    # the slices timed on its binned stream and on N_SLICES samples; then a
    # row of 2^31 samples: int64 counts through hist, sample_ccdf and
    # apd_fold, exact against the plain version's pieces
    smem = _build.smem_optin(dev)
    slice_runs = {}
    hist_row = None
    for n_edges in SLICE_EDGES:
        mon = it.WidebandMonitor(it.design_wideband_monitor(
            122.88e6, 61.44e6, **dict(FLAGSHIP, apd_bins=n_edges)))
        x = torch.randn(N_STEP, dtype=torch.complex64, device=dev, generator=gen)
        mon.step(x[: mon.min_input_multiple()])
        torch.cuda.synchronize()
        reset_counts()
        out = mon.step(x)
        torch.cuda.synchronize()
        launched = {k: v.launches for k, v in kset.items() if v.launches}
        hroutes = dict(kernels.hist.route_launches)
        require(mon.routes == {'ola': 'reg', 'chan': 'reg', 'apd': 'slices'}
                and launched == {'fused_ola': 1, 'chan_stats': 1, 'hist': 1}
                and hroutes == {'bucket': 0, 'generic': 0, 'slices': 1},
                f'25d {n_edges} edges: routes {mon.routes}, launches {launched}, hist {hroutes}')
        check_step(out, mon.reference_step(x), f'25d {n_edges} APD edges vs reference_step')
        step_ms = timed_ms(lambda: mon.step(x), reps=10)
        p = kernels.chan_stats(kernels.fused_ola(x, **mon.ola_kwargs), **mon.chan_kwargs)['p_binned']
        edges = mon.apd_edges
        got = kernels.hist(p, edges)
        ref = kernels.hist_plain(p, edges)
        require(torch.equal(got, ref), f'25d hist at {n_edges} edges differs from the plain version')
        q = torch.randn(N_SLICES, device=dev, generator=gen).square_()
        got_q, ref_q = kernels.hist(q, edges), kernels.hist_plain(q, edges)
        require(torch.equal(got_q, ref_q), f'25d hist at {n_edges} edges on {N_SLICES} samples')
        run = {'route': hist_route(n_edges, smem), 'slice_edges': slice_edges(n_edges, smem),
               'step_ms': step_ms, 'step_launches': launched,
               'ms_step_stream': timed_ms(lambda: kernels.hist(p, edges)),
               'plain_ms_step_stream': timed_ms(lambda: kernels.hist_plain(p, edges), reps=5),
               f'ms_{N_SLICES}': timed_ms(lambda: kernels.hist(q, edges)),
               f'plain_ms_{N_SLICES}': timed_ms(lambda: kernels.hist_plain(q, edges), reps=5)}
        nbytes, nops = hist_work(N_SLICES, n_edges)
        run[f'bound_ms_{N_SLICES}'] = max(nbytes / mem_rate, nops / fp32_rate) * 1e3
        slice_runs[str(n_edges)] = run
        print(f'25d {n_edges} APD edges: routes {json.dumps(mon.routes)}, launches '
              f'{json.dumps(launched)}, hist {json.dumps(hroutes)}; within phase 3\'s gates; '
              f'equal to the plain version on the step\'s {p.numel()} and on {N_SLICES} samples; '
              + json.dumps(run) + f' ({smi})')
        if hist_row is None:
            nbytes, nops = hist_work(p.numel(), n_edges)
            hist_row = kernel_row(
                'hist_slices', {'launches': launched.get('hist', 0), 'max_abs_err': 0.0}, nbytes, nops,
                lambda: kernels.hist(p, edges), lambda: kernels.hist_plain(p, edges), None,
                mem_rate, fp32_rate,
            )
            hist_row['path'] = f'WidebandMonitor.step, flagship with {n_edges} APD edges'
            hist_row['path_ms'] = step_ms
        del mon, x, out, p, q, got, ref, got_q, ref_q
        torch.cuda.empty_cache()
    hist_row['edges'] = slice_runs

    wide = {}
    p = wide_row(dev, gen)
    for n_edges in WIDE_EDGES:
        edges = torch.logspace(-4, 1.5, n_edges, device=dev)
        reset_counts()
        got = kernels.hist(p, edges)
        torch.cuda.synchronize()
        hroutes = {k: v for k, v in kernels.hist.route_launches.items() if v}
        want = pieces_counts(p, edges)
        require(got.dtype == torch.int64 and torch.equal(got, want) and int(got.sum()) == N_WIDE,
                f'25d hist on {N_WIDE} samples x {n_edges} edges: {got.dtype}, sum {int(got.sum())}')
        ms = timed_ms(lambda: kernels.hist(p, edges), reps=WIDE_REPS, warmup=1)
        nbytes, nops = hist_work(N_WIDE, n_edges)
        wide[str(n_edges)] = {'routes': hroutes, 'dtype': str(got.dtype), 'ms': ms,
                              'bound_ms': max(nbytes / mem_rate, nops / fp32_rate) * 1e3}
        if n_edges == CCDF_EDGES:
            reset_counts()
            ccdf = it.sample_ccdf(p, edges, density=False)
            acc = apd_fold(torch.zeros(n_edges + 1, dtype=torch.int64, device=dev), p, edges=edges)
            torch.cuda.synchronize()
            launched = {k: v.launches for k, v in kset.items() if v.launches}
            require(launched == {'hist': 2}, f'25d sample_ccdf + apd_fold on 2^31: {launched}')
            require(torch.equal(ccdf, (N_WIDE - want.cumsum(0))[:-1]),
                    '25d sample_ccdf on 2^31 samples differs from the plain pieces')
            require(torch.equal(acc, want), '25d apd_fold on 2^31 samples differs')
            wide[str(n_edges)]['sample_ccdf_ms'] = timed_ms(
                lambda: it.sample_ccdf(p, edges, density=False), reps=WIDE_REPS, warmup=1)
            wide[str(n_edges)]['apd_fold_launches'] = launched
        print(f'25d hist on {N_WIDE} samples x {n_edges} edges: ' + json.dumps(wide[str(n_edges)])
              + f'; equal to the plain version\'s pieces of {WIDE_PIECE} ({smi})')
    hist_row['wide_2e31'] = wide
    rows.append(hist_row)
    print(f'hist_slices at {SLICE_EDGES[0]} edges on the step\'s stream: {hist_row["ms"]:.4f} ms '
          f'(bound {hist_row["bound_ms"]:.4f} ms by {hist_row["bound_by"]}, plain (sort) '
          f'{hist_row["plain_ms"]:.4f} ms) ({smi})')
    del p, got, want
    torch.cuda.empty_cache()

    # ---- 25e: the prime split route: the blackman design at 135.168 ->
    # 24.576 MS/s (135168 -> 24576, 11 x 12288) on whole
    # min_input_multiple()s near 2^24 samples
    mon = it.WidebandMonitor(it.design_wideband_monitor(*PRIME_RATES, **PRIME_MONITOR))
    d = mon.design
    require((d.nfft, d.nfft_out) == (135168, 24576) and mon.routes['ola'] == 'split',
            f'25e: {(d.nfft, d.nfft_out)} routes {mon.routes}')
    x, frames = split_step_frames(mon, N_STEP, gen, dev)
    mon.step(x[: mon.min_input_multiple()])
    torch.cuda.synchronize()
    reset_counts()
    out = mon.step(x)
    torch.cuda.synchronize()
    launched = {k: v.launches for k, v in kset.items() if v.launches}
    froutes = dict(kernels.fused_ola_frames.route_launches)
    require(launched.get('fused_ola_frames') == 1 and froutes['split'] == 1,
            f'25e step launches {launched}, frame routes {froutes}')
    check_step(out, mon.reference_step(x), '25e prime split step vs reference_step')
    kw = {k: v for k, v in mon.ola_kwargs.items() if not k.startswith('noverlap')}
    few = frames[:N_F64_FRAMES].contiguous()
    got = kernels.fused_ola_frames(few, **kw)
    ref = kernels.fused_ola_frames_plain(few, **kw)
    ref64 = kernels.fused_ola_frames_plain(few.to(torch.complex128), **_wide_kw(kw))
    err, e64, p64 = rel_rms(got, ref), rel_rms(got, ref64), rel_rms(ref, ref64)
    require(err <= 1e-5 and e64 <= 2 * p64,
            f'25e frames: relative RMS {err:.3g}, complex128 {e64:.3g} vs the chain\'s {p64:.3g}')
    step_ms = timed_ms(lambda: mon.step(x), reps=10)
    row = kernel_row(
        PRIME_ROW, {'launches': launched.get('fused_ola_frames', 0), 'max_abs_err': max_abs(got, ref)},
        8 * frames.shape[0] * (d.nfft + d.nfft_out) + 8 * (d.nfft + d.nfft_out),
        frames.shape[0] * (fft_ops(d.nfft) + fft_ops(d.nfft_out) + 6 * (d.nfft + d.nfft_out)),
        lambda: kernels.fused_ola_frames(frames, **kw),
        lambda: kernels.fused_ola_frames_plain(frames, **kw),
        lambda: kernels.fused_ola_frames_plain(frames, **kw),
        mem_rate, fp32_rate,
    )
    row.update({'f64_rel_rms': e64, 'plain_f64_rel_rms': p64, 'path_ms': step_ms,
                'path': 'WidebandMonitor.step, blackman 135.168 -> 24.576 MS/s (11 x 12288)'})
    rows.append(row)
    print(f'25e {PRIME_ROW}: step launches {json.dumps(launched)}, frame routes '
          f'{json.dumps(froutes)}; frames {row["ms"]:.4f} ms (bound {row["bound_ms"]:.4f} ms by '
          f'{row["bound_by"]}, plain / torch.fft chain {row["plain_ms"]:.4f} ms), complex128 '
          f'{e64:.3g} vs the chain\'s {p64:.3g}; step {step_ms:.4f} ms for {x.numel()} samples '
          f'({smi})')
    del mon, x, frames, out, few, got, ref, ref64
    torch.cuda.empty_cache()

    # ---- 25f: the flagship 2:1 step at 'i16' and 'bf16': one launch of
    # fused_ola_strided on the tier's planes; timed beside the same step with
    # the parent's OLA stage (fused_ola on the planes widened to complex64)
    tiers = {}
    for tier, rname in STEP_TIERS.items():
        mon = it.WidebandMonitor(it.design_wideband_monitor(
            122.88e6, 61.44e6, **dict(FLAGSHIP, fft_precision=tier)))
        x = torch.randn(N_STEP, dtype=torch.complex64, device=dev, generator=gen) * PLANES_SCALE
        mon.step(x[: mon.min_input_multiple()])
        torch.cuda.synchronize()
        reset_counts()
        out = mon.step(x)
        torch.cuda.synchronize()
        launched = {k: v.launches for k, v in kset.items() if v.launches}
        layouts = {k: v for k, v in kernels.fused_ola_strided.layout_launches.items() if v}
        require(launched == {'fused_ola_strided': 1, 'chan_stats': 1, 'hist': 1}
                and layouts == {TIER_LAYOUT[tier]: 1},
                f'25f {tier} step launches {launched}, layouts {layouts}')
        # phase 3's gates hold the psd in dB above -100 dB for unit-power
        # input: the psd of samples scaled by PLANES_SCALE (integer counts
        # at 'i16') is shifted back by the scale's dB on both sides alike
        shift = 20 * math.log10(PLANES_SCALE)
        check_step(*({k: v - shift if k.startswith('psd') else v for k, v in o.items()}
                     for o in (out, mon.reference_step(x))), f'25f {tier} step vs reference_step')
        after = mon._step_ola

        def before(xs, plain=False, mon=mon):
            return kernels.fused_ola(dequantize(mon._stored(xs)), **mon.ola_kwargs)

        times = []
        for stage in (before, after, after, before):
            mon._step_ola = stage
            times.append(timed_ms(lambda: mon.step(x), reps=TIER_STEP_REPS))
        mon._step_ola = after
        tiers[rname] = {'tier': tier, 'launches': launched, 'layouts': layouts,
                        'before_ms': [times[0], times[3]], 'after_ms': [times[1], times[2]],
                        'samples': N_STEP}
        print(f'25f flagship step at {tier}: launches {json.dumps(launched)}, layouts '
              f'{json.dumps(layouts)}; within phase 3\'s gates; ms before (fused_ola on complex64), '
              f'after, after, before: {[round(t, 4) for t in times]} on {N_STEP} samples ({smi})')
        del mon, x, out
        torch.cuda.empty_cache()
    print(f'phase 25 peak device memory: {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB')
    return rows, tiers


# ---- phase 26: rows 1-3 at every monitor design the JAX kernels take: the
# 2:1 route on the frame kernels ('<frame route>+add': a frame kernel reads
# the frames and the halo where they lie, csrc/ola_add.cu overlap-adds) at
# the 21 hamming pairs of the 122.88 MS/s grid the older 2:1 kernels do not
# take, and the split frame route up to 2048 parts at the grid's four
# designs that took the plain frames

ADD_RATES = (61.44e6, 40.96e6, 30.72e6, 24.576e6, 20.48e6, 15.36e6, 7.68e6, 3.84e6)
N_ADD_FRAMES = 8  # 26a: frames a pair, with a halo and the tail
# 26a: the pairs held at the int16 and bfloat16 tiers too, one a frame route
ADD_TIER_PAIRS = ((12288, 4096), (32768, 16384), (20480, 4096), (65536, 16384))
ADD_KERNEL = 'ola_add_kernel'
# 26b: one hamming design a frame route, the kernels-line row of its 2:1
# route: row -> ((output rate, min_fft_size), pair, route, its frame kernels)
ADD_STEPS = {
    'ola_2to1_reg_12288': ((40.96e6, 4095), (12288, 4096), 'reg+add', (REG_KERNEL,)),
    'ola_2to1_cluster_32768': ((61.44e6, 16383), (32768, 16384), 'cluster+add',
                               (CLUSTER_KERNEL,)),
    'ola_2to1_split_20480': ((24.576e6, 4095), (20480, 4096), 'split+add',
                             ('split_radix_kernel', 'split_fwd_passes_kernel')),
    'ola_2to1_split_65536': ((30.72e6, 16383), (65536, 16384), 'split+add',
                             ('split_radix_kernel', 'split_fwd_passes_kernel')),
}
ADD_STREAM_ROW = 'ola_2to1_reg_12288'  # 26c: the design of the stream and sharded_step
N_ADD_STREAM = 16  # 26c: chunks of about 2^24 samples, 2^28 in all
N_ADD_STREAM_CHECK = 8  # 26c: chunks held against one step and reference_step
# 26d: the grid's designs that took the plain frames: row -> ((output rate,
# window, min_fft_size), pair)
WIDE_SPLIT = {
    'split_c80_1310720_81920': ((7.68e6, 'blackmanharris', 16383), (1310720, 81920)),
    'split_c96_1572864': ((3.84e6, 'blackman', 16383), (1572864, 49152)),
    'split_c80_1310720_40960': ((3.84e6, 'blackmanharris', 8191), (1310720, 40960)),
    'split_c160_2621440': ((3.84e6, 'blackmanharris', 16383), (2621440, 81920)),
}
KERNEL_INFO['ola_add'] = ('iqwaveform_torch/csrc/ola_add.cu',
                          'iqwaveform_tpu/ops/pallas/fused_ola_pallas.py:571')
for _name, (_, _, _route, _) in ADD_STEPS.items():
    KERNEL_INFO[_name] = ('iqwaveform_torch/csrc/'
                          + ('ola_split.cu' if _route == 'split+add' else 'ola_frames.cuh'),
                          'iqwaveform_tpu/ops/pallas/fused_ola_pallas.py:571')
for _name in WIDE_SPLIT:
    KERNEL_INFO[_name] = ('iqwaveform_torch/csrc/ola_split.cu',
                          'iqwaveform_tpu/ops/pallas/fused_ola_pallas.py:492')
del _name, _route


def strided_f64(src, halo, kw) -> tuple:
    """the plain 2:1 chain (fused_ola_strided_plain's) on the stored values
    ``src`` and ``halo`` in complex128: (output, tail)."""
    from iqwaveform_torch.ops import kernels
    from iqwaveform_torch.ops.kernels.fused_ola import dequantize, ola_grouped

    wide = _wide_kw({k: v for k, v in kw.items() if k not in ('hop_in', 'precision')})
    return ola_grouped(
        dequantize(src).to(torch.complex128), frames_fn=kernels.fused_ola_frames_plain,
        halo=dequantize(halo).to(torch.complex128), return_tail=True,
        noverlap_in=kw['hop_in'], noverlap_out=kw['nfft_out'] // 2, **wide)


def ola_add_library(frames):
    """the 2:1 overlap-add of (B, F, 2h) complex64 frames by one PyTorch call,
    torch.nn.functional.fold on their real and imaginary planes: (B, (F +
    1) h), the last h samples the tail."""
    b, f, n = frames.shape
    cols = torch.view_as_real(frames).permute(0, 3, 2, 1).reshape(b, 2 * n, f)
    out = torch.nn.functional.fold(cols, output_size=(1, (f + 1) * (n // 2)),
                                   kernel_size=(1, n), stride=(1, n // 2))
    return torch.view_as_complex(out.reshape(b, 2, -1).permute(0, 2, 1).contiguous())


def wide_psd_check(mon, x, out, ref, label: str) -> dict:
    """26d's psd gate: psd_mean and psd_max of the step ``out`` on ``x``
    within phase 3's 0.01 dB of ``ref`` (reference_step) on the bins above
    -100 dB, or, where the float32 plain step is itself that far off, the
    step's error against the same step in complex128 (the plain OLA and
    channelizer on the widened capture) at most twice reference_step's.
    Returns the errors, dB."""
    from iqwaveform_torch.ops import kernels
    from iqwaveform_torch.ops.kernels.fused_ola import ola_grouped

    y = ola_grouped(x.to(torch.complex128), frames_fn=kernels.fused_ola_frames_plain,
                    **_wide_kw(mon.ola_kwargs))
    cs = kernels.chan_stats_plain(y, **_wide_kw(mon.chan_kwargs))
    n = cs['channel_power'].shape[-2]
    ref64 = {'psd_mean': (10.0 / math.log(10.0)) * cs['psd_log_sum'] / n,
             'psd_max': 10.0 * torch.log10(cs['psd_max'] + 1e-25)}
    del y, cs
    errors = {}
    for key in ('psd_mean', 'psd_max'):
        band = ref[key] > -100
        require(int(band.sum()) > 0, f'{label} {key}: no bin above -100 dB')
        err = max_abs(out[key][band], ref[key][band])
        err64 = max_abs(out[key][band], ref64[key][band])
        plain64 = max_abs(ref[key][band], ref64[key][band])
        errors[key] = {'vs_plain': err, 'vs_complex128': err64, 'plain_vs_complex128': plain64}
        require(err <= 0.01 or err64 <= 2 * plain64,
                f'{label} {key}: {err:.4g} dB from reference_step, {err64:.4g} dB from the '
                f'complex128 step (reference_step {plain64:.4g})')
    print(f'{label}: psd max |diff| above -100 dB ' + json.dumps(errors))
    return errors


def add_step_input(mon, gen, dev):
    """whole min_input_multiple()s of noise near N_SPLIT_STEP samples."""
    m = mon.min_input_multiple()
    return torch.randn(max(1, round(N_SPLIT_STEP / m)) * m, dtype=torch.complex64, device=dev,
                       generator=gen)


def add_route_phases(dev, smi: str, mem_rate: float, fp32_rate: float) -> list:
    """phase 26; returns the kernels line's rows of the 2:1 route on the
    frame kernels, of ola_add_kernel and of the split route above 64
    parts."""
    import os

    import torch.distributed as dist

    import iqwaveform_torch as it
    from iqwaveform_torch import parallel
    from iqwaveform_torch.ops import kernels
    from iqwaveform_torch.ops.kernels.fused_ola import (
        _fused_ola_grouped,
        frames_route,
        ola_route,
        split_plan,
        stored,
    )

    kset = {k.__name__: k for k in kernels.KERNELS}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    strided, ola, add = kernels.fused_ola_strided, kernels.fused_ola, kernels.ola_add
    torch.cuda.reset_peak_memory_stats(dev)

    # ---- 26a: the 21 hamming pairs on N_ADD_FRAMES frames with a halo and the
    # tail, against the plain version and complex128; the planes of int16 and
    # bfloat16 at one pair a frame route
    designs = {}
    for fo, m in itertools.product(ADD_RATES, (4095, 8191, 16383)):
        mon = split_design(fo, 'hamming', m)
        if mon.routes['ola'].endswith('+add'):
            designs.setdefault((mon.design.nfft, mon.design.nfft_out), mon)
    require(len(designs) == 21, f'26a: {len(designs)} hamming pairs on a \'+add\' route, not 21')
    pairs = {}
    for pair, mon in sorted(designs.items()):
        route = mon.routes['ola']
        require(route == ola_route(*pair) == frames_route(*pair) + '+add',
                f'26a {pair}: route {route}')
        hop = mon.hop_in
        entry = {'route': route}
        for tier in ('highest',) + (('i16', 'bf16') if pair in ADD_TIER_PAIRS else ()):
            kw = dict(mon.strided_kwargs, precision=tier)
            x = torch.randn((N_ADD_FRAMES + 1) * hop, dtype=torch.complex64, device=dev,
                            generator=gen)
            src, halo = x[:-hop], x[-hop:]
            if tier != 'highest':
                src, halo = (stored(PLANES_SCALE * v, tier) for v in (src, halo))
            reset_counts()
            got, tail = strided(src, halo, n_frames=N_ADD_FRAMES, **kw)
            torch.cuda.synchronize()
            launched = {k: c.launches for k, c in kset.items() if c.launches}
            require(launched == {'fused_ola_strided': 1, 'ola_add': 1}
                    and strided.route_launches == ola_routes(**{route: 1}),
                    f'26a {pair} {tier}: launches {launched}, {strided.route_launches}')
            ref, ref_tail = kernels.fused_ola_strided_plain(src, halo, n_frames=N_ADD_FRAMES, **kw)
            y64, t64 = strided_f64(stored(src, tier), stored(halo, tier), kw)
            both, plain = torch.cat([got, tail]), torch.cat([ref, ref_tail])
            ref64 = torch.cat([y64, t64])
            err, err64, plain64 = rel_rms(both, plain), rel_rms(both, ref64), rel_rms(plain, ref64)
            entry[tier] = {'relative_rms': err, 'f64_rel_rms': err64, 'plain_f64_rel_rms': plain64}
            print(f'26a {pair[0]} -> {pair[1]} {route} at \'{tier}\', {N_ADD_FRAMES} frames, halo '
                  f'and tail: vs plain {err:.3g}; vs complex128 {err64:.4g}, the plain chain '
                  f'{plain64:.4g}')
            require(err <= 1e-5, f'26a {pair} {tier}: relative RMS {err:.3g}')
            require(err64 <= 2 * plain64,
                    f'26a {pair} {tier}: complex128 error {err64:.4g} > 2 x the plain chain\'s '
                    f'{plain64:.4g}')
        pairs[f'{pair[0]}->{pair[1]}'] = entry
    del designs
    torch.cuda.empty_cache()

    # ---- 26b: the monitor step near 2^24 samples at one design a frame
    # route: routes, launches (one of the 2:1 route, no frame wrapper, no
    # torch.cat of the input in the profile), reference_step's gates, times
    # beside the same step through ola_grouped on the same frame kernel
    # (the route before) and through the plain OLA
    rows = []
    add_row = None
    for name, ((fo, m), pair, route, frame_kernels) in ADD_STEPS.items():
        mon = split_design(fo, 'hamming', m)
        d = mon.design
        require((d.nfft, d.nfft_out) == pair and mon.routes['ola'] == route,
                f'26b {name}: {d.nfft} -> {d.nfft_out}, routes {mon.routes}')
        x = add_step_input(mon, gen, dev)
        mon.step(x[: mon.min_input_multiple()])  # warm-up: first-use setup
        torch.cuda.synchronize()
        reset_counts()
        out = mon.step(x)
        torch.cuda.synchronize()
        launched = {k: c.launches for k, c in kset.items() if c.launches}
        ola_launches = dict(ola.route_launches)
        print(f'26b {name} ({x.numel()} samples, {pair[0]} -> {pair[1]}): launches '
              f'{json.dumps(launched)}; fused_ola routes {json.dumps(ola_launches)}')
        require(launched.get('fused_ola') == 1 and launched.get('ola_add') == 1
                and 'fused_ola_frames' not in launched and ola_launches == ola_routes(**{route: 1}),
                f'26b {name}: launches {launched}, {ola_launches}')
        check_step(out, mon.reference_step(x), f'26b {name} vs reference_step')

        def grouped_step(mon=mon, x=x):
            return mon._outputs(_fused_ola_grouped(x, **mon.ola_kwargs), mon._chan, mon._counts)

        def plain_step(mon=mon, x=x):
            return mon._outputs(mon._step_ola(x, plain=True), mon._chan, mon._counts)

        check_step(grouped_step(), out, f'26b {name} through ola_grouped vs the step')
        step_ms = timed_ms(lambda: mon.step(x))
        grouped_ms = timed_ms(grouped_step)
        plain_ms = timed_ms(plain_step)
        names, device_us = device_kernels(lambda: mon.step(x), ADD_KERNEL, *frame_kernels,
                                          fresh=name)
        require(all(any(k in n for n in names) for k in (ADD_KERNEL,) + frame_kernels),
                f'26b {name}: the profile lacks {ADD_KERNEL} or {frame_kernels}: {names}')
        require(not library_kernels(names), f'26b {name}: library kernels {library_kernels(names)}')
        cats = [n for n in names if 'CatArray' in n]
        require(not cats, f'26b {name}: the step concatenates on the card: {cats}')
        copies = {k: us for k, us in device_us.items() if 'copy' in k.lower()}
        g_names, g_us = device_kernels(grouped_step, 'CatArray', *frame_kernels)
        g_cats = {k: us for k, us in g_us.items() if 'CatArray' in k}
        busy = sum(device_us.values()) / 1e3
        route_us = {k: us for k, us in device_us.items()
                    if any(f in k for f in (ADD_KERNEL,) + frame_kernels + SPLIT_KERNELS)}
        print(f'26b {name} device time by kernel (us): ' + json.dumps(
            dict(sorted(device_us.items(), key=lambda kv: -kv[1]))))
        print(f'26b {name}: no CatArray kernel in the step, copy kernels {json.dumps(copies)}; '
              f'through ola_grouped: {json.dumps(g_cats)} of concatenation')
        print(f'26b {name}: {step_ms:.4f} ms for {x.numel()} samples = '
              f'{x.numel() / step_ms / 1e3:.1f} MS/s; through ola_grouped on the same frame kernel '
              f'{grouped_ms:.4f} ms; through the plain OLA {plain_ms:.4f} ms; device busy '
              f'{busy:.4f} ms (idle share {max(0.0, 1 - busy / step_ms):.3f}) ({smi})')

        # the route alone on the step's capture, its row
        okw = mon.ola_kwargs
        y = ola(x, **okw)
        y_plain = kernels.fused_ola_plain(x, **okw)
        err = rel_rms(y, y_plain)
        require(err <= 1e-5, f'26b {name}: fused_ola vs plain relative RMS {err:.3g}')
        n_fr = x.numel() // mon.hop_in
        row = kernel_row(
            name, {'launches': ola_launches[route], 'max_abs_err': max_abs(y, y_plain)},
            8 * x.numel() + 8 * y.numel() + 8 * (d.nfft + d.nfft_out),
            n_fr * (fft_ops(d.nfft) + fft_ops(d.nfft_out) + 6 * (d.nfft + d.nfft_out)),
            lambda: ola(x, **okw), lambda: kernels.fused_ola_plain(x, **okw),
            lambda: kernels.fused_ola_plain(x, **okw), mem_rate, fp32_rate,
        )
        row.update({
            'pair': f'{pair[0]}->{pair[1]}', 'ola_route': route,
            'path': f'WidebandMonitor.step, hamming 122.88 -> {fo / 1e6:g} MS/s min_fft_size={m}',
            'relative_rms': err, 'grouped_ms': timed_ms(lambda: _fused_ola_grouped(x, **okw)),
            'path_ms': step_ms, 'grouped_path_ms': grouped_ms, 'plain_path_ms': plain_ms,
            'profiled_device_ms': sum(route_us.values()) / 1e3,
            'grouped_cat_device_ms': sum(g_cats.values()) / 1e3,
            'copy_device_us': copies, 'idle_share': max(0.0, 1 - busy / step_ms),
            'device_us': device_us,
        })
        print(f'26b {name} route alone: {row["ms"]:.4f} ms (bound {row["bound_ms"]:.4f} ms by '
              f'{row["bound_by"]}); through ola_grouped {row["grouped_ms"]:.4f} ms; plain (torch.fft '
              f'chain) {row["plain_ms"]:.4f} ms; {row["profiled_device_ms"]:.4f} ms of route '
              f'device time in the profiled step ({smi})')
        if route == 'split+add':
            row['pairs'] = pairs
        rows.append(row)

        # ola_add_kernel alone on frames of this step's shape: its row from
        # the register design's step
        if add_row is None:
            frames = torch.randn((1, n_fr, d.nfft_out), dtype=torch.complex64, device=dev,
                                 generator=gen)
            got, tail = add(frames, tail=True)
            ref, ref_tail = kernels.ola_add_plain(frames, tail=True)
            require(torch.equal(got, ref) and torch.equal(tail, ref_tail),
                    f'26b ola_add: differs from ola_add_plain')
            lib = ola_add_library(frames)
            lib_err = rel_rms(torch.cat([got, tail], -1), lib)
            require(lib_err <= 1e-6, f'26b ola_add vs fold: relative RMS {lib_err:.3g}')
            h = d.nfft_out // 2
            add_row = kernel_row(
                'ola_add', {'launches': launched.get('ola_add', 0), 'max_abs_err': 0.0},
                8 * frames.numel() + 8 * (n_fr + 1) * h, 2 * n_fr * h,
                lambda: add(frames, tail=True), lambda: kernels.ola_add_plain(frames, tail=True),
                lambda: ola_add_library(frames), mem_rate, fp32_rate,
            )
            add_row.update({'frames': list(frames.shape), 'path': row['path'],
                            'fold_rel_rms': lib_err,
                            'profiled_device_ms': device_ms(device_us, ADD_KERNEL)})
            print(f'26b ola_add on {tuple(frames.shape)}: equal to ola_add_plain; {add_row["ms"]:.4f} '
                  f'ms (bound {add_row["bound_ms"]:.4f} ms by {add_row["bound_by"]}), plain '
                  f'{add_row["plain_ms"]:.4f} ms, torch.nn.functional.fold '
                  f'{add_row["library_ms"]:.4f} ms ({smi})')
        del mon, x, out, y, y_plain
        torch.cuda.empty_cache()
    rows.append(add_row)

    # ---- 26c: the stream over 2^28 samples and sharded_step on one NCCL
    # rank at 12288 -> 4096, each against its plain path
    (fo, m), pair, route, _ = ADD_STEPS[ADD_STREAM_ROW]
    mon = split_design(fo, 'hamming', m)
    chunk = (STREAM_CHUNK // mon.min_input_multiple()) * mon.min_input_multiple()
    x = torch.randn(N_ADD_STREAM_CHECK * chunk, dtype=torch.complex64, device=dev, generator=gen)
    got, _ = _stream(mon, x.split(chunk))
    worst = check_stream(got, mon.step(x), f'26c stream of {N_ADD_STREAM_CHECK} chunks vs one step')
    check_step(got, mon.reference_step(x), f'26c stream of {N_ADD_STREAM_CHECK} chunks vs '
                                           'reference_step')
    print(f'26c stream of {N_ADD_STREAM_CHECK} x {chunk} samples at {pair[0]} -> {pair[1]}: '
          f'equal apd_counts and max |diff| {json.dumps(worst)} against one step, within '
          f'phase 3\'s gates of reference_step')
    del x, got
    torch.cuda.empty_cache()
    chunks = [torch.randn(chunk, dtype=torch.complex64, device=dev, generator=gen)
              for _ in range(N_ADD_STREAM)]
    _stream(mon, chunks[:2])  # warm up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    stats, n_chunks = _stream(mon, chunks)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    launched = {k: c.launches for k, c in kset.items() if c.launches}
    require(launched.get('fused_ola_strided') == n_chunks and launched.get('ola_add') == n_chunks
            and strided.route_launches == ola_routes(**{route: n_chunks})
            and 'fused_ola_frames' not in launched,
            f'26c stream: launches {launched}, routes {strided.route_launches}')
    n_total = n_chunks * chunk
    require(int(stats['apd_counts'].sum())
            == n_total // mon.hop_in * mon.hop_out // mon.design.apd_navg,
            '26c stream: the APD total differs from its binned samples')
    stream = {'chunks': n_chunks, 'samples': n_total, 's': stream_s, 'launches': launched,
              'ms_per_s': n_total / stream_s / 1e6}
    print(f'26c stream: {n_chunks} chunks, {n_total} samples in {stream_s:.4f} s = '
          f'{n_total / stream_s / 1e6:.1f} MS/s; launches {json.dumps(launched)} ({smi})')
    del chunks, stats
    torch.cuda.empty_cache()

    store = ROOT / 'build' / 'nccl_rank0_store_26'
    store.parent.mkdir(parents=True, exist_ok=True)
    if store.exists():
        store.unlink()
    os.environ.setdefault('NCCL_SOCKET_IFNAME', 'lo')
    torch.cuda.set_device(dev.index or 0)
    dist.init_process_group('nccl', init_method=f'file://{store}', rank=0, world_size=1)
    try:
        mon_s = it.WidebandMonitor(mon.design, mesh=parallel.time_mesh(1))
        xs = add_step_input(mon, gen, dev)[None]
        sharded = sharded_step_check(mon_s, mon, xs, f'26c {ADD_STREAM_ROW}', smi)
        require(sharded['launches'].get('fused_ola_strided') == 1
                and sharded['launches'].get('ola_add') == 1
                and 'fused_ola_frames' not in sharded['launches'],
                f'26c sharded_step launches {sharded["launches"]}')
        check_step(mon_s.sharded_step(xs), mon.reference_step(xs),
                   '26c sharded_step vs reference_step')
    finally:
        dist.destroy_process_group()
    del mon, mon_s, xs
    torch.cuda.empty_cache()
    row = next(r for r in rows if r['name'] == ADD_STREAM_ROW)
    row['stream'] = stream
    row['sharded'] = sharded

    # ---- 26d: the four grid designs that took the plain frames, on the
    # split route's radix steps of 80 to 160 parts
    for name, ((fo, w, m), pair) in WIDE_SPLIT.items():
        mon = split_design(fo, w, m)
        d = mon.design
        require((d.nfft, d.nfft_out) == pair and mon.routes['ola'] == 'split',
                f'26d {name}: {d.nfft} -> {d.nfft_out}, routes {mon.routes}')
        (c1, m1), (c2, m2) = split_plan(*pair)
        x = add_step_input(mon, gen, dev)
        mon.step(x[: mon.min_input_multiple()])
        torch.cuda.synchronize()
        reset_counts()
        out = mon.step(x)
        torch.cuda.synchronize()
        launched = {k: c.launches for k, c in kset.items() if c.launches}
        frame_routes = dict(kernels.fused_ola_frames.route_launches)
        require(launched.get('fused_ola_frames') == 1 and frame_routes['split'] == 1
                and 'fused_ola' not in launched,
                f'26d {name}: launches {launched}, {frame_routes}')
        ref = mon.reference_step(x)
        check_step(out, ref, f'26d {name} vs reference_step', psd=False)
        psd_errors = wide_psd_check(mon, x, out, ref, f'26d {name}')
        del ref
        step_ms = timed_ms(lambda: mon.step(x), reps=10)

        def plain_step(mon=mon, x=x):
            return mon._outputs(mon._step_ola(x, plain=True), mon._chan, mon._counts)

        plain_ms = timed_ms(plain_step, reps=10)
        names, device_us = device_kernels(lambda: mon.step(x), *SPLIT_KERNELS, fresh=name)
        require(all(any(k in n for n in names) for k in SPLIT_KERNELS)
                and not library_kernels(names),
                f'26d {name}: the profile lacks a split kernel or holds a library kernel: {names}')
        busy = sum(device_us.values()) / 1e3
        print(f'26d {name} ({pair[0]} -> {pair[1]}: {c1} x {m1} -> {c2} x {m2}), {x.numel()} '
              f'samples: launches {json.dumps(launched)}; within the step gates of '
              f'reference_step; {step_ms:.4f} ms, through the plain frames {plain_ms:.4f} ms; '
              f'device busy {busy:.4f} ms (idle share {max(0.0, 1 - busy / step_ms):.3f}) ({smi})')
        row = cluster_frame_row(name, mon, x, launched, device_us, step_ms, mem_rate, fp32_rate,
                                smi, kernels_of=SPLIT_KERNELS)
        row.update({'path': f'WidebandMonitor.step, {w} 122.88 -> {fo / 1e6:g} MS/s '
                            f'min_fft_size={m}, {pair[0]} -> {pair[1]}',
                    'plan': f'{c1} x {m1} -> {c2} x {m2}', 'plain_frames_path_ms': plain_ms,
                    'idle_share': max(0.0, 1 - busy / step_ms), 'psd_errors': psd_errors,
                    'split_device_us': {k: v for k, v in device_us.items()
                                        if k.split('<')[0] in SPLIT_KERNELS}})
        rows.append(row)
        del mon, x, out
        torch.cuda.empty_cache()
    print(f'phase 26 peak device memory: {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB')
    return rows


# ---- phase 27: the plan frame kernel of rows 1-3
# (fused_ola_frames_plan_kernel on the run-time plans of csrc/fft_plan.cuh)
# at every one-block pair the generic frame kernel and the radix-2 2:1
# kernel took: 'plan' frames, 'plan+add' at 2:1

PLAN_KERNEL = 'fused_ola_frames_plan_kernel'
# 27a: the monitor pairs that routed to an older body
# (tests/test_torch_ola_plan.py ENUMERATED): the 12 power-of-two 2:1 pairs of
# the radix-2 kernel, the 15 of 'generic+add', the 25 blackman /
# blackmanharris frame pairs of the generic kernel
PLAN_RADIX2 = ((1024, 1024), (2048, 1024), (2048, 2048), (4096, 1024), (4096, 2048),
               (4096, 4096), (8192, 1024), (8192, 2048), (8192, 8192), (16384, 1024),
               (16384, 2048), (16384, 16384))
PLAN_GENERIC_ADD = ((1536, 1024), (3072, 1024), (3072, 2048), (5120, 1024), (6144, 1024),
                    (6144, 2048), (6144, 4096), (10240, 1024), (10240, 2048), (12288, 2048),
                    (12288, 8192), (20480, 2048), (20480, 4096), (24576, 4096), (24576, 16384))
PLAN_R_FRAMES = ((3072, 3072), (5120, 5120), (6144, 3072), (6144, 6144), (7680, 3072),
                 (9216, 3072), (10240, 5120), (10240, 10240), (12288, 3072), (12288, 12288),
                 (12800, 5120), (15360, 3072), (15360, 5120), (15360, 6144), (18432, 3072),
                 (18432, 6144), (19200, 5120), (20480, 5120), (20480, 10240), (20480, 20480),
                 (21504, 3072), (24576, 3072), (24576, 6144), (24576, 24576), (25600, 5120))
N_PLAN_FRAMES = 8  # 27a: frames a pair
# 27a: the pairs held on int16 and bfloat16 planes too, one a size class:
# grouped small frames, one frame a block, the largest frames
PLAN_TIER_PAIRS = ((1024, 1024), (9216, 3072), (16384, 2048))
# 27b: the pairs timed on a step's frames near 2^24 samples, each at its
# design's hop: the radix-2 kernel's 4096 -> 2048 and 16384 -> 1024, grouped
# 1024 -> 1024, 'generic+add''s 6144 -> 2048 (and 20480 -> 4096 and 24576
# -> 4096, which the plan kernel does not hold), the R > 2 frames 9216 ->
# 3072 (and 20480 -> 10240 and 25600 -> 5120, not held), and 16384 -> 8192
# beside its compile-time register instance; a pair the plan kernel does
# not hold gives the row of its generic route
PLAN_TIMED = {(4096, 2048): 2048, (16384, 1024): 8192, (1024, 1024): 512,
              (20480, 4096): 10240, (24576, 4096): 12288, (6144, 2048): 3072,
              (9216, 3072): 3072, (20480, 10240): 4096, (25600, 5120): 5120,
              (16384, 8192): 8192}
N_PLAN_STEP = 1 << 24
PLAN_TRACE_CALLS = 3  # 27b: frame calls in one trace, each a launch of the pair's kernel
# 27c: the monitor designs of the slice: row -> (fs_sdr, output rate,
# window, min_fft_size, pair, route; 9216 -> 3072 on the split route since
# 28e timed it faster than the plan kernel)
PLAN_STEPS = {
    'plan_example_4096': (61.44e6, 30.72e6, 'hamming', 2047, (4096, 2048), 'plan+add'),
    'plan_hamming_6144': (122.88e6, 40.96e6, 'hamming', 2047, (6144, 2048), 'plan+add'),
    'plan_blackman_9216': (122.88e6, 40.96e6, 'blackman', 1023, (9216, 3072), 'split'),
    'plan_blackmanharris_10240': (30.72e6, 15.36e6, 'blackmanharris', 1023, (10240, 5120),
                                  'plan'),
}
N_PLAN_STREAM = 16  # 27d: chunks of about 2^24 samples, 2^28 in all
N_PLAN_STREAM_CHECK = 8  # 27d: chunks held against one step and reference_step
# 27d: ola_filter at a 'plan' pair on BASELINE #2's capture, and at row 3's
# split pair (blackmanharris 1310720 -> 40960, 80 parts, the split route) on the
# largest multiple of its output overlap (32768) at or below BASELINE #2's
# 99,999,744 samples, timed beside its plain route and the stage chain
PLAN_FILTER_KW = dict(OLA_KW, nfft=8192, nfft_out=4096)
SPLIT80_FILTER_KW = dict(fs=122.88e6, nfft=1310720, nfft_out=40960, window='blackmanharris',
                         passband=(-1e6, 1e6))
N_SPLIT80_FILTER = 3051 * 32768
# the summary row is the example design's 2:1 pair, 'plan+add' (row 1)
KERNEL_INFO['fused_ola_frames_plan'] = ('iqwaveform_torch/csrc/ola_frames.cuh',
                                        'iqwaveform_tpu/ops/pallas/fused_ola_pallas.py:571')
for _pair in PLAN_TIMED:
    for _route in ('plan', 'plan_cluster'):
        KERNEL_INFO[f'{_route}_{_pair[0]}_{_pair[1]}'] = (
            'iqwaveform_torch/csrc/ola_frames.cuh', 'iqwaveform_tpu/ops/pallas/fused_ola_pallas.py:'
            + ('571' if _pair in PLAN_RADIX2 + PLAN_GENERIC_ADD else '492'))
del _pair, _route


def plan_spills(report: str, kernel: str = 'plan_kernel') -> dict:
    """ptxas's spills (and registers) of each instance of the plan kernel
    (``kernel`` the end of its name: 'plan_cluster_kernel' for the
    two-block one), by instance; a spill of any inlined pass shows in its
    kernel's line."""
    return kernel_ptxas(report, 'frames_' + kernel)


def named_ms(device_us: dict, kernel: str) -> float:
    """the device milliseconds of every kernel whose name holds ``kernel``
    (any namespace and instance) in a device_kernels breakdown."""
    return sum(us for k, us in device_us.items() if kernel in k) / 1e3


def plan_frames_input(pair, gen, dev) -> tuple:
    """27b's input at ``pair``: (near N_PLAN_STEP samples of noise, their
    frames at the pair's PLAN_TIMED hop, zeros past the end, the frame
    kernels' arguments)."""
    n1, n2 = pair
    hop = PLAN_TIMED[pair]
    kw = tier_kwargs(n1, n2, gen, dev)
    n_fr = N_PLAN_STEP // hop
    x = torch.randn(n_fr * hop, dtype=torch.complex64, device=dev, generator=gen)
    return x, torch.cat([x, x.new_zeros(n1 - hop)]).unfold(-1, n1, hop)[:n_fr], kw


def plan_frames_fn(pair, frames, kw) -> tuple:
    """27b's frame call at ``pair`` and its kernel's name: the plan kernel
    where it holds the pair (at a register pair too), else the two-block
    plan kernel (the route there since phase 28)."""
    from iqwaveform_torch.ops.kernels.fused_ola import (
        _fused_ola_frames_plan,
        _fused_ola_frames_plan_cluster,
        plan_takes,
    )

    if plan_takes(*pair):
        return (lambda: _fused_ola_frames_plan(frames, **kw)), PLAN_KERNEL
    return (lambda: _fused_ola_frames_plan_cluster(frames, **kw)), PLAN_CLUSTER_KERNEL


def plan_frames_trace(name: str, gen, dev) -> tuple:
    """``--trace plan_frames_<nfft>_<nfft_out>``: (PLAN_TRACE_CALLS of 27b's
    frame calls at the pair, its kernel's name)."""
    pair = tuple(int(v) for v in name.removeprefix('plan_frames_').split('_'))
    _, frames, kw = plan_frames_input(pair, gen, dev)
    fn, kernel = plan_frames_fn(pair, frames, kw)
    return (lambda: [fn() for _ in range(PLAN_TRACE_CALLS)]), kernel


def plan_design(name: str, device='cuda'):
    """27c's monitor ``name`` on ``device``."""
    import iqwaveform_torch as it

    fs, fo, w, m, _, _ = PLAN_STEPS[name]
    return it.WidebandMonitor(it.design_wideband_monitor(fs, fo, fs_sdr=fs, window=w,
                                                         min_fft_size=m), device=device)


def plan_step_input(mon, gen, dev):
    """whole min_input_multiple()s of noise near N_PLAN_STEP samples."""
    m = mon.min_input_multiple()
    return torch.randn(max(1, round(N_PLAN_STEP / m)) * m, dtype=torch.complex64, device=dev,
                       generator=gen)


def older_step(mon, x):
    """the step on ``x`` through the older body of its OLA pair (the
    radix-2 kernel, 'generic+add' or the generic frame kernel): the
    yardstick of 27c, never a route."""
    import functools

    from iqwaveform_torch.ops.kernels.fused_ola import (
        _fused_ola_frames_generic,
        _fused_ola_older,
        ola_grouped,
    )

    if mon._strided:
        y = _fused_ola_older(x, **mon.ola_kwargs)
    else:
        y = functools.partial(ola_grouped, frames_fn=_fused_ola_frames_generic)(
            x, **mon.ola_kwargs)
    return mon._outputs(y, mon._chan, mon._counts)


def frame_routes(**counts) -> dict:
    """fused_ola_frames' route counts: ``counts`` and 0 on every other."""
    from iqwaveform_torch.ops import kernels

    return {**dict.fromkeys(kernels.fused_ola_frames.route_launches, 0), **counts}


def plan_phases(dev, smi: str, mem_rate: float, fp32_rate: float) -> list:
    """phase 27; returns the kernels line's rows of the plan kernel: one at
    each pair of 27b, and 'fused_ola_frames_plan' with the launches of 27c's
    four steps and the times of the example design's pair."""
    from iqwaveform_torch.ops import kernels
    from iqwaveform_torch.ops.kernels import _build
    from iqwaveform_torch.ops.kernels.fused_ola import (
        _fused_ola_frames_generic,
        _fused_ola_frames_plan,
        _fused_ola_older,
        _fused_ola_via,
        _radix2_pair,
        frames_route,
        ola_route,
        plan_shape,
        plan_takes,
    )

    kset = {k.__name__: k for k in kernels.KERNELS}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    frames_k, strided = kernels.fused_ola_frames, kernels.fused_ola_strided
    torch.cuda.reset_peak_memory_stats(dev)

    # ptxas: registers and spills of each instance (one an element type);
    # none may spill
    spills = plan_spills(_build.ptxas_report())
    print(f'27 ptxas {PLAN_KERNEL} instances: {json.dumps(spills)}')
    spilled = {k: v for k, v in spills.items() if v['spill_stores'] or v['spill_loads']}
    require(len(spills) == 4 and not spilled,
            f'27: the plan kernel\'s four instances spill or are missing: {spills}')

    # ---- 27a: each enumerated pair on N_PLAN_FRAMES frames against the
    # plain chain and complex128 (forced where the split route takes the
    # pair: 9216 -> 3072, 28e); planes at one pair a size class; the 2:1
    # pairs through 'plan+add' with a halo and the tail
    pairs, not_held = {}, []
    two_to_one = PLAN_RADIX2 + PLAN_GENERIC_ADD
    for pair in two_to_one + PLAN_R_FRAMES:
        n1, n2 = pair
        held = plan_takes(n1, n2)
        route = frames_route(n1, n2)
        require(route in (('plan', 'split') if held else ('plan_cluster', 'split')),
                f'27a {pair}: frames_route {route}')
        if not held:
            not_held.append(f'{n1}->{n2}')
            continue
        call = frames_k if route == 'plan' else _fused_ola_frames_plan
        kw = tier_kwargs(n1, n2, gen, dev)
        hop = n1 // 2 if pair in two_to_one else n1 // 3
        capture = torch.randn(N_PLAN_FRAMES * hop + n1, dtype=torch.complex64, device=dev,
                              generator=gen)
        frames = capture.unfold(-1, n1, hop)[:N_PLAN_FRAMES]
        reset_counts()
        got = call(frames, **kw)
        torch.cuda.synchronize()
        require(frames_k.route_launches == frame_routes(plan=1),
                f'27a {pair}: frame routes {frames_k.route_launches}')
        ref = kernels.fused_ola_frames_plain(frames, **kw)
        ref64 = kernels.fused_ola_frames_plain(frames.to(torch.complex128), **_wide_kw(kw))
        err, err64, plain64 = rel_rms(got, ref), rel_rms(got, ref64), rel_rms(ref, ref64)
        entry = {'shape': list(plan_shape(n1, n2)), 'relative_rms': err, 'f64_rel_rms': err64,
                 'plain_f64_rel_rms': plain64}
        require(err <= 1e-5, f'27a {pair}: relative RMS {err:.3g}')
        require(err64 <= 2 * plain64,
                f'27a {pair}: complex128 error {err64:.4g} > 2 x the plain chain\'s {plain64:.4g}')
        if pair in PLAN_TIER_PAIRS:
            for dtype in (torch.int16, torch.bfloat16):
                planes = (PLANES_SCALE * torch.stack([capture.real, capture.imag])).round().to(dtype)
                reset_counts()
                gp = call(planes, hop_in=hop, **kw)
                rp = kernels.fused_ola_frames_plain(planes, hop_in=hop, **kw)
                e = rel_rms(gp, rp)
                layout = str(dtype).split('.')[-1]
                require(frames_k.route_launches == frame_routes(plan=1)
                        and frames_k.layout_launches[layout] == 1,
                        f'27a {pair} {layout}: {frames_k.route_launches} {frames_k.layout_launches}')
                require(e <= 1e-5, f'27a {pair} {layout} planes: relative RMS {e:.3g}')
                entry[layout] = e
        if pair in two_to_one:
            h = n1 // 2
            skw = dict(hop_in=h, **kw)
            x = torch.randn((N_PLAN_FRAMES + 1) * h, dtype=torch.complex64, device=dev,
                            generator=gen)
            src, halo = x[:-h], x[-h:]
            reset_counts()
            y, tail = strided(src, halo, n_frames=N_PLAN_FRAMES, **skw)
            torch.cuda.synchronize()
            launched = {k: c.launches for k, c in kset.items() if c.launches}
            require(launched == {'fused_ola_strided': 1, 'ola_add': 1}
                    and strided.route_launches == ola_routes(**{'plan+add': 1})
                    and ola_route(n1, n2) == 'plan+add',
                    f'27a {pair} 2:1: launches {launched}, {strided.route_launches}')
            r, rt = kernels.fused_ola_strided_plain(src, halo, n_frames=N_PLAN_FRAMES, **skw)
            y64, t64 = strided_f64(src, halo, dict(skw, precision='highest'))
            both, plain = torch.cat([y, tail]), torch.cat([r, rt])
            ref64 = torch.cat([y64, t64])
            e, e64, p64 = rel_rms(both, plain), rel_rms(both, ref64), rel_rms(plain, ref64)
            require(e <= 1e-5, f'27a {pair} plan+add: relative RMS {e:.3g}')
            require(e64 <= 2 * p64,
                    f'27a {pair} plan+add: complex128 error {e64:.4g} > 2 x the plain\'s {p64:.4g}')
            entry['plan+add'] = {'relative_rms': e, 'f64_rel_rms': e64, 'plain_f64_rel_rms': p64}
        pairs[f'{n1}->{n2}'] = entry
    print('27a the plan kernel at the enumerated pairs (G, F, vs plain, vs complex128): '
          + json.dumps(pairs))
    print(f'27a pairs the plan kernel does not hold (the two-block plan kernel or the split route, '
          f'28a): {not_held}')
    torch.cuda.empty_cache()

    # ---- 27b: each pair of PLAN_TIMED on the frames of a step near 2^24
    # samples: the route beside its older body, the plain version and the
    # torch.fft chain, with its bound
    rows = []
    for (n1, n2), hop in PLAN_TIMED.items():
        pair = (n1, n2)
        held = plan_takes(*pair)
        name = f'{"plan" if held else "plan_cluster"}_{n1}_{n2}'
        x, fr, kw = plan_frames_input(pair, gen, dev)
        n_fr = fr.shape[0]
        route = frames_route(*pair)
        frames_fn, kernel = plan_frames_fn(pair, fr, kw)
        generic_fn = lambda fr=fr, kw=kw: _fused_ola_frames_generic(fr, **kw)  # noqa: E731
        plain_fn = lambda fr=fr, kw=kw: kernels.fused_ola_frames_plain(fr, **kw)  # noqa: E731
        entry = {'pair': f'{n1}->{n2}', 'hop': hop, 'frames': n_fr, 'frames_route': route,
                 'plan_shape': None if not held else list(plan_shape(*pair))}
        # each input read once (the samples, both windows), each output
        # written once: the 2:1 route's overlap-added signal, else the frames
        windows = 8 * (n1 + n2)
        nops = n_fr * (fft_ops(n1) + fft_ops(n2) + 6 * (n1 + n2))
        if pair in two_to_one:
            # a pair the older 2:1 bodies took: the 2:1 route of the row's
            # plan kernel (the pair's route but where the split route takes
            # it, 28e)
            okw = dict(kw, noverlap_in=hop, noverlap_out=n2 // 2)
            route = ('plan' if held else 'plan_cluster') + '+add'
            add_fn = lambda x=x, okw=okw, r=route: _fused_ola_via(x, r, **okw)  # noqa: E731
            reset_counts()
            y = add_fn()
            torch.cuda.synchronize()
            launches = kernels.fused_ola.route_launches[route]
            y_plain = kernels.fused_ola_plain(x, **okw)
            err = rel_rms(y, y_plain)
            require(err <= 1e-5, f'27b {pair}: fused_ola vs plain relative RMS {err:.3g}')
            row = kernel_row(name, {'launches': launches, 'max_abs_err': max_abs(y, y_plain)},
                             8 * (x.numel() + y.numel()) + windows, nops, add_fn,
                             lambda: kernels.fused_ola_plain(x, **okw),
                             lambda: kernels.fused_ola_plain(x, **okw), mem_rate, fp32_rate)
            row['route_of_pair'] = ola_route(*pair)
            row['generic_ms'] = timed_ms(lambda: _fused_ola_older(x, **okw))
            row['older_route'] = 'generic' if _radix2_pair(n1, n2) else 'generic+add'
            row['ola_route'] = route
            del y, y_plain
        else:
            # the pair's kernel (the plan kernel at a register pair too:
            # its row times the plan, the register instance apart)
            reset_counts()
            got = frames_fn()
            torch.cuda.synchronize()
            launches = frames_k.route_launches['plan' if held else 'plan_cluster']
            ref = kernels.fused_ola_frames_plain(fr, **kw)
            err = rel_rms(got, ref)
            require(err <= 1e-5, f'27b {pair}: relative RMS {err:.3g}')
            row = kernel_row(name, {'launches': launches, 'max_abs_err': max_abs(got, ref)},
                             8 * (x.numel() + got.numel()) + windows, nops, frames_fn, plain_fn,
                             plain_fn, mem_rate, fp32_rate)
            row['generic_ms'] = timed_ms(generic_fn)
            row['older_route'] = 'generic'
            del got, ref
        row.update(entry)
        row['relative_rms'] = err
        # the frame kernels alone on the same frames; the pair's kernel by
        # CUDA events a call and over PLAN_TRACE_CALLS calls back to back
        # (launch gaps hidden), and its device time in one trace of as many
        # calls, every device kernel of the trace printed
        row['plan_frames_ms'] = timed_ms(frames_fn) if held else None
        row['generic_frames_ms'] = timed_ms(generic_fn)
        if route == 'reg':
            row['reg_frames_ms'] = timed_ms(lambda: frames_k(fr, **kw))
        calls = lambda: [frames_fn() for _ in range(PLAN_TRACE_CALLS)]  # noqa: E731
        row['back_to_back_ms'] = timed_ms(calls) / PLAN_TRACE_CALLS
        counts = {}
        _, device_us = device_kernels(calls, kernel, fresh=f'plan_frames_{n1}_{n2}',
                                      counts=counts)
        traced = sum(c for k, c in counts.items() if kernel in k)
        row['profiled_device_ms'] = (named_ms(device_us, kernel) / traced
                                     if traced == PLAN_TRACE_CALLS else None)
        row['trace'] = {'kernel_events': traced, 'device_us': device_us}
        prof = row['profiled_device_ms']
        print(f'27b {n1} -> {n2} ({n_fr} frames at hop {hop}, route {row.get("ola_route", route)}, '
              f'plan {entry["plan_shape"]}): {row["ms"]:.4f} ms (bound {row["bound_ms"]:.4f} ms by '
              f'{row["bound_by"]}); older body {row["older_route"]} {row["generic_ms"]:.4f} ms; '
              f'plain / torch.fft chain {row["plain_ms"]:.4f} ms; frames alone: plan '
              f'{row["plan_frames_ms"]}, generic {row["generic_frames_ms"]:.4f}'
              + (f', register instance {row["reg_frames_ms"]:.4f}' if 'reg_frames_ms' in row else '')
              + f' ms; {kernel} back to back {row["back_to_back_ms"]:.4f} ms a call, profiled '
              + (f'{prof:.4f} ms a launch' if prof is not None else 'not measured')
              + f' ({traced} of {PLAN_TRACE_CALLS} launches in the trace; device us '
              f'{json.dumps(device_us)}) ({smi})')
        rows.append(row)
        del x, fr
        torch.cuda.empty_cache()

    # ---- 27c: the monitor steps near 2^24 samples at the four designs:
    # routes, launches (the plan route once a step; no generic frame kernel
    # and no radix-2 2:1 kernel in the profile), reference_step's gates,
    # times beside the same step through the older body
    steps, plan_launches = {}, 0
    for sname, (fs, fo, w, m, pair, route) in PLAN_STEPS.items():
        mon = plan_design(sname)
        d = mon.design
        require((d.nfft, d.nfft_out) == pair and mon.routes['ola'] == route,
                f'27c {sname}: {d.nfft} -> {d.nfft_out}, routes {mon.routes}')
        x = plan_step_input(mon, gen, dev)
        mon.step(x[: mon.min_input_multiple()])
        torch.cuda.synchronize()
        reset_counts()
        out = mon.step(x)
        torch.cuda.synchronize()
        launched = {k: c.launches for k, c in kset.items() if c.launches}
        if route == 'plan+add':
            ok = (launched.get('fused_ola') == 1 and launched.get('ola_add') == 1
                  and 'fused_ola_frames' not in launched
                  and kernels.fused_ola.route_launches == ola_routes(**{route: 1}))
        else:
            ok = (launched.get('fused_ola_frames') == 1 and 'fused_ola' not in launched
                  and frames_k.route_launches == frame_routes(**{route: 1}))
        require(ok, f'27c {sname}: launches {launched}, fused_ola {kernels.fused_ola.route_launches}, '
                    f'frames {frames_k.route_launches}')
        plan_launches += (kernels.fused_ola.route_launches.get('plan+add', 0)
                          + frames_k.route_launches.get('plan', 0))
        check_step(out, mon.reference_step(x), f'27c {sname} vs reference_step')
        check_step(older_step(mon, x), out, f'27c {sname} through the older body vs the step')
        step_ms = timed_ms(lambda: mon.step(x), reps=10)
        older_ms = timed_ms(lambda: older_step(mon, x), reps=10)
        kernel = route_kernel(route)
        names, device_us = device_kernels(lambda: mon.step(x), kernel, fresh=sname)
        require(any(kernel in n for n in names),
                f'27c {sname}: the profile lacks {kernel}: {names}')
        old = [n for n in names if short_name(n) in (GENERIC_KERNEL, OLA_GENERIC_KERNEL)
               or GENERIC_KERNEL + '<' in n or OLA_GENERIC_KERNEL + '<' in n]
        require(not old and not library_kernels(names),
                f'27c {sname}: older or library kernels in the step: {old} {library_kernels(names)}')
        busy = sum(device_us.values()) / 1e3
        steps[sname] = {'pair': f'{pair[0]}->{pair[1]}', 'route': route, 'samples': x.numel(),
                        'step_ms': step_ms, 'older_step_ms': older_ms, 'launches': launched,
                        'plan_device_ms': named_ms(device_us, kernel),
                        'idle_share': max(0.0, 1 - busy / step_ms), 'device_us': device_us}
        print(f'27c {sname} ({fs / 1e6:g} -> {fo / 1e6:g} MS/s {w} min_fft_size={m}, {pair[0]} -> '
              f'{pair[1]}, {x.numel()} samples): launches {json.dumps(launched)}; within the step '
              f'gates of reference_step; {step_ms:.4f} ms, through the older body {older_ms:.4f} '
              f'ms; {kernel} {steps[sname]["plan_device_ms"]:.4f} ms of device time; idle '
              f'share {steps[sname]["idle_share"]:.3f} ({smi})')
        del mon, x, out
        torch.cuda.empty_cache()

    # ---- 27d: the stream over 2^28 samples at the example design against
    # one step and reference_step; ola_filter at a 'plan' pair on BASELINE
    # #2's capture against its plain route
    mon = plan_design('plan_example_4096')
    chunk = (STREAM_CHUNK // mon.min_input_multiple()) * mon.min_input_multiple()
    x = torch.randn(N_PLAN_STREAM_CHECK * chunk, dtype=torch.complex64, device=dev, generator=gen)
    got, _ = _stream(mon, x.split(chunk))
    worst = check_stream(got, mon.step(x), f'27d stream of {N_PLAN_STREAM_CHECK} chunks vs one step')
    check_step(got, mon.reference_step(x),
               f'27d stream of {N_PLAN_STREAM_CHECK} chunks vs reference_step')
    del x, got
    torch.cuda.empty_cache()
    chunks = [torch.randn(chunk, dtype=torch.complex64, device=dev, generator=gen)
              for _ in range(N_PLAN_STREAM)]
    _stream(mon, chunks[:2])
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    stats, n_chunks = _stream(mon, chunks)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    launched = {k: c.launches for k, c in kset.items() if c.launches}
    require(launched.get('fused_ola_strided') == n_chunks
            and strided.route_launches == ola_routes(**{'plan+add': n_chunks})
            and 'fused_ola_frames' not in launched,
            f'27d stream: launches {launched}, routes {strided.route_launches}')
    stream = {'chunks': n_chunks, 'samples': n_chunks * chunk, 's': stream_s,
              'ms_per_s': n_chunks * chunk / stream_s / 1e6, 'vs_one_step': worst,
              'launches': launched}
    print(f'27d stream at the example design: {n_chunks} x {chunk} samples in {stream_s:.4f} s = '
          f'{stream["ms_per_s"]:.1f} MS/s; launches {json.dumps(launched)}; against one step '
          f'{json.dumps(worst)} ({smi})')
    del chunks, stats, mon
    torch.cuda.empty_cache()

    import iqwaveform_torch as it

    nf, nfo = PLAN_FILTER_KW['nfft'], PLAN_FILTER_KW['nfft_out']
    require(frames_route(nf, nfo) == 'plan', f'27d ola_filter: frames_route {frames_route(nf, nfo)}')
    x = torch.randn(N_OLA, dtype=torch.complex64, device=dev, generator=gen)
    it.ola_filter(x[: 4 * nf], **PLAN_FILTER_KW)
    torch.cuda.synchronize()
    reset_counts()
    y = it.ola_filter(x, **PLAN_FILTER_KW)
    torch.cuda.synchronize()
    launched = {k: c.launches for k, c in kset.items() if c.launches}
    require(launched == {'fused_ola_frames': 1} and frames_k.route_launches == frame_routes(plan=1),
            f'27d ola_filter launches {launched}, {frames_k.route_launches}')
    ref = it.ola_filter(x, **PLAN_FILTER_KW, plain=True)
    err = rel_rms(y, ref)
    require(err <= 1e-5, f'27d ola_filter {nf} -> {nfo}: relative RMS {err:.3g}')
    filt = {'pair': f'{nf}->{nfo}', 'samples': N_OLA, 'relative_rms': err,
            'ms': timed_ms(lambda: it.ola_filter(x, **PLAN_FILTER_KW), reps=FILTER_REPS),
            'plain_ms': timed_ms(lambda: it.ola_filter(x, **PLAN_FILTER_KW, plain=True),
                                 reps=FILTER_REPS)}
    print(f'27d ola_filter {nf} -> {nfo} on {N_OLA} samples: one plan launch, vs its plain route '
          f'{err:.3g}; {filt["ms"]:.4f} ms, plain route {filt["plain_ms"]:.4f} ms ({smi})')
    del x, y, ref
    torch.cuda.empty_cache()

    kw80 = SPLIT80_FILTER_KW
    n1, n2 = kw80['nfft'], kw80['nfft_out']
    require(frames_route(n1, n2) == 'split', f'27d ola_filter: frames_route {frames_route(n1, n2)}')
    x = torch.randn(N_SPLIT80_FILTER, dtype=torch.complex64, device=dev, generator=gen)
    it.ola_filter(x[: 4 * n1], **kw80)
    torch.cuda.synchronize()
    reset_counts()
    y = it.ola_filter(x, **kw80)
    torch.cuda.synchronize()
    launched = {k: c.launches for k, c in kset.items() if c.launches}
    require(launched == {'fused_ola_frames': 1} and frames_k.route_launches == frame_routes(split=1),
            f'27d ola_filter at {n1} -> {n2}: launches {launched}, {frames_k.route_launches}')
    ref = it.ola_filter(x, **kw80, plain=True)
    err = rel_rms(y, ref)
    require(err <= 1e-5, f'27d ola_filter {n1} -> {n2}: relative RMS {err:.3g}')
    n_fr = N_SPLIT80_FILTER // (n1 // 5)
    t_bytes = 8 * (x.numel() + y.numel()) / mem_rate * 1e3
    t_ops = n_fr * (fft_ops(n1) + fft_ops(n2) + 6 * (n1 + n2)) / fp32_rate * 1e3
    split80 = {'pair': f'{n1}->{n2}', 'samples': N_SPLIT80_FILTER, 'frames': n_fr,
               'relative_rms': err, 'max_abs_err': max_abs(y, ref),
               'ms': timed_ms(lambda: it.ola_filter(x, **kw80), reps=FILTER_REPS),
               'plain_ms': timed_ms(lambda: it.ola_filter(x, **kw80, plain=True),
                                    reps=FILTER_REPS),
               'chain_ms': timed_ms(lambda: it.ola_filter(x, **kw80, fft_backend='xla'),
                                    reps=FILTER_REPS),
               'bound_ms': max(t_bytes, t_ops), 'bound_by': 'bytes' if t_bytes >= t_ops
               else 'operations'}
    print(f'27d ola_filter {n1} -> {n2} (split, 80 parts) on {N_SPLIT80_FILTER} samples: one '
          f'split launch, vs its plain route {err:.3g}; {split80["ms"]:.4f} ms (bound '
          f'{split80["bound_ms"]:.4f} ms by {split80["bound_by"]}), plain route '
          f'{split80["plain_ms"]:.4f} ms, stage chain (torch.fft) {split80["chain_ms"]:.4f} ms '
          f'({smi})')
    del x, y, ref
    torch.cuda.empty_cache()

    # the kernel's row: the example design's 2:1 pair (27b's 'plan+add',
    # its ms the route's: the plan kernel and ola_add_kernel), the plan
    # route's counted launches in 27c's four steps
    main = dict(next(r for r in rows if r['pair'] == '4096->2048'))
    main.update(name='fused_ola_frames_plan', source=KERNEL_INFO['fused_ola_frames_plan'][0],
                replaces=KERNEL_INFO['fused_ola_frames_plan'][1], launches=plan_launches,
                steps=steps, stream=stream, ola_filter=filt, pairs=pairs, not_held=not_held,
                ptxas=spills, split_ola_filter_1310720=split80)
    rows.append(main)
    print(f'phase 27 peak device memory: {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB')
    return rows



# ---- phase 28: the two-block plan frame kernel of rows 1-3
# (fused_ola_frames_plan_cluster_kernel: one frame on a cluster of two
# blocks, each on the run-time plan passes of csrc/fft_plan.cuh) at the
# one-block pairs the plan kernel does not hold: 'plan_cluster' frames,
# 'plan_cluster+add' at 2:1

# 28a: the pairs the one-block plan kernel does not hold
# (tests/test_torch_ola_plan.py NOT_HELD): the 15 of 27a's 52 above 16384
# points and five more monitor pairs of 25600-28672 points
PC_PAIRS = tuple(p for p in PLAN_RADIX2 + PLAN_GENERIC_ADD + PLAN_R_FRAMES if max(p) > 16384) + (
    (25600, 1024), (27648, 3072), (28672, 1024), (28672, 2048), (28672, 4096))
# 28a: the pairs of 8193-16384 points both plan kernels hold, which the
# two-block kernel does not take (28b times both there; 9216 -> 3072 takes
# the split route, 28e), the two-block kernel forced
PC_CLASS_PAIRS = ((9216, 3072), (16384, 1024))
# 28a: planes of int16, bfloat16 and float32 at one pair a size class:
# blocks of 256 threads (halves up to 8192 points), of 512, the largest frames
PC_TIER_PAIRS = ((9216, 3072), (20480, 10240), (28672, 4096))
# 28a: the 2:1 route with a halo and the tail (the pair's own, 'split+add'
# at the first two since 28e, 'plan_cluster+add' at the others)
PC_ADD_PAIRS = ((20480, 4096), (24576, 16384), (19200, 5120), (24576, 24576))
# 28b: the pairs timed on a step's frames near 2^24 samples, each at its
# design's hop (20480 -> 10240 blackmanharris at 122.88 -> 61.44 MS/s,
# 25600 -> 5120 blackmanharris at 122.88 -> 24.576, the hamming 2:1 pairs
# at 122.88 -> 24.576 and 20.48 MS/s, blackman 9216 -> 3072, 16384 -> 1024,
# and the three monitor pairs the two-block kernel takes: blackmanharris
# 19200 -> 5120 at 122.88 -> 32.768 MS/s at 1023, the unresampled
# blackmanharris 20480 -> 20480 at 4095 and blackman 24576 -> 24576 at 8191)
PC_TIMED = {(25600, 5120): 5120, (20480, 10240): 4096, (20480, 4096): 10240,
            (24576, 4096): 12288, (9216, 3072): 3072, (16384, 1024): 8192,
            (19200, 5120): 3840, (20480, 20480): 4096, (24576, 24576): 8192}
PC_TURNS = 2  # 28b and 28e: turns of each comparison, in the order A B B A
# 28c: the monitor steps near 2^24 samples: row -> (fs_sdr, output rate,
# window, min_fft_size, pair)
PC_STEPS = {
    'plan_cluster_blackmanharris_20480': (122.88e6, 61.44e6, 'blackmanharris', 2047,
                                          (20480, 10240)),
    'plan_cluster_blackmanharris_25600': (122.88e6, 24.576e6, 'blackmanharris', 1023,
                                          (25600, 5120)),
    'plan_cluster_hamming_20480': (122.88e6, 24.576e6, 'hamming', 4095, (20480, 4096)),
    'plan_blackman_9216': PLAN_STEPS['plan_blackman_9216'][:5],
    'plan_cluster_blackmanharris_19200': (122.88e6, 32.768e6, 'blackmanharris', 1023,
                                          (19200, 5120)),
}
# 28e: the monitor pairs of 27a / 28a above 8192 points (those with a
# split shape; none is a compiled pair): the split route beside the plan
# kernel that holds the pair, on a step's frames near 2^24 samples at the
# pair's PC_TIMED hop (else half the frame at 2:1, a third otherwise),
# frames alone and at 2:1 the '+add' routes, in turns
PC_SPLIT_PAIRS = tuple(p for p in PLAN_RADIX2 + PLAN_GENERIC_ADD + PLAN_R_FRAMES + PC_PAIRS[-5:]
                       if max(p) > 8192)
# the summary row is the blackmanharris 19200 -> 5120 frames (row 2)
KERNEL_INFO['fused_ola_frames_plan_cluster'] = (
    'iqwaveform_torch/csrc/ola_frames.cuh', 'iqwaveform_tpu/ops/pallas/fused_ola_pallas.py:492')
for _pair in PC_TIMED:
    KERNEL_INFO[f'plan_cluster_{_pair[0]}_{_pair[1]}'] = (
        'iqwaveform_torch/csrc/ola_frames.cuh', 'iqwaveform_tpu/ops/pallas/fused_ola_pallas.py:'
        + ('571' if _pair in PLAN_RADIX2 + PLAN_GENERIC_ADD else '492'))
del _pair


def route_kernel(route: str) -> str:
    """the device kernel of a frame route ('plan', 'plan_cluster' or
    'split', or any with '+add'; the split route's radix step)."""
    if route.startswith('split'):
        return 'split_radix_kernel'
    return PLAN_CLUSTER_KERNEL if route.startswith('plan_cluster') else PLAN_KERNEL


def pc_design(name: str, device='cuda'):
    """28c's monitor ``name`` on ``device``."""
    import iqwaveform_torch as it

    fs, fo, w, m, _ = PC_STEPS[name]
    return it.WidebandMonitor(it.design_wideband_monitor(fs, fo, fs_sdr=fs, window=w,
                                                         min_fft_size=m), device=device)


def pc_frames_input(pair, gen, dev) -> tuple:
    """28b's input at ``pair``: (near N_PLAN_STEP samples of noise, their
    frames at the pair's PC_TIMED hop, zeros past the end, the frame
    kernels' arguments)."""
    n1, n2 = pair
    hop = PC_TIMED[pair]
    kw = tier_kwargs(n1, n2, gen, dev)
    n_fr = N_PLAN_STEP // hop
    x = torch.randn(n_fr * hop, dtype=torch.complex64, device=dev, generator=gen)
    return x, torch.cat([x, x.new_zeros(n1 - hop)]).unfold(-1, n1, hop)[:n_fr], kw


def split_beside_plans(dev, smi: str) -> dict:
    """28e: at each pair of PC_SPLIT_PAIRS with a split shape, on a step's
    frames near N_PLAN_STEP samples, the split route (three or four
    launches through device memory, the parts on the compile-time passes of
    csrc/fft_reg.cuh) against the plan kernel that holds the pair
    (one-block up to 16384 points, else the two-block kernel), frames alone
    and at 2:1 through the '+add' routes, single-call CUDA events in turns;
    the split route's frames held against the plan kernel's. Returns
    {pair: entry}."""
    from iqwaveform_torch.ops.kernels.fused_ola import (
        _fused_ola_frames_plan,
        _fused_ola_frames_plan_cluster,
        _fused_ola_frames_split,
        _fused_ola_via,
        frames_route,
        ola_route,
        plan_takes,
        split_plan,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 28)
    two_to_one = PLAN_RADIX2 + PLAN_GENERIC_ADD
    out = {}
    for pair in PC_SPLIT_PAIRS:
        n1, n2 = pair
        if None in split_plan(n1, n2):
            continue
        plan = 'plan' if plan_takes(n1, n2) else 'plan_cluster'
        plan_frames = _fused_ola_frames_plan if plan == 'plan' else _fused_ola_frames_plan_cluster
        hop = PC_TIMED.get(pair, n1 // 2 if pair in two_to_one else n1 // 3)
        kw = tier_kwargs(n1, n2, gen, dev)
        n_fr = N_PLAN_STEP // hop
        x = torch.randn(n_fr * hop, dtype=torch.complex64, device=dev, generator=gen)
        fr = torch.cat([x, x.new_zeros(n1 - hop)]).unfold(-1, n1, hop)[:n_fr]
        split_fn = lambda fr=fr, kw=kw: _fused_ola_frames_split(fr, **kw)  # noqa: E731
        plan_fn = lambda fr=fr, kw=kw, f=plan_frames: f(fr, **kw)  # noqa: E731
        err = rel_rms(split_fn(), plan_fn())
        require(err <= 1e-5, f'28e {pair}: split vs {plan} relative RMS {err:.3g}')
        ts, tp = turns_ms(split_fn, plan_fn)
        entry = {'hop': hop, 'frames': n_fr, 'split': [list(s) for s in split_plan(n1, n2)],
                 'frames_route': frames_route(n1, n2), 'plan': plan,
                 'split_frames_ms': ts, f'{plan}_frames_ms': tp, 'split_vs_plan_rel_rms': err}
        if pair in two_to_one:
            okw = dict(kw, noverlap_in=n1 - n1 // 2, noverlap_out=n2 // 2)
            add_split = lambda x=x, okw=okw: _fused_ola_via(x, 'split+add', **okw)  # noqa: E731
            add_plan = lambda x=x, okw=okw: _fused_ola_via(x, plan + '+add', **okw)  # noqa: E731
            e2 = rel_rms(add_split(), add_plan())
            require(e2 <= 1e-5, f'28e {pair}: split+add vs {plan}+add relative RMS {e2:.3g}')
            ta, tb = turns_ms(add_split, add_plan)
            entry.update({'ola_route': ola_route(n1, n2), 'split+add_ms': ta,
                          f'{plan}+add_ms': tb})
        out[f'{n1}->{n2}'] = entry
        print(f'28e {n1} -> {n2} ({n_fr} frames at hop {hop}, split {entry["split"]}, route '
              f'{entry.get("ola_route", entry["frames_route"])}): frames alone, split '
              f'{json.dumps(ts)} ms against {plan} {json.dumps(tp)}'
              + (f'; 2:1 split+add {json.dumps(entry["split+add_ms"])} against {plan}+add '
                 f'{json.dumps(entry[plan + "+add_ms"])}' if 'ola_route' in entry else '')
              + f' ({smi})')
        del x, fr
        torch.cuda.empty_cache()
    return out


def turns_many(fns: dict, turns: int = PC_TURNS) -> dict:
    """medians of single-call CUDA-event times of each of ``fns`` in turns:
    in order, then in reverse, ``turns`` rounds; {name: [ms a round]}."""
    out = {k: [] for k in fns}
    for t in range(turns):
        for k in (list(fns) if t % 2 == 0 else list(fns)[::-1]):
            out[k].append(timed_ms(fns[k]))
    return out


def turns_ms(a, b, turns: int = PC_TURNS) -> tuple:
    """medians of single-call CUDA-event times of ``a`` and ``b`` in turns
    a, b, b, a (``turns`` of each): (a's, b's)."""
    t = turns_many({'a': a, 'b': b}, turns)
    return t['a'], t['b']


def plan_cluster_phases(dev, smi: str, mem_rate: float, fp32_rate: float) -> list:
    """phase 28; returns the kernels line's rows of the two-block plan
    kernel: one at each pair of 28b, and 'fused_ola_frames_plan_cluster'
    with the launches of 28c's steps and the times of 19200 -> 5120."""
    from iqwaveform_torch.ops import kernels
    from iqwaveform_torch.ops.kernels import _build
    from iqwaveform_torch.ops.kernels.fused_ola import (
        _fused_ola_frames_generic,
        _fused_ola_frames_plan,
        _fused_ola_frames_plan_cluster,
        _fused_ola_frames_split,
        _fused_ola_older,
        _fused_ola_via,
        _require_plan_cluster_residency,
        frames_route,
        ola_grouped,
        ola_route,
        plan_cluster_shape,
        plan_cluster_takes,
        plan_takes,
        split_plan,
    )

    kset = {k.__name__: k for k in kernels.KERNELS}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    frames_k, strided = kernels.fused_ola_frames, kernels.fused_ola_strided
    torch.cuda.reset_peak_memory_stats(dev)

    # ---- 28d: ptxas's registers and spills of each instance (an element
    # type and a block size each); none may spill
    spills = plan_spills(_build.ptxas_report(), 'plan_cluster_kernel')
    print(f'28d ptxas {PLAN_CLUSTER_KERNEL} instances: {json.dumps(spills)}')
    spilled = {k: v for k, v in spills.items() if v['spill_stores'] or v['spill_loads']}
    require(len(spills) == 8 and not spilled,
            f'28d: the two-block plan kernel\'s eight instances (four element types, blocks of '
            f'256 and 512 threads) spill or are missing: {spills}')

    # ---- 28a: each pair the plan kernel does not hold on N_PLAN_FRAMES
    # frames against the plain chain and complex128, the class pairs
    # forced; planes at one pair a size class; '+add' with a halo and the tail
    pairs = {}
    two_to_one = PLAN_RADIX2 + PLAN_GENERIC_ADD
    for pair in PC_PAIRS + PC_CLASS_PAIRS:
        n1, n2 = pair
        cls = pair in PC_CLASS_PAIRS
        route = frames_route(n1, n2)
        require(route in (('plan', 'split') if cls else ('plan_cluster', 'split'))
                and plan_takes(n1, n2) == cls, f'28a {pair}: frames_route {route}')
        call = frames_k if route == 'plan_cluster' else _fused_ola_frames_plan_cluster
        kw = tier_kwargs(n1, n2, gen, dev)
        hop = n1 // 2 if pair in two_to_one else n1 // 3
        capture = torch.randn(N_PLAN_FRAMES * hop + n1, dtype=torch.complex64, device=dev,
                              generator=gen)
        frames = capture.unfold(-1, n1, hop)[:N_PLAN_FRAMES]
        reset_counts()
        got = call(frames, **kw)
        torch.cuda.synchronize()
        require(frames_k.route_launches == frame_routes(plan_cluster=1),
                f'28a {pair}: frame routes {frames_k.route_launches}')
        ref = kernels.fused_ola_frames_plain(frames, **kw)
        ref64 = kernels.fused_ola_frames_plain(frames.to(torch.complex128), **_wide_kw(kw))
        err, err64, plain64 = rel_rms(got, ref), rel_rms(got, ref64), rel_rms(ref, ref64)
        entry = {'shape': list(plan_cluster_shape(n1, n2)), 'route': route, 'relative_rms': err,
                 'f64_rel_rms': err64, 'plain_f64_rel_rms': plain64}
        require(err <= 1e-5, f'28a {pair}: relative RMS {err:.3g}')
        require(err64 <= 2 * plain64,
                f'28a {pair}: complex128 error {err64:.4g} > 2 x the plain chain\'s {plain64:.4g}')
        if pair in PC_TIER_PAIRS:
            for dtype in (torch.int16, torch.bfloat16, torch.float32):
                planes = (PLANES_SCALE * torch.stack([capture.real, capture.imag])).round().to(dtype)
                reset_counts()
                gp = call(planes, hop_in=hop, **kw)
                torch.cuda.synchronize()
                rp = kernels.fused_ola_frames_plain(planes, hop_in=hop, **kw)
                e = rel_rms(gp, rp)
                layout = str(dtype).split('.')[-1]
                require(frames_k.route_launches == frame_routes(plan_cluster=1)
                        and frames_k.layout_launches[layout] == 1,
                        f'28a {pair} {layout}: {frames_k.route_launches} {frames_k.layout_launches}')
                require(e <= 1e-5, f'28a {pair} {layout} planes: relative RMS {e:.3g}')
                entry[layout] = e
        if pair in PC_ADD_PAIRS:
            h = n1 // 2
            skw = dict(hop_in=h, **kw)
            x = torch.randn((N_PLAN_FRAMES + 1) * h, dtype=torch.complex64, device=dev,
                            generator=gen)
            src, halo = x[:-h], x[-h:]
            add_route = ola_route(n1, n2)
            reset_counts()
            y, tail = strided(src, halo, n_frames=N_PLAN_FRAMES, **skw)
            torch.cuda.synchronize()
            launched = {k: c.launches for k, c in kset.items() if c.launches}
            require(launched == {'fused_ola_strided': 1, 'ola_add': 1}
                    and strided.route_launches == ola_routes(**{add_route: 1})
                    and add_route == route + '+add',
                    f'28a {pair} 2:1: launches {launched}, {strided.route_launches}')
            r, rt = kernels.fused_ola_strided_plain(src, halo, n_frames=N_PLAN_FRAMES, **skw)
            y64, t64 = strided_f64(src, halo, dict(skw, precision='highest'))
            both, plain = torch.cat([y, tail]), torch.cat([r, rt])
            ref64 = torch.cat([y64, t64])
            e, e64, p64 = rel_rms(both, plain), rel_rms(both, ref64), rel_rms(plain, ref64)
            require(e <= 1e-5, f'28a {pair} {add_route}: relative RMS {e:.3g}')
            require(e64 <= 2 * p64, f'28a {pair} {add_route}: complex128 error {e64:.4g} '
                                    f'> 2 x the plain\'s {p64:.4g}')
            entry[add_route] = {'relative_rms': e, 'f64_rel_rms': e64, 'plain_f64_rel_rms': p64}
        pairs[f'{n1}->{n2}'] = entry
    print('28a the two-block plan kernel at the pairs the plan kernel does not hold and at the '
          'class pairs, forced where another route takes them (G, shared memory, vs plain, vs '
          'complex128); the 2:1 pairs\' own route with a halo and the tail: ' + json.dumps(pairs))
    torch.cuda.empty_cache()

    # ---- 28b: each pair of PC_TIMED on the frames of a step near 2^24
    # samples: the two-block kernel beside the generic kernel, the one-block
    # plan kernel where it holds the pair, the split route where it has a
    # shape and the torch.fft chain, with its bound; the class pairs' two
    # plan kernels in turns
    rows = []
    for (n1, n2), hop in PC_TIMED.items():
        pair = (n1, n2)
        x, fr, kw = pc_frames_input(pair, gen, dev)
        n_fr = fr.shape[0]
        shape = plan_cluster_shape(*pair)
        pc_fn = lambda fr=fr, kw=kw: _fused_ola_frames_plan_cluster(fr, **kw)  # noqa: E731
        plain_fn = lambda fr=fr, kw=kw: kernels.fused_ola_frames_plain(fr, **kw)  # noqa: E731
        entry = {'pair': f'{n1}->{n2}', 'hop': hop, 'frames': n_fr,
                 'frames_route': frames_route(*pair), 'shape': list(shape),
                 'active_clusters': _require_plan_cluster_residency(n1, n2, dev, 0)}
        windows = 8 * (n1 + n2)
        nops = n_fr * (fft_ops(n1) + fft_ops(n2) + 6 * (n1 + n2))
        reset_counts()
        got = pc_fn()
        torch.cuda.synchronize()
        launches = frames_k.route_launches['plan_cluster']
        ref = plain_fn()
        err = rel_rms(got, ref)
        require(launches == 1 and err <= 1e-5, f'28b {pair}: {launches} launches, relative RMS '
                                               f'{err:.3g}')
        if pair in two_to_one:
            # the 2:1 route: the frame kernel reading the rows, then ola_add
            okw = dict(kw, noverlap_in=hop, noverlap_out=n2 // 2)
            add_fn = lambda x=x, okw=okw: _fused_ola_via(x, 'plan_cluster+add', **okw)  # noqa: E731
            ola_plain = lambda x=x, okw=okw: kernels.fused_ola_plain(x, **okw)  # noqa: E731
            y, y_plain = add_fn(), ola_plain()
            e2 = rel_rms(y, y_plain)
            require(e2 <= 1e-5, f'28b {pair}: plan_cluster+add vs plain relative RMS {e2:.3g}')
            row = kernel_row(f'plan_cluster_{n1}_{n2}', {'launches': launches,
                                                          'max_abs_err': max_abs(y, y_plain)},
                             8 * (x.numel() + y.numel()) + windows, nops, add_fn, ola_plain,
                             ola_plain, mem_rate, fp32_rate)
            row['ola_route'] = ola_route(*pair)
            row['generic_ms'] = timed_ms(lambda: _fused_ola_older(x, **okw))
            if plan_takes(*pair):
                plan_add = lambda x=x, okw=okw: _fused_ola_via(x, 'plan+add', **okw)  # noqa: E731
                row['plan_ms'] = timed_ms(plan_add)
                row['turns_ms'] = dict(zip(('plan+add', 'plan_cluster+add'),
                                           turns_ms(plan_add, add_fn)))
            row['relative_rms'] = e2
            del y, y_plain
        else:
            row = kernel_row(f'plan_cluster_{n1}_{n2}', {'launches': launches,
                                                          'max_abs_err': max_abs(got, ref)},
                             8 * (x.numel() + got.numel()) + windows, nops, pc_fn, plain_fn,
                             plain_fn, mem_rate, fp32_rate)
            row['generic_ms'] = timed_ms(lambda: _fused_ola_frames_generic(fr, **kw))
            if plan_takes(*pair):
                plan_fn = lambda fr=fr, kw=kw: _fused_ola_frames_plan(fr, **kw)  # noqa: E731
                row['plan_ms'] = timed_ms(plan_fn)
                row['turns_ms'] = dict(zip(('plan', 'plan_cluster'), turns_ms(plan_fn, pc_fn)))
            row['relative_rms'] = err
        del got, ref
        row.update(entry)
        # the frame kernels alone on the same frames: the two-block kernel by
        # CUDA events a call and over PLAN_TRACE_CALLS calls back to back,
        # the one-block plan kernel, the generic kernel, the split route
        # (a yardstick where it has a shape) and the chain
        row['plan_cluster_frames_ms'] = timed_ms(pc_fn)
        row['back_to_back_ms'] = timed_ms(
            lambda: [pc_fn() for _ in range(PLAN_TRACE_CALLS)]) / PLAN_TRACE_CALLS
        row['plan_frames_ms'] = (timed_ms(lambda: _fused_ola_frames_plan(fr, **kw))
                                 if plan_takes(*pair) else None)
        row['generic_frames_ms'] = timed_ms(lambda: _fused_ola_frames_generic(fr, **kw))
        row['split_frames_ms'] = (timed_ms(lambda: _fused_ola_frames_split(fr, **kw))
                                  if None not in split_plan(*pair) else None)
        row['chain_frames_ms'] = timed_ms(plain_fn)
        print(f'28b {n1} -> {n2} ({n_fr} frames at hop {hop}, route '
              f'{row.get("ola_route", row["frames_route"])}, G {shape[0]}, '
              f'{row["active_clusters"]} clusters at once): {row["ms"]:.4f} ms (bound '
              f'{row["bound_ms"]:.4f} ms by {row["bound_by"]}); generic {row["generic_ms"]:.4f} ms'
              + (f', one-block plan {row["plan_ms"]:.4f} ms' if 'plan_ms' in row else '')
              + f'; plain / torch.fft chain {row["plain_ms"]:.4f} ms; frames alone: two-block '
              f'{row["plan_cluster_frames_ms"]:.4f} (back to back {row["back_to_back_ms"]:.4f}), '
              f'one-block plan {row["plan_frames_ms"]}, generic {row["generic_frames_ms"]:.4f}, '
              f'split {row["split_frames_ms"]}, chain {row["chain_frames_ms"]:.4f} ms'
              + (f'; turns {json.dumps(row["turns_ms"])}' if 'turns_ms' in row else '')
              + f' ({smi})')
        rows.append(row)
        del x, fr
        torch.cuda.empty_cache()

    # ---- 28e: the split route beside the plan kernels at the monitor pairs
    # above 8192 points (the times that decide split_takes' one-block pairs)
    split_turns = split_beside_plans(dev, smi)

    # ---- 28c: the monitor steps near 2^24 samples: routes, launches (the
    # route once a step), reference_step's gates, times beside the same
    # step through the generic kernel and through each plan kernel that
    # holds the pair where the route is another, profiled: the route's
    # kernel and no generic one
    steps, pc_launches = {}, 0
    for sname, (fs, fo, w, m, pair) in PC_STEPS.items():
        mon = pc_design(sname)
        d = mon.design
        route = mon.routes['ola']
        want = ola_route(*pair) if mon._strided else frames_route(*pair)
        require((d.nfft, d.nfft_out) == pair and route == want,
                f'28c {sname}: {d.nfft} -> {d.nfft_out}, routes {mon.routes}')
        x = plan_step_input(mon, gen, dev)
        mon.step(x[: mon.min_input_multiple()])
        torch.cuda.synchronize()
        reset_counts()
        out = mon.step(x)
        torch.cuda.synchronize()
        launched = {k: c.launches for k, c in kset.items() if c.launches}
        if route.endswith('+add'):
            ok = (launched.get('fused_ola') == 1 and launched.get('ola_add') == 1
                  and 'fused_ola_frames' not in launched
                  and kernels.fused_ola.route_launches == ola_routes(**{route: 1}))
        else:
            ok = (launched.get('fused_ola_frames') == 1 and 'fused_ola' not in launched
                  and frames_k.route_launches == frame_routes(**{route: 1}))
        require(ok, f'28c {sname}: launches {launched}, fused_ola {kernels.fused_ola.route_launches}, '
                    f'frames {frames_k.route_launches}')
        pc_launches += (kernels.fused_ola.route_launches.get('plan_cluster+add', 0)
                        + frames_k.route_launches.get('plan_cluster', 0))
        check_step(out, mon.reference_step(x), f'28c {sname} vs reference_step')
        check_step(older_step(mon, x), out, f'28c {sname} through the generic kernel vs the step')
        step_ms = timed_ms(lambda: mon.step(x), reps=10)
        older_ms = timed_ms(lambda: older_step(mon, x), reps=10)
        entry = {'pair': f'{pair[0]}->{pair[1]}', 'route': route, 'samples': x.numel(),
                 'step_ms': step_ms, 'generic_step_ms': older_ms, 'launches': launched}
        for other, takes, other_frames in (
                ('plan', plan_takes, _fused_ola_frames_plan),
                ('plan_cluster', plan_cluster_takes, _fused_ola_frames_plan_cluster)):
            if route.removesuffix('+add') == other or not takes(*pair):
                continue
            # the same step through this plan kernel
            if mon._strided:
                via = lambda o=other: mon._outputs(  # noqa: E731
                    _fused_ola_via(x, o + '+add', **mon.ola_kwargs), mon._chan, mon._counts)
            else:
                via = lambda f=other_frames: mon._outputs(  # noqa: E731
                    ola_grouped(x, frames_fn=f, **mon.ola_kwargs), mon._chan, mon._counts)
            check_step(via(), out, f'28c {sname} through {other} vs the step')
            entry[f'{other}_step_ms'] = timed_ms(via, reps=10)
        kernel = route_kernel(route)
        names, device_us = device_kernels(lambda: mon.step(x), kernel, fresh=sname)
        require(any(kernel in n for n in names), f'28c {sname}: the profile lacks {kernel}: {names}')
        old = [n for n in names if short_name(n) in (GENERIC_KERNEL, OLA_GENERIC_KERNEL)
               or GENERIC_KERNEL + '<' in n or OLA_GENERIC_KERNEL + '<' in n]
        require(not old and not library_kernels(names),
                f'28c {sname}: older or library kernels in the step: {old} {library_kernels(names)}')
        busy = sum(device_us.values()) / 1e3
        entry.update(kernel_device_ms=named_ms(device_us, kernel),
                     idle_share=max(0.0, 1 - busy / step_ms), device_us=device_us)
        steps[sname] = entry
        print(f'28c {sname} ({fs / 1e6:g} -> {fo / 1e6:g} MS/s {w} min_fft_size={m}, {pair[0]} -> '
              f'{pair[1]}, {x.numel()} samples, route {route}): launches {json.dumps(launched)}; '
              f'within the step gates of reference_step; {step_ms:.4f} ms, through the generic '
              f'kernel {older_ms:.4f} ms'
              + ''.join(f', through {o} {entry[o + "_step_ms"]:.4f} ms'
                        for o in ('plan', 'plan_cluster') if o + '_step_ms' in entry)
              + f'; {kernel} {entry["kernel_device_ms"]:.4f} ms of device time; idle share '
              f'{entry["idle_share"]:.3f} ({smi})')
        del mon, x, out
        torch.cuda.empty_cache()

    # the kernel's row: the blackmanharris 19200 -> 5120 frames (28b), the
    # two-block route's counted launches in 28c's steps
    require(pc_launches >= 1, f'28c: no step launched {PLAN_CLUSTER_KERNEL}')
    main = dict(next(r for r in rows if r['pair'] == '19200->5120'))
    main.update(name='fused_ola_frames_plan_cluster',
                source=KERNEL_INFO['fused_ola_frames_plan_cluster'][0],
                replaces=KERNEL_INFO['fused_ola_frames_plan_cluster'][1], launches=pc_launches,
                steps=steps, pairs=pairs, ptxas=spills, split_turns=split_turns)
    rows.append(main)
    print(f'phase 28 peak device memory: {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB')
    return rows


# ---- phase 29: the channelizer's split route redesigned where it lost to
# torch.fft: the one-block kernel (csrc/chan_split_block.cu, route
# 'split_block') and the device-memory route's radix step with the binned
# power and the cross twiddles on chip (csrc/chan_split.cu, route 'split')

# the sizes traced and timed (29b): (points, mode) with the modes of 25a and
# 2^21 points at navg 128
SPLIT_TRACE = ((11264, 'channels'), (11264, 'stats'), (1 << 21, 'stats128'),
               (36864, 'channels'), (36864, 'stats'), (81920, 'channels'), (81920, 'stats'),
               (131072, 'channels'), (131072, 'stats'))
SPLIT_MODES = dict(CHAN_SIZE_MODES, stats128=SPLIT_WIDE[1])
SPLIT_TRACE_CALLS = 4  # calls in one trace, its device times divided by them
SPLIT_HOST_CALLS = 200  # calls host_ms averages
SPLIT_WALL_REPS = 20


def split_device(device_us: dict) -> dict:
    """a trace of SPLIT_TRACE_CALLS calls (device us by kernel) a call:
    device_us by kernel, longest first, and device_ms (None where the trace
    was empty)."""
    per_call = {k: us / SPLIT_TRACE_CALLS for k, us in device_us.items()}
    return {'device_us': dict(sorted(per_call.items(), key=lambda kv: -kv[1])),
            'device_ms': sum(per_call.values()) / 1e3 if per_call else None}


def split_trace(call, expect: str) -> dict:
    """one call of a channelizer route (``call``, no arguments): the device
    microseconds of each kernel a call (``split_device`` of a trace of
    SPLIT_TRACE_CALLS calls, retaken until it holds ``expect``, at most
    PROFILE_TRIES times), the call by CUDA events (median of single
    calls), the host milliseconds a call takes to return (host_ms) and the
    host clock around a call and a synchronize (median of
    SPLIT_WALL_REPS)."""
    _, device_us = device_kernels(lambda: [call() for _ in range(SPLIT_TRACE_CALLS)], expect)
    wall = []
    for _ in range(SPLIT_WALL_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    return {
        **split_device(device_us),
        'event_ms': timed_ms(call),
        'host_ms': host_ms(call, SPLIT_HOST_CALLS),
        'wall_ms': float(np.median(wall)),
    }

SPLIT_BLOCK_KERNEL = 'chan_split_block_kernel'
SPLIT_STEP_KERNEL = 'chan_split_step_kernel'
# the kernel a trace of each split route must hold
SPLIT_ROUTE_KERNEL = {'split_block': SPLIT_BLOCK_KERNEL, 'split': SPLIT_STEP_KERNEL,
                      'split_older': 'chan_split_radix_kernel'}


def split_call_trace(name: str, gen, dev) -> tuple:
    """``--trace splitcall_<n>_<mode>_<route>``: 29b's SPLIT_TRACE_CALLS
    calls of chan_stats at n points in SPLIT_MODES[mode] on ``route``
    (chan_size_input's input); ``--trace splitstep_<design>_navg<navg>``:
    the monitor step of 25b and 29c at a design of SPLIT_CHAN_DESIGNS (its
    input warmed up). (call, kernels its trace must hold)."""
    import iqwaveform_torch as it
    from iqwaveform_torch.ops.kernels.chan_stats import _chan_stats_via

    if name.startswith('spg30_'):
        return spg_trace(name, dev)
    if name.startswith('chan30_'):
        return chan_small_trace(name, gen, dev)
    if name.startswith('spgpath_') or name == 'smallstep':
        return path_trace(name, gen, dev)
    if name.startswith('splitcall_'):
        _, n, mode, route = name.split('_', 3)
        y, kw = chan_size_input(int(n), SPLIT_MODES[mode], gen, dev)
        return (lambda: [_chan_stats_via(y, route, **kw) for _ in range(SPLIT_TRACE_CALLS)],
                (SPLIT_ROUTE_KERNEL[route],))
    design, navg = name.removeprefix('splitstep_').split('_navg')
    extra, _ = dict(SPLIT_CHAN_DESIGNS, **SPLIT_BLOCK_STEPS)[design]
    mon = it.WidebandMonitor(it.design_wideband_monitor(
        122.88e6, 61.44e6, **dict(FLAGSHIP, **extra, apd_navg=int(navg))))
    m = mon.min_input_multiple()
    x = torch.randn(max(1, N_STEP // m) * m, dtype=torch.complex64, device=dev, generator=gen)
    mon.step(x[:m])
    expect = ((SPLIT_BLOCK_KERNEL,) if mon.routes['chan'] == 'split_block'
              else SPLIT_CHAN_KERNELS)
    return (lambda: mon.step(x)), expect


def trace_split_calls(names: str) -> int:
    """``python3 chip_smoke.py --traces <name>,<name>,...`` (names of
    ``split_call_trace``): each call made, warmed up and traced with
    ``device_kernels`` in this one process; prints {name: {names,
    device_us}} of the traces that held their kernels as the last line.
    Exits 1 if none did."""
    sys.path.insert(0, str(ROOT))
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(SEED)
    got = {}
    for name in names.split(','):
        fn, expect = split_call_trace(name, gen, dev)
        fn()
        torch.cuda.synchronize()
        kernel_names, device_us = device_kernels(fn, *expect)
        if kernel_names:
            got[name] = {'names': kernel_names, 'device_us': device_us}
        del fn
        torch.cuda.empty_cache()
    print(json.dumps(got))
    return 0 if got else 1


def fresh_traces(names: list) -> dict:
    """the traces of ``names`` (``split_call_trace``'s) retaken, all in one
    fresh process (``trace_split_calls``), those that did not hold their
    kernels there once more in another: name -> (kernel names, device us
    by short name), for the traces that held their kernels."""
    got = {}
    for _ in range(FRESH_TRACE_PROCESSES):
        left = [n for n in names if n not in got]
        if not left:
            break
        print(f'profiler: taking the traces of {", ".join(left)} in one fresh process')
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), '--traces',
                               ','.join(left)], capture_output=True, text=True,
                              timeout=FRESH_TRACE_TIMEOUT_S)
        lines = proc.stdout.strip().splitlines()
        for line in lines[:-1]:
            print(f'profiler (fresh process): {line}')
        if proc.returncode or not lines:
            print(f'profiler: the fresh process exited {proc.returncode}: {proc.stderr[-2000:]}')
            continue
        got.update({k: (v['names'], v['device_us']) for k, v in json.loads(lines[-1]).items()})
    return got

# the older route's radix step (the C M cross twiddles) and bin kernel: on
# no default path since phase 29
SPLIT_OLDER_KERNELS = ('chan_split_radix_kernel', 'chan_split_bin_kernel')
# 29a: the modes the one-block kernel is held in at each size its route
# takes (25a holds 11264 and the device-memory route's sizes), and the
# device-memory route's sizes held here (the first above the one-block
# limits, a prime radix step of 13, 2^21 in the channel-only mode)
SPLIT_BLOCK_MODES = {'channels': CHAN_SIZE_MODES['channels'], 'stats': CHAN_SIZE_MODES['stats'],
                     'stats128': SPLIT_WIDE[1]}
SPLIT_STEP_CHECKS = ((17408, 'stats'), (18432, 'stats'), (26624, 'channels'), (26624, 'stats128'),
                     (1 << 21, 'channels'))
# 29c: the monitor steps of the new route and of the redesigned one
SPLIT_BLOCK_STEPS = {'chan11264': (dict(channel_count=22, fft_size_per_channel=512), 11264),
                     'chan36864': (dict(channel_count=48, fft_size_per_channel=768), 36864)}
SPLIT_STEP_NAVG = (16, 128)
KERNEL_INFO.update({
    'chan_split_block': ('iqwaveform_torch/csrc/chan_split_block.cu',
                         'iqwaveform_tpu/ops/pallas/chan_stats_pallas.py:301'),
    'chan_split_step': ('iqwaveform_torch/csrc/chan_split.cu',
                        'iqwaveform_tpu/ops/pallas/chan_stats_pallas.py:301'),
})


def kernel_ptxas(report: str, kernel: str) -> dict:
    """ptxas's registers and spills of each instance of ``kernel`` (by its
    mangled template arguments, or 'kernel' where it has none)."""
    import re

    lines, out = report.splitlines(), {}
    for i, line in enumerate(lines):
        m = re.search(r'Compiling entry function .?(_Z\S*' + kernel + r'\S*)', line)
        if not m:
            continue
        e = re.search(kernel + r'I(\w+?)EEv', m.group(1))
        props = out.setdefault(e.group(1) if e else 'kernel',
                               {'spill_stores': 0, 'spill_loads': 0, 'registers': 0})
        for ln in lines[i + 1:i + 4]:
            sp = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads', ln)
            rg = re.search(r'Used (\d+) registers', ln)
            if sp:
                props['spill_stores'] = max(props['spill_stores'], int(sp.group(1)))
                props['spill_loads'] = max(props['spill_loads'], int(sp.group(2)))
            if rg:
                props['registers'] = max(props['registers'], int(rg.group(1)))
    return out


def split_block_phases(dev, smi: str, mem_rate: float, fp32_rate: float) -> list:
    """phase 29; returns the kernels line's rows of the one-block kernel
    ('chan_split_block', the 22 x 512 step's stream) and of the redesigned
    device-memory route ('chan_split_step', 2^21 points at navg 128)."""
    import iqwaveform_torch as it
    from iqwaveform_torch.ops import kernels
    from iqwaveform_torch.ops.kernels import _build
    from iqwaveform_torch.ops.kernels.chan_stats import (
        CHAN_SIZES,
        _chan_stats_via,
        block_plan,
        split_shape,
    )

    kset = {k.__name__: k for k in kernels.KERNELS}
    gen = torch.Generator(device=dev).manual_seed(SEED + 29)
    torch.cuda.reset_peak_memory_stats(dev)
    rows = []
    report = _build.ptxas_report()
    ptxas = {k: kernel_ptxas(report, k) for k in (SPLIT_BLOCK_KERNEL, SPLIT_STEP_KERNEL,
                                                   'chan_split_passes_kernel')}
    print('29 ptxas: ' + json.dumps(ptxas))

    # ---- 29a: the one-block kernel at every size and mode its route takes
    # (17a's gates: 1e-5 of the plain version, CHAN_F64_LIMIT of its
    # complex128 error), and the device-memory route at the sizes beside
    sizes = {}
    checks = [(n, name) for n in range(1024, 65536 + 1, 1024)
              if n not in CHAN_SIZES and split_shape(n) is not None and n != 11264
              for name, mode in SPLIT_BLOCK_MODES.items()
              if block_plan(n, mode['emit_psd'], mode['emit_pbin'], mode['navg'])]
    for n, name in checks + list(SPLIT_STEP_CHECKS):
        mode = SPLIT_MODES.get(name, SPLIT_BLOCK_MODES.get(name))
        r = chan_size_check(n, mode, gen, dev, mem_rate, fp32_rate)
        want = split_route(n, mode)
        require(r['route'] == want, f'29a chan_stats at {n} {name}: route {r["route"]}, not {want}')
        r['plan'] = (list(block_plan(n, mode['emit_psd'], mode['emit_pbin'], mode['navg']))
                     if want == 'split_block' else list(split_shape(n)))
        sizes.setdefault(str(n), {})[name] = r
        print(f'29a chan_stats at {n} ({name}, {want}, plan {r["plan"]}): ' + json.dumps(
            {k: (v if not isinstance(v, dict) else
                 {e: f'{x:.3g}' for e, x in v.items() if 'f64' in e})
             for k, v in r.items() if k not in ('frames', 'max_abs_err', 'bound_by', 'plan')})
            + f' ({smi})')
        torch.cuda.empty_cache()

    # ---- 29b: the default route (one-block kernel or redesigned step), the
    # redesigned step forced at a one-block size, the older split route and
    # the torch.fft chain at the SPLIT_TRACE sizes: profiled device time by
    # kernel, event / host / wall times of each, then event times in turns
    traces = {}
    for n, name in SPLIT_TRACE:
        mode = SPLIT_MODES[name]
        y, kw = chan_size_input(n, mode, gen, dev)
        want = split_route(n, mode)
        calls = {want: lambda y=y, kw=kw: kernels.chan_stats(y, **kw)}
        if want == 'split_block':
            calls['split'] = lambda y=y, kw=kw: _chan_stats_via(y, 'split', **kw)
        calls['split_older'] = lambda y=y, kw=kw: _chan_stats_via(y, 'split_older', **kw)
        ref = kernels.chan_stats_plain(y, **kw)
        entry = {'route': want, 'frames': y.numel() // n}
        for route, fn in calls.items():
            reset_counts()
            got = fn()
            torch.cuda.synchronize()
            require(kernels.chan_stats.route_launches == dict(CHAN_NO_ROUTE, **{route: 1}),
                    f'29b {n} {name} {route}: routes {kernels.chan_stats.route_launches}')
            err = max(rel_rms(got[k], ref[k]) for k in ref)
            require(err <= 1e-5, f'29b {n} {name} {route}: relative RMS {err:.3g}')
            entry[route] = dict(split_trace(fn, SPLIT_ROUTE_KERNEL[route]), relative_rms=err)
            del got
        entry['chain'] = {'event_ms': timed_ms(lambda y=y, kw=kw: kernels.chan_stats_plain(y, **kw))}
        entry['turns'] = turns_many(dict(calls, chain=lambda y=y, kw=kw: kernels.chan_stats_plain(
            y, **kw)))
        traces[f'{n}_{name}'] = entry
        print(f'29b {n} {name} ({entry["frames"]} frames): ' + json.dumps(
            {r: {k: (round(v, 4) if isinstance(v, float) else v) for k, v in e.items()
                 if k in ('device_ms', 'event_ms', 'host_ms', 'wall_ms')}
             for r, e in entry.items() if isinstance(e, dict) and r != 'turns'})
            + '; device us by kernel ' + json.dumps(
                {r: {k[:48]: round(us, 1) for k, us in e['device_us'].items()}
                 for r, e in entry.items() if isinstance(e, dict) and 'device_us' in e})
            + '; in turns ' + json.dumps({k: [round(t, 4) for t in v]
                                          for k, v in entry['turns'].items()}) + f' ({smi})')
        del y, kw, ref
        torch.cuda.empty_cache()
    # the default route's trace must hold its kernel: the traces that did
    # not are retaken, all in one fresh process; a forced route's may stay
    # empty (device_ms None)
    retake = {f'splitcall_{key}_{e["route"]}': e for key, e in traces.items()
              if not any(SPLIT_ROUTE_KERNEL[e['route']] in k for k in e[e['route']]['device_us'])}
    for call, (_, device_us) in fresh_traces(list(retake)).items():
        e = retake[call]
        e[e['route']].update(split_device(device_us))
        print(f'29b {call} (fresh process): device us by kernel ' + json.dumps(
            {k[:48]: round(us, 1) for k, us in e[e['route']]['device_us'].items()}))
    for key, e in traces.items():
        names = set(e[e['route']]['device_us'])
        kernel = SPLIT_ROUTE_KERNEL[e['route']]
        require(any(kernel in k for k in names), f'29b {key}: no {kernel} in {sorted(names)}')
        old = [k for k in names if any(o in k for o in SPLIT_OLDER_KERNELS)]
        require(not old, f'29b {key}: the older split kernels on the default route: {old}')

    # ---- 29c: the monitor at 22 x 512 (the one-block kernel) and 48 x 768
    # (the redesigned step), navg 16 and 128, near 2^24 samples: routes,
    # launches with the counts set to 0 just before, phase 3's gates against
    # reference_step (the psd 26d's), the step and the plain step timed, a
    # profile
    steps, launches, streams, profiles = {}, {}, {}, {}
    for name, (extra, nb) in SPLIT_BLOCK_STEPS.items():
        for navg in SPLIT_STEP_NAVG:
            mode = dict(emit_psd=True, emit_pbin=True, navg=navg)
            want = split_route(nb, mode)
            mon = it.WidebandMonitor(it.design_wideband_monitor(
                122.88e6, 61.44e6, **dict(FLAGSHIP, **extra, apd_navg=navg)))
            require(mon.chan_kwargs['nfft_big'] == nb and mon.routes['chan'] == want,
                    f'29c {name} navg {navg}: {mon.chan_kwargs["nfft_big"]}, {mon.routes}')
            m = mon.min_input_multiple()
            x = torch.randn(max(1, N_STEP // m) * m, dtype=torch.complex64, device=dev,
                            generator=gen)
            mon.step(x[:m])  # warm-up: first-use setup
            torch.cuda.synchronize()
            reset_counts()
            out = mon.step(x)
            torch.cuda.synchronize()
            launched = {k: v.launches for k, v in kset.items() if v.launches}
            routes = dict(kernels.chan_stats.route_launches)
            require(launched == {'fused_ola': 1, 'chan_stats': 1, 'hist': 1},
                    f'29c {name} navg {navg}: launches {launched}')
            require(routes == dict(CHAN_NO_ROUTE, **{want: 1}), f'29c {name}: routes {routes}')
            launches[want] = launches.get(want, 0) + routes[want]
            # the psd by 26d's gate: the float32 reference_step can itself sit
            # 0.03 dB from complex128 at a bin just above -100 dB (the 48 x 768
            # step, ROADMAP Queue 3's absolute gate), so a step that far from it
            # is held to complex128 instead
            ref = mon.reference_step(x)
            check_step(out, ref, f'29c {name} navg {navg} vs reference_step', psd=False)
            psd_err = wide_psd_check(mon, x, out, ref, f'29c {name} navg {navg}')
            del ref
            kernel = SPLIT_BLOCK_KERNEL if want == 'split_block' else SPLIT_STEP_KERNEL
            key = f'{name}_navg{navg}'
            profiles[key] = (kernel,) + device_kernels(lambda: mon.step(x), kernel)
            step_ms = timed_ms(lambda: mon.step(x), reps=10)
            plain_ms = timed_ms(lambda: mon.reference_step(x), reps=5, warmup=1)
            steps[key] = {'samples': x.numel(), 'route': want, 'launches': launched,
                          'psd_errors_db': psd_err, 'step_ms': step_ms, 'plain_step_ms': plain_ms}
            print(f'29c {key}: launches {json.dumps(launched)}, chan_stats route {want}; within '
                  f'phase 3\'s gates of reference_step (the psd 26d\'s); step {step_ms:.4f} ms for '
                  f'{x.numel()} samples = {x.numel() / step_ms / 1e3:.1f} MS/s, the plain step '
                  f'{plain_ms:.4f} ms ({smi})')
            if navg == 16:
                streams[want] = (kernels.fused_ola(x, **mon.ola_kwargs), dict(mon.chan_kwargs),
                                 name)
            del mon, x, out
            torch.cuda.empty_cache()
    require(launches.get('split_block', 0) >= 1 and launches.get('split', 0) >= 1,
            f'29c: a kernel of the path launched no time: {launches}')
    # each step's profile must hold its kernel: the traces that did not are
    # retaken, all in one fresh process
    retake = [f'splitstep_{key}' for key, (kernel, names, _) in profiles.items()
              if not any(kernel in k for k in names)]
    for call, got in fresh_traces(retake).items():
        key = call.removeprefix('splitstep_')
        profiles[key] = (profiles[key][0],) + got
    for key, (kernel, names, device_us) in profiles.items():
        require(any(kernel in k for k in names), f'29c {key}: profiler shows no {kernel}')
        old = [k for k in names if any(o in k for o in SPLIT_OLDER_KERNELS)]
        require(not old, f'29c {key}: the older split kernels in the step: {old}')
        bad = library_kernels(names)
        require(not bad, f'29c {key}: library kernels in the step: {bad}')
        busy = sum(device_us.values()) / 1e3
        chan_us = sum(us for k, us in device_us.items() if 'chan_split' in k or 'chan_fold' in k)
        steps[key].update(channelizer_device_ms=chan_us / 1e3,
                          idle_share=max(0.0, 1 - busy / steps[key]['step_ms']))
        print(f'29c {key}: channelizer {chan_us:.1f} us of device time, idle share '
              f'{steps[key]["idle_share"]:.3f} ({smi})')

    # the kernels line's rows: the one-block kernel on the 22 x 512 step's
    # stream (navg 16); the redesigned step at 2^21 points, navg 128
    y, ckw, name = streams['split_block']
    nb = ckw['nfft_big']
    cs, ref = kernels.chan_stats(y, **ckw), kernels.chan_stats_plain(y, **ckw)
    for k in ref:
        require(rel_rms(cs[k], ref[k]) <= 1e-5, f'29 chan_split_block {k} on the {name} stream')
    row = kernel_row(
        'chan_split_block',
        {'launches': launches['split_block'], 'max_abs_err': max(max_abs(cs[k], ref[k]) for k in ref)},
        8 * y.numel() + 8 * nb + 4 * sum(v.numel() for v in cs.values()),
        (y.shape[-1] // nb) * (fft_ops(nb) + 12 * nb),
        lambda: kernels.chan_stats(y, **ckw), lambda: kernels.chan_stats_plain(y, **ckw),
        lambda: kernels.chan_stats_plain(y, **ckw), mem_rate, fp32_rate)
    row.update(path=f'WidebandMonitor.step, 22 x 512 channels ({nb} points), navg 16, the '
                    'launches of 29c\'s steps at navg 16 and 128',
               older_ms=timed_ms(lambda: _chan_stats_via(y, 'split_older', **ckw)),
               sizes=sizes, ptxas=ptxas[SPLIT_BLOCK_KERNEL], steps=steps,
               traces={k: v for k, v in traces.items() if v['route'] == 'split_block'})
    rows.append(row)
    print(f'chan_split_block at {nb}: {row["ms"]:.4f} ms (bound {row["bound_ms"]:.4f} ms by '
          f'{row["bound_by"]}, plain / torch.fft chain {row["plain_ms"]:.4f} ms, the older split '
          f'route {row["older_ms"]:.4f} ms) ({smi})')
    del y, cs, ref, streams
    torch.cuda.empty_cache()

    n, mode = SPLIT_WIDE
    y, kw = chan_size_input(n, mode, gen, dev)
    cs, ref = kernels.chan_stats(y, **kw), kernels.chan_stats_plain(y, **kw)
    row = kernel_row(
        'chan_split_step',
        {'launches': launches['split'], 'max_abs_err': max(max_abs(cs[k], ref[k]) for k in ref)},
        8 * y.numel() + 8 * n + 4 * sum(v.numel() for v in cs.values()),
        (y.shape[-1] // n) * (fft_ops(n) + 12 * n),
        lambda: kernels.chan_stats(y, **kw), lambda: kernels.chan_stats_plain(y, **kw),
        lambda: kernels.chan_stats_plain(y, **kw), mem_rate, fp32_rate)
    row.update(path=f'chan_stats at {n} points (C x M = {split_shape(n)}), navg 128, on '
                    f'{y.numel()} samples; launches: 29c\'s 48 x 768 steps',
               older_ms=timed_ms(lambda: _chan_stats_via(y, 'split_older', **kw)),
               ptxas=ptxas[SPLIT_STEP_KERNEL],
               traces={k: v for k, v in traces.items() if v['route'] == 'split'})
    rows.append(row)
    print(f'chan_split_step at {n} navg 128: {row["ms"]:.4f} ms (bound {row["bound_ms"]:.4f} ms '
          f'by {row["bound_by"]}, plain / torch.fft chain {row["plain_ms"]:.4f} ms, the older '
          f'split route {row["older_ms"]:.4f} ms) ({smi})')
    del y, cs, ref
    torch.cuda.empty_cache()

    # ---- 29e: the one-block kernel beside the redesigned device-memory
    # route and the chain, in turns, at every size and mode its plan takes
    # (the measurement behind block_plan's limits)
    beside = {}
    for n, name in checks + [(11264, m) for m in SPLIT_BLOCK_MODES]:
        mode = SPLIT_BLOCK_MODES[name]
        y, kw = chan_size_input(n, mode, gen, dev)
        t = turns_many({
            'split_block': lambda: _chan_stats_via(y, 'split_block', **kw),
            'split': lambda: _chan_stats_via(y, 'split', **kw),
            'chain': lambda: kernels.chan_stats_plain(y, **kw)})
        beside[f'{n}_{name}'] = t
        print(f'29e {n} {name}: in turns ' + json.dumps(
            {k: [round(x, 4) for x in v] for k, v in t.items()}) + f' ({smi})')
        del y, kw
        torch.cuda.empty_cache()
    rows[0]['block_beside_split'] = beside

    print(f'phase 29 peak device memory: {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB')
    return rows


# ---- phase 30: rows 9-10 at every nfft the JAX kernels take (the
# frame-group kernels at 64-1024, csrc/spectrogram_group.cuh; the block
# kernel at 2048-16384, csrc/spectrogram_block.cu) and rows 4-5 at 64-512
# points (chan_stats_small_kernel, csrc/chan_small.cu), each beside the
# radix-2 body it replaces there

SPG_SIZES = (64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384)
# 30a: row 10 timed at the sizes the radix-2 body ran (the JAX levels
# kernel's above 1024 at apd_navg 0 and 16; 1024 at the apd_navg its
# register kernel did not take), in the levels (1024 bins) and stats modes
SPG_LEVELS_TIMED = tuple((n, a) for n in (2048, 4096, 8192, 16384) for a in (0, 16)) + (
    (1024, 32), (1024, 64), (1024, 128))
# and held to the plain version alone at the frame-group sizes below 1024
SPG_LEVELS_HELD = ((64, 0), (64, 64), (128, 2), (256, 32), (512, 16), (512, 128))
SPG_HIST_BINS = 1024
SPG_TRACE_CALLS = 4  # calls in one trace, its device times divided by them
BLOCK_KERNEL = 'spectrogram_block_kernel'
REDUCE_KERNEL = 'spectrogram_reduce_kernel'
# 30b: power_spectral_density's resolutions fs / n, the persistence fold's nfft
SPG_PSD_NFFT = (256, 2048, 4096)
SPG_FOLD_NFFT = 2048
# 30c: rows 4-5 at 64-512 in the channel-only mode and the statistics
# modes at navg 1 and 16 (timed), and held in the other modes
CHAN_SMALL_KERNEL = 'chan_stats_small_kernel'
CHAN_SMALL_MODES = {'channels': CHAN_SIZE_MODES['channels'],
                    'stats1': dict(emit_psd=True, emit_pbin=True, navg=1),
                    'stats': CHAN_SIZE_MODES['stats']}
CHAN_SMALL_HELD = ((64, dict(emit_psd=True, emit_pbin=False, navg=1)),
                   (128, dict(emit_psd=False, emit_pbin=True, navg=128)),
                   (256, dict(emit_psd=True, emit_pbin=True, navg=64)),
                   (512, dict(emit_psd=False, emit_pbin=True, navg=4)))
# the monitor step whose channelizer frame is 256 points: the small
# blackman design of ROADMAP Queue 3 (4 x 64 points)
SMALL_MONITOR = ((2e6, 1e6), dict(bw=0.8e6, channel_count=4, fft_size_per_channel=64,
                                  window='blackman', apd_bins=256, min_fft_size=255, fs_sdr=2e6))
KERNEL_INFO.update({
    'spectrogram_block': ('iqwaveform_torch/csrc/spectrogram_block.cu',
                          'iqwaveform_tpu/ops/pallas/spectrogram_pallas.py:258'),
    'spectrogram_db_small': ('iqwaveform_torch/csrc/spectrogram_group.cuh',
                             'iqwaveform_tpu/ops/pallas/spectrogram_pallas.py:258'),
    'chan_stats_small': ('iqwaveform_torch/csrc/chan_small.cu',
                         'iqwaveform_tpu/ops/pallas/chan_stats_pallas.py:301'),
})


def spg_kernel(route: str, db: bool) -> str:
    """the device kernel a spectrogram route launches"""
    if route == 'generic':
        return LEVELS_GENERIC_KERNEL
    if route == 'block':
        return BLOCK_KERNEL
    return DB_REG_KERNEL if db else LEVELS_REG_KERNEL


def spg_window(nfft: int, dev):
    """BASELINE #3's design at ``nfft`` (hann, SPG_HIST_BINS bins over
    (-150, 50) dB): (the kernels' window on the card, the histogram rule)"""
    from iqwaveform_torch import parallel as P

    design = P.design_persistence(nfft=nfft, window=PERSISTENCE['window'], hist_bins=SPG_HIST_BINS,
                                  hist_range_dB=PERSISTENCE['hist_range_dB'])
    return torch.from_numpy(design['kernel_window']).to(dev), design['quant']


def spg_call(mode: str, nfft: int, navg: int, route: str, x, w, quant):
    """one call of row 9 (mode 'dB') or row 10 (mode 'levels' or 'stats') on
    ``route`` ('new': the port's route; 'generic': the radix-2 body)"""
    from iqwaveform_torch.ops import kernels
    from iqwaveform_torch.ops.kernels.spectrogram import (
        _spectrogram_dB_generic,
        _spectrogram_levels_generic,
    )

    q = quant if mode == 'levels' else None
    if mode == 'dB':
        fn = kernels.spectrogram_dB if route == 'new' else _spectrogram_dB_generic
        return lambda: fn(x, w, nfft)
    fn = kernels.spectrogram_levels if route == 'new' else _spectrogram_levels_generic
    return lambda: fn(x, w, nfft, quant=q, apd_navg=navg)


def spg_input(mode: str, dev):
    """phase 19's capture, complex64 (row 9, the PSD's layout) or as (2, n)
    float32 planes (row 10, the fold's)"""
    x = psd_capture(dev)
    return x if mode == 'dB' else torch.stack([x.real, x.imag])


def spg_trace(name: str, dev) -> tuple:
    """``--traces spg30_<mode>_<nfft>_<navg>_<route>``: SPG_TRACE_CALLS calls
    of spg_call on phase 19's capture; (call, kernels its trace must hold)"""
    from iqwaveform_torch.ops.kernels.spectrogram import db_route, levels_route

    _, mode, nfft, navg, route = name.split('_')
    nfft, navg = int(nfft), int(navg)
    w, quant = spg_window(nfft, dev)
    call = spg_call(mode, nfft, navg, route, spg_input(mode, dev), w, quant)
    real = route if route == 'generic' else (db_route(nfft) if mode == 'dB'
                                            else levels_route(nfft, navg))
    return (lambda: [call() for _ in range(SPG_TRACE_CALLS)]), (spg_kernel(real, mode == 'dB'),)


def chan_small_trace(name: str, gen, dev) -> tuple:
    """``--traces chan30_<n>_<mode>_<route>``: SPG_TRACE_CALLS calls of
    chan_stats at n points in CHAN_SMALL_MODES[mode] on 17a's input,
    through the port's route ('new') or the radix-2 kernel ('generic')"""
    from iqwaveform_torch.ops import kernels
    from iqwaveform_torch.ops.kernels.chan_stats import _chan_stats_generic

    _, n, mode, route = name.split('_')
    y, kw = chan_size_input(int(n), CHAN_SMALL_MODES[mode], gen, dev)
    fn = kernels.chan_stats if route == 'new' else _chan_stats_generic
    kernel = CHAN_SMALL_KERNEL if route == 'new' else STATS_GENERIC_KERNEL
    return (lambda: [fn(y, **kw) for _ in range(SPG_TRACE_CALLS)]), (kernel,)


def path_trace(name: str, gen, dev) -> tuple:
    """``--traces spgpath_psd<nfft>|spgpath_fold<nfft>|smallstep``: 30b's PSD
    or fold call on phase 19's capture, or 30c's small monitor step (its
    input warmed up); (call, kernels its trace must hold)"""
    import iqwaveform_torch as it
    from iqwaveform_torch.ops.kernels.spectrogram import db_route

    if name == 'smallstep':
        rates, extra = SMALL_MONITOR
        mon = it.WidebandMonitor(it.design_wideband_monitor(*rates, **extra))
        m = mon.min_input_multiple()
        xs = torch.randn(max(1, N_STEP // m) * m, dtype=torch.complex64, device=dev, generator=gen)
        mon.step(xs[:m])
        return (lambda: mon.step(xs)), (CHAN_SMALL_KERNEL,)
    x = psd_capture(dev)
    key = name.removeprefix('spgpath_')
    if key.startswith('psd'):
        nfft = int(key[3:])
        kw = dict(fs=PSD_FS, window='hann', resolution=PSD_FS / nfft, statistics=PSD_STATS)
        return (lambda: it.power_spectral_density(x, **kw)), (spg_kernel(db_route(nfft), True),)
    nfft = int(key[4:])
    fkw = dict(fs=PSD_FS, window='hann', nfft=nfft, chunk_frames=x.numel() // 4 // nfft,
               hist_bins=SPG_HIST_BINS, quantiles=[0.5, 0.99])
    return (lambda: it.streaming_persistence_spectrum(x, **fkw)), (BLOCK_KERNEL,)


def trace_device(call, kernel: str, name: str, retake: list) -> dict:
    """device milliseconds a call of ``call`` (a trace of SPG_TRACE_CALLS
    calls, by kernel, ``split_device``); where the trace holds no
    ``kernel``, ``name`` joins ``retake`` (the traces taken again in a fresh
    process)"""
    _, device_us = device_kernels(lambda: [call() for _ in range(SPG_TRACE_CALLS)], kernel)
    got = split_device(device_us)
    if not any(kernel in k for k in device_us):
        retake.append(name)
    return got


def spg_bounds(mode: str, n: int, nfft: int, navg: int, mem_rate: float, fp32_rate: float) -> dict:
    """the least time of a row 9 / 10 call on ``n`` samples (phase 4's
    work): the frames read once (8 B a sample), dB or the levels written
    (4 B a sample; none in the stats mode), the binned power (4 B per navg
    samples) and the statistics (12 B a bin); 5 nfft log2 nfft + 12 nfft
    flop a frame"""
    frames = n // nfft
    nbytes = 8 * n + 8 * nfft + (4 * n if mode != 'stats' else 0)
    if mode != 'dB':
        nbytes += 12 * nfft + (4 * n // navg if navg else 0)
    t_bytes = nbytes / mem_rate * 1e3
    t_ops = frames * (fft_ops(nfft) + 12 * nfft) / fp32_rate * 1e3
    return {'bound_ms': max(t_bytes, t_ops), 'bound_by': 'bytes' if t_bytes >= t_ops else 'operations'}


def spg_min_readings(got, ref, level: float, nfft: int, frames: int) -> dict:
    """min of dB of a row 10 call against another's: the largest dB
    difference (the 1024-point card test's 5e-3 dB), the largest power
    difference over the float32 FFT bound of a value (phase 30's gate) and
    over the bin's mean power (phase 4's min_gate, 1e-6)"""
    p_ref = 10 ** (ref['pmin'].double() / 10)
    share = (10 ** (got['pmin'].double() / 10) - p_ref).abs() / fft_power_bound(p_ref, level, nfft)
    return {'min_dB': max_abs(got['pmin'], ref['pmin']), 'min_over_bound': float(share.max()),
            'min_power_over_mean': min_gate(got['pmin'], ref['pmin'], ref['psum'] / frames)[1]}


def spg_check(mode: str, nfft: int, navg: int, x, w, quant, label: str) -> dict:
    """one row 9 / 10 call on its route against the plain version and the
    radix-2 body: dB (row 9) by value_gate, phase 19's float32 FFT bound;
    the levels equal but where dB lies on an edge (phase 4's rule: at most
    1e-3 of them, by one bin); mean and max of dB by psd_gate, min by the
    float32 FFT bound of a value, the binned power within 1e-5; against float64 on
    the first N_F64_FRAMES frames, the RMS error of mean and max of dB (of
    dB, row 9) at most twice the radix-2 body's (phase 4's, 17a's); the
    statistics bit-equal between the levels and stats modes, and every
    output between the two input layouts. The gates' level is the
    spectrum's mean power a bin (dB), of the plain version's frames. The
    radix-2 body's min of dB against the plain version is read under the
    same bound and phase 4's min_gate, and not held
    ('generic_vs_plain'). Returns the errors."""
    from iqwaveform_torch.ops import kernels
    from iqwaveform_torch.ops.kernels.spectrogram import (
        _spectrogram_dB_generic,
        _spectrogram_levels_generic,
        db_route,
        levels_route,
    )

    planes = x if x.dim() == 2 else torch.stack([x.real, x.imag])
    cplx = torch.complex(planes[0], planes[1])
    frames = planes.shape[1] // nfft
    route = db_route(nfft) if mode == 'dB' else levels_route(nfft, navg)
    require(route == ('reg' if nfft <= 1024 else 'block'), f'{label}: route {route}')
    reset_counts()
    got = spg_call(mode, nfft, navg, 'new', x, w, quant)()
    torch.cuda.synchronize()
    wrapper = kernels.spectrogram_dB if mode == 'dB' else kernels.spectrogram_levels
    routes = dict(wrapper.route_launches)
    want = dict.fromkeys(routes, 0)
    want[route] = 1
    require(routes == want, f'{label}: routes {routes}')
    other = spg_call(mode, nfft, navg, 'new', cplx if x.dim() == 2 else planes, w, quant)()
    level = float(10 * torch.log10((10 ** (kernels.spectrogram_dB_plain(x, w, nfft).double() / 10))
                                   .mean()))
    out = {'route': route, 'frames': frames, 'level_dB': level}
    head = planes[:, : min(frames, N_F64_FRAMES) * nfft]
    w64 = w.to(torch.complex128)
    if mode == 'dB':
        require(torch.equal(got, other), f'{label}: the two input layouts differ')
        ref = kernels.spectrogram_dB_plain(x, w, nfft)
        generic = _spectrogram_dB_generic(x, w, nfft)
        out['plain'] = value_gate(got, ref, level, nfft, f'{label} vs plain')
        out['generic'] = value_gate(got, generic, level, nfft, f'{label} vs the radix-2 body')
        ref64 = kernels.spectrogram_dB_plain(head.double(), w64, nfft)
        sel = ref64 >= level - 40
        k = head.shape[1] // nfft
        e64 = float((got[:k].double() - ref64)[sel].pow(2).mean().sqrt())
        g64 = float((generic[:k].double() - ref64)[sel].pow(2).mean().sqrt())
        require(e64 <= 2 * g64, f'{label}: float64 error {e64:.4g} > 2 x the radix-2 body\'s {g64:.4g}')
        out.update(f64_rms_dB=e64, generic_f64_rms_dB=g64)
        out['max_abs_err'] = out['plain']['dB']
        return out
    q = quant if mode == 'levels' else None
    for key in ('levels', 'psum', 'pmax', 'pmin', 'p_binned'):
        require((got[key] is None) == (other[key] is None)
                and (got[key] is None or torch.equal(got[key], other[key])),
                f'{label} {key}: the two input layouts differ')
    if mode == 'levels':
        stats = kernels.spectrogram_levels(x, w, nfft, apd_navg=navg)
        for key in ('psum', 'pmax', 'pmin'):
            require(torch.equal(stats[key], got[key]), f'{label} {key}: the stats mode differs')
    ref = kernels.spectrogram_levels_plain(x, w, nfft, quant=q, apd_navg=navg)
    generic = _spectrogram_levels_generic(x, w, nfft, quant=q, apd_navg=navg)
    for name, other in (('plain', ref), ('generic', generic)):
        e = {'mean_dB': psd_gate(got['psum'] / frames, other['psum'] / frames, level,
                                 f'{label} mean_dB vs {name}', nfft=nfft)['dB'],
             'max_dB': psd_gate(got['pmax'], other['pmax'], level, f'{label} max_dB vs {name}',
                                nfft=nfft)['dB']}
        # min of dB is each bin's deepest value, one value of the frames:
        # its power within the float32 FFT bound of a value (phase 19's;
        # phase 4's min_gate, 1e-6 of the bin's mean, is that bound's on
        # white noise, where no tone sets the frames' energy)
        e.update(spg_min_readings(got, other, level, nfft, frames))
        require(e['min_over_bound'] <= 1,
                f'{label} min_dB vs {name}: {e["min_over_bound"]:.3g} x the float32 FFT bound')
        if q is not None:
            diff = (got['levels'] - other['levels']).abs()
            e['levels_moved'] = float((diff > 0).double().mean())
            require(int(diff.max()) <= 1 and e['levels_moved'] <= 1e-3,
                    f'{label} levels vs {name}: {e["levels_moved"]:.3g} moved, by up to '
                    f'{int(diff.max())}')
        if navg:
            e['p_binned'] = rel_rms(got['p_binned'], other['p_binned'])
            require(e['p_binned'] <= 1e-5, f'{label} p_binned vs {name}: {e["p_binned"]:.3g}')
        out[name] = e
    out['generic_vs_plain'] = spg_min_readings(generic, ref, level, nfft, frames)
    lv64, lv64_generic = levels_f64(planes, w, nfft, q)
    for key in lv64:
        require(lv64[key] <= 2 * lv64_generic[key],
                f'{label} {key}: float64 error {lv64[key]:.4g} > 2 x the radix-2 body\'s '
                f'{lv64_generic[key]:.4g}')
    out.update(f64_rms_dB=lv64, generic_f64_rms_dB=lv64_generic)
    out['max_abs_err'] = max(v for k, v in out['plain'].items() if k.endswith('_dB'))
    return out


def small_frame_phases(dev, smi: str, mem_rate: float, fp32_rate: float) -> list:
    """phase 30; returns the kernels line's rows of the block kernel
    ('spectrogram_block': the PSD at fs / 2048), the frame-group dB kernel
    below 1024 points ('spectrogram_db_small': the PSD at fs / 256) and the
    small-frame channelizer ('chan_stats_small': the small blackman
    monitor's stream)."""
    import iqwaveform_torch as it
    from iqwaveform_torch.ops import kernels
    from iqwaveform_torch.ops.kernels import _build
    from iqwaveform_torch.ops.kernels.chan_stats import RADIX2_SIZES, _chan_stats_generic

    kset = {k.__name__: k for k in kernels.KERNELS}
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    torch.cuda.reset_peak_memory_stats(dev)
    t_phase = time.perf_counter()
    report = _build.ptxas_report()
    ptxas = {k: kernel_ptxas(report, k) for k in (BLOCK_KERNEL, CHAN_SMALL_KERNEL,
                                                   LEVELS_REG_KERNEL, DB_REG_KERNEL)}
    print('30 ptxas: ' + json.dumps(ptxas))

    # ---- 30a: rows 9-10 at every size against the plain version and the
    # radix-2 body, timed beside them, the torch.fft chain and the bound
    x = psd_capture(dev)
    n = x.numel()
    retake, table = [], {}
    configs = ([('dB', nfft, 0, True) for nfft in SPG_SIZES]
               + [(m, nfft, a, True) for nfft, a in SPG_LEVELS_TIMED for m in ('levels', 'stats')]
               + [('levels', nfft, a, False) for nfft, a in SPG_LEVELS_HELD])
    inputs = {'dB': x, 'levels': torch.stack([x.real, x.imag])}
    inputs['stats'] = inputs['levels']
    for mode, nfft, navg, timed in configs:
        w, quant = spg_window(nfft, dev)
        xin = inputs[mode]
        key = f'{mode}_{nfft}_{navg}'
        label = f'30a {mode} nfft {nfft} apd_navg {navg}'
        r = spg_check(mode, nfft, navg, xin, w, quant, label)
        if timed:
            r.update(spg_bounds(mode, n, nfft, navg, mem_rate, fp32_rate))
            calls = {route: spg_call(mode, nfft, navg, route, xin, w, quant)
                     for route in ('new', 'generic')}
            q = quant if mode == 'levels' else None
            chain = ((lambda: kernels.spectrogram_dB_plain(xin, w, nfft)) if mode == 'dB' else
                     (lambda: kernels.spectrogram_levels_plain(xin, w, nfft, quant=q, apd_navg=navg)))
            r['generic_ms'] = timed_ms(calls['generic'])
            r['chain_ms'] = timed_ms(chain)
            r['generic_device'] = trace_device(calls['generic'], LEVELS_GENERIC_KERNEL,
                                               f'spg30_{key}_generic', retake)
            r['ms'] = timed_ms(calls['new'])
            r['device'] = trace_device(calls['new'], spg_kernel(r['route'], mode == 'dB'),
                                       f'spg30_{key}_new', retake)
        table[key] = r
        print(f'{label} ({r["route"]}, {r["frames"]} frames): ' + json.dumps(
            {k: (round(v, 4) if isinstance(v, float) else v) for k, v in r.items()
             if k in ('ms', 'generic_ms', 'chain_ms', 'bound_ms', 'bound_by')})
            + ' device ms ' + json.dumps({k: r[k]['device_ms'] for k in ('device', 'generic_device')
                                          if k in r})
            + ''.join(f' {head} ' + json.dumps({k: (f'{v:.3g}' if isinstance(v, float) else v)
                                               for k, v in r[part].items()})
                      for head, part in (('vs plain', 'plain'), ('radix-2 vs plain', 'generic_vs_plain'))
                      if part in r) + f' ({smi})')
        del w
        torch.cuda.empty_cache()
    del inputs

    # ---- 30c: rows 4-5 at 64-512 points in every mode (17a's gates),
    # timed beside the radix-2 kernel and the chain
    chan_table = {}
    for size in RADIX2_SIZES:
        for name, mode in CHAN_SMALL_MODES.items():
            label = f'30c chan_stats at {size} ({name})'
            r = chan_size_check(size, mode, gen, dev, mem_rate, fp32_rate)
            require(r['route'] == 'small', f'{label}: route {r["route"]}')
            y, kw = chan_size_input(size, mode, gen, dev)
            r['generic_device'] = trace_device(
                lambda: _chan_stats_generic(y, **kw), STATS_GENERIC_KERNEL, f'chan30_{size}_{name}_generic',
                retake)
            r['device'] = trace_device(lambda: kernels.chan_stats(y, **kw), CHAN_SMALL_KERNEL,
                                       f'chan30_{size}_{name}_new', retake)
            chan_table[f'{size}_{name}'] = r
            print(f'{label}, {r["frames"]} frames: ' + json.dumps(
                {k: (round(v, 4) if isinstance(v, float) else v) for k, v in r.items()
                 if k in ('ms', 'generic_ms', 'plain_ms', 'bound_ms', 'bound_by')})
                + ' device ms ' + json.dumps({k: r[k]['device_ms'] for k in ('device', 'generic_device')
                                              if k in r}) + f' ({smi})')
            del y, kw
    for size, mode in CHAN_SMALL_HELD:
        r = chan_size_check(size, mode, gen, dev, mem_rate, fp32_rate, timed=False)
        require(r['route'] == 'small', f'30c chan_stats at {size} {mode}: route {r["route"]}')
        print(f'30c chan_stats at {size} {json.dumps(mode)}: held to the plain version and '
              'complex128 (17a\'s gates)')
    torch.cuda.empty_cache()

    # the traces that held no kernel, taken again in one fresh process
    for call, (_, device_us) in fresh_traces(retake).items():
        got = split_device(device_us)
        parts = call.split('_')
        entry = (table['_'.join(parts[1:4])] if call.startswith('spg30_')
                 else chan_table['_'.join(parts[1:3])])
        entry['device' if parts[-1] == 'new' else 'generic_device'] = dict(got, fresh=True)
        print(f'30 {call} (fresh process): device ms {got["device_ms"]}')

    # ---- 30b: power_spectral_density at fs / 256, fs / 2048, fs / 4096 and
    # the persistence fold at nfft 2048 on phase 19's capture: the new
    # kernels launched, no radix-2 body, 20d's psd_gate against the CPU
    paths, spg_launches = {}, {'reg': 0, 'block': 0}
    small = x[:N_PSD_CPU]
    for nfft in SPG_PSD_NFFT:
        kw = dict(fs=PSD_FS, window='hann', resolution=PSD_FS / nfft, statistics=PSD_STATS)
        psd, launched, routes = psd_launches(lambda: it.power_spectral_density(x, **kw))
        want = 'reg' if nfft <= 1024 else 'block'
        require(launched == {'spectrogram_dB': 1} and routes == {'spectrogram_dB': {want: 1}},
                f'30b psd at nfft {nfft}: launches {launched} {routes}')
        spg_launches[want] += routes.get('spectrogram_dB', {}).get(want, 0)
        lvl = float(10 * torch.log10((small.abs() ** 2).double().mean() / nfft))
        g = psd_gate(it.power_spectral_density(small, **kw),
                     it.power_spectral_density(small.cpu(), device='cpu', **kw), lvl,
                     f'30b psd at nfft {nfft} vs the CPU', nfft=nfft)
        kernel = spg_kernel(want, True)
        names, device_us = device_kernels(lambda: it.power_spectral_density(x, **kw), kernel)
        paths[f'psd{nfft}'] = {'launches': launched, 'gate': g, 'names': names,
                               'device_us': device_us, 'kernel': kernel,
                               'ms': timed_ms(lambda: it.power_spectral_density(x, **kw), reps=10)}
        print(f'30b psd at nfft {nfft}: launches {json.dumps(launched)}, routes '
              f'{json.dumps(routes)}, vs the CPU {json.dumps(g)}, '
              f'{paths[f"psd{nfft}"]["ms"]:.4f} ms a call ({smi})')
        del psd
    nfft = SPG_FOLD_NFFT
    fkw = dict(fs=PSD_FS, window='hann', nfft=nfft, chunk_frames=n // 4 // nfft,
               hist_bins=SPG_HIST_BINS, quantiles=[0.5, 0.99])
    fold, launched, routes = psd_launches(lambda: it.streaming_persistence_spectrum(x, **fkw))
    require(launched.get('spectrogram_levels') == 4 and routes['spectrogram_levels'] == {'block': 4}
            and 'spectrogram_dB' not in launched,
            f'30b fold at nfft {nfft}: launches {launched} {routes}')
    spg_launches['block'] += routes.get('spectrogram_levels', {}).get('block', 0)
    small_kw = dict(fkw, chunk_frames=N_PSD_CPU // 2 // nfft)
    card = it.streaming_persistence_spectrum(small, **small_kw)
    cpu = it.streaming_persistence_spectrum(small.cpu(), device='cpu', **small_kw)
    lvl = float(10 * torch.log10((small.abs() ** 2).double().mean() / nfft))
    g = {k: psd_gate(card[k], cpu[k], lvl, f'30b fold at {nfft} {k} vs the CPU', nfft=nfft)
         for k in ('mean_dB', 'max_dB')}
    drift = int((card['hist'].cpu().long().cumsum(1) - cpu['hist'].long().cumsum(1)).abs().max())
    require(drift <= 2, f'30b fold at {nfft}: cumulative counts {drift} from the CPU\'s')
    names, device_us = device_kernels(lambda: it.streaming_persistence_spectrum(x, **fkw),
                                      BLOCK_KERNEL)
    paths[f'fold{nfft}'] = {'launches': launched, 'gate': g, 'hist_drift': drift, 'names': names,
                            'device_us': device_us, 'kernel': BLOCK_KERNEL}
    print(f'30b fold at nfft {nfft}: launches {json.dumps(launched)}, routes {json.dumps(routes)}, '
          f'vs the CPU {json.dumps(g)}, cumulative counts within {drift}')
    del fold, card, cpu
    # each path's profile must hold its kernel and no radix-2 body; the
    # traces that did not hold the kernel are retaken in a fresh process
    retake = [f'spgpath_{key}' for key, p in paths.items()
              if not any(p['kernel'] in k for k in p['names'])]
    for call, got in fresh_traces(retake).items():
        key = call.removeprefix('spgpath_')
        paths[key]['names'], paths[key]['device_us'] = got
    for key, p in paths.items():
        require(any(p['kernel'] in k for k in p['names']), f'30b {key}: profiler shows no {p["kernel"]}')
        old = [k for k in p['names'] if LEVELS_GENERIC_KERNEL in k]
        require(not old, f'30b {key}: the radix-2 body ran: {old}')
        bad = library_kernels(p['names'])
        require(not bad, f'30b {key}: library kernels: {bad}')
    require(spg_launches['block'] >= 1 and spg_launches['reg'] >= 1,
            f'30b: a kernel of the path launched no time: {spg_launches}')

    # ---- 30c (the path): the monitor step whose channelizer frame is 256
    # points, phase 3's gates against reference_step (the psd 26d's)
    rates, extra = SMALL_MONITOR
    mon = it.WidebandMonitor(it.design_wideband_monitor(*rates, **extra))
    nb = mon.chan_kwargs['nfft_big']
    require(nb in RADIX2_SIZES and mon.routes['chan'] == 'small',
            f'30c small monitor: {nb} points, routes {mon.routes}')
    m = mon.min_input_multiple()
    xs = torch.randn(max(1, N_STEP // m) * m, dtype=torch.complex64, device=dev, generator=gen)
    mon.step(xs[:m])
    torch.cuda.synchronize()
    reset_counts()
    out = mon.step(xs)
    torch.cuda.synchronize()
    launched = {k: v.launches for k, v in kset.items() if v.launches}
    chan_routes = dict(kernels.chan_stats.route_launches)
    require(launched.get('chan_stats') == 1 and chan_routes == dict(CHAN_NO_ROUTE, small=1),
            f'30c small monitor: launches {launched}, routes {chan_routes}')
    ref = mon.reference_step(xs)
    check_step(out, ref, '30c small monitor vs reference_step', psd=False)
    psd_err = wide_psd_check(mon, xs, out, ref, '30c small monitor')
    names, device_us = device_kernels(lambda: mon.step(xs), CHAN_SMALL_KERNEL)
    if not any(CHAN_SMALL_KERNEL in k for k in names):
        names, device_us = fresh_traces(['smallstep']).get('smallstep', (names, device_us))
    require(any(CHAN_SMALL_KERNEL in k for k in names), '30c small monitor: profiler shows no '
            f'{CHAN_SMALL_KERNEL}')
    old = [k for k in names if STATS_GENERIC_KERNEL in k]
    require(not old, f'30c small monitor: the radix-2 kernel ran: {old}')
    step_ms = timed_ms(lambda: mon.step(xs), reps=10)
    step = {'samples': xs.numel(), 'launches': launched, 'psd_errors_db': psd_err,
            'step_ms': step_ms, 'plain_step_ms': timed_ms(lambda: mon.reference_step(xs), reps=5,
                                                            warmup=1),
            'chan_device_ms': sum(us for k, us in device_us.items() if 'chan_' in k) / 1e3}
    print(f'30c small monitor ({nb}-point channelizer frames): launches {json.dumps(launched)}; '
          f'within phase 3\'s gates (the psd 26d\'s); step {step_ms:.4f} ms for {xs.numel()} '
          f'samples, the plain step {step["plain_step_ms"]:.4f} ms ({smi})')
    y = mon._step_ola(xs)  # the step's resampled stream
    ckw = dict(mon.chan_kwargs)
    del out, ref, xs

    # ---- the kernels line's rows, each at its path's shapes
    rows = []
    for name, nfft in (('spectrogram_block', 2048), ('spectrogram_db_small', 256)):
        w, _ = spg_window(nfft, dev)
        got, ref = kernels.spectrogram_dB(x, w, nfft), kernels.spectrogram_dB_plain(x, w, nfft)
        row = kernel_row(
            name, {'launches': spg_launches['block' if nfft > 1024 else 'reg'],
                   'max_abs_err': max_abs(got, ref)},
            12 * n + 8 * nfft, (n // nfft) * (fft_ops(nfft) + 12 * nfft),
            lambda: kernels.spectrogram_dB(x, w, nfft), lambda: kernels.spectrogram_dB_plain(x, w, nfft),
            lambda: kernels.spectrogram_dB_plain(x, w, nfft), mem_rate, fp32_rate)
        row.update(path=f'power_spectral_density at fs / {nfft} on {n} samples (its row 9 call); '
                        'launches: 30b\'s PSD and fold calls',
                   generic_ms=table[f'dB_{nfft}_0']['generic_ms'], ptxas=ptxas[
                       BLOCK_KERNEL if nfft > 1024 else DB_REG_KERNEL],
                   sizes={k: v for k, v in table.items()
                          if (int(k.split('_')[1]) > 1024) == (nfft > 1024)},
                   paths={k: {kk: vv for kk, vv in p.items() if kk not in ('names',)}
                          for k, p in paths.items()})
        rows.append(row)
        print(f'{name}: {row["ms"]:.4f} ms (bound {row["bound_ms"]:.4f} ms by {row["bound_by"]}, '
              f'plain / torch.fft chain {row["plain_ms"]:.4f} ms, the radix-2 body '
              f'{row["generic_ms"]:.4f} ms) ({smi})')
        del got, ref
    cs, ref = kernels.chan_stats(y, **ckw), kernels.chan_stats_plain(y, **ckw)
    for k in ref:
        require(rel_rms(cs[k], ref[k]) <= 1e-5, f'30 chan_stats_small {k} on the monitor stream')
    row = kernel_row(
        'chan_stats_small',
        {'launches': chan_routes['small'], 'max_abs_err': max(max_abs(cs[k], ref[k]) for k in ref)},
        8 * y.numel() + 8 * nb + 4 * sum(v.numel() for v in cs.values()),
        (y.shape[-1] // nb) * (fft_ops(nb) + 12 * nb),
        lambda: kernels.chan_stats(y, **ckw), lambda: kernels.chan_stats_plain(y, **ckw),
        lambda: kernels.chan_stats_plain(y, **ckw), mem_rate, fp32_rate)
    row.update(path=f'WidebandMonitor.step at the small blackman design ({nb}-point frames, '
                    f'{ckw["channel_count"]} channels), the launch of 30c\'s step',
               generic_ms=timed_ms(lambda: _chan_stats_generic(y, **ckw)), step=step,
               sizes=chan_table, ptxas=ptxas[CHAN_SMALL_KERNEL])
    rows.append(row)
    print(f'chan_stats_small at {nb}: {row["ms"]:.4f} ms (bound {row["bound_ms"]:.4f} ms by '
          f'{row["bound_by"]}, plain / torch.fft chain {row["plain_ms"]:.4f} ms, the radix-2 '
          f'kernel {row["generic_ms"]:.4f} ms) ({smi})')
    print(f'phase 30: {time.perf_counter() - t_phase:.1f} s, peak device memory '
          f'{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB')
    return rows


# ---- phase 31: rows 2-3 at every frame size the JAX OLA kernel takes up
# to 2^21 points: a prime radix above 7 as a pass of the run-time plan
# kernels (csrc/fft_plan.cuh pass_prime) and split parts on run-time plans
# (csrc/ola_split.cu split_plan_passes_kernel)

# 31a: each new route's kernel on N_PRIME_FRAMES frames (the largest on
# N_PRIME_BIG_FRAMES) against the plain chain and complex128: the plan
# kernel (1408 = 11 x 128, 2816, 4224 = 33 x 128, an output of one prime
# pass: 1408 -> 11), the two-block plan kernel (16768 = 131 x 128, 16896 ->
# 8448 = 2^8 3 11), split parts on run-time plans (38400 = 3 x 12800,
# 69120 = 5 x 13824, 41250 = 3 x 13750 -> 25344 = 2 x 12672, and 2096768 =
# 128 x 16381 -> 16 x 16381, one prime pass a part, the largest prime)
PRIME_PAIRS = {(1408, 704): 'plan', (1408, 176): 'plan', (2816, 1408): 'plan',
               (4224, 2112): 'plan', (1408, 11): 'plan', (16768, 8384): 'plan_cluster',
               (16896, 8448): 'plan_cluster', (76800, 38400): 'split', (69120, 69120): 'split',
               (41250, 25344): 'split', (2096768, 262096): 'split'}
PRIME_BIG = (2096768, 262096)
N_PRIME_FRAMES = 64
N_PRIME_BIG_FRAMES = 2
PRIME_FRAME_REPS = 5
# the plane instances at the two-block pair of 31b, and the 2:1 routes
# with a halo and the tail
PRIME_TIER_PAIR = (16896, 8448)
PRIME_ADD_PAIRS = ((2816, 1408), (16768, 8384), (76800, 38400))
# 31b: ola_filter on BASELINE #2's capture length, cut to whole input
# hops: 135.168 MS/s in 8 kHz bins to 67.584 MS/s, and 76.8 MS/s in
# 1 kHz bins to 38.4 MS/s
PRIME_FILTERS = {
    'ola_filter_16896': dict(fs=135.168e6, nfft=16896, nfft_out=8448, window='hamming',
                             passband=(-27e6, 27e6)),
    'ola_filter_76800': dict(fs=76.8e6, nfft=76800, nfft_out=38400, window='hamming',
                             passband=(-15e6, 15e6)),
}
# 31c: the monitor at 100 -> 61.44 MS/s (a USRP X310 / N310 rate to an
# LTE / NR sample rate), steps near 2^24 samples
PRIME_MONITOR_RATES = (100e6, 61.44e6)
PRIME_STEPS = {'hamming': ((13750, 8448), 'plan+add'), 'blackman': ((41250, 25344), 'split')}
PRIME_SPLIT_KERNEL = 'split_plan_passes_kernel'
KERNEL_INFO.update({
    # the plan kernel at sizes with a prime above 7 (the 2:1 route 'plan+add'
    # of the hamming monitor at 100 -> 61.44 MS/s, 13750 -> 8448)
    'fused_ola_frames_plan_prime': ('iqwaveform_torch/csrc/fft_plan.cuh',
                                    'iqwaveform_tpu/ops/pallas/fused_ola_pallas.py:571'),
    # the two-block plan kernel there (ola_filter at 16896 -> 8448)
    'fused_ola_frames_plan_cluster_prime': ('iqwaveform_torch/csrc/fft_plan.cuh',
                                            'iqwaveform_tpu/ops/pallas/fused_ola_pallas.py:394'),
    # the split route with parts on run-time plans (ola_filter at 76800 ->
    # 38400; the blackman monitor at 41250 -> 25344)
    'fused_ola_frames_split_plan': ('iqwaveform_torch/csrc/ola_split.cu',
                                    'iqwaveform_tpu/ops/pallas/fused_ola_pallas.py:394'),
    # the largest prime part: 2096768 = 128 x 16381 -> 16 x 16381
    'fused_ola_frames_split_prime16381': ('iqwaveform_torch/csrc/ola_split.cu',
                                          'iqwaveform_tpu/ops/pallas/fused_ola_pallas.py:394'),
})


def prime_frames_bound(n1: int, n2: int, frames: int, samples: int, mem_rate: float,
                       fp32_rate: float) -> tuple:
    """(bound ms, 'bytes' or 'operations') of ``frames`` frames of a pair
    read from ``samples`` complex64 samples: each sample read once, each
    output written once, the windows; 5 n log2 n a transform and the
    windows' and trim's products."""
    t_bytes = (8 * (samples + frames * n2) + 8 * (n1 + n2)) / mem_rate * 1e3
    t_ops = frames * (fft_ops(n1) + fft_ops(n2) + 6 * (n1 + n2)) / fp32_rate * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def prime_route_kernel(route: str) -> str:
    """the device kernel that shows a frame route of this phase: the
    one-block or two-block plan kernel, or the split route's run-time
    passes."""
    return PRIME_SPLIT_KERNEL if route.startswith('split') else route_kernel(route)


def prime_input(name: str, gen, dev) -> tuple:
    """31b's or 31c's call ``name`` ('ola_filter_<nfft>' of PRIME_FILTERS,
    'step_<window>' of PRIME_STEPS) at its shapes: (the call, its route,
    its input, the monitor or None)."""
    import iqwaveform_torch as it
    from iqwaveform_torch.ops.kernels.fused_ola import frames_route

    if name in PRIME_FILTERS:
        okw = PRIME_FILTERS[name]
        hop = okw['nfft'] // 2
        x = torch.randn((N_OLA // hop) * hop, dtype=torch.complex64, device=dev, generator=gen)
        return (lambda: it.ola_filter(x, **okw)), frames_route(okw['nfft'], okw['nfft_out']), x, None
    window = name.removeprefix('step_')
    mon = it.WidebandMonitor(it.design_wideband_monitor(*PRIME_MONITOR_RATES, window=window))
    x = plan_step_input(mon, gen, dev)
    return (lambda: mon.step(x)), mon.routes['ola'], x, mon


def prime_trace(name: str, gen, dev) -> tuple:
    """``--trace prime_<call>``: (31b's or 31c's call, the kernel its
    profile must show)."""
    fn, route, _, _ = prime_input(name.removeprefix('prime_'), gen, dev)
    return fn, (prime_route_kernel(route),)


def prime_phases(dev, smi: str, mem_rate: float, fp32_rate: float) -> list:
    """phase 31; returns the kernels line's rows of the new routes."""
    import iqwaveform_torch as it
    from iqwaveform_torch.ops import filtering as TF
    from iqwaveform_torch.ops import kernels
    from iqwaveform_torch.ops.kernels import _build
    from iqwaveform_torch.ops.kernels.fused_ola import (
        frames_route,
        ola_grouped,
        ola_route,
        split_part_on_plan,
        split_plan,
    )

    t_phase = time.perf_counter()
    kset = {k.__name__: k for k in kernels.KERNELS}
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    frames_k, strided = kernels.fused_ola_frames, kernels.fused_ola_strided
    torch.cuda.reset_peak_memory_stats(dev)

    # ---- 31d: ptxas's registers and spills of the kernels that run the
    # prime pass: none may spill
    report = _build.ptxas_report()
    ptxas = {k: kernel_ptxas(report, k) for k in (
        PLAN_KERNEL, PLAN_CLUSTER_KERNEL, PRIME_SPLIT_KERNEL)}
    print(f'31d ptxas: {json.dumps(ptxas)}')
    spilled = {k: i for k, v in ptxas.items() for i, p in v.items()
               if p['spill_stores'] or p['spill_loads']}
    require(len(ptxas[PLAN_KERNEL]) == 4 and len(ptxas[PLAN_CLUSTER_KERNEL]) == 8
            and len(ptxas[PRIME_SPLIT_KERNEL]) == 2 and not spilled,
            f'31d: an instance spills or is missing: {spilled} {ptxas}')

    # ---- 31a: each new route's kernel against the plain chain and
    # complex128, route and launch counts, frames timed beside the chain
    pairs = {}
    for pair, want in PRIME_PAIRS.items():
        n1, n2 = pair
        route = frames_route(n1, n2)
        require(route == want, f'31a {pair}: frames_route {route}, not {want}')
        n_fr = N_PRIME_BIG_FRAMES if pair == PRIME_BIG else N_PRIME_FRAMES
        kw = tier_kwargs(n1, n2, gen, dev)
        hop = n1 // 2
        capture = torch.randn(n_fr * hop + n1, dtype=torch.complex64, device=dev, generator=gen)
        frames = capture.unfold(-1, n1, hop)[:n_fr]
        reset_counts()
        got = frames_k(frames, **kw)
        torch.cuda.synchronize()
        launched = {k: c.launches for k, c in kset.items() if c.launches}
        require(launched == {'fused_ola_frames': 1}
                and frames_k.route_launches == frame_routes(**{route: 1}),
                f'31a {pair}: launches {launched}, routes {frames_k.route_launches}')
        ref = kernels.fused_ola_frames_plain(frames, **kw)
        ref64 = kernels.fused_ola_frames_plain(frames.to(torch.complex128), **_wide_kw(kw))
        err, err64, plain64 = rel_rms(got, ref), rel_rms(got, ref64), rel_rms(ref, ref64)
        require(err <= 1e-5, f'31a {pair}: relative RMS {err:.3g}')
        require(err64 <= 2 * plain64,
                f'31a {pair}: complex128 error {err64:.4g} > 2 x the plain chain\'s {plain64:.4g}')
        kernel_fn = lambda fr=frames, kw=kw: frames_k(fr, **kw)  # noqa: E731
        chain_fn = lambda fr=frames, kw=kw: kernels.fused_ola_frames_plain(fr, **kw)  # noqa: E731
        ms, chain_ms = (timed_ms(f, reps=PRIME_FRAME_REPS, warmup=1) for f in (kernel_fn, chain_fn))
        bound, by = prime_frames_bound(n1, n2, n_fr, n_fr * hop + n1, mem_rate, fp32_rate)
        entry = {'route': route, 'frames': n_fr, 'relative_rms': err, 'f64_rel_rms': err64,
                 'plain_f64_rel_rms': plain64, 'max_abs_err': max_abs(got, ref), 'ms': ms,
                 'chain_ms': chain_ms, 'bound_ms': bound, 'bound_by': by,
                 'ms_over_bound': ms / bound}
        if route == 'split':
            entry['split'] = [list(s) for s in split_plan(n1, n2)]
            entry['run_time_parts'] = [split_part_on_plan(split_plan(n1, n2)[0][1]),
                                       split_part_on_plan(split_plan(n1, n2)[1][1], True)]
        if pair == PRIME_TIER_PAIR:
            for dtype in (torch.int16, torch.bfloat16, torch.float32):
                planes = (PLANES_SCALE * torch.stack([capture.real, capture.imag])).round().to(dtype)
                reset_counts()
                gp = frames_k(planes, hop_in=hop, **kw)
                torch.cuda.synchronize()
                rp = kernels.fused_ola_frames_plain(planes, hop_in=hop, **kw)
                e = rel_rms(gp, rp)
                layout = str(dtype).split('.')[-1]
                require(frames_k.route_launches == frame_routes(**{route: 1})
                        and frames_k.layout_launches[layout] == 1,
                        f'31a {pair} {layout}: {frames_k.route_launches} {frames_k.layout_launches}')
                require(e <= 1e-5, f'31a {pair} {layout} planes: relative RMS {e:.3g}')
                entry[layout] = {'relative_rms': e, 'ms': timed_ms(
                    lambda p=planes: frames_k(p, hop_in=hop, **kw), reps=PRIME_FRAME_REPS,
                    warmup=1)}
        if pair in PRIME_ADD_PAIRS:
            h = n1 // 2
            skw = dict(hop_in=h, **kw)
            x = torch.randn((n_fr + 1) * h, dtype=torch.complex64, device=dev, generator=gen)
            src, halo = x[:-h], x[-h:]
            add_route = ola_route(n1, n2)
            reset_counts()
            y, tail = strided(src, halo, n_frames=n_fr, **skw)
            torch.cuda.synchronize()
            launched = {k: c.launches for k, c in kset.items() if c.launches}
            require(launched == {'fused_ola_strided': 1, 'ola_add': 1}
                    and strided.route_launches == ola_routes(**{add_route: 1})
                    and add_route == route + '+add',
                    f'31a {pair} 2:1: launches {launched}, {strided.route_launches}')
            r, rt = kernels.fused_ola_strided_plain(src, halo, n_frames=n_fr, **skw)
            y64, t64 = strided_f64(src, halo, dict(skw, precision='highest'))
            both, plain = torch.cat([y, tail]), torch.cat([r, rt])
            ref64 = torch.cat([y64, t64])
            e, e64, p64 = rel_rms(both, plain), rel_rms(both, ref64), rel_rms(plain, ref64)
            require(e <= 1e-5, f'31a {pair} {add_route}: relative RMS {e:.3g}')
            require(e64 <= 2 * p64, f'31a {pair} {add_route}: complex128 error {e64:.4g} '
                                    f'> 2 x the plain\'s {p64:.4g}')
            entry[add_route] = {'relative_rms': e, 'f64_rel_rms': e64, 'plain_f64_rel_rms': p64}
        pairs[f'{n1}->{n2}'] = entry
        print(f'31a {n1} -> {n2} ({route}, {n_fr} frames): vs plain {err:.3g}, vs complex128 '
              f'{err64:.4g} (the chain {plain64:.4g}); {ms:.4f} ms, the torch.fft chain '
              f'{chain_ms:.4f} ms, bound {bound:.4f} ms by {by} ({ms / bound:.1f}x)'
              + ''.join(f'; {k} {json.dumps(entry[k])}' for k in entry
                        if k in ('int16', 'bfloat16', 'float32') or k.endswith('+add'))
              + f' ({smi})')
        del capture, frames, got, ref, ref64
        torch.cuda.empty_cache()

    # the largest prime part's row: its 31a call and times
    big = pairs[f'{PRIME_BIG[0]}->{PRIME_BIG[1]}']
    rows = [{'name': 'fused_ola_frames_split_prime16381', 'route': 'cuda',
             'source': KERNEL_INFO['fused_ola_frames_split_prime16381'][0],
             'replaces': KERNEL_INFO['fused_ola_frames_split_prime16381'][1], 'launches': 1,
             'max_abs_err': big['max_abs_err'], 'ms': big['ms'], 'plain_ms': big['chain_ms'],
             'bound_ms': big['bound_ms'], 'bound_by': big['bound_by'],
             'library_ms': big['chain_ms'], 'frames': big['frames'], 'split': big['split']}]

    # ---- 31b: ola_filter through the kernel route, the plain route and
    # the stage chain, one launch a call, at the two designs
    for rname, okw in PRIME_FILTERS.items():
        nfft, nfft_out = okw['nfft'], okw['nfft_out']
        hop = nfft // 2
        call, route, x, _ = prime_input(rname, gen, dev)
        n = x.numel()
        it.ola_filter(x[: 4 * nfft], **okw)
        torch.cuda.synchronize()
        reset_counts()
        y = it.ola_filter(x, **okw)
        torch.cuda.synchronize()
        launched = {k: c.launches for k, c in kset.items() if c.launches}
        require(launched == {'fused_ola_frames': 1}
                and frames_k.route_launches == frame_routes(**{route: 1}),
                f'31b {rname}: launches {launched}, routes {frames_k.route_launches}')
        route_count = frames_k.route_launches[route]
        ref = it.ola_filter(x, **okw, plain=True)
        require(y.shape == ref.shape == (n * nfft_out // nfft,)
                and bool(torch.isfinite(torch.view_as_real(y)).all()),
                f'31b {rname}: shape {tuple(y.shape)} or not finite')
        # a prefix of whole output overlaps whose frames cover the first
        # N_OLA_CHAIN output samples
        o = nfft_out // 2
        n_pre = -(-(N_OLA_CHAIN * nfft // nfft_out + 2 * nfft) // o) * o
        chain = it.ola_filter(x[:n_pre], **okw, fft_backend='xla')
        err_route, err_chain = rel_rms(y, ref), rel_rms(y[:N_OLA_CHAIN], chain[:N_OLA_CHAIN])
        require(err_route <= 1e-5 and err_chain <= 1e-5,
                f'31b {rname}: vs plain {err_route:.3g}, vs the stage chain {err_chain:.3g}')
        del ref, chain
        call_ms = {k: timed_ms(lambda kk=kk: it.ola_filter(x, **okw, **kk), reps=FILTER_REPS,
                               warmup=1)
                   for k, kk in (('kernel', {}), ('plain', {'plain': True}),
                                 ('chain', {'fft_backend': 'xla'}))}
        kernel = prime_route_kernel(route)
        names, device_us = device_kernels(call, kernel, fresh=f'prime_{rname}')
        require(any(kernel in k for k in names) and not library_kernels(names),
                f'31b {rname}: the profile lacks {kernel} or holds library kernels: {names}')
        busy = sum(device_us.values()) / 1e3
        # the frame kernel alone on this call's frames, with its bound
        enbw = it.equivalent_noise_bandwidth('hamming', nfft_out, fftbins=False)
        zero_lo, zero_hi, b_in, b_out = TF._ola_bin_bounds(
            nfft, nfft_out, okw['fs'], okw['passband'], enbw, True)
        w_in, w_out = TF._ola_windows('hamming', nfft, nfft_out, hop, dev)
        fkw = dict(w_in=w_in, w_shift_out=w_out, nfft=nfft, nfft_out=nfft_out, zero_lo=zero_lo,
                   zero_hi=zero_hi, bounds_in=b_in, bounds_out=b_out)
        frames = x.unfold(-1, nfft, hop)
        got_f, ref_f = frames_k(frames, **fkw), kernels.fused_ola_frames_plain(frames, **fkw)
        err_f = rel_rms(got_f, ref_f)
        require(err_f <= 1e-5, f'31b {rname} frames: relative RMS {err_f:.3g}')
        n_fr = frames.shape[0]
        kname = ('fused_ola_frames_plan_cluster_prime' if route == 'plan_cluster'
                 else 'fused_ola_frames_split_plan')
        row = kernel_row(kname, {'launches': route_count,
                                 'max_abs_err': max_abs(got_f, ref_f)},
                         8 * x.numel() + 8 * got_f.numel() + 8 * (nfft + nfft_out),
                         n_fr * (fft_ops(nfft) + fft_ops(nfft_out) + 6 * (nfft + nfft_out)),
                         lambda: frames_k(frames, **fkw),
                         lambda: kernels.fused_ola_frames_plain(frames, **fkw),
                         lambda: kernels.fused_ola_frames_plain(frames, **fkw),
                         mem_rate, fp32_rate, reps=FILTER_REPS, warmup=1)
        row.update(pair=f'{nfft}->{nfft_out}', frames_route=route, frames=n_fr,
                   relative_rms=err_f, path=f'ola_filter {okw["fs"] / 1e6:g} MS/s, {n} samples',
                   path_ms=call_ms, path_device_us=device_us,
                   path_idle_share=max(0.0, 1 - busy / call_ms['kernel']),
                   path_vs_plain=err_route, path_vs_chain=err_chain,
                   split=[list(s) for s in split_plan(nfft, nfft_out)] if route == 'split' else None)
        rows.append(row)
        print(f'31b {rname} ({n} samples, {nfft} -> {nfft_out}, route {route}): vs plain '
              f'{err_route:.3g}, vs the stage chain {err_chain:.3g}; ola_filter '
              f'{json.dumps(call_ms)} ms ({n / call_ms["kernel"] / 1e3:.1f} MS/s through the '
              f'kernel), device busy {busy:.4f} ms; the frames alone {row["ms"]:.4f} ms (bound '
              f'{row["bound_ms"]:.4f} ms by {row["bound_by"]}, plain / torch.fft chain '
              f'{row["plain_ms"]:.4f} ms) ({smi})')
        del x, y, frames, got_f, ref_f
        torch.cuda.empty_cache()

    # ---- 31c: the monitor at 100 -> 61.44 MS/s, hamming ('plan+add') and
    # blackman ('split' and the grouped overlap-add), near 2^24 samples
    steps = {}
    for window, (pair, want) in PRIME_STEPS.items():
        call, route, x, mon = prime_input(f'step_{window}', gen, dev)
        d = mon.design
        require((d.nfft, d.nfft_out) == pair and route == want,
                f'31c {window}: {d.nfft} -> {d.nfft_out}, routes {mon.routes}')
        mon.step(x[: mon.min_input_multiple()])
        torch.cuda.synchronize()
        reset_counts()
        out = mon.step(x)
        torch.cuda.synchronize()
        launched = {k: c.launches for k, c in kset.items() if c.launches}
        if route.endswith('+add'):
            ok = (launched.get('fused_ola') == 1 and launched.get('ola_add') == 1
                  and kernels.fused_ola.route_launches == ola_routes(**{route: 1}))
        else:
            ok = (launched.get('fused_ola_frames') == 1
                  and frames_k.route_launches == frame_routes(**{route: 1}))
        require(ok, f'31c {window}: launches {launched}, fused_ola '
                    f'{kernels.fused_ola.route_launches}, frames {frames_k.route_launches}')
        route_count = (kernels.fused_ola.route_launches[route] if route.endswith('+add')
                       else frames_k.route_launches[route])
        check_step(out, mon.reference_step(x), f'31c {window} vs reference_step')
        if mon._strided:
            plain_ola = lambda: kernels.fused_ola_plain(x, **mon.ola_kwargs)  # noqa: E731
        else:
            plain_ola = lambda: ola_grouped(  # noqa: E731
                x, frames_fn=kernels.fused_ola_frames_plain, **mon.ola_kwargs)
        plain_step = lambda: mon._outputs(plain_ola(), mon._chan, mon._counts)  # noqa: E731
        check_step(plain_step(), out, f'31c {window} through the plain route vs the step')
        step_ms = timed_ms(lambda: mon.step(x), reps=10)
        plain_step_ms = timed_ms(plain_step, reps=10)
        kernel = prime_route_kernel(route)
        names, device_us = device_kernels(call, kernel, fresh=f'prime_step_{window}')
        require(any(kernel in k for k in names) and not library_kernels(names),
                f'31c {window}: the profile lacks {kernel} or holds library kernels: {names}')
        busy = sum(device_us.values()) / 1e3
        steps[window] = {'pair': f'{pair[0]}->{pair[1]}', 'route': route, 'samples': x.numel(),
                         'launches': launched, 'route_launches': route_count, 'step_ms': step_ms,
                         'plain_route_step_ms': plain_step_ms, 'device_us': device_us,
                         'kernel_device_ms': named_ms(device_us, kernel),
                         'idle_share': max(0.0, 1 - busy / step_ms)}
        print(f'31c {window} ({pair[0]} -> {pair[1]}, {x.numel()} samples, route {route}): '
              f'launches {json.dumps(launched)}; within the step gates of reference_step; '
              f'{step_ms:.4f} ms a step, through the plain route {plain_step_ms:.4f} ms; {kernel} '
              f'{steps[window]["kernel_device_ms"]:.4f} ms of device time; idle share '
              f'{steps[window]["idle_share"]:.3f} ({smi})')
        if window == 'hamming':
            # the plan kernel's row: the 2:1 route on this step's samples
            okw = mon.ola_kwargs
            y, y_plain = kernels.fused_ola(x, **okw), kernels.fused_ola_plain(x, **okw)
            e = rel_rms(y, y_plain)
            require(e <= 1e-5, f'31c {window} fused_ola: relative RMS {e:.3g}')
            n_fr = x.numel() // mon.hop_in
            row = kernel_row('fused_ola_frames_plan_prime',
                             {'launches': route_count,
                              'max_abs_err': max_abs(y, y_plain)},
                             8 * (x.numel() + y.numel()) + 8 * (pair[0] + pair[1]),
                             n_fr * (fft_ops(pair[0]) + fft_ops(pair[1]) + 6 * sum(pair)),
                             lambda: kernels.fused_ola(x, **okw),
                             lambda: kernels.fused_ola_plain(x, **okw),
                             lambda: kernels.fused_ola_plain(x, **okw), mem_rate, fp32_rate)
            row.update(pair=steps[window]['pair'], ola_route=route, frames=n_fr,
                       relative_rms=e, path='WidebandMonitor.step, hamming 100 -> 61.44 MS/s',
                       pairs=pairs, ptxas=ptxas)
            rows.append(row)
            print(f'31c fused_ola at {pair[0]} -> {pair[1]} ({route}): {row["ms"]:.4f} ms (bound '
                  f'{row["bound_ms"]:.4f} ms by {row["bound_by"]}, plain / torch.fft chain '
                  f'{row["plain_ms"]:.4f} ms) ({smi})')
            del y, y_plain
        del mon, x, out
        torch.cuda.empty_cache()
    split_row = next(r for r in rows if r['name'] == 'fused_ola_frames_split_plan')
    split_row['launches'] += steps['blackman']['route_launches']
    split_row['monitor_steps'] = steps
    print(f'phase 31: {time.perf_counter() - t_phase:.1f} s, peak device memory '
          f'{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB')
    return rows


MULTI_TIMEOUT_S = 120  # a collective that waits longer fails the rank


def _multi_rank(rank: int, world: int, store: str, results) -> None:
    """one rank of ``--ranks``: the flagship and blackman (C = 3)
    ``sharded_step`` on this rank's 2^24 samples of a world x 2^24 capture
    made on every card from SEED, held (on rank 0) to phase 3's gates
    against ``step`` on the whole capture, its collectives counted and
    timed; the exact ``sharded_psd_stats`` on phase 19's capture split over
    the ranks, ``torch.equal`` to ``_quantile`` of the whole capture's dB
    on rank 0; ``sharded_apd_histogram`` equal to the whole capture's
    counts."""
    import datetime

    import torch.distributed as dist

    import iqwaveform_torch as it
    from iqwaveform_torch import parallel
    from iqwaveform_torch.ops import kernels
    from iqwaveform_torch.ops.power import _quantile, histogram_edge_counts
    from iqwaveform_torch.parallel import _collectives
    from iqwaveform_torch.parallel.mesh import gather_time_axis, mesh_device

    out = {'rank': rank}
    try:
        torch.cuda.set_device(rank)
        dist.init_process_group('nccl', init_method=f'file://{store}', rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=MULTI_TIMEOUT_S))
        mesh = parallel.time_mesh()
        dev = mesh_device(mesh)
        require(dev == torch.device('cuda', rank), f'rank {rank} on {dev}')
        gen = torch.Generator(device=dev).manual_seed(SEED)
        x = torch.randn((1, world * N_STEP), dtype=torch.complex64, device=dev, generator=gen)
        shard = x[:, rank * N_STEP : (rank + 1) * N_STEP].contiguous()
        for name, kw in (('flagship', FLAGSHIP), ('blackman_c3', CLUSTER_MONITOR)):
            design = it.design_wideband_monitor(122.88e6, 61.44e6, **kw)
            mon = it.WidebandMonitor(design, mesh=mesh)
            reset_counts()
            _collectives.reset_calls()
            got = mon.sharded_step(shard)
            torch.cuda.synchronize()
            calls = dict(_collectives.calls)
            launched = {k.__name__: k.launches for k in kernels.KERNELS if k.launches}
            require(calls == {'halo': 1, 'tail': 1, 'all_reduce': 3, 'all_gather': 0},
                    f'{name}: collectives {calls}')
            cp = gather_time_axis(got['channel_power'][0], mesh)
            if rank == 0:
                ref = it.WidebandMonitor(design).step(x)
                check_step({**got, 'channel_power': cp[None]}, ref,
                           f'{name}: {world} ranks vs step on the whole capture')
            ms = timed_ms(lambda: mon.sharded_step(shard))
            out[name] = {'ms': ms, 'launches': launched, 'collectives': calls}
            del got, cp, mon
        del x, shard
        torch.cuda.empty_cache()

        nfft = PSD_NFFT
        xp = psd_capture(dev)
        s = N_PSD // world
        local = xp[rank * s : (rank + 1) * s].contiguous()
        qs = tuple(v for v in PSD_STATS if isinstance(v, float))
        stats, hist, _ = parallel.sharded_psd_stats(local, mesh=mesh, fs=PSD_FS, window='hann',
                                                   nperseg=nfft, statistics=PSD_STATS,
                                                   exact_quantiles=True)
        if rank == 0:
            w = torch.from_numpy(it.get_window('hann', nfft, xp=np, dtype='complex64', norm=True,
                                               fftshift=True) / nfft).to(torch.complex64).to(dev)
            dB = kernels.spectrogram_dB(xp, w, nfft)
            require(torch.equal(stats[2:], _quantile(dB, np.asarray(qs, dtype='float32'), axis=0)),
                    'exact quantiles differ from _quantile of the whole capture\'s dB')
            require(torch.equal(stats[1], dB.amax(dim=0)), 'max differs from the whole dB\'s')
            require(int(hist.sum()) == N_PSD // nfft * nfft, 'histogram total')
        out['psd_exact_ms'] = timed_ms(lambda: parallel.sharded_psd_stats(
            local, mesh=mesh, fs=PSD_FS, window='hann', nperseg=nfft, statistics=PSD_STATS,
            exact_quantiles=True), reps=5, warmup=1)
        edges = ccdf_edges()
        counts = parallel.sharded_apd_histogram(local, mesh=mesh, edges=edges)
        if rank == 0:
            p = xp.real * xp.real + xp.imag * xp.imag
            require(torch.equal(counts.long(), histogram_edge_counts(p, edges)),
                    'sharded APD counts differ from the whole capture\'s')
        out['apd_ms'] = timed_ms(lambda: parallel.sharded_apd_histogram(local, mesh=mesh,
                                                                        edges=edges))
        out['ok'] = True
    except Exception as exc:  # reported to the parent, which fails the run
        out['error'] = f'{type(exc).__name__}: {exc}'
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        results.put(out)


def multi_card(world: int) -> int:
    """``python3 chip_smoke.py --ranks N``: the sharded layer on N NCCL
    ranks, one a card (spawned processes); prints each rank's result and,
    last, the ``{"ok": ...}`` line; nonzero where any rank failed."""
    import torch.multiprocessing as mp

    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        print(f'chip_smoke: --ranks {world} needs {world} cards', file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from iqwaveform_torch.ops.kernels import _build

    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    print(f'cards: {smi}')
    _build.library()  # build once, before the ranks load it
    store = ROOT / 'build' / f'nccl_{world}_store'
    store.parent.mkdir(parents=True, exist_ok=True)
    if store.exists():
        store.unlink()
    ctx = mp.get_context('spawn')
    results = ctx.Queue()
    procs = [ctx.Process(target=_multi_rank, args=(r, world, str(store), results))
             for r in range(world)]
    for p in procs:
        p.start()
    outs = []
    try:
        for _ in range(world):
            outs.append(results.get(timeout=600))
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    outs.sort(key=lambda o: o['rank'])
    for o in outs:
        print(json.dumps(o))
    ok = len(outs) == world and all(o.get('ok') for o in outs)
    print(json.dumps({'ok': ok, 'ranks': world, 'cards': smi}))
    return 0 if ok else 1


def main(parent: str | None = None) -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from iqwaveform_torch import WidebandMonitor, design_wideband_monitor
    from iqwaveform_torch.ops import kernels
    from iqwaveform_torch.ops.kernels import _build
    from iqwaveform_torch.ops.kernels.chan_stats import _chan_stats_generic
    from iqwaveform_torch.ops.kernels.fused_ola import _fused_ola_generic

    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f'card: {smi}')
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'python {sys.version.split()[0]}')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda')
    name = torch.cuda.get_device_name(0)
    mem_rate, fp32_rate = card_rates(name)

    t0 = time.perf_counter()
    _build.library()
    print(f'build: {time.perf_counter() - t0:.1f} s')
    for line in _build.ptxas_report().splitlines():
        if ('registers' in line or 'spill' in line or line.startswith('==')
                or ('Compiling entry' in line and ('reg_kernel' in line or 'cluster_kernel' in line
                                                   or CORR_KERNEL in line or 'split_' in line))):
            print(f'ptxas: {line.strip()}')
    require_no_spill(_build.ptxas_report())

    design = design_wideband_monitor(122.88e6, 61.44e6, **FLAGSHIP)
    mon = WidebandMonitor(design)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    # complex white noise: the input the slice's psd tolerance is stated for
    x = torch.randn(N_STEP, dtype=torch.complex64, device=dev, generator=gen)

    # ---- phase 1: each kernel against its plain version, flagship shapes
    results = {}
    y = kernels.fused_ola(x, **mon.ola_kwargs)
    y_ref = kernels.fused_ola_plain(x, **mon.ola_kwargs)
    err = rel_rms(y, y_ref)
    print(f'fused_ola: {tuple(x.shape)} -> {tuple(y.shape)} relative RMS {err:.3g}')
    require(err <= 1e-5, f'fused_ola relative RMS {err:.3g} > 1e-5')
    results['fused_ola'] = {'max_abs_err': max_abs(y, y_ref)}
    err = rel_rms(y, _fused_ola_generic(x, **mon.ola_kwargs))
    print(f'fused_ola: {OLA_REG_KERNEL} vs the radix-2 {OLA_GENERIC_KERNEL}: relative RMS {err:.3g}')
    require(err <= 1e-5, f'fused_ola vs the radix-2 kernel: relative RMS {err:.3g} > 1e-5')
    ola64, ola64_generic = ola_f64(x, mon.ola_kwargs)
    print(f'fused_ola: first {N_F64_FRAMES} frames vs the complex128 plain version: relative RMS '
          f'{ola64:.4g}, radix-2 kernel {ola64_generic:.4g}')
    require(ola64 <= 2 * ola64_generic,
            f'fused_ola complex128 error {ola64:.4g} > 2 x the radix-2 kernel\'s {ola64_generic:.4g}')

    # full-band noise of the resampled stream's shape: the resampled stream
    # itself has bins the OLA zeroed, whose ln(|Y|^2 + 1e-25) is the log of
    # each FFT's own roundoff and agrees between two FFTs in no digit (the
    # step check below compares the psd in dB on the bins above -100 dB)
    y_noise = torch.randn(y.shape, dtype=torch.complex64, device=dev, generator=gen)
    cs_noise = kernels.chan_stats(y_noise, **mon.chan_kwargs)
    cs_ref = kernels.chan_stats_plain(y_noise, **mon.chan_kwargs)
    cs_generic = _chan_stats_generic(y_noise, **mon.chan_kwargs)
    worst = 0.0
    for key in cs_noise:
        err = rel_rms(cs_noise[key], cs_ref[key])
        err_generic = rel_rms(cs_noise[key], cs_generic[key])
        print(f'chan_stats {key}: {tuple(cs_noise[key].shape)} relative RMS {err:.3g}; '
              f'{STATS_REG_KERNEL} vs the radix-2 {STATS_GENERIC_KERNEL} {err_generic:.3g}')
        require(err <= 1e-5, f'chan_stats {key} relative RMS {err:.3g} > 1e-5')
        require(err_generic <= 1e-5,
                f'chan_stats {key} vs the radix-2 kernel: relative RMS {err_generic:.3g} > 1e-5')
        worst = max(worst, max_abs(cs_noise[key], cs_ref[key]))
    results['chan_stats'] = {'max_abs_err': worst}
    # the register-resident kernel (this route) and the radix-2 kernel it
    # replaces here against the plain version in complex128, first frames
    chan64, chan64_generic = {}, {}
    for key in cs_noise:
        chan64[key], chan64_generic[key] = f64_errors(
            y_noise[: N_F64_FRAMES * mon.chan_kwargs['nfft_big']], mon.chan_kwargs,
            kernels.chan_stats, _chan_stats_generic, kernels.chan_stats_plain,
            pick=lambda out, key=key: out[key])
    print(f'chan_stats: first {N_F64_FRAMES} frames vs the complex128 plain version, relative '
          f'RMS {json.dumps(chan64)}, radix-2 kernel {json.dumps(chan64_generic)}')
    for key in chan64:
        require(chan64[key] <= 2 * chan64_generic[key],
                f'chan_stats {key} complex128 error {chan64[key]:.4g} > 2 x the radix-2 '
                f'kernel\'s {chan64_generic[key]:.4g}')
    del y_noise, cs_noise, cs_generic
    cs = kernels.chan_stats(y, **mon.chan_kwargs)

    p = cs['p_binned']
    kernels.hist.route_launches.update(bucket=0, generic=0, slices=0)
    counts = kernels.hist(p, mon.apd_edges)
    hist_routes = dict(kernels.hist.route_launches)
    counts_ref = kernels.hist_plain(p, mon.apd_edges)
    diff = (counts.long() - counts_ref.long()).abs()
    print(f'hist: {tuple(p.shape)} -> {tuple(counts.shape)} L1 vs plain {int(diff.sum())}; '
          f'kernels {json.dumps(hist_routes)}')
    require(hist_routes == {'bucket': 1, 'generic': 0, 'slices': 0}, f'hist kernels {hist_routes}')
    require(int(diff.sum()) == 0, 'hist differs from sort + searchsorted')
    require(int(counts.sum()) == p.numel(), 'hist total differs from sample count')
    results['hist'] = {'max_abs_err': float(diff.max())}
    torch.cuda.synchronize()

    # ---- phase 2: the full step through the kernels
    reset_counts()
    out = mon.step(x)
    torch.cuda.synchronize()
    launched = {k.__name__: k.launches for k in kernels.KERNELS}
    for kname in MONITOR_KERNELS:
        results[kname]['launches'] = launched[kname]
        require(launched[kname] > 0, f'the step launched no {kname} kernel')
    print('launches in one step: ' + json.dumps(launched))
    routes = {'fused_ola': dict(kernels.fused_ola.route_launches),
              'chan_stats': dict(kernels.chan_stats.route_launches),
              'hist': dict(kernels.hist.route_launches)}
    print('kernels by route in one step: ' + json.dumps(routes))
    require(routes == {'fused_ola': ola_routes(reg=1), 'chan_stats': CHAN_REG_ROUTE,
                       'hist': {'bucket': 1, 'generic': 0, 'slices': 0}},
            f'the step\'s routes {routes}')

    step_kernels = (OLA_REG_KERNEL, STATS_REG_KERNEL, HIST_KERNEL)
    names, device_us = device_kernels(lambda: mon.step(x), *step_kernels)
    print('step device kernels: ' + json.dumps(names))
    for k in step_kernels:
        require(any(k in n for n in names), f'profiler shows no {k} in the step')
    old_ola = [n for n in names if OLA_GENERIC_KERNEL in n]
    require(not old_ola, f'the radix-2 OLA kernel ran in the step: {old_ola}')
    require_stats_kernel(names, 'the step')
    require_hist_kernel(names, 'the step')
    bad = [n for n in names if any(f in n.lower() for f in FORBIDDEN)]
    require(not bad, f'library FFT / GEMM kernels in the step: {bad}')

    ref = mon.reference_step(x)
    check_step(out, ref, 'step vs plain-version step')
    small = x[:N_SMALL].cpu()
    check_step(
        {k: v.cpu() for k, v in mon.step(small).items()},
        WidebandMonitor(design, device='cpu').step(small),
        'card step vs CPU step (short input)',
    )
    print('step outputs: ' + json.dumps({k: list(v.shape) for k, v in out.items()}))
    del ref, y_ref, cs_ref

    # ---- phase 3: times
    step_ms = timed_ms(lambda: mon.step(x))
    print(f'step: {step_ms:.4f} ms for {N_STEP} samples = '
          f'{N_STEP / step_ms / 1e3:.1f} MS/s ({smi})')
    busy_ms = sum(device_us.values()) / 1e3
    print('step device time by kernel (one profiled step, us): ' + json.dumps(
        dict(sorted(device_us.items(), key=lambda kv: -kv[1]))))
    print(f'step device busy: {busy_ms:.4f} ms of the {step_ms:.4f} ms step '
          f'(idle share {max(0.0, 1 - busy_ms / step_ms):.3f})')

    d = design
    n_ola_frames = N_STEP // mon.hop_in
    nb = mon.chan_kwargs['nfft_big']
    n_chan_frames = y.shape[-1] // nb

    def fft_ops(n):
        return 5 * n * math.log2(n)

    work = {
        'fused_ola': (
            8 * x.numel() + 8 * y.numel() + 8 * (d.nfft + d.nfft_out),
            n_ola_frames * (fft_ops(d.nfft) + fft_ops(d.nfft_out)
                            + 6 * (d.nfft + d.nfft_out)),
        ),
        'chan_stats': (
            8 * y.numel() + 8 * nb + 4 * sum(v.numel() for v in cs.values()),
            n_chan_frames * (fft_ops(nb) + 12 * nb),
        ),
        'hist': (
            4 * p.numel() + 4 * mon.apd_edges.numel() + 4 * counts.numel(),
            p.numel() * math.ceil(math.log2(mon.apd_edges.numel() + 1)),
        ),
    }
    calls = {
        'fused_ola': (lambda: kernels.fused_ola(x, **mon.ola_kwargs),
                      lambda: kernels.fused_ola_plain(x, **mon.ola_kwargs)),
        'chan_stats': (lambda: kernels.chan_stats(y, **mon.chan_kwargs),
                       lambda: kernels.chan_stats_plain(y, **mon.chan_kwargs)),
        'hist': (lambda: kernels.hist(p, mon.apd_edges),
                 lambda: kernels.hist_plain(p, mon.apd_edges)),
    }
    # the one PyTorch path that computes the same function, where there is
    # one: for the OLA and the channelizer statistics that is the
    # torch.fft formulation (the plain version); no single PyTorch call
    # counts fixed-edge histograms
    library = {'fused_ola': calls['fused_ola'][1],
               'chan_stats': calls['chan_stats'][1], 'hist': None}

    rows = []
    for kname, (kernel_fn, plain_fn) in calls.items():
        nbytes, nops = work[kname]
        row = kernel_row(kname, results[kname], nbytes, nops, kernel_fn, plain_fn,
                         library[kname], mem_rate, fp32_rate)
        if kname == 'fused_ola':
            row['generic_ms'] = timed_ms(lambda: _fused_ola_generic(x, **mon.ola_kwargs))
            row['f64_rel_rms'] = ola64
            row['generic_f64_rel_rms'] = ola64_generic
            print(f'fused_ola: radix-2 kernel {row["generic_ms"]:.4f} ms on {smi}')
        if kname == 'chan_stats':
            row['generic_ms'] = timed_ms(lambda: _chan_stats_generic(y, **mon.chan_kwargs))
            row['f64_rel_rms'] = chan64
            row['generic_f64_rel_rms'] = chan64_generic
            row['profiled_device_ms'] = sum(
                us for k, us in device_us.items() if STATS_REG_KERNEL in k or 'chan_fold' in k) / 1e3
            print(f'chan_stats: radix-2 kernel {row["generic_ms"]:.4f} ms; '
                  f'{row["profiled_device_ms"]:.4f} ms of device time in the profiled step, on {smi}')
        if kname == 'hist':
            row.update(hist_times(p, mon.apd_edges, device_ms(device_us, HIST_KERNEL)))
            print(f'hist: {row["profiled_device_ms"]:.4f} ms of device time in the profiled step; '
                  f'the older {HIST_GENERIC_KERNEL} {row["generic_ms"]:.4f} ms, '
                  f'{row["generic_profiled_device_ms"]:.4f} ms of device time alone; host time a '
                  f'call {row["host_ms"]:.4f} ms, the older wrapper {row["generic_host_ms"]:.4f} '
                  f'ms, on {smi}')
        rows.append(row)
        print(f'{kname}: {row["ms"]:.4f} ms (bound {row["bound_ms"]:.4f} ms by '
              f'{row["bound_by"]}, plain {row["plain_ms"]:.4f} ms) on {smi}')
    del x, y, cs, p, counts, out, mon
    torch.cuda.empty_cache()

    # ---- phases 4-7: the streaming persistence spectrum + APD
    rows = merge_rows(rows, persistence_phases(dev, smi, mem_rate, fp32_rate))

    # ---- phases 8-10: the filtering path and the monitor beyond 2:1
    filter_rows, hist_blackman = filtering_phases(dev, smi, mem_rate, fp32_rate)
    rows = merge_rows(rows, filter_rows)
    next(r for r in rows if r['name'] == 'hist')['monitor_blackman'] = hist_blackman

    # ---- phases 11-15: the OFDM path and channelize_power
    rows = merge_rows(rows, ofdm_phases(dev, smi, mem_rate, fp32_rate, parent))

    # ---- phase 16: the monitor at frames above one block (cluster kernel)
    rows = merge_rows(rows, cluster_phases(dev, smi, mem_rate, fp32_rate))

    # ---- phase 17: the channelizer at the frame sizes of CHAN_SIZES
    rows = merge_rows(rows, channelizer_phases(dev, smi, mem_rate, fp32_rate))

    # ---- phase 18: the long-capture path on row 1's full contract
    rows = merge_rows(rows, stream_phases(dev, smi, mem_rate, fp32_rate))

    # ---- phase 19: BASELINE config #1 (spectrogram, envelope power, PSD):
    # rows 6-10 gain this path's launches and times beside their own
    baseline1 = psd_phases(dev, smi, mem_rate, fp32_rate)
    for row in rows:
        if row['name'] in baseline1:
            row['baseline1'] = baseline1[row['name']]

    # ---- phase 20: exact quantiles by the refinement (rows 7, 9, 10 on its
    # passes), the carry's checkpoint, the routes by shape
    refinement = refinement_phases(dev, smi)
    for row in rows:
        if row['name'] in refinement:
            row['refinement'] = refinement[row['name']]

    # ---- phase 21: the sharded layer on one NCCL rank (the kernels of rows
    # 1-3 and 5-9 through the sharded entry points and sharded_step)
    sharded = sharded_phases(dev, smi)
    for row in rows:
        if row['name'] in sharded:
            row['sharded'] = sharded[row['name']]
    missing = set(sharded) - {row['name'] for row in rows}
    require(not missing, f'phase 21 launched kernels with no row on the kernels line: {missing}')

    # ---- phase 22: the split frame route of rows 2-3 (frames above one
    # block that no cluster pair takes) and the register / cluster instances
    # of the grid's five remaining pairs
    rows = merge_rows(rows, split_phases(dev, smi, mem_rate, fp32_rate))

    # ---- phase 23: the host layer on the card, and row 3's split route
    # through ola_filter (rows 1, 5 and 6 gain the host-layer entries)
    host_rows, host_layer = host_phases(dev, smi, mem_rate, fp32_rate)
    rows = merge_rows(rows, host_rows)
    for row in rows:
        if row['name'] in host_layer:
            row['host_layer'] = host_layer[row['name']]

    # ---- phase 24: rows 2-3's storage tiers (the frame kernels' plane
    # instances, ola_filter and the monitor at 'i16' / 'bf16') and the split
    # route's radix-7 frames
    rows = merge_rows(rows, tier_phases(dev, smi, mem_rate, fp32_rate))

    # ---- phase 25: rows 4-6 at every shape the JAX kernels take (the
    # channelizer's split route, the histogram's slices and int64 rows), the
    # split frame route's prime radix steps, the 2:1 step at its tiers
    split_rows, tier_steps = rows46_phases(dev, smi, mem_rate, fp32_rate)
    rows = merge_rows(rows, split_rows)
    for row in rows:
        if row['name'] in tier_steps:
            row['monitor_step'] = tier_steps[row['name']]

    # ---- phase 26: rows 1-3 at every monitor design the JAX kernels take:
    # the 2:1 route on the frame kernels with ola_add_kernel, the split route
    # above 64 parts
    rows = merge_rows(rows, add_route_phases(dev, smi, mem_rate, fp32_rate))

    # ---- phase 27: the plan frame kernel of rows 1-3 at every one-block
    # pair the generic frame kernel and the radix-2 2:1 kernel took
    rows = merge_rows(rows, plan_phases(dev, smi, mem_rate, fp32_rate))

    # ---- phase 28: the two-block plan frame kernel of rows 1-3 at the
    # one-block pairs the plan kernel does not hold
    rows = merge_rows(rows, plan_cluster_phases(dev, smi, mem_rate, fp32_rate))

    # ---- phase 29: the channelizer's split route redesigned: the one-block
    # kernel at the split sizes one block holds, the device-memory route's
    # binned power and cross twiddles on chip
    rows = merge_rows(rows, split_block_phases(dev, smi, mem_rate, fp32_rate))

    # ---- phase 30: rows 9-10 at every nfft the JAX kernels take (the
    # frame-group and block kernels) and rows 4-5 at 64-512 points (the
    # small-frame channelizer), beside the radix-2 bodies they replace
    rows = merge_rows(rows, small_frame_phases(dev, smi, mem_rate, fp32_rate))

    # ---- phase 31: rows 2-3 at every frame size the JAX OLA kernel takes
    # up to 2^21 points: the prime pass of the run-time plan kernels, split
    # parts on run-time plans
    rows = merge_rows(rows, prime_phases(dev, smi, mem_rate, fp32_rate))

    print(json.dumps({'kernels': rows}))
    print(json.dumps({
        'ok': True,
        'device': {
            'platform': 'gpu',
            'kind': name,
            'count': torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == '__main__':
    if len(sys.argv) == 3 and sys.argv[1] == '--trace':
        sys.exit(trace_call(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == '--traces':
        sys.exit(trace_split_calls(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == '--corr-times':
        if not torch.cuda.is_available():
            sys.exit(1)
        print(json.dumps(corr_times(sys.argv[2])))
        sys.exit(0)
    if len(sys.argv) == 3 and sys.argv[1] == '--step-times':
        if not torch.cuda.is_available():
            sys.exit(1)
        print(json.dumps(step_times(sys.argv[2])))
        sys.exit(0)
    if len(sys.argv) == 3 and sys.argv[1] == '--parent':
        sys.exit(main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == '--ranks':
        sys.exit(multi_card(int(sys.argv[2])))
    if len(sys.argv) != 1:
        sys.exit(f'usage: {sys.argv[0]} [--parent DIR | --trace CALL | --corr-times DIR | '
                 '--step-times DIR | --ranks N]')
    sys.exit(main())
