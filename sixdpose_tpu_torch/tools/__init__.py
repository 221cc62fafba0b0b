"""The SIXD tools and benchmarks of the JAX package's ``tools/``, as
modules of the port: ``python -m sixdpose_tpu_torch.tools.<name>`` with
the JAX tool's flags (and ``--device``, CUDA unless ``cpu``) and its
output files.

Each twin is a compute function on arrays and a file layer (``main``) that
reads and writes the dataset's files, so a machine without ``yaml`` and
``PIL`` can still run the compute:

- ``train_templates``: ``train_object`` renders a view sphere and trains a
  bank;
- ``detect_sixd``: ``detect_image`` serves one test image;
- ``calc_gt_stats``: ``visib_stats`` measures each ground-truth pose's
  visible fraction;
- ``eval_calc_errors``: ``image_errors`` scores the estimates of one image;
- ``eval_loc``: ``localization_scores`` matches errors to ground truth and
  gives the recall;
- ``vis_poses``: ``overlay`` blends each pose's rendered silhouette over
  a test image;
- ``bench_multiscale_multiclass``: the multi-scale sweep on
  ``synthetic.multiscale_workload``;
- ``bench_scaling``: data-parallel scaling over ``parallel``;
- ``bench_stage_breakdown``: the match frame's time by stage, as prefix
  differences, on the bench bank;
- ``bench_local_refine`` (twin of ``bench_pallas_refine``): the refine
  kernel against its plain version, exactly, and its time beside the plain
  version's, the grouped convolution's and the bound;
- ``check_poses_tless``: ``gt_overlay`` renders a T-LESS image's
  ground-truth poses over it, ``depth_diff`` maps its captured depth
  against the render (``--torch-device`` picks the card or the CPU, since
  ``--device`` is the T-LESS sensor, as in the JAX tool);
- ``tless_download``: the T-LESS archive list as a manifest, printed, or
  fetched and unpacked with checksums (standard library only).

The JAX package's ``bench.py`` has its twin one level up,
``python -m sixdpose_tpu_torch.bench``.
"""
