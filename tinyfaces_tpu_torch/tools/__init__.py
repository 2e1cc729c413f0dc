"""Command-line tools of the port, each run as `python -m
tinyfaces_tpu_torch.tools.<name>`: template clustering; the closed-loop
accuracy tools (train_soak, parity_run, recall_bands, e2e_accuracy,
ap_cost) that drive the port's own CLIs and grader; and the speed
instruments (train_bench, serving_bench, eval_sweep_bench, loader_bench,
pipeline_profile, jpegdct_ceiling, device_profile, profile_model,
wire_stats, h2d_probe), each a function that returns its numbers and a
`main(argv)`; prewarm_cache, which builds the native libraries ahead of a
run; and kernel_selftest, K1 against the plain assignment on a card."""
