"""Command-line tools of the port, each run as `python -m
tinyfaces_tpu_torch.tools.<name>`: template clustering, and the closed-loop
accuracy tools (train_soak, parity_run, recall_bands, e2e_accuracy,
ap_cost) that drive the port's own CLIs and grader."""
