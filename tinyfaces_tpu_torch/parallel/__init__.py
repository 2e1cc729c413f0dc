"""Multi-process training and multi-card evaluation on torch.distributed:
run control (`distributed`) and devices (`mesh`)."""
