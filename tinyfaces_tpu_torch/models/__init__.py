"""torch.nn models of the port: ResNet backbone and detector."""
