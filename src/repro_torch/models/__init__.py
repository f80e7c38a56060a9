"""DNNs of the port: the ResNets of ``repro.models.resnet`` as ``nn.Module``s."""
