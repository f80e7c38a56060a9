"""Models of the port: the ResNets of ``repro.models.resnet`` and the dense
GQA transformer LM of ``repro.models.transformer`` as ``nn.Module``s."""
