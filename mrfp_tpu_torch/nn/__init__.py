"""Layers of the port: conv/pool helpers, norms, ResNet-50, DeepLabV3+ heads."""
