"""The model zoo, in PyTorch: parameter trees, layers, the dense decoder-only
transformer and the model factory (``model_zoo.build_model``)."""
