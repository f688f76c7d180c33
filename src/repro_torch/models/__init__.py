"""The LM substrate on PyTorch: config schema and registry (copies of the
reference's), layers, model assembly and the weight converter."""
