"""Models of the port: ``llm`` (Llama), ``image`` (ResNet) and
``recommendation`` (NeuralCF)."""
