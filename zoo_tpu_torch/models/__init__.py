"""Models of the port: ``llm`` (Llama), ``image`` (ResNet, VGG),
``recommendation`` (NeuralCF, SessionRecommender),
``textclassification`` (TextClassifier) and ``anomalydetection``
(AnomalyDetector)."""
