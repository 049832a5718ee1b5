"""Models of the port: ``llm`` (Llama, MoELlama), ``image`` (ResNet,
VGG, the classification zoo), ``recommendation`` (NeuralCF,
WideAndDeep, SessionRecommender), ``ranking`` (KNRM), ``text`` (NER,
SequenceTagger, IntentEntity on the CRF), ``textclassification``
(TextClassifier), ``seq2seq`` and ``anomalydetection``
(AnomalyDetector)."""
