"""The offline interpretability tools: prototype heatmaps
(``tools.visualize``) and the consistency score
(``tools.eval_interpretability``)."""
