"""Evaluation (port of hairci.eval): ``features`` (l2_normalize,
extract_features), ``knn`` (kNN prediction for all ks in one pass),
``report`` (sklearn's report layout in numpy) and ``classifier`` (the
``Classifier`` facade that writes ``knn_evaluation_results.txt``)."""
