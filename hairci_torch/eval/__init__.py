"""Evaluation (port of hairci.eval): ``features`` (l2_normalize,
extract_features), ``knn`` (kNN prediction for
all ks in one pass), ``linear_probe`` (the L-BFGS probe), ``variance``
(intra/inter-class variance), ``umap_export`` (the 2-D projection),
``report`` (sklearn's report layout in numpy) and ``classifier`` (the
``Classifier`` facade that writes the result files); ``retrieval_metrics``
(Recall@K and mAP@K of DualViewHair's evaluation) is imported by its
users."""

from hairci_torch.eval.features import extract_features, l2_normalize
from hairci_torch.eval.knn import (
    DEFAULT_KS,
    format_knn_report,
    knn_eval,
    knn_predict,
    knn_predict_multi,
)
from hairci_torch.eval.linear_probe import (
    linear_probe_eval,
    linear_probe_fit_predict,
)
from hairci_torch.eval.variance import compute_intra_inter_variance
from hairci_torch.eval.umap_export import pca_2d, project_2d, save_umap
from hairci_torch.eval.classifier import Classifier
