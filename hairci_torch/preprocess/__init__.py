"""Offline preprocessing (port of ``hairci/preprocess``): hair-region
extraction and the folder splitter."""

from hairci_torch.preprocess.data_split import split_folder
from hairci_torch.preprocess.face_toolkit import (
    hair_mask,
    process_face_image,
    process_folder_multiprocess,
)
