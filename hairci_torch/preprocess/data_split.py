"""Folder splitter (port of ``hairci/preprocess/data_split.py``; the
reference's ``src/util/data_split.py:6-37``): copy the files of a folder into
``hair_i/`` subfolders of ``chunk_size`` (default 5000) each.

CLI: python -m hairci_torch.preprocess.data_split --input_dir x/ --output_dir y/
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
from typing import List

log = logging.getLogger(__name__)


def split_folder(input_dir: str, output_dir: str,
                 chunk_size: int = 5000, prefix: str = "hair_") -> List[str]:
    files = sorted(
        f for f in os.listdir(input_dir)
        if os.path.isfile(os.path.join(input_dir, f)))
    out_dirs = []
    for i in range(0, len(files), chunk_size):
        sub = os.path.join(output_dir, f"{prefix}{i // chunk_size}")
        os.makedirs(sub, exist_ok=True)
        for f in files[i:i + chunk_size]:
            shutil.copy2(os.path.join(input_dir, f), os.path.join(sub, f))
        out_dirs.append(sub)
        log.info("%s: %d files", sub, len(files[i:i + chunk_size]))
    return out_dirs


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--chunk_size", type=int, default=5000)
    args = p.parse_args(argv)
    split_folder(args.input_dir, args.output_dir, args.chunk_size)


if __name__ == "__main__":
    main()
