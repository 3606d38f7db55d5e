"""Face-retrieval CLI (the reference's ``src/face_retrieval.py``): the
retrieval CLI with the face encoder (``ViT_face`` / ``ViTs_face`` at 112).

    python -m hairci_torch.cli.face_retrieval --data_path DIR \
        [--model_name VIT|VITs] [--device cuda|cpu]
"""

from hairci_torch.cli.retrieval import run

if __name__ == "__main__":
    run("face")
