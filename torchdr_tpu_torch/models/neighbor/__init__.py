from .tsne import SNE, TSNE
from .umap import UMAP

__all__ = ["SNE", "TSNE", "UMAP"]
