from .cosne import COSNE
from .largevis import InfoTSNE, LargeVis
from .pacmap import PACMAP
from .tsne import SNE, TSNE
from .tsnekhorn import TSNEkhorn
from .umap import UMAP

__all__ = ["SNE", "TSNE", "UMAP", "LargeVis", "InfoTSNE", "TSNEkhorn", "PACMAP", "COSNE"]
