"""Model families: the eigenfaces PCA model."""
