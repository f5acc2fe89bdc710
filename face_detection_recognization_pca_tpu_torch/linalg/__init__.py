"""Dense linear algebra: snapshot PCA and standardization."""
