"""Weight exchange with the JAX package and the reference .pth layout."""
