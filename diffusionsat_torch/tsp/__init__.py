"""Dense-matrix TSP: data with exact labels, the subtour finder, the tour
losses, the DenseGNN and MatrixSE layers, the TSPMatrixSE model and the
decoders with their optimality-gap metric."""

PADDING_VALUE = -1.0  # marks padded rows and columns of distances and labels
