"""Model layers, the layer stack and the Model API of the port."""
