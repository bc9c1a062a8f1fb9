"""The dense model family: configuration, parameters, layers and assembly."""
