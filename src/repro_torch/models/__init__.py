"""Model stack of the port: dense and ssm decoder blocks, the Model API."""
