"""Training substrate of the port: the optimizers (``optimizer``) and
gradients over a param tree (``grad``)."""
