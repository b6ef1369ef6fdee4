"""Model configs, the BERT classifier module and the JAX weight bridge."""
