"""Host-side utilities: the name registry, metric meters, the step timer,
logging and the TensorBoard writer."""
