"""Encoder, MLP, ODE-model and decoder blocks as functions on tensors."""
