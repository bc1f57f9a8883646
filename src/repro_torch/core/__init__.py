"""Compiler (numpy copies of ``repro.core``) and the torch executor."""
