"""The plain reference the check holds the program to. Imports torch and
numpy only: nothing of the program, of JAX or of the JAX package."""
