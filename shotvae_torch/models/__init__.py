"""The port's models (eval-mode serving slice)."""
