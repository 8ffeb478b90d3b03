"""Plain PyTorch references the checks compare the program with."""
