"""One SGD-with-momentum step of every filter MLP at once."""
