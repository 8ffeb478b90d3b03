"""One module per kind of traffic mix; a mix's file names its driver."""
