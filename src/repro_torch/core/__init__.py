"""Core APC-VFL modules: PSI, the Table-3 autoencoders (forward half)
and the logistic-regression head."""
