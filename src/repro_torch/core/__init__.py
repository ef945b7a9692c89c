"""Core APC-VFL modules: PSI, the Table-3 autoencoders and their losses,
the Eq. 5 distillation loss, the training engine, the logistic probe and
k-fold CV, communication accounting and the four-step protocol."""
