"""Hyperparameters of the tabular APC-VFL protocol (``apcvfl_paper``)."""
