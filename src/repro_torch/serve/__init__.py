"""Online VFL serving: bundle, representation cache, batched engine,
int8 active path."""
