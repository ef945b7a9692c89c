"""Online VFL serving: bundle, versioned representation cache, batched
engine, int8 active path, and the live multi-tenant runtime."""
