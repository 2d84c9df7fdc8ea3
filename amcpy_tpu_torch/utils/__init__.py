"""Device selection and metrics."""
