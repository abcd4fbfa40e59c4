"""Device selection and parameter conversion."""
