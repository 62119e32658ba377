"""Body model, VPoser decoder, priors and cameras of the port."""
