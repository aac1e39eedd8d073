"""Analysis helpers of the port (counterpart of ``repro.analysis``): the
roofline constants of the one card the port targets. The reference's
``hlo_analyzer`` reads XLA HLO and has no counterpart here."""
