"""The repo's tests as a regular package, so that ``tests.<module>``
(the helpers the tests import from each other) names this directory
even where an installed distribution ships a top-level ``tests``
package, which a namespace package would lose to."""
